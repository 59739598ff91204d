"""Times K9's scalar route (f32 flash attention) and the unpack kernel of
two checkouts on one card, per launch, and the training step the unpacks
sit in.

- K9 f32 at B 1, H 16 over Hkv 8, D 128, causal, S 248 (the f32 LM
  variant's prefill), 512, 2048 and 8192 on the scalar route, seeded
  operands, beside SDPA on the same operands (TF32 off).
- The unpacks of the packed KD step: each fused PE pass's spikes unpacked
  to f32 as the training forward asks for them (``unpack_spikes(ps,
  dtype=torch.float32)``: a checkout whose kernel writes int8 casts after
  it, and the cast is timed with the call), at res1's two [262144, 64],
  res2's two [65536, 128], res3's two [16384, 256] and res4's two and the
  five QKFormer passes' [4096, 512]: the 13 launches of a T = 1 step, and
  four seeded maps of each shape for the 52 of a T = 4 step (a step's
  launches unpack one time step's map each). Then the head's unpack (the
  int8 map [1, 4096, 512] of 256 images' 4x4x512). Seeded spikes, density
  0.2, every third 128-row block silent (``chip_smoke.rand_spikes``).
- The folded ``fused_packed+grad`` KD step of QKFResNet-11 (batch 256,
  ``chip_smoke``'s weights and teacher) at T = 1 and T = 4: the median of
  three synchronised steps (host clock), the profiler's device busy time
  and kernel launches a step (``chip_smoke.profile_step``), and the
  launches and device time of elementwise copy kernels (where the int8 to
  f32 casts after the unpacks go).

Each launch's device time is taken with a cold L2
(``chip_smoke.device_time``). Each run is a process of its own that builds
the kernels from its checkout's sources; the runs go A, B, B, A, so that a
drift of the card over the call shows.

    python3 tools/compare_flash_unpack.py PARENT_CHECKOUT CHANGED_CHECKOUT

Needs a CUDA device. Compare two checkouts only within one call.
"""
from __future__ import annotations

import subprocess
import sys

CHILD = r'''
import dataclasses, statistics, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.insert(0, root + "/src")
import torch
import chip_smoke as C
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import packed as P

card = C.phase_setup(torch)
_build.build()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(31)

for s in (248, 512, 2048, 8192):
    q = torch.randn((1, s, 16, 128), generator=gen, device=dev)
    k, v = (torch.randn((1, s, 8, 128), generator=gen, device=dev)
            for _ in range(2))
    reps = max(3, 40960 // s)
    ms = C.device_time(torch, lambda: F.flash_attention_cuda(
        q, k, v, True, route="scalar"), reps)
    sdpa = C.device_time(torch, C.sdpa_call(torch, q, k, v, True), reps)
    print(f"[compare] {root}: K9 f32 S {s} scalar route {ms:.4f} ms; SDPA "
          f"{sdpa:.4f} ms", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

STEP = ([(f"res1.conv{i}", 262144, 64) for i in (1, 2)]
        + [(f"res2.conv{i}", 65536, 128) for i in (1, 2)]
        + [(f"res3.conv{i}", 16384, 256) for i in (1, 2)]
        + [(f"res4.conv{i}", 4096, 512) for i in (1, 2)]
        + [(f"qkf{i}", 4096, 512) for i in range(5)])
t1 = t4 = 0.0
for label, m, n in STEP:
    for j in range(4):
        ps = P.pack_spikes(C.rand_spikes(torch, gen, m, n, 0.2, dev))
        ms = C.device_time(torch, lambda: P.unpack_spikes(
            ps, dtype=torch.float32), reps=20)
        t4 += ms
        if j == 0:
            t1 += ms
            print(f"[compare] {root}: step unpack {label} [{m}x{n}] to "
                  f"f32: {ms:.4f} ms", flush=True)
        del ps
print(f"[compare] {root}: the T=1 step's 13 unpacks to f32: {t1:.4f} ms; "
      f"the T=4 step's 52: {t4:.4f} ms", flush=True)
ps = P.pack_spikes(C.rand_spikes(torch, gen, 4096, 512, 0.2, dev)[None])
ms = C.device_time(torch, lambda: P.unpack_spikes(ps), reps=50)
print(f"[compare] {root}: head unpack [1x4096x512] int8: {ms:.4f} ms",
      flush=True)
del ps
lib = _build.library()
if hasattr(lib, "repro_empty"):
    def empty():
        lib.repro_empty(torch.cuda.current_stream().cuda_stream)
    ms = C.device_time(torch, empty, reps=50)
    print(f"[compare] {root}: launch floor (an empty kernel): {ms:.4f} ms",
          flush=True)


def copies(path, reps=2):
    """Elementwise copy kernels (casts among them) a step: launches and
    device ms, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    carry, data = path.carry, path.batch0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            carry, _ = path.step(carry, data)
        torch.cuda.synchronize()
    n = ms = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and "copy" in ev.key:
            n += ev.count / reps
            ms += getattr(ev, "self_device_time_total", 0.0) / 1e3 / reps
    return n, ms


M = C.training_namespace()
cfg1, variables = C.init_model(torch, M.snn_cnn, dev)
tcfg, tvar, batches = C.kd_setup(torch, M, dev, 256)
for t in (1, 4):
    cfg = dataclasses.replace(cfg1, timesteps=t)
    path = C.TrainPath(torch, M, cfg, variables, tcfg, tvar, "fold",
                       "fused_packed+grad", suffix=f" T={t}")
    path.run(batches[:1], _build)
    carry, steps = path.carry, []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = path.step(carry, path.batch0)
        torch.cuda.synchronize()
        if i:
            steps.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(steps)
    print(f"[compare] {root}: fused_packed+grad T = {t} step median "
          f"{median:.3f} ms; unpack launches {path.launches[0]['unpack_spikes']}",
          flush=True)
    C.profile_step(torch, path, median)
    n, ms = copies(path)
    print(f"[compare] {root}: fused_packed+grad T = {t} step: {n:.0f} "
          f"elementwise copy launches, {ms:.3f} ms device time", flush=True)
    del path
    torch.cuda.empty_cache()
print(f"[compare] {root}: {card}", flush=True)
'''


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    for root in (a, b, b, a):
        done = subprocess.run([sys.executable, "-c", CHILD, root])
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
