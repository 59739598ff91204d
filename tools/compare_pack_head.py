"""Times the pack kernel (K6-pack) and the W2TTFS head (K5) of two
checkouts on one card, per launch, and the forward they sit in.

The shapes are the main paths' launches of QKFResNet-11 at batch 256: the
T = 1 ``fused_packed`` forward's stem pack [1, 262144, 64], the T = 4
forward's 14 packs of [4, M, N] trains (the stem's and res1's two at N =
64, res2's two at 128, res3's two at 256, res4's two and the five
QKFormer passes' at 512), and the head on the 256 images' 4x4x512 map
(10 classes, and a CIFAR-100 head of 100). The spikes are seeded, density
0.2, every third 128-row block silent (``chip_smoke.rand_spikes``). The
head is timed as the forward calls it: on the int8 map where the
checkout's launcher reads int8, else on the f32 map cast from it, the
cast timed with the launch. A checkout that has the empty kernel also
times its launch (the floor). Each launch's device time is taken with a
cold L2 (``chip_smoke.device_time``). Last, the device busy time
(``torch.profiler``) of QKFResNet-11's forward at batch 256
(``chip_smoke.init_model``'s weights) under ``fused_packed`` and
``fused_dense`` at T = 1 and T = 4, where the two kernels' gain shows end
to end. Each run is a process of its own that builds the kernels from its
checkout's sources; the runs go A, B, B, A, so that a drift of the card
over the call shows.

    python3 tools/compare_pack_head.py PARENT_CHECKOUT CHANGED_CHECKOUT

Needs a CUDA device. Compare two checkouts only within one call.
"""
from __future__ import annotations

import subprocess
import sys

CHILD = r'''
import sys
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.insert(0, root + "/src")
import torch
import chip_smoke as C
from repro_torch.kernels import _build
from repro_torch.kernels import packed as P
from repro_torch.kernels import w2ttfs_pool as H

card = C.phase_setup(torch)
_build.build()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(29)
PACKS = ([("stem T=1", 1, 262144, 64)]
         + [(f"{name} T=4", 4, m, n) for name, m, n in (
             ("stem", 262144, 64), ("res1.conv1", 262144, 64),
             ("res1.conv2", 262144, 64), ("res2.conv1", 65536, 128),
             ("res2.conv2", 65536, 128), ("res3.conv1", 16384, 256),
             ("res3.conv2", 16384, 256), ("res4.conv1", 4096, 512),
             ("res4.conv2", 4096, 512))]
         + [(f"qkf{i} T=4", 4, 4096, 512) for i in range(5)])
total = 0.0
for label, items, m, n in PACKS:
    x = torch.stack([C.rand_spikes(torch, gen, m, n, 0.2, dev)
                     for _ in range(items)])
    ms = C.device_time(torch, lambda: P.pack_spikes_cuda(x), reps=20)
    if label != "stem T=1":
        total += ms
    print(f"[compare] {root}: pack {label} [{items}x{m}x{n}]: {ms:.4f} ms",
          flush=True)
    del x
print(f"[compare] {root}: pack, the 14 T=4 launches: {total:.4f} ms",
      flush=True)
for classes in (10, 100):
    s8 = (torch.rand((256, 4, 4, 512), generator=gen, device=dev) < 0.2
          ).to(torch.int8)
    fc_w = torch.randn((512, classes), generator=gen, device=dev)
    fc_b = torch.randn((classes,), generator=gen, device=dev)
    try:
        H.w2ttfs_pool_cuda(s8, fc_w, fc_b, 4)
        call, how = (lambda: H.w2ttfs_pool_cuda(s8, fc_w, fc_b, 4)), "int8"
    except (TypeError, ValueError):
        call = lambda: H.w2ttfs_pool_cuda(s8.to(torch.float32), fc_w, fc_b, 4)
        how = "f32 cast from int8"
    ms = C.device_time(torch, call, reps=20)
    print(f"[compare] {root}: head [256x4x4x512] {classes} classes on the "
          f"{how} map: {ms:.4f} ms", flush=True)
lib = _build.library()
if hasattr(lib, "repro_empty"):
    def empty():
        lib.repro_empty(torch.cuda.current_stream().cuda_stream)
    ms = C.device_time(torch, empty, reps=50)
    print(f"[compare] {root}: launch floor (an empty kernel): {ms:.4f} ms",
          flush=True)


def busy_ms(fn, reps=3):
    """Device busy ms a call: the profiler's kernel time over reps calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(ev, "self_device_time_total", 0.0)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3 / reps


import dataclasses
from repro_torch.models import snn_cnn
cfg1, variables = C.init_model(torch, snn_cnn, dev)
images = torch.rand((256, 32, 32, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
for t in (1, 4):
    cfg = dataclasses.replace(cfg1, timesteps=t)
    fused = snn_cnn.fuse_model(variables, cfg)
    for policy in ("fused_packed", "fused_dense"):
        ms = busy_ms(lambda: snn_cnn.forward(fused, images, cfg,
                                             policy=policy))
        print(f"[compare] {root}: QKFResNet-11 batch 256 T={t} {policy} "
              f"forward: device busy {ms:.3f} ms", flush=True)
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
