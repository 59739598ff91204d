#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero:

1. setup   — the card's name and power limit; TF32 off for matmul and cuDNN.
2. build   — nvcc builds the six kernels from ``src/repro_torch/csrc`` (one
             process per source, all started together); prints the build
             seconds and each kernel's registers, shared memory and spills.
3. parity  — each kernel's launcher against its plain PyTorch version on
             the card, on seeded spike maps at densities {0, 0.1, 0.5} with
             silent row blocks, at the main paths' shapes plus ragged ones:
             the int8 (``fused_dense``) operands, then the packed ones of
             ``fused_packed`` (pack and unpack bit-equal, round trip exact;
             the packed fused PE and spike-matmul variants).
4. end to end — QKFResNet-11 at full width (64/128/256/512 channels,
             QKFormer d=512, CIFAR-10 32x32x3 inputs), random weights from
             ``torch.Generator`` seed 0 with every BN beta = 0.5, folded by
             ``fuse_model``; 256 seeded images through ``forward`` under
             ``"fused_dense"`` and ``"fused_packed"`` (the kernels) and
             ``"reference"`` (plain PyTorch) on the card. Launch counts are
             reset just before each kernel path's forward and read just
             after it. Then VGG-11 at full width, batch 64, under
             ``"fused_packed"`` against ``"reference"`` (parity only: it is
             the arch that reaches the packed max-pool).
5. timing  — CUDA events: median forward time of each policy, the
             profiler's device breakdown of both kernel paths, and each
             kernel's time at the operands its main path gave it, beside
             its bound, its plain version and, for the matmul kernels, one
             ``torch.matmul``.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the f32 rate outside the
# tensor cores (IEEE f32 is what parity with the reference needs).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
BATCH = 256              # images in the end-to-end forward
ITERS = 10               # timed forwards per policy
V_TH = 1.0
NEAR_VTH = 1e-4          # |plain current - v_th| below this may flip
RTOL, ATOL = 1e-5, 1e-4  # f32 outputs: the sums run in another order
VGG_BATCH = 64           # images in the VGG-11 packed parity forward
# launches per forward of each kernel path, every count read after a reset
EXPECTED_LAUNCHES = {
    "fused_dense": {"lif_update": 1, "fused_pe": 13, "spike_matmul": 3,
                    "w2ttfs_pool": 1, "pack_spikes": 0, "unpack_spikes": 0},
    "fused_packed": {"lif_update": 1, "fused_pe": 13, "spike_matmul": 3,
                     "w2ttfs_pool": 1, "pack_spikes": 1, "unpack_spikes": 1},
}
# row of the kernels line -> (kernel, path whose launches it reports,
# source, the TPU kernel's pallas_call it replaces)
ROWS = {
    "lif_update": ("lif_update", "fused_dense",
                   "src/repro_torch/csrc/lif_update.cu",
                   "src/repro/kernels/lif_update/lif_update.py:62"),
    "fused_pe": ("fused_pe", "fused_dense", "src/repro_torch/csrc/fused_pe.cu",
                 "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "spike_matmul": ("spike_matmul", "fused_dense",
                     "src/repro_torch/csrc/spike_matmul.cu",
                     "src/repro/kernels/spike_matmul/spike_matmul.py:83"),
    "w2ttfs_pool": ("w2ttfs_pool", "fused_dense",
                    "src/repro_torch/csrc/w2ttfs_pool.cu",
                    "src/repro/kernels/w2ttfs_pool/w2ttfs_pool.py:49"),
    "pack_spikes": ("pack_spikes", "fused_packed",
                    "src/repro_torch/csrc/pack_spikes.cu",
                    "src/repro/kernels/packed/packed.py:66"),
    "unpack_spikes": ("unpack_spikes", "fused_packed",
                      "src/repro_torch/csrc/unpack_spikes.cu",
                      "src/repro/kernels/packed/packed.py:96"),
    "fused_pe_packed": ("fused_pe", "fused_packed",
                        "src/repro_torch/csrc/fused_pe.cu",
                        "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "spike_matmul_packed": ("spike_matmul", "fused_packed",
                            "src/repro_torch/csrc/spike_matmul.cu",
                            "src/repro/kernels/spike_matmul/"
                            "spike_matmul.py:83"),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ phase 1
def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_setup(torch) -> str:
    smi = gpu_name_and_power()
    say(f"[setup] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    say(f"[setup] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    say(f"[setup] torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


# ------------------------------------------------------------------ phase 2
def phase_build(build_mod) -> None:
    t0 = time.perf_counter()
    info = build_mod.build()
    build_mod.library()
    say(f"[build] {info.path.name}: nvcc {info.seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s in all)")
    for line in info.ptxas_log.splitlines():
        if ("Compiling entry" in line or "Used" in line or "spill" in line
                or line.startswith("==")):
            say(f"[build]   {line.strip()}")


# ------------------------------------------------------------------ phase 3
class Parity:
    """Worst errors per kernel across every comparison made."""

    def __init__(self):
        self.max_abs_err: dict[str, float] = {}
        self.near_vth: dict[str, int] = {}

    def note(self, name: str, err: float, near: int = 0) -> None:
        self.max_abs_err[name] = max(self.max_abs_err.get(name, 0.0), err)
        self.near_vth[name] = self.near_vth.get(name, 0) + near


def rand_spikes(torch, gen, m: int, k: int, density: float, dev):
    """Seeded 0/1 int8 map; every third 128-row block is silent, so the
    kernels' block skip runs at any density."""
    x = (torch.rand((m, k), generator=gen, device=dev) < density)
    rows = torch.arange(m, device=dev)
    x[(rows // 128) % 3 == 1] = False
    return x.to(torch.int8)


def check_fused_pe(torch, K, args, parity: Parity, label: str) -> None:
    """Kernel vs plain version on one set of block-aligned operands (dense
    or packed; the row is ``fused_pe_packed`` when x is packed)."""
    xp, wp, vld, bp, rp, qp, m0, n0, v_th, _, packing = args
    row = "fused_pe_packed" if packing.x else "fused_pe"
    k_out, k_vld = K.fused_pe_cuda(*args)
    p_out, p_vld = K.fused_pe_block_ref(*args)
    if packing.out:
        k_spk, p_spk = K.unpack_words(k_out), K.unpack_words(p_out)
        inv = K.check_packed_invariants(K.PackedSpikes(k_out, k_vld,
                                                       (m0, n0)))
        require(inv["ok"], f"{row} {label}: packed output {inv}")
    else:
        k_spk, p_spk = k_out, p_out
    cur = K.spike_matmul_block_ref(xp, wp, vld, packing.x)
    if bp is not None:
        cur = cur + bp.reshape(1, -1)
    if rp is not None:
        cur = cur + (K.unpack_words(rp, torch.float32) if packing.residual
                     else rp)
    valid = torch.zeros_like(k_spk, dtype=torch.bool)
    valid[:m0, :n0] = True
    near = ((cur - v_th).abs() < NEAR_VTH) & valid
    diff = k_spk != p_spk
    bad = int((diff & ~near).sum())
    flips = int((diff & near).sum())
    require(bad == 0, f"{row} {label}: {bad} spikes differ away from v_th")
    require(bool((k_vld == K.block_count_map_2d(k_spk, 128, 128)).all()),
            f"{row} {label}: vld_next is not the block count of the "
            f"kernel's own spikes")
    require(not bool(k_spk[m0:].any()) and not bool(k_spk[:, n0:].any()),
            f"{row} {label}: padding fired")
    parity.note(row, float(bad), int(near.sum()))
    say(f"[parity] {row} {label}: spikes equal away from v_th; "
        f"{int(near.sum())} positions within {NEAR_VTH} of v_th, {flips} of "
        f"them flipped; rate {float(k_spk[:m0, :n0].float().mean()):.4f}; "
        f"silent x blocks {int((vld == 0).sum())}/{vld.numel()}; "
        f"packing {tuple(packing)}")


def check_spike_matmul(torch, K, args, parity: Parity, label: str) -> None:
    row = "spike_matmul_packed" if args[3] else "spike_matmul"
    out = K.spike_matmul_cuda(*args)
    ref = K.spike_matmul_block_ref(*args)
    err = float((out - ref).abs().max())
    require(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
            f"{row} {label}: max abs err {err}")
    parity.note(row, err)
    say(f"[parity] {row} {label}: max abs err {err:.3e}; silent x "
        f"blocks {int((args[2] == 0).sum())}/{args[2].numel()}")


def check_pack(torch, K, args, parity: Parity, label: str) -> None:
    """Words, vld_cnt and occ bit-equal to the plain pack; the unpack
    kernel restores x exactly."""
    (x3,) = args
    words, vld, occ = K.pack_spikes_cuda(x3)
    ref = K.pack_spikes_ref(x3, with_occ=True)
    bad = int((words != ref.words).sum() + (vld != ref.vld_cnt).sum()
              + (occ != ref.occ).sum())
    require(bad == 0, f"pack_spikes {label}: {bad} words or map entries "
                      f"differ")
    back = K.unpack_spikes_cuda(words)[:, :x3.shape[1], :x3.shape[2]]
    lost = int((back != (x3 != 0).to(torch.int8)).sum())
    require(lost == 0, f"pack_spikes {label}: round trip lost {lost}")
    parity.note("pack_spikes", float(bad))
    say(f"[parity] pack_spikes {label}: words, vld_cnt and occ bit-equal; "
        f"round trip exact; words with bit 31 set "
        f"{int((words < 0).sum())}; spikes {int(ref.vld_cnt.sum())}")


def check_unpack(torch, K, args, parity: Parity, label: str) -> None:
    (words,) = args
    bad = int((K.unpack_spikes_cuda(words) != K.unpack_words(words)).sum())
    require(bad == 0, f"unpack_spikes {label}: {bad} bytes differ")
    parity.note("unpack_spikes", float(bad))
    say(f"[parity] unpack_spikes {label}: bytes equal ({words.numel()} "
        f"words)")


def check_lif(torch, K, args, parity: Parity, label: str) -> None:
    cur, vp, sp, tau, v_th, soft = args
    k_spk, k_v = K.lif_update_cuda(*args)
    p_spk, p_v = K.lif_update_ref(cur, vp, sp, tau, v_th, soft)
    v = tau * vp * (1.0 - sp) + cur
    near = (v - v_th).abs() < NEAR_VTH
    bad = int(((k_spk != p_spk) & ~near).sum())
    require(bad == 0, f"lif_update {label}: {bad} spikes differ")
    err = float(((k_v - p_v).abs() * ~near).max())
    require(err <= ATOL, f"lif_update {label}: v_next max abs err {err}")
    parity.note("lif_update", err, int(near.sum()))
    say(f"[parity] lif_update {label}: spikes equal away from v_th "
        f"({int(near.sum())} within {NEAR_VTH}); v_next max abs err "
        f"{err:.3e}")


def check_w2ttfs(torch, K, args, parity: Parity, label: str) -> None:
    out = K.w2ttfs_pool_cuda(*args)
    ref = K.w2ttfs_pool_fc_ref(*args)
    err = float((out - ref).abs().max())
    require(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
            f"w2ttfs_pool {label}: max abs err {err}")
    parity.note("w2ttfs_pool", err)
    say(f"[parity] w2ttfs_pool {label}: max abs err {err:.3e}")


CHECKS = {"fused_pe": check_fused_pe, "spike_matmul": check_spike_matmul,
          "lif_update": check_lif, "w2ttfs_pool": check_w2ttfs,
          "pack_spikes": check_pack, "unpack_spikes": check_unpack}

# (label, M, K, N, residual, q mask) of every fused PE pass on the int8 main
# path (batch 256), plus a ragged one
FUSED_PE_SHAPES = [
    ("res1.conv1", 262144, 576, 64, None, False),
    ("res1.conv2", 262144, 576, 64, "int8", False),
    ("res2.conv1", 65536, 576, 128, None, False),
    ("res2.conv2", 65536, 1152, 128, "f32", False),
    ("res3.conv1", 16384, 1152, 256, None, False),
    ("res3.conv2", 16384, 2304, 256, "f32", False),
    ("res4.conv1", 4096, 2304, 512, None, False),
    ("res4.conv2", 4096, 4608, 512, "f32", False),
    ("qkf.q", 4096, 512, 512, None, False),
    ("qkf.k", 4096, 512, 512, None, True),
    ("qkf.proj", 4096, 512, 512, "int8", False),
    ("ragged", 4059, 500, 300, "f32", True),
]
# the packed main path: x, q, the spike residual and the output packed;
# each 3x3 tap's channels are padded to 128, so K is 9 * 128 where the int8
# path has 9 * 64 (res1, res2.conv1)
FUSED_PE_PACKED_SHAPES = [
    ("res1.conv1", 262144, 1152, 64, None, False),
    ("res1.conv2", 262144, 1152, 64, "packed", False),
    ("res2.conv1", 65536, 1152, 128, None, False),
    ("res2.conv2", 65536, 1152, 128, "f32", False),
    ("res3.conv1", 16384, 1152, 256, None, False),
    ("res3.conv2", 16384, 2304, 256, "f32", False),
    ("res4.conv1", 4096, 2304, 512, None, False),
    ("res4.conv2", 4096, 4608, 512, "f32", False),
    ("qkf.q", 4096, 512, 512, None, False),
    ("qkf.k", 4096, 512, 512, None, True),
    ("qkf.proj", 4096, 512, 512, "packed", False),
    ("ragged", 4059, 500, 300, "packed", True),
]
SPIKE_MATMUL_SHAPES = [
    ("res2.sc", 65536, 64, 128), ("res3.sc", 16384, 128, 256),
    ("res4.sc", 4096, 256, 512), ("ragged", 4059, 200, 300),
]
# packed shortcut patches: the 1x1 tap's channels padded to 128
SPIKE_MATMUL_PACKED_SHAPES = [
    ("res2.sc", 65536, 128, 128), ("res3.sc", 16384, 128, 256),
    ("res4.sc", 4096, 256, 512), ("ragged", 4059, 200, 300),
]
# [items, M, K] spike maps packed on the main path (the first LIF's
# tokens, batch 256 at 32x32x64) and ragged ones
PACK_SHAPES = [("first LIF", 1, 262144, 64), ("ragged", 2, 4059, 300),
               ("ragged", 3, 130, 33)]
DENSITIES = (0.0, 0.1, 0.5)


def parity_fused_pe(torch, K, gen, dev, parity, shapes, packed: bool
                    ) -> None:
    for label, m, k, n, res, with_q in shapes:
        for p in DENSITIES:
            x = rand_spikes(torch, gen, m, k, p, dev)
            w = torch.randn((k, n), generator=gen, device=dev) \
                * (2.0 / math.sqrt(k))
            b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=dev)
            r = None
            if res == "f32":
                r = 0.5 * torch.randn((m, n), generator=gen, device=dev)
            elif res is not None:
                r = rand_spikes(torch, gen, m, n, 0.3, dev)
                if res == "packed":
                    r = K.pack_spikes_ref(r)
            # Q rows are sparse enough that the mask cuts some of them
            q = (rand_spikes(torch, gen, m, n, 0.002, dev) if with_q
                 else None)
            if packed:
                x = K.pack_spikes_ref(x)
                q = None if q is None else K.pack_spikes_ref(q)
            args = K.fused_pe_operands(
                x, w, bias=b, residual=r, q=q, v_th=V_TH, qk_threshold=1.0,
                out_format="packed" if packed else "dense")
            check_fused_pe(torch, K, args, parity,
                           f"{label} [{m}x{k}x{n}] density {p}")


def phase_parity(torch, K, dev) -> Parity:
    parity = Parity()
    gen = torch.Generator(device=dev).manual_seed(1234)
    parity_fused_pe(torch, K, gen, dev, parity, FUSED_PE_SHAPES, False)
    parity_fused_pe(torch, K, gen, dev, parity, FUSED_PE_PACKED_SHAPES, True)
    for packed, shapes in ((False, SPIKE_MATMUL_SHAPES),
                           (True, SPIKE_MATMUL_PACKED_SHAPES)):
        for label, m, k, n in shapes:
            for p in DENSITIES:
                x = rand_spikes(torch, gen, m, k, p, dev)
                w = torch.randn((k, n), generator=gen, device=dev)
                if packed:
                    x = K.pack_spikes_ref(x)
                check_spike_matmul(torch, K,
                                   K.spike_matmul_operands(x, w), parity,
                                   f"{label} [{m}x{k}x{n}] density {p}")
    for label, items, m, k in PACK_SHAPES:
        for p in DENSITIES + (1.0,):
            x = torch.stack([rand_spikes(torch, gen, m, k, p, dev)
                             for _ in range(items)])
            if p > 0:
                x[..., 31::32] = 1          # every word's sign bit
            check_pack(torch, K, (x,), parity,
                       f"{label} [{items}x{m}x{k}] density {p}")
            check_unpack(torch, K, (K.pack_spikes_ref(x).words,), parity,
                         f"{label} [{items}x{m}x{k}] density {p}")
    for numel in (262144 * 64, 1000003):
        for p in DENSITIES:
            cur = 1.0 + torch.randn((numel,), generator=gen, device=dev)
            vp = torch.randn((numel,), generator=gen, device=dev)
            sp = (torch.rand((numel,), generator=gen, device=dev) < p
                  ).to(torch.float32)
            check_lif(torch, K, (cur, vp, sp, 0.5, V_TH, False), parity,
                      f"n={numel} s_prev density {p}")
    for b, h, c, window, classes in ((256, 4, 512, 4, 10),
                                     (5, 8, 64, 4, 10)):
        for p in DENSITIES:
            spikes = (torch.rand((b, h, h, c), generator=gen, device=dev)
                      < p).to(torch.float32)
            feats = (h // window) ** 2 * c
            fc_w = torch.randn((feats, classes), generator=gen, device=dev)
            fc_b = torch.randn((classes,), generator=gen, device=dev)
            check_w2ttfs(torch, K, (spikes, fc_w, fc_b, window), parity,
                         f"[{b},{h},{h},{c}] window {window} density {p}")
    torch.cuda.synchronize()
    return parity


# ------------------------------------------------------------------ phase 4
def build_model(torch, snn_cnn, dev, arch: str = "qkfresnet11"):
    cfg = snn_cnn.SNNCNNConfig(arch=arch, width_mult=1.0, image_size=32,
                               in_channels=3, num_classes=10)
    gen = torch.Generator(device="cpu").manual_seed(0)
    variables = snn_cnn.init(gen, cfg, device=dev)
    # a random net at full width goes silent by the third resblock; a BN
    # beta of 0.5 keeps every layer firing (per-layer rates 0.24-0.52)
    for p in variables["params"]:
        for key, sub in p.items():
            if key.startswith("bn"):
                sub["bias"].fill_(0.5)
    return cfg, snn_cnn.fuse_model(variables, cfg)


def run_path(torch, snn_cnn, build_mod, fused, images, cfg, policy: str):
    """One forward of a kernel path, its launch counts set to 0 just
    before it and read just after it."""
    build_mod.reset_launches()
    with build_mod.capture_launches() as captured:
        logits, _, aux = snn_cnn.forward(fused, images, cfg, policy=policy)
        torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    say(f"[e2e] kernel launches in one {policy} forward: {launches}")
    require(launches == EXPECTED_LAUNCHES[policy],
            f"{policy} launch counts {launches} != "
            f"{EXPECTED_LAUNCHES[policy]}")
    return logits, aux, launches, captured


def compare_spikes(aux, ref_aux, label: str, rel_tol: float) -> float:
    """Per-layer spike totals of a kernel path against another run."""
    worst = 0.0
    for key, val in aux["spikes"].items():
        if key not in ref_aux["spikes"]:
            continue
        a, b = float(val), float(ref_aux["spikes"][key])
        rel = abs(a - b) / max(b, 1.0)
        worst = max(worst, rel)
        say(f"[e2e] spikes {key}: {label} {a:.0f} vs {b:.0f} "
            f"(rel diff {rel:.2e})")
        require(rel <= rel_tol, f"{label}: spike total {key} differs by "
                                f"{rel:.2e}")
    return worst


def check_logits(torch, logits, ref_logits, batch: int, label: str) -> None:
    require(tuple(logits.shape) == (batch, 10), f"logits {logits.shape}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    diff = float((logits - ref_logits).abs().max())
    say(f"[e2e] top-1 agreement {label}: {agree:.4f}; max |logit diff| "
        f"{diff:.3e}; logits range [{float(logits.min()):.3f}, "
        f"{float(logits.max()):.3f}]")
    require(agree >= 0.99, f"{label}: top-1 agreement {agree} < 0.99")


def phase_end_to_end(torch, snn_cnn, build_mod, dev, batch: int):
    cfg, fused = build_model(torch, snn_cnn, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.rand((batch, 32, 32, 3), generator=gen, device=dev)
    say(f"[e2e] QKFResNet-11 width 1.0, {len(fused)} layers, "
        f"{sum(t.numel() for p in fused for s in p.values() for t in s.values())}"
        f" parameters, batch {batch}")
    paths = {policy: run_path(torch, snn_cnn, build_mod, fused, images, cfg,
                              policy)
             for policy in ("fused_dense", "fused_packed")}
    ref_logits, _, ref_aux = snn_cnn.forward(fused, images, cfg,
                                             policy="reference")
    torch.cuda.synchronize()
    d_logits, d_aux = paths["fused_dense"][:2]
    p_logits, p_aux = paths["fused_packed"][:2]
    for key, rate in d_aux["rates"].items():
        r = float(rate)
        say(f"[e2e] rate {key}: fused_dense {r:.4f} fused_packed "
            f"{float(p_aux['rates'][key]):.4f} reference "
            f"{float(ref_aux['rates'][key]):.4f}")
        require(0.0 < r < 1.0, f"rate {key} = {r} is not strictly in (0, 1)")
    compare_spikes(d_aux, ref_aux, "fused_dense vs reference", 1e-3)
    compare_spikes(p_aux, d_aux, "fused_packed vs fused_dense", 0.0)
    check_logits(torch, d_logits, ref_logits, batch,
                 "fused_dense vs reference")
    check_logits(torch, p_logits, ref_logits, batch,
                 "fused_packed vs reference")
    say(f"[e2e] fused_packed logits equal fused_dense's: "
        f"{bool(torch.equal(p_logits, d_logits))}")
    for name, args, _ in paths["fused_packed"][3]:
        if name in ("fused_pe", "spike_matmul"):
            require(args[-1] is True or (args[-1].x and args[-1].out),
                    f"a fused_packed {name} launch took int8 operands")
    say(f"[e2e] spike bytes between kernels: fused_dense "
        f"{d_aux['spike_hbm_bytes']}, fused_packed "
        f"{p_aux['spike_hbm_packed_bytes']} (int8 equivalent "
        f"{p_aux['spike_hbm_dense_bytes']}); vld maps reused "
        f"{d_aux['vld_reused']} / {p_aux['vld_reused']}")
    return cfg, fused, images, paths


def phase_vgg(torch, snn_cnn, build_mod, dev, batch: int) -> None:
    """VGG-11 at full width under fused_packed against reference: the
    packed max-pool (a bitwise OR of words) on the card. Parity only."""
    cfg, fused = build_model(torch, snn_cnn, dev, "vgg11")
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.rand((batch, 32, 32, 3), generator=gen, device=dev)
    build_mod.reset_launches()
    logits, _, aux = snn_cnn.forward(fused, images, cfg,
                                     policy="fused_packed")
    torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    say(f"[vgg] VGG-11 width 1.0, batch {batch}, fused_packed launches "
        f"{launches}")
    require(launches["pack_spikes"] == 1 and launches["unpack_spikes"] == 1
            and launches["fused_pe"] == 7 and launches["spike_matmul"] == 0,
            f"VGG-11 launches {launches}")
    ref_logits, _, ref_aux = snn_cnn.forward(fused, images, cfg,
                                             policy="reference")
    torch.cuda.synchronize()
    for key, rate in aux["rates"].items():
        say(f"[vgg] rate {key}: fused_packed {float(rate):.4f} reference "
            f"{float(ref_aux['rates'][key]):.4f}")
    compare_spikes(aux, ref_aux, "VGG-11 fused_packed vs reference", 1e-3)
    check_logits(torch, logits, ref_logits, batch,
                 "VGG-11 fused_packed vs reference")


# ------------------------------------------------------------------ phase 5
def time_cuda(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def valid_extent(torch, n: int, blocks: int):
    """How many of each 128-wide block's indices lie below ``n``."""
    starts = torch.arange(blocks, dtype=torch.float64) * 128
    return (n - starts).clamp(0, 128)


def spike_bytes(K, t) -> float:
    """Bytes of a binary spike operand at the caller's extent: one per
    spike as int8 (whatever dtype it reached the wrapper in: the forward
    produces every spike map as int8 and widens some only for the call),
    1/8 when packed (4 bytes a word)."""
    if isinstance(t, K.PackedSpikes):
        return math.prod(t.shape) / 8.0
    return float(t.numel())


def bound(torch, K, name: str, args, inputs) -> tuple[float, float, float]:
    """(bytes, operations, block operations) of one launch, from the
    kernel's operands ``args`` and the tensors its caller gave the wrapper
    (``inputs``, before padding and casts).

    Bytes: each input read once and each output written once, at the
    caller's extent (never the 128-padded one); spike maps as
    ``spike_bytes`` counts them. A matmul reads only the x blocks its vld
    map does not skip, and the w rows some row block uses. Operations: what
    the data needs; a spike matmul needs one multiply-add per nonzero
    spike and valid output column (2 * nnz(x) * N). Block operations: the
    dense product over the blocks the kernel does not skip, which is the
    work the kernel's algorithm does (2 * 128 * 128 * Np per active
    block)."""
    if name == "lif_update":
        cur, v_prev, s_prev = inputs
        n = cur.numel()
        # current and v_prev f32, s_prev spikes; spikes int8 and v_next f32
        return 4.0 * n + 4.0 * n + n + n + 4.0 * n, 7.0 * n, 7.0 * n
    if name == "w2ttfs_pool":
        spikes, fc_w, fc_b = inputs
        b, classes = spikes.shape[0], fc_w.shape[1]
        ops = spikes.numel() + 2.0 * b * fc_w.numel()
        return (spikes.numel() + 4.0 * (fc_w.numel() + fc_b.numel()
                                        + b * classes), ops, ops)
    if name == "pack_spikes":
        (x,) = inputs
        n = float(x.numel())
        tiles = args[0].shape[0] * math.prod(
            -(-d // 128) for d in x.shape[-2:])
        # x read; words, vld_cnt and occ written; a compare per position
        return n + n / 8.0 + 8.0 * tiles, n, n
    if name == "unpack_spikes":
        (ps,) = inputs
        n = float(math.prod(ps.shape))
        return n / 8.0 + n, n, n
    xp, wp, vld = args[:3]
    x, w = inputs[:2]
    packed_x = isinstance(x, K.PackedSpikes)
    (m0, k0), n0 = x.shape, w.shape[1]
    np_ = wp.shape[1]
    nnz = int(K.popcount32(xp).sum()) if packed_x else int((xp != 0).sum())
    active = (vld > 0).to(torch.float64).cpu()
    rows = valid_extent(torch, m0, active.shape[0])
    cols = valid_extent(torch, k0, active.shape[1])
    x_bytes = float((active * rows[:, None] * cols[None, :]).sum())
    if packed_x:
        x_bytes /= 8.0
    w_rows = float((cols * (active.sum(dim=0) > 0)).sum())
    nbytes = x_bytes + 4.0 * w_rows * n0 + 4.0 * vld.numel()
    block_ops = 2.0 * float(active.sum()) * 128 * 128 * np_
    if name == "spike_matmul":
        return nbytes + 4.0 * m0 * n0, 2.0 * nnz * n0, block_ops
    bias, residual, q = inputs[2:]
    packing = args[-1]
    tiles_out = -(-m0 // 128) * -(-n0 // 128)
    nbytes += m0 * n0 / (8.0 if packing.out else 1.0) + 4.0 * tiles_out
    if bias is not None:
        nbytes += 4.0 * n0
    if residual is not None:                       # f32 current or spikes
        nbytes += (4.0 * residual.numel()
                   if isinstance(residual, torch.Tensor)
                   and residual.is_floating_point()
                   else spike_bytes(K, residual))
    if q is not None:
        nbytes += spike_bytes(K, q)
    epilogue = 3.0 * m0 * n0
    return nbytes, 2.0 * nnz * n0 + epilogue, block_ops + epilogue


def phase_profile(torch, snn_cnn, cfg, fused, images, policy: str,
                  forward_ms: float, reps: int = 3) -> None:
    """Where the time of one forward of a kernel path goes on the device:
    ``torch.profiler`` self device time by kernel, summed over ``reps``
    forwards, and the device's idle share of the forward's median time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    snn_cnn.forward(fused, images, cfg, policy=policy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            snn_cnn.forward(fused, images, cfg, policy=policy)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:     # kernels only: the aten
            continue                              # ops would count twice
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / reps, ev.count // reps, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        say(f"[profile] the profiler reported no device time: {policy} "
            f"device breakdown not measured")
        return
    say(f"[profile] {policy}: device busy {busy:.3f} ms per forward of "
        f"median {forward_ms:.3f} ms: idle share "
        f"{max(0.0, 1 - busy / forward_ms):.3f}")
    for ms, count, key in rows[:20]:
        say(f"[profile]   {policy} {ms:8.4f} ms  x{count:<4d} {key[:100]}")


def library_call(torch, K, name: str, inputs):
    """One PyTorch call computing the launch's product on the same data,
    or None: torch.matmul of the caller's x (int8 cast to f32, a packed x
    unpacked to its logical f32 map) by w. No single call packs or
    unpacks."""
    if name not in ("fused_pe", "spike_matmul"):
        return None
    x, w = inputs[:2]
    xf = (K.unpack_spikes_ref(x, torch.float32)
          if isinstance(x, K.PackedSpikes) else x.to(torch.float32))
    return lambda: torch.matmul(xf, w)


def phase_timing(torch, K, snn_cnn, cfg, fused, images, paths,
                 parity: Parity, iters: int) -> list[dict]:
    batch = images.shape[0]
    medians = {}
    for policy in ("fused_dense", "fused_packed", "reference"):
        times = []
        for i in range(iters + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snn_cnn.forward(fused, images, cfg, policy=policy)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        med = medians[policy] = statistics.median(times)
        say(f"[timing] forward {policy}: median {med:.3f} ms over {iters} "
            f"(min {min(times):.3f}, max {max(times):.3f}); "
            f"{batch / med * 1e3:.1f} images/s")
    for policy in ("fused_dense", "fused_packed"):
        phase_profile(torch, snn_cnn, cfg, fused, images, policy,
                      medians[policy])

    launch_fn = {"lif_update": K.lif_update_cuda,
                 "fused_pe": K.fused_pe_cuda,
                 "spike_matmul": K.spike_matmul_cuda,
                 "w2ttfs_pool": K.w2ttfs_pool_cuda,
                 "pack_spikes": K.pack_spikes_cuda,
                 "unpack_spikes": K.unpack_spikes_cuda}
    plain_fn = {"lif_update": K.lif_update_ref,
                "fused_pe": K.fused_pe_block_ref,
                "spike_matmul": K.spike_matmul_block_ref,
                "w2ttfs_pool": K.w2ttfs_pool_fc_ref,
                "pack_spikes": lambda x: K.pack_spikes_ref(x, with_occ=True),
                "unpack_spikes": K.unpack_words}
    totals = {row: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": None, "bytes_s": 0.0, "ops_s": 0.0,
                    "block_ms": 0.0}
              for row in ROWS}
    row_of = {(kernel, policy): row
              for row, (kernel, policy, _, _) in ROWS.items()}
    i = 0
    for policy, (_, _, _, captured) in paths.items():
        for name, args, inputs in captured:
            row = row_of.get((name, policy))
            if row is None:     # the same kernel at the same shapes as the
                continue        # other path's launch, which is timed there
            # the main path's own operands: kernel vs plain version again
            CHECKS[name](torch, K, args, parity, f"main-path launch {i}")
            ms = time_cuda(torch, lambda: launch_fn[name](*args), reps=20)
            plain_ms = time_cuda(torch, lambda: plain_fn[name](*args), reps=5)
            nbytes, ops, block_ops = bound(torch, K, name, args, inputs)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
            t_block = block_ops / PEAK_F32_OPS_PER_S * 1e3
            lib = library_call(torch, K, name, inputs)
            lib_ms = None if lib is None else time_cuda(torch, lib, reps=10)
            del lib
            tot = totals[row]
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += max(t_bytes, t_ops)
            tot["bytes_s"] += t_bytes
            tot["ops_s"] += t_ops
            tot["block_ms"] += t_block
            if lib_ms is not None:
                tot["library_ms"] = (tot["library_ms"] or 0.0) + lib_ms
            shape = "x".join(str(d) for d in args[0].shape)
            if name in ("fused_pe", "spike_matmul"):
                shape += f" @ {args[1].shape[0]}x{args[1].shape[1]}"
            say(f"[timing] launch {i} {row} [{shape}]: {ms:.4f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}), its "
                f"unskipped blocks at the f32 peak {t_block:.4f} ms, plain "
                f"{plain_ms:.4f} ms"
                + ("" if lib_ms is None else f", torch.matmul {lib_ms:.4f} ms"))
            i += 1
    torch.cuda.synchronize()

    rows = []
    for row, tot in totals.items():
        kernel, policy, source, replaces = ROWS[row]
        out = {"name": row, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": paths[policy][2][kernel],
               "max_abs_err": parity.max_abs_err.get(row, 0.0),
               "ms": tot["ms"], "plain_ms": tot["plain_ms"],
               "bound_ms": tot["bound_ms"],
               "bound_by": ("bytes" if tot["bytes_s"] >= tot["ops_s"]
                            else "operations"),
               "library_ms": tot["library_ms"]}
        say(f"[timing] {row}: {out['ms']:.4f} ms per {policy} forward in "
            f"{out['launches']} launches; bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']}); unskipped blocks at the f32 peak "
            f"{tot['block_ms']:.4f} ms; plain {out['plain_ms']:.4f} ms; "
            f"library {out['library_ms']}; positions near v_th "
            f"{parity.near_vth.get(row, 0)}")
        rows.append(out)
    return rows


# --------------------------------------------------------------------- main
def kernels_namespace(torch):
    """The launchers, plain versions and helpers the phases call."""
    from repro_torch.core import events
    import repro_torch.kernels.fused_pe as fused_pe
    import repro_torch.kernels.lif_update as lif_update
    import repro_torch.kernels.packed as packed
    import repro_torch.kernels.spike_matmul as spike_matmul
    import repro_torch.kernels.w2ttfs_pool as w2ttfs_pool

    return types.SimpleNamespace(
        fused_pe_cuda=fused_pe.fused_pe_cuda,
        fused_pe_block_ref=fused_pe.fused_pe_block_ref,
        fused_pe_operands=fused_pe.fused_pe_operands,
        spike_matmul_cuda=spike_matmul.spike_matmul_cuda,
        spike_matmul_block_ref=spike_matmul.spike_matmul_block_ref,
        spike_matmul_operands=spike_matmul.spike_matmul_operands,
        lif_update_cuda=lif_update.lif_update_cuda,
        lif_update_ref=lif_update.lif_update_ref,
        w2ttfs_pool_cuda=w2ttfs_pool.w2ttfs_pool_cuda,
        w2ttfs_pool_fc_ref=w2ttfs_pool.w2ttfs_pool_fc_ref,
        pack_spikes_cuda=packed.pack_spikes_cuda,
        unpack_spikes_cuda=packed.unpack_spikes_cuda,
        pack_spikes_ref=packed.pack_spikes_ref,
        unpack_spikes_ref=packed.unpack_spikes_ref,
        unpack_words=events.unpack_words,
        popcount32=events.popcount32,
        PackedSpikes=events.PackedSpikes,
        check_packed_invariants=events.check_packed_invariants,
        block_count_map_2d=events.block_count_map_2d)


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              f"(no {SRC / 'repro_torch'} here)", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run on "
              "the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.models import snn_cnn

    K = kernels_namespace(torch)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi = phase_setup(torch)
    phase_build(_build)
    parity = phase_parity(torch, K, dev)
    say(f"[parity] all kernels agree with their plain versions "
        f"({time.perf_counter() - t_start:.1f} s so far)")
    cfg, fused, images, paths = phase_end_to_end(torch, snn_cnn, _build, dev,
                                                 BATCH)
    phase_vgg(torch, snn_cnn, _build, dev, VGG_BATCH)
    say(f"[e2e] done ({time.perf_counter() - t_start:.1f} s so far)")
    rows = phase_timing(torch, K, snn_cnn, cfg, fused, images, paths,
                        parity, ITERS)
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
