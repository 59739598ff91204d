"""Times K2's float-x launches (the fused PE of a dense f32 or bf16 x) of
two checkouts on one card, per launch.

The shapes are the LM training step's: qwen3-1.7b's wq and its grouped wk
expanded to the 16 query heads with the head-blocked mask of wq's spikes,
both [rows, 2048] @ [2048, 2048] with the emitted current, at the step's
8 x 129 = 1032 rows and at 1024; and wq with a bf16 x. Each run is a
process of its own that builds the kernels from its checkout's sources
and makes each launch's operands with that checkout's own
``fused_pe_operands`` (seeded inputs); it prints, per shape, the launch's
device time with a cold L2 (``chip_smoke.device_time``) and
``torch.matmul``'s on the same x and w. The runs go A, B, B, A, so that a
drift of the card over the call shows.

    python3 tools/compare_float_tile.py PARENT_CHECKOUT CHANGED_CHECKOUT

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
from repro_torch.kernels import fused_pe as K

C.phase_setup(torch)
_build.build()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(29)
k = n = 2048
wq = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
wk = (torch.randn((k, 8, 1, 128), generator=gen, device=dev)
      / k ** 0.5).expand(k, 8, 2, 128).reshape(k, n).contiguous()
for m in (1032, 1024):
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        q = (x.to(torch.float32) @ wq >= 1.0).to(torch.int8)
        for name, w, kw in (("wq", wq, {}),
                            ("wk", wk, dict(q=q, heads=(16, 128),
                                            qk_threshold=20.0))):
            if dtype == torch.bfloat16 and (name == "wk" or m != 1032):
                continue
            args = K.fused_pe_operands(x, w, emit_current=True, **kw)
            ms = C.device_time(torch, lambda: K.fused_pe_cuda(*args), reps=20)
            xf = x.to(torch.float32)
            lib = C.device_time(torch, lambda: torch.matmul(xf, w), reps=20)
            print(f"[compare] {root}: {name} {str(dtype)[6:]} ({m}, {k}, {n}):"
                  f" K2 {ms:.4f} ms, torch.matmul {lib:.4f} ms", flush=True)
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
