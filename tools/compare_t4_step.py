"""Times the T = 4 folded KD step of two checkouts on one card.

The step is chip_smoke.py's: QKFResNet-11 at width 1.0 and ``timesteps=4``,
batch 256, the ResNet-18 teacher, ``fused_dense+grad``, from chip_smoke's
seeded weights. Each run is a process of its own that builds the kernels
from its checkout's sources and drives the step through that checkout's
own ``chip_smoke`` helpers; the runs go A, B, B, A, so that a drift of the
card over the call shows. Each prints the median of three synchronised
steps (host clock), the profiler's device busy time of a step and its
largest kernels (``chip_smoke.profile_step``).

    python3 tools/compare_t4_step.py PARENT_CHECKOUT CHANGED_CHECKOUT

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

C.phase_setup(torch)
M = C.training_namespace()
dev = torch.device("cuda")
_build.build()
cfg1, variables = C.init_model(torch, M.snn_cnn, dev)
cfg = dataclasses.replace(cfg1, timesteps=4)
tcfg, tvar, batches = C.kd_setup(torch, M, dev, 256)
path = C.TrainPath(torch, M, cfg, variables, tcfg, tvar, "fold",
                   "fused_dense+grad")
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
print(f"[compare] {root}: T = 4 step median {median:.3f} ms", flush=True)
C.profile_step(torch, path, median)
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
