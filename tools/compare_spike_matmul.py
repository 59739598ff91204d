"""Times the spike matmul (K3) of two checkouts on one card, per launch.

The shapes are the main paths' K3 launches: the T = 1 forward's three
ResNet shortcuts (int8, and res2's packed one, whose 1x1 tap is padded to
128 channels) and the unfused KD step's convs and QKFormer linears
(``chip_smoke.unfused_step_launches``), on seeded spikes at density 0.2
with every third 128-row block silent (``chip_smoke.rand_spikes``). Each
run is a process of its own that builds the kernels from its checkout's
sources and makes each launch's operands with that checkout's own
``spike_matmul_operands``; it prints, per shape, the launch's device time
with a cold L2 (``chip_smoke.device_time``) and ``torch.matmul``'s on the
same spikes. The runs go A, B, B, A, so that a drift of the card over the
call shows.

    python3 tools/compare_spike_matmul.py PARENT_CHECKOUT CHANGED_CHECKOUT

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
from repro_torch.core.events import pack_spikes_ref
from repro_torch.kernels import _build
from repro_torch.kernels import spike_matmul as K

C.phase_setup(torch)
_build.build()
dev = torch.device("cuda")
SHAPES = [("res2.sc", 65536, 64, 128, False),
          ("res3.sc", 16384, 128, 256, False),
          ("res4.sc", 4096, 256, 512, False),
          ("res2.sc packed", 65536, 128, 128, True),
          ("res1.conv", 262144, 576, 64, False),
          ("res2.conv1", 65536, 576, 128, False),
          ("res2.conv2", 65536, 1152, 128, False),
          ("res3.conv1", 16384, 1152, 256, False),
          ("res3.conv2", 16384, 2304, 256, False),
          ("res4.conv1", 4096, 2304, 512, False),
          ("res4.conv2", 4096, 4608, 512, False),
          ("qkf", 4096, 512, 512, False)]
gen = torch.Generator(device=dev).manual_seed(23)
for label, m, k, n, packed in SHAPES:
    x = C.rand_spikes(torch, gen, m, k, 0.2, dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    args = K.spike_matmul_operands(pack_spikes_ref(x) if packed else x, w)
    ms = C.device_time(torch, lambda: K.spike_matmul_cuda(*args), reps=20)
    xf = x.to(torch.float32)
    lib = C.device_time(torch, lambda: torch.matmul(xf, w), reps=20)
    print(f"[compare] {root}: {label} ({m}, {k}, {n}): K3 {ms:.4f} ms, "
          f"torch.matmul {lib:.4f} ms", flush=True)
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
