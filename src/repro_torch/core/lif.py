"""LIF neuron configuration (twin of ``repro.core.lif``).

    v[t] = tau * v[t-1] * (1 - s[t-1]) + I[t]      (hard reset)
    s[t] = H(v[t] - v_th)

With the deployed single timestep (T=1, v[0]=0) this is ``s = H(I - v_th)``.
The inference Heaviside is ``v >= v_th`` everywhere in the port (the
kernels and their plain versions); for finite floats it equals the
reference's ``(v - v_th) >= 0``. ``surrogate``/``alpha`` choose the
pseudo-derivative the training backward puts in place of the Heaviside
(``core.surrogate``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    tau: float = 0.5            # decay (paper §V.A: tau = 0.5)
    v_th: float = 1.0           # firing threshold
    surrogate: str = "atan"
    alpha: float = 2.0
    soft_reset: bool = False    # paper uses hard reset; soft kept for ablation
