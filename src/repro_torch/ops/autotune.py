"""Roofline-driven policy autotuner: the ``"auto"`` kernel mode (twin of
``repro.ops.autotune``).

``ExecutionPolicy(kernels="auto")`` defers the kernel choice to this
module: per (op, shape, format, sparsity bucket) the tuner enumerates the
execution points — the reference, the fused kernels with the dense skip,
the gated walk or the two-level walk, over the admissible block shapes —
prices each with the cost model in ``repro_torch.launch.roofline``, and
caches the cheapest as a ``KernelPlan``. Dispatch then runs that concrete
implementation, so an auto policy's outputs are those of the fixed policy
it selects.

Sparsity is read from the operand's ``vld_cnt``/``occ`` maps. PyTorch runs
eagerly, so every operand is concrete: each plan reads its operand's maps
back to the host (a device-to-host copy and a synchronisation), as the
reference does outside ``jit``; ``read_s`` and ``reads`` total that cost.
The observed hint (``observe``, fed by ``observe_train_sparsity``) is the
fallback for an operand with no maps and no payload. Plans are keyed on the
bucketed sparsity, so one regime reuses one plan.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.events import block_count_map_2d, pad_to_blocks
from ..launch import roofline
from .spike_tensor import SpikeTensor

# sparsity buckets: fraction of ACTIVE blocks quantized to these edges
# (coarse on the dense end, fine on the sparse end where strategy flips)
_BUCKETS = (0.0, 0.05, 0.15, 0.3, 0.5, 0.7, 0.85, 0.95, 1.0)


def bucket(frac: float) -> float:
    """Quantize an active-block fraction to its plan-cache bucket edge."""
    frac = min(max(float(frac), 0.0), 1.0)
    return min(_BUCKETS, key=lambda b: abs(b - frac))


def _host(x: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """The host copy of a map (a device-to-host copy on the card)."""
    return None if x is None else x.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One resolved execution point for one (op, shape, sparsity) cell."""
    kernels: str                  # "reference" | "fused"
    skip: str                     # "dense" | "gated" | "two_level"
    block_m: int
    block_n: int
    block_k: int
    est_time_s: float
    est_hbm_bytes: float
    active_frac: float            # the bucketed sparsity it was priced at
    occ_frac: float


class AutoTuner:
    """Plan cache + online sparsity observer for the "auto" kernel mode.
    ``costs`` is the cost model's constants (the card's by default)."""

    def __init__(self, ewma: float = 0.2,
                 costs: roofline.CostModel = roofline.H100):
        self.costs = costs
        self._plans: dict = {}
        self._ewma = ewma
        # EWMA of (active-block fraction, word-occupancy fraction)
        self._hint: Optional[tuple] = None
        # ops whose fused kernels were demoted to reference at runtime:
        # "auto" stops pricing a mode that cannot run
        self._demoted: set = set()
        # host seconds and count of the metadata reads sparsity_of made
        self.read_s = 0.0
        self.reads = 0
        # when a list, every plan_for / plan_grad_for call appends
        # (m, k, n, fmt, measured active_frac, occ_frac, plan), in order
        self.trace: Optional[list] = None

    # ------------------------------------------------------------ observe
    def observe(self, active_frac: float, occ_frac: float = 1.0) -> None:
        """Feed one measured sparsity sample (a training step's firing
        rate), EWMA-smoothed into the fallback hint."""
        a, o = float(active_frac), float(occ_frac)
        if self._hint is None:
            self._hint = (a, o)
        else:
            pa, po = self._hint
            w = self._ewma
            self._hint = (pa * (1 - w) + a * w, po * (1 - w) + o * w)

    def sparsity_of(self, st: SpikeTensor) -> tuple:
        """(active_frac, occ_frac) of an operand, measured from its maps
        (a dense operand without one: from its payload) on the host in
        float64, as the reference measures concrete maps; else the
        observed hint; else dense (1.0, 1.0), the safe default."""
        t0 = time.perf_counter()
        vld = _host(st.vld_cnt)
        if vld is None and not st.is_packed:
            x2 = pad_to_blocks(st.data.detach().reshape(-1, st.k),
                               st.block_m, st.block_k)
            vld = _host(block_count_map_2d(x2, st.block_m, st.block_k))
        if vld is None:
            return self._hint if self._hint is not None else (1.0, 1.0)
        active = float(np.mean(vld > 0)) if vld.size else 1.0
        occ = _host(st.occ)
        if occ is None:
            occ_frac = 1.0
        else:
            wpb = max(st.block_k // 32, 1)
            cols = sum(((occ.astype(np.uint32) >> c) & 1).mean()
                       for c in range(wpb)) / wpb
            # stripe occupancy WITHIN active blocks
            occ_frac = float(cols / active) if active > 0 else 1.0
        self.read_s += time.perf_counter() - t0
        self.reads += 1
        return active, min(occ_frac, 1.0)

    # --------------------------------------------------------------- plan
    def plan_matmul(self, m: int, k: int, n: int, *, fmt: str = "dense",
                    active_frac: float = 1.0, occ_frac: float = 1.0,
                    block_m: int = 128, block_n: int = 128,
                    block_k: int = 128, allow_reference: bool = True,
                    allow_wide_n: bool = True) -> KernelPlan:
        """Pick kernel + skip strategy + block shape for one accumulation
        sweep (spike_matmul, or fused_pe's matmul core). Cached by
        (shape, fmt, blocks, sparsity bucket)."""
        a, o = bucket(active_frac), bucket(occ_frac)
        key = ("matmul", m, k, n, fmt, block_m, block_n, block_k, a, o,
               allow_reference, allow_wide_n)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._enumerate(m, k, n, fmt=fmt, active_frac=a,
                                   occ_frac=o, block_m=block_m,
                                   block_n=block_n, block_k=block_k,
                                   allow_reference=allow_reference,
                                   allow_wide_n=allow_wide_n)
            self._plans[key] = plan
        return plan

    def plan_for(self, st: SpikeTensor, n: int, *, block_m: int,
                 block_n: int, block_k: int, allow_reference: bool = True,
                 allow_wide_n: bool = True) -> KernelPlan:
        """Plan from a live operand: sparsity from its metadata, block_m /
        block_k pinned to the operand's own grid (its vld/occ maps are
        only valid there). ``allow_wide_n=False`` pins block_n too, as a
        packed residual or q operand's grid ties the output tiling."""
        active, occ = self.sparsity_of(st)
        plan = self.plan_matmul(
            st.m, st.k, n, fmt=st.fmt, active_frac=active, occ_frac=occ,
            block_m=st.block_m, block_n=block_n, block_k=st.block_k,
            allow_reference=allow_reference, allow_wide_n=allow_wide_n)
        self._record(st, n, active, occ, plan)
        return plan

    def plan_grad_matmul(self, m: int, k: int, n: int, *,
                         fmt: str = "dense", active_frac: float = 1.0,
                         occ_frac: float = 1.0, block_m: int = 128,
                         block_n: int = 128, block_k: int = 128,
                         allow_reference: bool = True) -> KernelPlan:
        """Pick the backward execution point of one accumulation sweep:
        dx plus dw per skip strategy against the autodiff backward, priced
        with ``spike_matmul_grad_traffic``. The plan's ``skip`` gates the
        dw sweep (and the forward kernel of the same layer). Cached by
        ("matmul_grad", shape, fmt, blocks, sparsity bucket)."""
        a, o = bucket(active_frac), bucket(occ_frac)
        key = ("matmul_grad", m, k, n, fmt, block_m, block_n, block_k,
               a, o, allow_reference)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        packed = fmt == "packed"
        candidates = []

        def price(kernels, skip):
            t = roofline.spike_matmul_grad_traffic(
                m, k, n, block_m=block_m, block_n=block_n,
                block_k=block_k, active_frac=a, occ_frac=o,
                packed=packed, skip=skip, kernels=kernels, costs=self.costs)
            candidates.append(KernelPlan(
                kernels, skip, block_m, block_n, block_k,
                est_time_s=roofline.kernel_time_s(t, self.costs),
                est_hbm_bytes=t["hbm_bytes"],
                active_frac=a, occ_frac=o))

        for skip in ("dense", "gated", "two_level"):
            price("fused", skip)
        if allow_reference:
            price("reference", "dense")
        plan = min(candidates, key=lambda p: p.est_time_s)
        self._plans[key] = plan
        return plan

    def plan_grad_for(self, st: SpikeTensor, n: int) -> KernelPlan:
        """Backward plan from a live forward operand: sparsity from its
        payload, blocks pinned to the operand's own grid."""
        active, occ = self.sparsity_of(st)
        plan = self.plan_grad_matmul(
            st.m, st.k, n, fmt=st.fmt, active_frac=active, occ_frac=occ,
            block_m=st.block_m, block_k=st.block_k)
        self._record(st, n, active, occ, plan)
        return plan

    def _record(self, st: SpikeTensor, n: int, active: float, occ: float,
                plan: KernelPlan) -> None:
        if self.trace is not None:
            self.trace.append((st.m, st.k, n, st.fmt, active, occ, plan))

    def _enumerate(self, m, k, n, *, fmt, active_frac, occ_frac,
                   block_m, block_n, block_k, allow_reference,
                   allow_wide_n=True) -> KernelPlan:
        packed = fmt == "packed"
        candidates = []

        def price(kernels, skip, bm, bn, bk):
            t = roofline.spike_matmul_traffic(
                m, k, n, block_m=bm, block_n=bn, block_k=bk,
                active_frac=active_frac, occ_frac=occ_frac,
                packed=packed, skip=skip, kernels=kernels, costs=self.costs)
            candidates.append(KernelPlan(
                kernels, skip, bm, bn, bk,
                est_time_s=roofline.kernel_time_s(t, self.costs),
                est_hbm_bytes=t["hbm_bytes"],
                active_frac=active_frac, occ_frac=occ_frac))

        # block_m/block_k stay on the operand's metadata grid; block_n is
        # free — the requested tile and a double-wide one when n allows it
        bn_cands = {block_n}
        if allow_wide_n and n % (2 * block_n) == 0:
            bn_cands.add(2 * block_n)
        for bn in sorted(bn_cands):
            for skip in ("dense", "gated", "two_level"):
                price("fused", skip, block_m, bn, block_k)
        if allow_reference:
            price("reference", "dense", block_m, block_n, block_k)
        return min(candidates, key=lambda p: p.est_time_s)

    # ----------------------------------------------------------- demotion
    def demote(self, op: str) -> None:
        """Exclude ``op``'s fused kernels from future plans (a demotion in
        ``ops.fallback`` calls this)."""
        if op not in self._demoted:
            self._demoted.add(op)
            self._plans.clear()

    def is_demoted(self, op: str) -> bool:
        return op in self._demoted

    def clear_demotions(self) -> None:
        if self._demoted:
            self._demoted.clear()
            self._plans.clear()

    # ---------------------------------------------------------- reporting
    def snapshot(self) -> dict:
        """Cache + hint state (the serving stats export)."""
        return {
            "observed_active_frac": None if self._hint is None
            else self._hint[0],
            "observed_occ_frac": None if self._hint is None
            else self._hint[1],
            "demoted_ops": sorted(self._demoted),
            "plans": {
                "|".join(map(str, k)): {
                    "kernels": p.kernels, "skip": p.skip,
                    "blocks": [p.block_m, p.block_n, p.block_k],
                    "est_time_us": p.est_time_s * 1e6,
                    "est_hbm_bytes": p.est_hbm_bytes,
                }
                for k, p in self._plans.items()
            },
        }

    def reset(self) -> None:
        self._plans.clear()
        self._hint = None
        self._demoted.clear()
        self.read_s = 0.0
        self.reads = 0


_TUNER: Optional[AutoTuner] = None


def get_tuner() -> AutoTuner:
    """The process-global tuner the "auto" policies share."""
    global _TUNER
    if _TUNER is None:
        _TUNER = AutoTuner()
    return _TUNER
