"""Engine 1: the kernel-contract sweep (twin of
``repro.analysis.contracts``).

Walks the whole ``(op, mode)`` registry of ``repro_torch.ops``: all seven
kernel families x reference / fused x dense / packed x byte-skip
strategies x +-grad x head configurations, over the edge-shape corpus
(``repro_torch.analysis.abstract.EDGE_SHAPES``), and checks:

  * NL-DISPATCH-TOTALITY: every advertised point resolves, and the sweep
    reaches every registered pair;
  * NL-SILENT-DOWNGRADE: the registry modes a cell resolves are the
    requested policy's kernel axis (``ops.record_dispatches``);
  * NL-FORMAT-PRESERVE: spike outputs leave in the policy's format with
    the contracted dtypes;
  * NL-META-PROP: every packed output carries a grid-true ``vld_cnt``;
  * NL-GRAD-COVERAGE: every op of a grad-declaring family registers both
    ``+grad`` modes;
  * NL-BLOCK-CONTRACT: the packed block-shape guard rejects a mismatched
    tiling;
  * NL-VMEM-BUDGET: each family's shared-memory model fits one H100
    block (``launch.roofline.SMEM_BYTES_PER_BLOCK``).

A cell runs on fake CPU tensors (``abstract_eval``: no FLOP, no launch).
A cell whose function reads operand values on the host (the plain
versions of the gated routes compact their block lists with ``nonzero``
and ``tolist``) cannot, and runs concretely on seeded CPU operands of the
same shapes instead (``concrete_eval``, milliseconds at the corpus's
sizes); the report counts the two kinds apart. While a cell runs, the
fused modes' degradation guard (``ops.fallback``) is disarmed, so that a
failing fused implementation is reported and never demoted: the sweep
leaves ``fallback.demotions()`` as it found it.

``device_check`` runs the fused cells again on real tensors on a card and
holds each output's signature (shapes, dtypes, formats, ``vld_cnt``
grids) to the sweep's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import torch

from ..core.events import DEFAULT_BLOCKS
from ..core.lif import LIFConfig
from ..kernels.contract import KernelContract, kernel_contracts
from .abstract import (EDGE_SHAPES, HEAD_CONFIGS, AbstractEvalError,
                       abstract_eval, concrete_eval, packed_grid, sds,
                       spike_aval)
from .findings import Finding

GRAD_SUFFIX = "+grad"

#: the policy points the sweep drives (preset name -> (kernels, format)).
#: "auto" is left out by design: it prices each call and resolves to one
#: of these points (tests/test_torch_sparsity.py holds it to the point it
#: chose).
POLICY_POINTS = {
    "reference": ("reference", "dense"),
    "reference_packed": ("reference", "packed"),
    "fused_dense": ("fused", "dense"),
    "fused_packed": ("fused", "packed"),
}


@dataclasses.dataclass
class Cell:
    """One sweep point: an op under one policy on one corpus shape."""
    op: str
    mode: str                 # the registry mode the policy requests
    kernels: str              # the policy's kernel axis
    fmt: str
    label: str
    fn: Callable
    args: tuple
    kwargs: dict
    check: Optional[Callable] = None   # out -> (format, meta) violations

    def evaluate(self, concrete: bool = False, device=None) -> Any:
        run = concrete_eval if concrete else abstract_eval
        extra = {"device": device} if concrete else {}
        return run(self.fn, *self.args, what=self.label, **extra,
                   **self.kwargs)


@dataclasses.dataclass
class ContractReport:
    findings: list
    coverage: set             # (op, mode) pairs the sweep dispatched
    registered: set           # (op, mode) pairs in the registry
    cells: int
    duration_s: float
    concrete: int = 0         # cells run on seeded operands, not fake ones
    signatures: dict = dataclasses.field(default_factory=dict)

    @property
    def uncovered(self) -> set:
        return self.registered - self.coverage

    @property
    def abstract(self) -> int:
        return self.cells - self.concrete


def _pol(name: str, grad: bool):
    from ..ops.policy import ExecutionPolicy

    kernels, fmt = POLICY_POINTS[name]
    return ExecutionPolicy(kernels, fmt, differentiable=grad)


def signature(out: Any) -> Any:
    """What a cell's output promises, as plain data: per tensor its shape
    and dtype, per SpikeTensor also its format, logical shape, blocks and
    the shape of its ``vld_cnt``."""
    from ..ops.spike_tensor import SpikeTensor

    if isinstance(out, torch.Tensor):
        return ("tensor", tuple(out.shape), str(out.dtype))
    if isinstance(out, SpikeTensor):
        vld = None if out.vld_cnt is None else tuple(out.vld_cnt.shape)
        return ("spikes", out.fmt, tuple(out.shape), out.block_m,
                out.block_k, signature(out.data), vld)
    if isinstance(out, (list, tuple)):
        return tuple(signature(o) for o in out)
    return repr(out)


def _vld_ok(vld, lead: tuple, m: int, n: int, bm: int, bk: int) -> bool:
    _, _, _, gm, gn = packed_grid(m, n, block_m=bm, block_k=bk)
    return vld is not None and tuple(vld.shape) == (*lead, gm, gn)


def _check_spike_out(st, pol, m: int, n: int, lead: tuple = ()) -> tuple:
    """Format and dtype (first list) and metadata (second) violations of
    one emitted SpikeTensor."""
    fmt_bad, meta_bad = [], []
    if pol.differentiable:
        # differentiable outputs are dense f32 for autograd
        if st.is_packed or st.data.dtype != torch.float32:
            fmt_bad.append(f"+grad output must be dense f32, got "
                           f"{st.fmt}/{st.data.dtype}")
        return fmt_bad, meta_bad
    if st.fmt != pol.format:
        fmt_bad.append(f"policy format {pol.format!r} but output left "
                       f"{st.fmt!r}")
        return fmt_bad, meta_bad
    if st.is_packed:
        if st.data.dtype != torch.int32:
            fmt_bad.append(f"packed words must be int32, got "
                           f"{st.data.dtype}")
        mp, _, words, _, _ = packed_grid(m, n, block_m=st.block_m,
                                         block_k=st.block_k)
        if tuple(st.data.shape) != (*lead, mp, words):
            meta_bad.append(f"packed words shape {tuple(st.data.shape)} != "
                            f"padded grid {(*lead, mp, words)}")
        if not _vld_ok(st.vld_cnt, lead, m, n, st.block_m, st.block_k):
            meta_bad.append(
                f"packed output must carry a vld_cnt map on its "
                f"(block_m={st.block_m}, block_k={st.block_k}) grid; got "
                f"{None if st.vld_cnt is None else tuple(st.vld_cnt.shape)}")
    elif st.vld_cnt is not None and not _vld_ok(st.vld_cnt, lead, m, n,
                                               st.block_m, st.block_k):
        meta_bad.append(f"dense output's vld_cnt grid "
                        f"{tuple(st.vld_cnt.shape)} inconsistent with "
                        f"[{m}, {n}] on its declared blocks")
    return fmt_bad, meta_bad


def _tensor_check(what: str, shape: tuple, dtype=None) -> Callable:
    def check(out):
        ok = tuple(out.shape) == shape and (dtype is None
                                            or out.dtype == dtype)
        return ([] if ok else [f"{what} must emit "
                               f"{dtype or ''}{list(shape)}, got "
                               f"{out.dtype}{list(out.shape)}"]), []
    return check


# -------------------------------------------------------------- cell makers
def _skips_for(pol, contract: KernelContract) -> tuple:
    if pol.kernels != "fused" or pol.differentiable:
        return ("dense",)
    return contract.skips


def _matmul_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    shapes = EDGE_SHAPES if not grad else EDGE_SHAPES[::2]
    for (m, k, n) in shapes:
        for skip in _skips_for(pol, contract):
            yield Cell(
                "matmul", pol.mode, pol.kernels, pol.format,
                f"matmul[{m}x{k}x{n}] skip={skip} {pol.name}", ops.matmul,
                (spike_aval(m, k, pol.format), sds((k, n))),
                dict(policy=pol, skip=skip),
                _tensor_check("matmul", (m, n), torch.float32))


def _lif_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    m, _, n = EDGE_SHAPES[-1]

    def check(out, m=m, n=n):
        ok = (tuple(out[0].shape) == (m, n) and tuple(out[1].shape) == (m, n)
              and out[1].dtype == torch.float32)
        return ([] if ok else ["lif must return (spikes, v_next f32) at "
                               "the input shape"]), []

    yield Cell("lif", pol.mode, pol.kernels, "dense",
               f"lif[{m}x{n}] {pol.name}", ops.lif,
               (sds((m, n)), sds((m, n)), sds((m, n))), dict(policy=pol),
               check)


def _fused_pe_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    shapes = EDGE_SHAPES if not grad else EDGE_SHAPES[::2]
    for (m, k, n) in shapes:
        for heads, _ in HEAD_CONFIGS:
            if heads is not None and n % heads:
                continue
            hcfg = None if heads is None else (heads, n // heads)
            for skip in _skips_for(pol, contract):
                if skip != "dense" and hcfg is not None:
                    continue          # keep the sweep quadratic, not cubic
                res = (spike_aval(m, n, pol.format, block_k=DEFAULT_BLOCKS.n)
                       if pol.format == "packed" else sds((m, n)))
                yield Cell(
                    "fused_pe", pol.mode, pol.kernels, pol.format,
                    f"fused_pe[{m}x{k}x{n}] heads={hcfg} skip={skip} "
                    f"{pol.name}", ops.fused_pe,
                    (spike_aval(m, k, pol.format), sds((k, n))),
                    dict(bias=sds((n,)), residual=res,
                         q=spike_aval(m, n, pol.format), lif_cfg=LIFConfig(),
                         policy=pol, skip=skip, heads=hcfg),
                    lambda out, m=m, n=n: _check_spike_out(out.spikes, pol,
                                                           m, n))


def _fused_pe_layer_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    m, k, n = EDGE_SHAPES[-1]
    for t in (1, 2):
        for heads, _ in ((None, None), (2, 2)):
            if heads is not None and n % heads:
                continue
            hcfg = None if heads is None else (heads, n // heads)
            yield Cell(
                "fused_pe_layer", pol.mode, pol.kernels, pol.format,
                f"fused_pe_layer[T={t},{m}x{k}x{n}] heads={hcfg} {pol.name}",
                ops.fused_pe_layer,
                (spike_aval(m, k, pol.format, lead=(t,)), sds((k, n))),
                dict(q=spike_aval(m, n, pol.format, lead=(t,)),
                     lif_cfg=LIFConfig(), policy=pol, heads=hcfg),
                lambda out, m=m, n=n, t=t: _check_spike_out(
                    out.spikes, pol, m, n, lead=(t,)))


def _dense_lif_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    m, k, n = EDGE_SHAPES[-1]
    for heads, kv in HEAD_CONFIGS:
        if heads is not None and n % heads:
            continue
        hcfg = None if heads is None else (heads, n // heads)
        wcols = n if kv in (None, heads) else kv * (n // heads)
        yield Cell(
            "dense_lif", pol.mode, pol.kernels, pol.format,
            f"dense_lif[{m}x{k}x{n}] heads={hcfg} kv={kv} {pol.name}",
            ops.dense_lif,
            ({"w": sds((k, wcols)), "b": sds((wcols,))}, sds((m, k)),
             LIFConfig()),
            dict(q=spike_aval(m, n, pol.format), heads=hcfg, kv_heads=kv,
                 policy=pol),
            lambda out, m=m, n=n: _check_spike_out(out, pol, m, n))


def _qk_mask_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    for (m, k, _) in EDGE_SHAPES[1:]:
        yield Cell(
            "qk_mask", pol.mode if grad else pol.kernels, pol.kernels,
            pol.format, f"qk_mask[{m}x{k}] {pol.name}", ops.qk_mask,
            (spike_aval(m, k, pol.format), spike_aval(m, k, pol.format)),
            dict(policy=pol),
            lambda out, m=m, k=k: _check_spike_out(out, pol, m, k))


def _pack_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    if pol.format == "packed":
        return                # pack / unpack dispatch on kernels only: the
                              # dense presets cover both modes
    m, k, _ = EDGE_SHAPES[-1]
    yield Cell(
        "pack", pol.kernels, pol.kernels, "packed",
        f"pack[{m}x{k}] {pol.kernels}", ops.pack,
        (spike_aval(m, k, "dense"),),
        dict(policy=dataclasses.replace(pol, format="packed")),
        lambda out, m=m, k=k: _check_spike_out(
            out, _pol("fused_packed", False), m, k))
    yield Cell(
        "unpack", pol.kernels, pol.kernels, "dense",
        f"unpack[{m}x{k}] {pol.kernels}", ops.unpack,
        (spike_aval(m, k, "packed"),), dict(policy=pol),
        _tensor_check("unpack", (m, k), torch.int8))


def _spatial_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    b, h, w, c = 2, 8, 8, 24          # a ragged channel count (pad lanes)
    spatial = (b, h, w, c)
    st = spike_aval(b * h * w, c, pol.format, lead=(1,))

    def check(out):
        return _check_spike_out(out[0], pol, *out[0].shape[-2:],
                                lead=tuple(out[0].shape[:-2]))

    yield Cell("im2col", pol.mode, pol.kernels, pol.format,
               f"im2col{spatial} {pol.name}", ops.im2col,
               (st, spatial, 3, 3, 1), dict(t=1, policy=pol), check)
    yield Cell("pool", pol.mode, pol.kernels, pol.format,
               f"pool{spatial} {pol.name}", ops.pool, (st, spatial),
               dict(t=1, window=2, policy=pol), check)


def _attention_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    for (b, s, h, d) in ((1, 16, 2, 8), (2, 24, 4, 16)):
        yield Cell(
            "attention", pol.kernels, pol.kernels, "dense",
            f"attention[b{b} s{s} h{h} d{d}] {pol.kernels}", ops.attention,
            (sds((b, s, h, d)), sds((b, s, h, d)), sds((b, s, h, d))),
            dict(q_block=s, kv_block=s, policy=pol),
            _tensor_check("attention", (b, s, h, d)))


def _w2ttfs_cells(contract, pol, grad: bool) -> Iterator[Cell]:
    from .. import ops

    b, h, w, c, classes, window = 4, 8, 8, 16, 10, 2
    fc_w = sds(((h // window) * (w // window) * c, classes))
    yield Cell(
        "w2ttfs_head", pol.mode, pol.kernels, "dense",
        f"w2ttfs_head[{b}x{h}x{w}x{c}] {pol.name}", ops.w2ttfs_head,
        (sds((b, h, w, c), torch.int8), fc_w, sds((classes,))),
        dict(window=window, policy=pol),
        _tensor_check("w2ttfs_head", (b, classes)))


_CELL_MAKERS = {
    "matmul": _matmul_cells,
    "lif": _lif_cells,
    "fused_pe": _fused_pe_cells,
    "fused_pe_layer": _fused_pe_layer_cells,
    "dense_lif": _dense_lif_cells,
    "qk_mask": _qk_mask_cells,
    "pack": _pack_cells,               # also drives "unpack"
    "im2col": _spatial_cells,          # also drives "pool"
    "attention": _attention_cells,
    "w2ttfs_head": _w2ttfs_cells,
}


def iter_cells(contracts: Optional[dict] = None,
               only_ops: Optional[set] = None) -> Iterator[Cell]:
    """Every sweep cell of the declared families (of ``only_ops``)."""
    contracts = kernel_contracts() if contracts is None else contracts
    for contract in contracts.values():
        for op in contract.ops:
            make = _CELL_MAKERS.get(op)
            if make is None:
                continue              # drawn by another op's cell maker
            if only_ops is not None and op not in only_ops:
                continue
            for preset, (_, fmt) in POLICY_POINTS.items():
                if fmt == "packed" and "packed" not in contract.formats:
                    continue
                grads = ((False, True)
                         if op in contract.gradient_ops() else (False,))
                for grad in grads:
                    yield from make(contract, _pol(preset, grad), grad)


@contextlib.contextmanager
def guard_disarmed():
    """Inside, a fused implementation's failure propagates instead of
    demoting its (op, mode) to the reference (``ops.fallback``)."""
    from ..ops import fallback

    saved = fallback.FALLBACK_EXCEPTIONS
    fallback.FALLBACK_EXCEPTIONS = ()
    try:
        yield
    finally:
        fallback.FALLBACK_EXCEPTIONS = saved


def _downgrades(cell: Cell, log: list) -> list:
    bad = []
    for rop, rmode in log:
        base = rmode[:-len(GRAD_SUFFIX)] if rmode.endswith(GRAD_SUFFIX) \
            else rmode
        if base != cell.kernels:
            bad.append(Finding(
                "NL-SILENT-DOWNGRADE", "<registry>", 0,
                f"{cell.label}: policy requested kernels={cell.kernels!r} "
                f"but the dispatch resolved ({rop!r}, {rmode!r}): a silent "
                f"{cell.kernels}->{base} downgrade"))
    return bad


def _checked(cell: Cell, out: Any) -> list:
    if cell.check is None:
        return []
    fmt_bad, meta_bad = cell.check(out)
    return ([Finding("NL-FORMAT-PRESERVE", "<registry>", 0,
                     f"{cell.label}: {msg}") for msg in fmt_bad]
            + [Finding("NL-META-PROP", "<registry>", 0,
                       f"{cell.label}: {msg}") for msg in meta_bad])


# --------------------------------------------------------- one-off checks
def _grad_coverage(contracts: dict, impls: dict) -> list:
    bad = []
    for fam, contract in contracts.items():
        for op in contract.gradient_ops():
            for mode in ("reference+grad", "fused+grad"):
                if (op, mode) not in impls:
                    bad.append(Finding(
                        "NL-GRAD-COVERAGE", "<registry>", 0,
                        f"family {fam!r} declares op {op!r} differentiable "
                        f"but ({op!r}, {mode!r}) is not registered: the "
                        f"+grad path has no backward"))
    return bad


def _smem_budget(contracts: dict) -> list:
    from ..launch.roofline import SMEM_BYTES_PER_BLOCK
    from .abstract import tile_models

    return [Finding(
        "NL-VMEM-BUDGET", "<registry>", 0,
        f"{t.family} at blocks ({t.block_m},{t.block_n},{t.block_k}) "
        f"packed={t.packed} models {t.bytes} bytes of shared memory per "
        f"block > the H100's {SMEM_BYTES_PER_BLOCK}")
        for t in tile_models(contracts) if t.bytes > SMEM_BYTES_PER_BLOCK]


def _block_contract_guard() -> list:
    """The packed block-shape contract must be enforced: a tensor packed on
    one grid dispatched into a kernel tiling another must raise, not route
    on a vld map of another grid."""
    from .. import ops

    try:
        abstract_eval(ops.matmul,
                      spike_aval(128, 128, "packed", block_m=64,
                                 block_k=128),
                      sds((128, 72)), policy="fused_packed",
                      what="block-contract probe")
    except AbstractEvalError as e:
        if isinstance(e.cause, ValueError):
            return []
        return [Finding(
            "NL-BLOCK-CONTRACT", "<registry>", 0,
            f"a block-shape mismatch must raise ValueError naming both "
            f"tilings, got {type(e.cause).__name__}: {e.cause}")]
    return [Finding(
        "NL-BLOCK-CONTRACT", "<registry>", 0,
        "a tensor packed on block_m=64 dispatched into the default "
        "128-tiling did not raise: check_block_contract is missing or "
        "bypassed")]


# ----------------------------------------------------------------- the sweep
def verify_contracts(only_ops: Optional[set] = None) -> ContractReport:
    """Run the registry-wide sweep. ``only_ops`` restricts it to some
    entry points (test hooks); the default sweeps every registered pair
    and reports any it could not reach."""
    from ..ops.registry import implementations, record_dispatches

    t0 = time.time()
    contracts = kernel_contracts()
    impls = implementations()
    registered = set(impls)
    findings: list = []
    coverage: set = set()
    signatures: dict = {}
    cells = concrete = 0

    with guard_disarmed():
        for cell in iter_cells(contracts, only_ops):
            cells += 1
            with record_dispatches() as log:
                try:
                    try:
                        out = cell.evaluate()
                    except AbstractEvalError as e:
                        if not e.data_dependent:
                            raise
                        del log[:]
                        concrete += 1
                        out = cell.evaluate(concrete=True)
                except AbstractEvalError as e:
                    # a ValueError is the block / shape guard firing on a
                    # shape the surface advertises; anything else means the
                    # advertised point does not run
                    rule = ("NL-BLOCK-CONTRACT"
                            if isinstance(e.cause, ValueError)
                            else "NL-DISPATCH-TOTALITY")
                    findings.append(Finding(rule, "<registry>", 0,
                                            f"{cell.label}: {e}"))
                    coverage.update(log)
                    continue
            coverage.update(log)
            findings += _downgrades(cell, log)
            findings += _checked(cell, out)
            signatures[cell.label] = signature(out)

    if only_ops is None:
        findings += _grad_coverage(contracts, impls)
        findings += _smem_budget(contracts)
        findings += _block_contract_guard()
        for op, mode in sorted(registered - coverage):
            findings.append(Finding(
                "NL-DISPATCH-TOTALITY", "<registry>", 0,
                f"registered implementation ({op!r}, {mode!r}) was not "
                f"reachable by the sweep: add a cell maker so that it is"))

    return ContractReport(findings, coverage, registered, cells,
                          time.time() - t0, concrete, signatures)


def device_check(device, report: Optional[ContractReport] = None) -> tuple:
    """Every fused cell of the sweep run on seeded tensors on ``device``
    (a card), each output's ``signature`` held to ``report``'s (a CPU
    sweep's; run here when None) and its format and metadata checked.
    Returns (cells run, mismatches as strings)."""
    from ..ops.registry import record_dispatches

    report = verify_contracts() if report is None else report
    bad, n = [], 0
    for cell in iter_cells():
        if cell.kernels != "fused":
            continue
        n += 1
        with record_dispatches() as log:
            try:
                out = cell.evaluate(concrete=True, device=device)
            except AbstractEvalError as e:
                bad.append(f"{cell.label}: {e}")
                continue
        got, want = signature(out), report.signatures.get(cell.label)
        if got != want:
            bad.append(f"{cell.label}: {got} on {device}, {want} in the "
                       f"sweep")
        bad += [str(f) for f in _downgrades(cell, log) + _checked(cell, out)]
    return n, bad
