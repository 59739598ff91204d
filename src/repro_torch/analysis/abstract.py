"""Shape-walking helpers of the contract sweep (twin of
``repro.analysis.abstract``).

The reference traces a function over ``ShapeDtypeStruct`` leaves with
``jax.eval_shape``. The port runs it under
``torch._subclasses.fake_tensor.FakeTensorMode`` on fake CPU tensors: every
shape and dtype decision is made, no FLOP is spent and nothing launches (a
fake CPU tensor takes each kernel wrapper's CPU branch; a fake CUDA tensor
would reach the kernel library and its launch). A function that reads its
operands' values on the host (``nonzero``, ``tolist``, ``item``) cannot run
on fake tensors; ``abstract_eval`` then raises an ``AbstractEvalError``
whose ``data_dependent`` is true, and the caller runs it concretely
(``concrete_eval``) on seeded operands of the same shapes.

Operands are described, not built: ``sds(shape, dtype)`` for a tensor and
``spike_aval(m, k, fmt, ...)`` for a spike map in either format. The two
evaluators materialise them, as fake tensors or as seeded values on a
device, and call the function on the result.

The dry run (``launch.dryrun``) walks a whole model the same way:
``module_param_shapes`` runs a model's ``init`` and ``optimizer_shapes`` an
optimizer's on fake CPU tensors of one mode, which the step's trace then
goes on in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import unittest.mock
import warnings
from typing import Any, Callable, NamedTuple

import torch

from ..core.events import DEFAULT_BLOCKS, LANE_BITS

#: the contract sweep's edge-shape corpus, (m, k, n): one block-aligned
#: cell, one sub-block cell (everything inside one tile) and one ragged
#: cell that reaches every pad path (m, k, n all off the 128 grid, k off
#: the 32-bit lane width)
EDGE_SHAPES = (
    (128, 128, 128),
    (8, 64, 32),
    (130, 96, 72),
)

#: head-blocking configurations of the QK write-back ops, (heads,
#: kv_heads): kv_heads < heads reaches the grouped-KV weight expansion;
#: head_dim is n // heads
HEAD_CONFIGS = ((None, None), (2, 2), (4, 2))

#: the density of the seeded spike maps a concrete evaluation builds
SPIKE_DENSITY = 0.3


class AbstractEvalError(RuntimeError):
    """An evaluation failed: names the callee and the operands' shapes, so
    a registry-wide sweep reports which cell broke."""

    def __init__(self, what: str, shapes: Any, cause: Exception):
        self.what, self.shapes, self.cause = what, shapes, cause
        super().__init__(f"abstract eval of {what} failed on {shapes}: "
                         f"{type(cause).__name__}: {cause}")

    @property
    def data_dependent(self) -> bool:
        """True when the callee read an operand's values on the host, which
        fake tensors do not have: run it concretely instead."""
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException, DynamicOutputShapeException)

        return isinstance(self.cause, (DataDependentOutputException,
                                       DynamicOutputShapeException))


class TensorSpec(NamedTuple):
    """A tensor operand by shape and dtype (the port's ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class SpikeSpec:
    """A ``SpikeTensor`` operand: [*lead, m, k] logical spikes in ``fmt``;
    packed ones on the (block_m, block_k) grid with their ``vld_cnt`` map,
    dense ones with it when ``with_vld``."""
    m: int
    k: int
    fmt: str = "dense"
    lead: tuple = ()
    block_m: int = DEFAULT_BLOCKS.m
    block_k: int = DEFAULT_BLOCKS.k
    with_vld: bool = False
    dtype: torch.dtype = torch.int8

    @property
    def shape(self) -> tuple:
        return (*self.lead, self.m, self.k)


def sds(shape: tuple, dtype: torch.dtype = torch.float32) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)


def spike_aval(m: int, k: int, fmt: str = "dense", *, lead: tuple = (),
               block_m: int = DEFAULT_BLOCKS.m,
               block_k: int = DEFAULT_BLOCKS.k, with_vld: bool = False,
               dtype: torch.dtype = torch.int8) -> SpikeSpec:
    """A spike operand, to be built as fake or seeded tensors: packed ones
    carry the padded word grid and ``vld_cnt`` map the packed contract
    pins down."""
    return SpikeSpec(m, k, fmt, tuple(lead), block_m, block_k, with_vld,
                     dtype)


def _ceil_to(x: int, b: int) -> int:
    return -(-x // b) * b


def packed_grid(m: int, k: int, *, block_m: int = DEFAULT_BLOCKS.m,
                block_k: int = DEFAULT_BLOCKS.k) -> tuple:
    """(padded_m, padded_k, word_cols, grid_m, grid_k) of a packed map:
    the shape algebra the metadata check holds outputs to."""
    mp, kp = _ceil_to(m, block_m), _ceil_to(k, block_k)
    return mp, kp, kp // LANE_BITS, mp // block_m, kp // block_k


# ------------------------------------------------------------ building
def _fake_spikes(s: SpikeSpec):
    from ..ops.spike_tensor import SpikeTensor

    if s.fmt == "packed":
        mp, _, words, gm, gk = packed_grid(s.m, s.k, block_m=s.block_m,
                                           block_k=s.block_k)
        grid = (*s.lead, gm, gk)
        return SpikeTensor(torch.empty((*s.lead, mp, words),
                                       dtype=torch.int32),
                           torch.empty(grid, dtype=torch.int32), "packed",
                           s.shape, s.block_m, s.block_k,
                           torch.empty(grid, dtype=torch.int32))
    vld = None
    if s.with_vld:
        _, _, _, gm, gk = packed_grid(s.m, s.k, block_m=s.block_m,
                                      block_k=s.block_k)
        vld = torch.empty((*s.lead, gm, gk), dtype=torch.int32)
    return SpikeTensor(torch.empty(s.shape, dtype=s.dtype), vld, "dense",
                       s.shape, s.block_m, s.block_k)


def _seeded_spikes(s: SpikeSpec, gen: torch.Generator, dev):
    from ..core.events import block_count_map_2d, pack_spikes_ref
    from ..ops.spike_tensor import SpikeTensor

    bits = (torch.rand(s.shape, generator=gen) < SPIKE_DENSITY).to(s.dtype)
    bits = bits.to(dev)
    if s.fmt == "packed":
        lead = math.prod(s.lead)
        parts = [pack_spikes_ref(b, block_m=s.block_m, block_k=s.block_k,
                                 with_occ=True)
                 for b in bits.reshape(lead, s.m, s.k)]
        words = torch.stack([p.words for p in parts]).reshape(
            *s.lead, *parts[0].words.shape)
        vld = torch.stack([p.vld_cnt for p in parts]).reshape(
            *s.lead, *parts[0].vld_cnt.shape)
        occ = None if parts[0].occ is None else torch.stack(
            [p.occ for p in parts]).reshape(*s.lead, *parts[0].occ.shape)
        return SpikeTensor(words, vld, "packed", s.shape, s.block_m,
                           s.block_k, occ)
    vld = None
    if s.with_vld:
        vld = block_count_map_2d(bits, s.block_m, s.block_k)
    return SpikeTensor(bits, vld, "dense", s.shape, s.block_m, s.block_k)


def _build(tree: Any, leaf: Callable, spikes: Callable) -> Any:
    if isinstance(tree, TensorSpec):
        return leaf(tree)
    if isinstance(tree, SpikeSpec):
        return spikes(tree)
    if isinstance(tree, dict):
        return {k: _build(v, leaf, spikes) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_build(v, leaf, spikes) for v in tree)
    return tree


def _shape_str(x: Any) -> list:
    out = []

    def walk(t):
        if isinstance(t, (TensorSpec, SpikeSpec)):
            dt = str(t.dtype).replace("torch.", "")
            fmt = f" {t.fmt}" if isinstance(t, SpikeSpec) else ""
            out.append(f"{dt}[{','.join(map(str, t.shape))}]{fmt}")
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(x)
    return out


def _call(fn: Callable, args: tuple, kwargs: dict, what: str,
          makers: tuple, mode) -> Any:
    name = what or getattr(fn, "__name__", str(fn))
    try:
        with warnings.catch_warnings(), mode:
            # a kernel wrapper's CPU branch asks a fake tensor for its
            # address (alignment), which torch warns about
            warnings.filterwarnings(
                "ignore", message="Accessing the data pointer of FakeTensor")
            return fn(*_build(args, *makers), **_build(kwargs, *makers))
    except Exception as e:                      # noqa: BLE001: re-raised
        raise AbstractEvalError(name, _shape_str((args, kwargs)), e) from e


def fake_mode():
    """A fake-tensor mode for a shape walk. Real tensors an op meets enter
    it as fakes: a constant a model made once and keeps (the RoPE
    frequencies) needs no values there."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def abstract_eval(fn: Callable, *args, what: str = "", mode=None, **kwargs):
    """``fn(*args, **kwargs)`` with every ``TensorSpec`` / ``SpikeSpec``
    built as a fake CPU tensor: the outputs' shapes and dtypes, no FLOP,
    no launch. ``mode``: the fake-tensor mode to run in (a fresh one when
    None), so that a walk can go on with the fakes of an earlier one. A
    failure raises ``AbstractEvalError``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    makers = (lambda t: torch.empty(t.shape, dtype=t.dtype), _fake_spikes)
    return _call(fn, args, kwargs, what, makers,
                 FakeTensorMode() if mode is None else mode)


def concrete_eval(fn: Callable, *args, what: str = "", device=None,
                  seed: int = 0, **kwargs):
    """``fn(*args, **kwargs)`` on seeded operands on ``device`` (the CPU
    when None): spike maps and int8 tensors Bernoulli(``SPIKE_DENSITY``),
    packed maps by the plain pack, floating tensors standard normal, other
    integer ones zero.
    A failure raises ``AbstractEvalError``."""
    dev = torch.device(device if device is not None else "cpu")
    gen = torch.Generator().manual_seed(seed)

    def leaf(t: TensorSpec):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen).to(dev, t.dtype)
        if t.dtype == torch.int8:            # a spike map
            return (torch.rand(t.shape, generator=gen) < SPIKE_DENSITY).to(
                dev, torch.int8)
        return torch.zeros(t.shape, dtype=t.dtype, device=dev)

    makers = (leaf, lambda s: _seeded_spikes(s, gen, dev))
    return _call(fn, args, kwargs, what, makers, contextlib.nullcontext())


# ------------------------------------------------- model-level shape walking
# (the dry run's side of the shared implementation)
def module_param_shapes(init_fn: Callable, *init_args, **init_kwargs):
    """The parameter tree of a model ``init`` as fake CPU tensors (its
    ``torch.Generator`` seeded 0, on the CPU: shapes do not depend on
    either). No tensor is made on a device and no FLOP is spent; the
    leaves' ``fake_mode`` goes on to the optimizer walk and the step."""
    if not init_args:
        init_args = (torch.Generator().manual_seed(0),)
    init_kwargs.setdefault("device", "cpu")
    # a fake tensor has no values, and the truncated normal's rejection
    # sampler reads them: nothing is drawn (every other init is shape-only)
    with unittest.mock.patch.object(torch.nn.init, "trunc_normal_",
                                    lambda t, *a, **k: t):
        return abstract_eval(init_fn, *init_args, what="model.init",
                             mode=fake_mode(), **init_kwargs)


def optimizer_shapes(opt_init: Callable, params_shape):
    """The optimizer-state tree for a fake parameter tree, as fake tensors
    of the parameters' mode."""
    from ..tree import tree_leaves

    return abstract_eval(opt_init, params_shape, what="optimizer.init",
                         mode=tree_leaves(params_shape)[0].fake_mode)


# ---------------------------------------------------------- tile models
@dataclasses.dataclass(frozen=True)
class TileModel:
    """The shared memory one CTA of a kernel family takes at one tiling:
    what the NL-VMEM-BUDGET check prices against
    ``launch.roofline.SMEM_BYTES_PER_BLOCK``."""
    family: str
    block_m: int
    block_n: int
    block_k: int
    packed: bool
    bytes: int


def tile_models(contracts: dict, blocks=DEFAULT_BLOCKS) -> list:
    """Every declared family's shared-memory model at ``blocks``, for each
    format the family takes."""
    out = []
    for fam, c in contracts.items():
        if c.smem_bytes is None:
            continue
        for packed in ((False, True) if "packed" in c.formats else (False,)):
            out.append(TileModel(fam, blocks.m, blocks.n, blocks.k, packed,
                                 int(c.smem_bytes(blocks.m, blocks.n,
                                                  blocks.k, packed))))
    return out
