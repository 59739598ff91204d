"""Static analysis of the op record of one step (twin of
``repro.launch.hlo_analysis``).

The reference parses the optimized HLO text of a compiled step. PyTorch
runs eagerly and compiles no module, so the port records what one step
dispatches instead: ``OpRecorder`` is a ``TorchDispatchMode`` that lists
every aten op with its operands' and results' dtypes and shapes, and every
c10d collective with its group's size. It works alike on fake tensors (the
dry run, ``launch.dryrun``) and on real ones on the card. ``analyze``
applies the reference's cost rules to such a record:

  * flops             -- 2*M*N*K summed over every matmul (``mm``, ``bmm``,
                         ``addmm``, ``baddbmm``, what ``matmul``, ``linear``
                         and ``einsum`` lower to), plus the convolutions
  * bytes             -- HBM-traffic proxy: operands plus results of every
                         op; views, reshapes and transposes cost nothing, a
                         slicing op reads only its slice, an in-place update
                         moves only the update, an overwrite reads no target
  * collectives       -- per kind: count, bytes and wire bytes under the
                         reference's ring models

A record is eager, so every op that ran is in it once per run: there are
no loop bodies to multiply out. Each number is this rank's, per step.

Fused ops are one node each. While an ``OpRecorder`` is active,
``ops.registry.lookup`` hands every mode containing ``"fused"`` out
through the recorder: the call becomes one record entry whose bytes are
its operands and results, and whose flops are those of its plain version
(the ``reference`` twin of its mode, run once more on fake tensors of the
same shapes). None of the plain version's intermediates count, toward
bytes or toward live memory: on the card the kernel makes none, where on
fake CPU tensors the wrapper runs its plain version. The backward of a
fused ``+grad`` op is recorded op by op; on the card its kernels' launches
are no aten op, so their flops are not in the record.

Memory (the twins of XLA's ``memory_analysis``): every storage counts from
the op that made it until it dies (a weak reference on the storage, which
lives as long as its last tensor, an autograd-saved one too).
``argument_size_in_bytes`` are the arguments' storages,
``output_size_in_bytes`` the results', ``alias_size_in_bytes`` the
arguments the caller donates (the state it replaces by the step's result,
or a cache the step writes in place) and ``temp_size_in_bytes`` the peak
of the step's own live bytes: the peak live bytes less the arguments.
"""
from __future__ import annotations

import contextlib
import math
import threading
import warnings
import weakref
from collections import defaultdict
from typing import Any, Callable, Iterable, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}
# allocation only: no traffic
_ZERO_COST = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "lift_fresh", "detach", "alias"}
# ops that READ only a slice: 2 * result bytes
_SLICING_OPS = {"index_select", "gather", "index", "embedding", "take",
                "narrow_copy"}
# in-place updates: 2 * the update's bytes (the last tensor operand)
_INPLACE_OPS = {"index_put_", "index_put", "scatter_", "scatter",
                "scatter_add_", "scatter_add", "index_add_", "index_add",
                "index_copy_", "index_copy", "slice_scatter",
                "select_scatter", "masked_scatter_"}
# ops that overwrite their target without reading it
_OVERWRITE_OPS = {"copy_", "fill_", "zero_", "normal_", "uniform_",
                  "bernoulli_", "random_", "exponential_"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot"}
_CONVS = {"convolution", "_convolution", "convolution_backward"}


# ------------------------------------------------------------ descriptors
def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def describe(t: torch.Tensor) -> list:
    """[dtype, shape, elements addressed]: a broadcast (stride 0)
    dimension addresses one element."""
    elems = 0 if t.numel() == 0 else math.prod(
        s for s, st in zip(t.shape, t.stride()) if st != 0)
    return [dtype_name(t.dtype), list(t.shape), int(elems)]


def _itemsize(name: str) -> int:
    """Bytes per element of the torch dtype named ``name`` (0 when
    ``name`` names none)."""
    dtype = getattr(torch, name, None)
    return dtype.itemsize if isinstance(dtype, torch.dtype) else 0


def shape_dims(descs: Iterable) -> list[tuple[str, tuple[int, ...]]]:
    """(dtype, dims) of every tensor described in ``descs``."""
    return [(d[0], tuple(d[1])) for d in descs if _itemsize(d[0])]


def type_bytes(descs: Iterable) -> int:
    """Bytes the described tensors address."""
    return sum(_itemsize(d[0]) * d[2] for d in descs)


def tensors(obj: Any) -> list[torch.Tensor]:
    """Every tensor inside ``obj``, in ``torch.utils._pytree``'s order
    (``SpikeTensor`` and ``PackedSpikes`` are registered there)."""
    return [t for t in pytree.tree_leaves(obj) if isinstance(t, torch.Tensor)]


def _written_args(func, args: tuple, kwargs: dict) -> list:
    """The tensors an op writes in place (its schema's mutable
    arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out.extend(tensors(v))
    return out


def _is_view(func) -> bool:
    """True when the op's result aliases an operand without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _allocates(func) -> bool:
    """True when the op's results are new storages: no result aliases an
    operand (a view or an in-place op makes none), or ``lift_fresh``, which
    brings in a tensor made outside the dispatcher (``torch.tensor``)."""
    rets = func._schema.returns
    return (func is torch.ops.aten.lift_fresh.default
            or bool(rets) and all(r.alias_info is None for r in rets))


@contextlib.contextmanager
def _constants_outside_modes():
    """Inside the block, the model's memoised constant (the RoPE
    frequencies, ``models.layers._rope_freqs_on``) is made outside every
    dispatch mode: a fake walk caches no fake for later real calls, and a
    record holds no one-off op of a cold cache, on fake tensors or on the
    card."""
    from ..models import layers

    made = layers._rope_freqs_on

    def outside(*key):
        with _disable_current_modes():
            return made(*key)

    layers._rope_freqs_on = outside
    try:
        yield
    finally:
        layers._rope_freqs_on = made


# ------------------------------------------------------------- the record
class OpRecorder(TorchDispatchMode):
    """Records every op dispatched inside the block (see the module
    docstring) and tracks the live bytes of the storages they make.

    ``arguments``: the trees the step is called on (their storages are the
    arguments); ``donated``: those of them the caller gives up. After the
    block, ``record`` holds the entries and ``memory_analysis(outputs)``
    the memory fields."""

    def __init__(self, arguments: Any = (), donated: Any = ()):
        super().__init__()
        self.record: list[dict] = []
        self._lock = threading.Lock()
        self._args = {}
        for t in tensors(arguments):
            s = t.untyped_storage()
            self._args[s._cdata] = s.nbytes()
        self._donated = {t.untyped_storage()._cdata for t in
                         tensors(donated)}
        self._live: dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self._open = False
        self._depth = 0                  # inside a fused node
        self._pending: list = []         # storages made inside a node
        self._stack = contextlib.ExitStack()

    # ---------------------------------------------------------- the block
    def __enter__(self):
        from ..ops import registry

        self._open = True
        self._stack.enter_context(registry.node_hook(self._node))
        self._stack.enter_context(_constants_outside_modes())
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        self._open = False
        return out

    # ------------------------------------------------------------ memory
    def _free(self, key: int, nbytes: int) -> None:
        with self._lock:
            if self._live.pop(key, None) is not None:
                self.live -= nbytes

    def _track(self, made: list) -> None:
        for t in made:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._args or key in self._live:
                continue
            nbytes = s.nbytes()
            if self._depth:
                self._pending.append((weakref.ref(s), key, nbytes))
                continue
            with self._lock:
                self._live[key] = nbytes
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key, nbytes)

    def _settle_pending(self) -> None:
        """The storages a node made that outlive it: live from here."""
        pending, self._pending = self._pending, []
        for ref, key, nbytes in pending:
            s = ref()
            if s is None or key in self._live:
                continue
            with self._lock:
                self._live[key] = nbytes
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key, nbytes)

    def memory_analysis(self, outputs: Any = ()) -> dict:
        """The twins of XLA's ``memory_analysis`` fields, in bytes."""
        seen: dict = {}
        for t in tensors(outputs):
            s = t.untyped_storage()
            seen[s._cdata] = s.nbytes()
        arg = sum(self._args.values())
        return {
            "argument_size_in_bytes": arg,
            "output_size_in_bytes": sum(seen.values()),
            "alias_size_in_bytes": sum(n for k, n in self._args.items()
                                       if k in self._donated),
            "temp_size_in_bytes": self.peak,
            "peak_bytes": arg + self.peak,
        }

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace not in ("aten", "c10d"):
            return out
        results = tensors(out) or _written_args(func, args, kwargs)
        if not self._depth:
            entry = self._entry(func, args, kwargs, results)
            if entry is not None:
                self.record.append(entry)
        if _allocates(func):
            self._track(results)
        return out

    @staticmethod
    def _entry(func, args, kwargs, results) -> Optional[dict]:
        operands = tensors([list(args), kwargs])
        if not operands and not results:
            return None
        entry = {"op": str(func), "in": [describe(t) for t in operands],
                 "out": [describe(t) for t in results]}
        name = func._schema.name.split("::")[-1]
        if _is_view(func):
            entry["view"] = True
        if func.namespace == "c10d":
            pg = next((a for a in args if isinstance(a, torch.ScriptObject)
                       and "ProcessGroup" in str(a)), None)
            if pg is not None:
                entry["group"] = int(
                    torch.distributed.ProcessGroup.unbox(pg).size())
        elif name in ("convolution", "_convolution"):
            entry["transposed"] = bool(args[6])
        elif name == "convolution_backward":
            entry["mask"] = [bool(m) for m in args[10][:2]]
        return entry

    # --------------------------------------------------------- fused nodes
    def _node(self, op: str, mode: str, fn: Callable) -> Callable:
        """``fn`` as one record entry while this recorder is open."""
        def call(*args, **kwargs):
            if not self._open or self._depth:
                return fn(*args, **kwargs)
            self._depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            self.record.append({
                "op": f"{op}[{mode}]", "node": True,
                "in": [describe(t) for t in tensors([list(args), kwargs])],
                "out": [describe(t) for t in tensors(out)],
                "inner": plain_record(op, mode, args, kwargs)})
            self._settle_pending()
            return out

        return call


def plain_record(op: str, mode: str, args: tuple, kwargs: dict) -> list:
    """The record of ``op``'s plain version (the ``reference`` twin of
    ``mode``) on fake CPU tensors of ``args``' shapes, without autograd:
    a fused node's flops."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..ops.registry import plain

    ref = plain(op, mode)
    with _disable_current_modes(), warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="Accessing the data pointer of FakeTensor")
        with FakeTensorMode(), torch.no_grad():
            fake = pytree.tree_map_only(
                torch.Tensor, lambda t: torch.empty_strided(
                    tuple(t.shape), tuple(t.stride()), dtype=t.dtype),
                (list(args), kwargs))
            sub = OpRecorder()
            with sub:
                ref(*fake[0], **fake[1])
    return sub.record


# ------------------------------------------------------------- the rules
def _matmul_flops(name: str, ins: list) -> float:
    dims = [s for _, s in shape_dims(ins)]
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        dims = dims[1:]
    a, b = dims[0], dims[1]
    if name in ("mm", "addmm"):
        return 2.0 * a[0] * a[1] * b[1]
    if name in ("bmm", "baddbmm", "addbmm"):
        return 2.0 * a[0] * a[1] * a[2] * b[2]
    if name in ("mv", "addmv"):
        return 2.0 * a[0] * a[1]
    return 2.0 * a[0]                              # dot


def _conv_flops(e: dict) -> float:
    """2 * output elements * the reduction (Cin / groups * kernel window:
    the weight's elements over its output channels), as the reference's
    ``_conv_flops``; a transposed conv reduces over its input's channels
    instead. The backward counts one such product per gradient it makes
    (input, weight)."""
    name = e["op"].split(".")[1]
    ins = e["in"]
    if name == "convolution_backward":
        grad_out, w = ins[0][1], ins[2][1]
        per = 2.0 * math.prod(grad_out) * (math.prod(w) // max(w[0], 1))
        return per * sum(e.get("mask", [True, True]))
    x, w = ins[0][1], ins[1][1]
    out = e["out"][0][1]
    if e.get("transposed"):
        return 2.0 * math.prod(x) * (math.prod(w) // max(w[0], 1))
    return 2.0 * math.prod(out) * (math.prod(w) // max(w[0], 1))


def op_flops(e: dict) -> float:
    """The flops of one record entry (a node's: its plain version's)."""
    if e.get("node"):
        return sum(op_flops(i) for i in e["inner"])
    parts = e["op"].split(".")
    if parts[0] != "aten":
        return 0.0
    name = parts[1]
    if name in _MATMULS:
        return _matmul_flops(name, e["in"])
    if name in _CONVS:
        return _conv_flops(e)
    return 0.0


def op_bytes(e: dict) -> float:
    """The HBM-traffic estimate of one record entry."""
    if e.get("node"):
        return float(type_bytes(e["in"]) + type_bytes(e["out"]))
    if e.get("view"):
        return 0.0
    ns, name = e["op"].split(".")[:2]
    if ns == "aten" and name in _ZERO_COST:
        return 0.0
    out_b = type_bytes(e["out"])
    if name in _SLICING_OPS:
        return 2.0 * out_b                 # read slice + write result
    if name in _INPLACE_OPS:
        return 2.0 * type_bytes(e["in"][-1:])   # read update + write it
    if name in _OVERWRITE_OPS:
        return float(type_bytes(e["in"][1:]) + out_b)
    return float(type_bytes(e["in"]) + out_b)


def _collective_wire_bytes(kind: str, out_bytes: int, n: int) -> float:
    """Per-device wire bytes under ring algorithms."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * out_bytes
    if kind == "all-gather":
        return (n - 1) / n * out_bytes          # out is the gathered size
    if kind == "reduce-scatter":
        return (n - 1) * out_bytes              # out is the shard
    if kind == "all-to-all":
        return (n - 1) / n * out_bytes
    return float(out_bytes)                     # collective-permute


def _collective_out_bytes(kind: str, e: dict) -> int:
    """The collective's result bytes, the size the ring models take: the
    gathered tensor of an all-gather, the shard of a reduce-scatter (the
    output operand of the ``_base`` forms, the first tensor operand)."""
    if kind in ("all-gather", "reduce-scatter") and e["in"]:
        return type_bytes(e["in"][:1])
    return type_bytes(e["out"])


def analyze(record: list, *, default_group: int = 1) -> dict:
    """Full analysis -> dict with flops / bytes / collective totals and a
    breakdown (the reference's keys; ``top_flop_computations`` by op)."""
    flops = 0.0
    bytes_accessed = 0.0
    coll_raw = 0.0
    coll_wire = 0.0
    per_coll: dict[str, dict] = defaultdict(
        lambda: {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0})
    per_op_flops: dict[str, float] = defaultdict(float)
    for e in record:
        ns, name = e["op"].split(".")[:2] if not e.get("node") else ("", "")
        kind = _COLLECTIVES.get(name) if ns == "c10d" else None
        if kind is not None:
            out_b = _collective_out_bytes(kind, e)
            n = e.get("group", default_group)
            wire = _collective_wire_bytes(kind, out_b, n)
            coll_raw += out_b
            coll_wire += wire
            d = per_coll[kind]
            d["count"] += 1
            d["bytes"] += out_b
            d["wire_bytes"] += wire
        f = op_flops(e)
        if f:
            flops += f
            per_op_flops[e["op"]] += f
        bytes_accessed += op_bytes(e)
    return {
        "flops": flops,
        "bytes": bytes_accessed,
        "collective_bytes": coll_raw,
        "collective_wire_bytes": coll_wire,
        "collectives": {k: dict(v) for k, v in per_coll.items()},
        "top_flop_computations": dict(sorted(
            per_op_flops.items(), key=lambda kv: -kv[1])[:8]),
    }
