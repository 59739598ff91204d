"""Sharding rules for the model zoo (twin of ``repro.models.sharding``).

The layout policy, as the reference states it:

* batch dims             -> ('pod', 'data')   (DP; 'pod' only on multi-pod)
* column-parallel W      -> last dim 'model'  (wq/wk/wv/gate/up/in_proj)
* row-parallel W         -> first dim 'model' (wo/down/out_proj)
* MoE expert stacks      -> expert dim 'model' (EP == TP axis)
* vocab embedding        -> vocab dim 'model'
* norms / scalar vectors -> replicated
* KV caches              -> batch on DP, kv-heads on 'model' when divisible;
                            long-context batch=1 shards SEQUENCE on 'data'.

A spec is a plain tuple of axis names (None: not split), one entry a
dimension. The port's layers are lists of one tree a layer, so a spec has
no stacked-layer dimension: on the same leaf it equals the reference's
``PartitionSpec`` without its leading None. The port runs data parallelism
only: every rank holds the whole model and its own rows of the batch, so
the models never constrain an activation (the reference's ``shard_act``
has no twin), and ``param_shardings`` places every leaf on the rank's
device. A ``model`` axis larger than 1 (tensor or expert parallelism) is
ROADMAP queue 1 item 6's and raises.
"""
from __future__ import annotations

import re
from typing import Any, Optional

from ..tree import Field, tree_map, tree_map_with_path

_GLOBAL_MESH = None
_DP_INCLUDES_MODEL: bool = False


def set_global_mesh(mesh) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh():
    return _GLOBAL_MESH


def set_dp_includes_model(flag: bool) -> None:
    """Pure-DP/FSDP regime (cfg.dp_over_model): the batch shards over
    'model' too."""
    global _DP_INCLUDES_MODEL
    _DP_INCLUDES_MODEL = flag


def dp_axes(mesh=None) -> tuple:
    """The data-parallel axis bundle: ('pod', 'data') on multi-pod
    meshes."""
    m = mesh or _GLOBAL_MESH
    if m is None:
        return ("data",)
    axes = tuple(a for a in ("pod", "data") if a in m.axis_names)
    if _DP_INCLUDES_MODEL and "model" in m.axis_names:
        axes = axes + ("model",)
    return axes


def _axis_size(mesh, s) -> int:
    if s is None:
        return 1
    if isinstance(s, (tuple, list)):
        out = 1
        for a in s:
            out *= mesh.shape[a]
        return out
    return mesh.shape[s]


def _fit_axis(mesh, dim: int, s):
    """Drop a sharding that does not evenly divide ``dim``."""
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        s = tuple(a for a in s if a in mesh.axis_names)
        if not s:
            return None
    elif s not in mesh.axis_names:
        return None
    return s if dim % _axis_size(mesh, s) == 0 else None


# (regex over the param tree path, base spec WITHOUT the stacked-layer dim)
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"emb",                          ("model", None)),      # [V, D]
    (r"(wq|wk|wv|gate|up|in_proj)/w", (None, "model")),
    (r"(wq|wk|wv|gate|up|in_proj)/b", ("model",)),
    (r"(wo|down|out_proj)/w",         ("model", None)),
    (r"(wo|down|out_proj)/b",         (None,)),
    (r"router/w",                     (None, None)),
    (r"w_gate|w_up",                  ("model", None, None)),  # [E, D, F]
    (r"w_down",                       ("model", None, None)),  # [E, F, D]
    (r"conv_w",                       (None, "model")),
    (r"conv_b",                       ("model",)),
    (r"(A_log|dt_bias|D$|/D)",        (None,)),
    (r"(norm|scale|q_norm|k_norm)",   (None,)),
    (r"head/w",                       (None, "model")),      # lm head [D, V]
    (r"head/b",                       ("model",)),
    (r"(proj|vision_proj|src_proj)/w", (None, "model")),
    (r"(proj|vision_proj|src_proj)/b", ("model",)),
]


def spec_for_leaf(path: str, ndim: int, mesh=None,
                  shape: Optional[tuple[int, ...]] = None) -> tuple:
    """The spec of one parameter leaf at ``path`` ("blocks/0/attn/wq/w").
    Leading dimensions past the rule's are padded with None on the left;
    with ``mesh`` and ``shape`` a split that does not divide is dropped."""
    for pat, base in _PARAM_RULES:
        if re.search(pat, path):
            spec = list(base)
            while len(spec) < ndim:
                spec.insert(0, None)
            spec = spec[:ndim] if ndim else []
            if mesh is not None and shape is not None:
                spec = [_fit_axis(mesh, d, s) for d, s in zip(shape, spec)]
            return tuple(spec)
    return ()  # replicate by default (norm scales, biases, scalars)


def _with_paths(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over ``tree``, the path's keys joined by "/" as
    the reference's ``_path_str`` joins them (a NamedTuple field as
    ``.field``, as ``str`` of jax's ``GetAttrKey`` writes it)."""
    return tree_map_with_path(
        lambda path, leaf: fn("/".join(
            f".{k}" if isinstance(k, Field) else str(k) for k in path),
            leaf), tree)


def param_specs(params: Any, mesh=None) -> Any:
    """A parameter tree (tensors, or anything with ``shape``) -> its specs,
    the same structure."""
    return _with_paths(lambda path, leaf: spec_for_leaf(
        path, len(leaf.shape), mesh, tuple(leaf.shape)), params)


def param_shardings(params: Any, mesh) -> Any:
    """Where each leaf of a parameter (or training-state) tree lives: the
    rank's device, the port holding the whole model on every rank. A
    ``model`` axis larger than 1 would split the weights over ranks and
    raises."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"tensor / expert parallelism over a 'model' axis of "
            f"{mesh.shape['model']} is not ported yet (ROADMAP queue 1 item "
            f"6); the port trains data-parallel: a 'model' axis of 1")
    return tree_map(lambda _: mesh.device, params)


def cache_specs(cache: Any, mesh, *, batch: int,
                context_parallel: bool = False,
                seq_axis: Optional[str] = None) -> Any:
    """Specs for a decode cache tree (LM or EncDecLM layout).

    * KV leaves [B, S, Hkv, Dh]: B on DP, Hkv on 'model' (if divisible);
      with ``context_parallel`` (long-context batch=1) S on 'data' instead.
    * mamba 'ssm' leaves [B, H, P, N]: B on DP, H on 'model'.
    * mamba 'conv' leaves [B, K, C]: B on DP, C on 'model'.
    * 'len' and scalars: replicated.
    """
    dp = dp_axes(mesh)

    def one(ps, leaf):
        nd = len(leaf.shape)
        if nd == 0 or "len" in ps:
            return ()
        spec = [None] * nd
        if "ssm" in ps:                    # [.., B, H, P, N]
            b_dim = nd - 4
            spec[b_dim] = _fit_axis(mesh, leaf.shape[b_dim], dp)
            spec[nd - 3] = _fit_axis(mesh, leaf.shape[nd - 3], "model")
        elif "conv" in ps:                 # [.., B, K, C]
            b_dim = nd - 3
            spec[b_dim] = _fit_axis(mesh, leaf.shape[b_dim], dp)
            spec[nd - 1] = _fit_axis(mesh, leaf.shape[nd - 1], "model")
        else:                              # KV: [.., B, S, Hkv, Dh]
            b_dim = nd - 4
            if context_parallel and batch == 1:
                spec[nd - 3] = _fit_axis(mesh, leaf.shape[nd - 3], "data")
            elif seq_axis:
                spec[b_dim] = _fit_axis(
                    mesh, leaf.shape[b_dim],
                    tuple(a for a in dp if a != seq_axis))
                spec[nd - 3] = _fit_axis(mesh, leaf.shape[nd - 3], seq_axis)
            else:
                spec[b_dim] = _fit_axis(mesh, leaf.shape[b_dim], dp)
                spec[nd - 2] = _fit_axis(mesh, leaf.shape[nd - 2], "model")
        return tuple(spec)

    return _with_paths(one, cache)


def batch_specs(batch: Any, mesh) -> Any:
    """Input batch: the leading dim on DP, the rest replicated."""
    dp = dp_axes(mesh)

    def one(leaf):
        if len(leaf.shape) == 0:
            return ()
        spec = [None] * len(leaf.shape)
        spec[0] = _fit_axis(mesh, leaf.shape[0], dp)
        return tuple(spec)

    return tree_map(one, batch)


def zero1_specs(params: Any, mesh=None) -> Any:
    """Optimizer-state specs (ZeRO-1): the first unsplit dim also split
    over 'data' where it divides."""

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = list(spec_for_leaf(path, len(shape), mesh, shape))
        if mesh is None or "data" not in mesh.axis_names:
            return tuple(spec)
        dsize = mesh.shape["data"]
        for i, (dim, s) in enumerate(zip(shape, spec)):
            if s is None and dim % dsize == 0 and dim >= 4 * dsize:
                spec[i] = "data"
                break
            if s == "model" and dim % (dsize * mesh.shape["model"]) == 0:
                spec[i] = ("model", "data")
                break
        return tuple(spec)

    return _with_paths(one, params)
