"""Nested parameter containers (dicts, lists, tuples and NamedTuples of
tensors), walked in one fixed order: the port's stand-in for the few
``jax.tree_util`` functions the training code needs. As there, a dict is
walked in sorted key order, so a tree flattens to the reference's leaf
order. ``derived`` memoises a value made from parameter tensors."""
from __future__ import annotations

import weakref
from typing import Any, Callable, Hashable, Optional

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure); None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order (None skipped)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


class Field(str):
    """A NamedTuple field in a key path (``jax``'s ``GetAttrKey``)."""


def tree_leaves_with_path(tree: Any, path: tuple = ()) -> list:
    """(key path, leaf) in ``tree_leaves`` order: the path a tuple of its
    keys, a dict key as itself, a list or tuple index as an int, a
    NamedTuple field as a ``Field``. The one walker that every path-aware
    function (``keystr``, ``models.sharding``, ``optim.compression``)
    derives its paths from."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for name, v in zip(tree._fields, tree)
                for pl in tree_leaves_with_path(v, path + (Field(name),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_leaves_with_path(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def keystr(path: tuple) -> str:
    """``path`` written as ``jax.tree_util.keystr`` writes it: ``['k']`` a
    dict key, ``[i]`` an index, ``.field`` a NamedTuple field."""
    return "".join(f".{k}" if isinstance(k, Field) else f"[{k!r}]"
                   for k in path)


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """``fn(path, leaf)`` over ``tree``'s leaves, in its structure."""
    return tree_unflatten_like(
        tree, [fn(p, leaf) for p, leaf in tree_leaves_with_path(tree)])


def tree_unflatten_like(tree: Any, leaves: list) -> Any:
    """``leaves`` (in ``tree_leaves`` order) put back in ``tree``'s
    structure."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


# (ids of the sources, tag) -> (weak refs of the sources, their versions,
# the value)
_DERIVED: dict = {}


def derived(base: torch.Tensor, tag: Hashable, make: Callable[[], Any],
            *also: Optional[torch.Tensor]) -> Any:
    """``make()``, memoised on the tensor ``base`` (and ``also``): made once
    while each of them lives and none is modified in place (their
    ``_version``), so a value derived from parameters (a weight cast to
    the activation dtype, grouped-KV columns repeated) is made once per
    parameter set, not once per call. A source is matched by identity,
    never by its id alone, which a new tensor may reuse. The entry goes
    with ``base``."""
    srcs = (base, *also)
    key = (tuple(id(t) for t in srcs), tag)
    versions = tuple(None if t is None else t._version for t in srcs)
    hit = _DERIVED.get(key)
    if (hit is not None and hit[1] == versions
            and all(r() is t for r, t in zip(hit[0], srcs) if t is not None)):
        return hit[2]
    out = make()
    refs = tuple(
        None if t is None
        else weakref.ref(t, (lambda _, k=key: _DERIVED.pop(k, None))
                         if t is base else None)
        for t in srcs)
    _DERIVED[key] = (refs, versions, out)
    return out
