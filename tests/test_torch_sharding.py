"""The port's sharding rules (``repro_torch.models.sharding``) against the
reference's: for every arch in the registry (reduced), the port's
``param_specs`` on its parameters equal the reference's on
``jax.eval_shape`` of its init, the stacked-layer dimension dropped, with
no mesh and on meshes of one, two and three axes, and its ``zero1_specs``
the reference's rule on the port's unstacked tree (the reference's may
split the layer dim itself);
``dp_axes``, ``batch_specs`` and ``cache_specs`` on the same shapes;
``param_shardings`` over a ``model`` axis larger than 1 raises. The
reference's rules read only a mesh's ``axis_names`` and ``shape``, so its
side takes a stand-in mesh of any size in this one-device process.
"""
import re
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import sharding as jshd
from repro_torch.configs import ARCHS, build_model, get_config, reduced
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as shd

STACKED = ("blocks", "enc_blocks", "dec_blocks")
MESHES = [None, ((2,), ("data",)), ((2, 2), ("data", "model")),
          ((2, 4, 2), ("pod", "data", "model")), ((1, 4), ("data", "model"))]


def _meshes(spec):
    if spec is None:
        return None, None
    shape, axes = spec
    return (Mesh(shape, axes, device="cpu"),
            types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, shape))))


def _flat_port(tree, prefix=""):
    """path -> spec of a port spec tree (dicts and lists; a tuple is a
    spec)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_port(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_port(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _flat_jax(specs, n_layers):
    """path -> spec of a reference spec tree, in the port's layout: a
    stacked tree's leaf becomes one leaf a layer, its first dim dropped
    (none stacked where ``n_layers`` is None)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for path, spec in flat[0]:
        ps = jshd._path_str(path)
        head = ps.split("/")[0]
        spec = tuple(spec)
        if n_layers is not None and head in STACKED:
            rest = ps[len(head):]
            for i in range(n_layers[head]):
                out[f"{head}/{i}{rest}"] = spec[1:]
        else:
            out[ps] = spec
    return out


def _as_jax(tree):
    """A port tree of tensors as ShapeDtypeStructs in the same dicts and
    lists."""
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _normal(spec):
    """A spec as the reference spells it: a one-name tuple may be the
    name itself."""
    return tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s
                 for s in spec)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_the_reference(arch):
    cfg = reduced(get_config(arch))
    params = build_model(cfg).init(torch.Generator(), device="cpu")
    jmodel = j_build_model(j_reduced(j_get_config(arch)))
    jshape = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    n_layers = {k: len(params[k]) for k in STACKED if k in params}
    for spec in MESHES:
        mesh, jmesh = _meshes(spec)
        got = _flat_port(shd.param_specs(params, mesh))
        want = _flat_jax(jshd.param_specs(jshape, jmesh), n_layers)
        assert got.keys() == want.keys()
        for k in got:
            assert _normal(got[k]) == _normal(want[k]), (spec, k)
        # ZeRO-1 splits a leaf's first free dim, which in the reference's
        # stacked tree may be the layer dim: both rules on the port's tree
        got = _flat_port(shd.zero1_specs(params, mesh))
        want = _flat_jax(jshd.zero1_specs(_as_jax(params), jmesh), None)
        assert got.keys() == want.keys()
        for k in got:
            assert _normal(got[k]) == _normal(want[k]), ("zero1", spec, k)
    # the big matmul weights are split somewhere with no mesh
    for k, s in _flat_port(shd.param_specs(params)).items():
        if re.search(r"(wq|wo|up|down)/w$", k):
            assert any(a is not None for a in s), k


def test_spec_rules():
    assert shd.spec_for_leaf("blocks/0/attn/wq/w", 2) == (None, "model")
    assert shd.spec_for_leaf("blocks/0/attn/wo/w", 2) == ("model", None)
    assert shd.spec_for_leaf("embed/emb", 2) == ("model", None)
    assert shd.spec_for_leaf("blocks/0/moe/w_gate", 3) == ("model", None,
                                                             None)
    assert shd.spec_for_leaf("final_norm/scale", 1) == (None,)
    assert shd.spec_for_leaf("something/else", 2) == ()


@pytest.mark.parametrize("dp_over_model", [False, True])
@pytest.mark.parametrize("spec", MESHES[1:])
def test_dp_axes_and_batch_specs_match(spec, dp_over_model):
    mesh, jmesh = _meshes(spec)
    shd.set_dp_includes_model(dp_over_model)
    jshd.set_dp_includes_model(dp_over_model)
    try:
        assert shd.dp_axes(mesh) == jshd.dp_axes(jmesh)
        for rows in (8, 6, 1):
            batch = {"tokens": torch.empty((rows, 16), device="meta"),
                     "n": torch.empty((), device="meta")}
            jbatch = {"tokens": jax.ShapeDtypeStruct((rows, 16), jnp.int32),
                      "n": jax.ShapeDtypeStruct((), jnp.int32)}
            got = shd.batch_specs(batch, mesh)
            want = jshd.batch_specs(jbatch, jmesh)
            assert got["n"] == tuple(want["n"]) == ()
            assert _normal(got["tokens"]) == _normal(tuple(want["tokens"]))
    finally:
        shd.set_dp_includes_model(False)
        jshd.set_dp_includes_model(False)
    shd.set_global_mesh(None)
    assert shd.dp_axes() == ("data",)


@pytest.mark.parametrize("kw", [{}, {"context_parallel": True},
                                {"seq_axis": "model"}])
@pytest.mark.parametrize("batch", [1, 4])
def test_cache_specs_match(kw, batch):
    shapes = {"k": (batch, 64, 8, 16), "v": (batch, 64, 8, 16),
              "ssm": (batch, 8, 16, 16), "conv": (batch, 4, 160),
              "len": ()}
    cache = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    jcache = {k: jax.ShapeDtypeStruct(s, jnp.float32)
              for k, s in shapes.items()}
    for spec in MESHES[1:]:
        mesh, jmesh = _meshes(spec)
        got = shd.cache_specs(cache, mesh, batch=batch, **kw)
        want = jshd.cache_specs(jcache, jmesh, batch=batch, **kw)
        for k in shapes:
            assert _normal(got[k]) == _normal(tuple(want[k])), (spec, kw, k)


def test_param_shardings_place_on_the_rank_and_refuse_a_model_axis():
    params = build_model(reduced(get_config("qwen3-1.7b"))).init(
        torch.Generator(), device="cpu")
    mesh = Mesh((2, 1), ("data", "model"), device="cpu")
    devs = shd.param_shardings(params, mesh)
    assert devs["embed"]["emb"] == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        shd.param_shardings(params, Mesh((1, 2), ("data", "model"),
                                         device="cpu"))
