"""The port's vision-language and encoder-decoder families on the CPU
against the JAX package: the patch merge (spike counts in spiking mode, a
mean otherwise), the reduced phi-3-vision-4.2b's ``prefill`` with
``img_embeds`` (positions over image and text), its decode after it, its
text-only ``prefill_chunk`` and its loss over the text positions with the
gradients; the reduced seamless-m4t-large-v2's ``encode``, ``prefill``,
``decode_step``, loss and gradients, decode equal to a longer prefill's
continuation, and its spiking variant ignoring the encoder as JAX's does
(the token attention reads no ``kv_override``); ``ShapeSpec`` / ``SHAPES``
/ ``cells_for`` and ``input_specs`` (meta tensors) against JAX's
``jax.eval_shape`` leaves for one cell of each family.

Logits at rtol 1e-5, loss 1e-4, gradients 1e-3 relative L2 (``torch_
families``). Inputs are numpy arrays made from a seed; the parameters are
JAX's, carried across by ``convert``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import build_model as jbuild
from repro.configs import cells_for as jcells_for
from repro.configs import get_config as jget
from repro_torch.configs import (ARCHS, SHAPES, build_model, cells_for,
                                 get_config)
from repro_torch.tree import tree_leaves
from torch_families import (check_loss_and_grads, close, family_pair,
                            to_jax, to_torch, tokens)

VLM = "phi-3-vision-4.2b"
ENCDEC = "seamless-m4t-large-v2"


def _img(seed, b, cfg):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.n_img_tokens, cfg.d_vision)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("spiking", [False, True])
def test_patch_merge_matches_jax(spiking):
    jm, _, _, tm, _ = family_pair(VLM, spiking=spiking)
    img = _img(1, 3, tm.cfg)
    got = tm._patch_merge(torch.tensor(img))
    want = jm._patch_merge(jnp.asarray(img))
    assert tuple(got.shape) == (3, 4, tm.cfg.d_vision)
    close(got, want)
    if spiking:       # spike counts of 2 x 2 windows over 4: quarters
        assert set(np.unique(got.numpy() * 4)) <= {0.0, 1.0, 2.0, 3.0, 4.0}


@pytest.mark.parametrize("spiking", [False, True])
def test_vlm_prefill_with_images_and_decode_match_jax(spiking):
    jm, steps, jp, tm, tp = family_pair(VLM, spiking=spiking)
    batch = {"tokens": tokens(1, 2, 6, tm.cfg.vocab_size),
             "img_embeds": _img(2, 2, tm.cfg)}
    jl, jc = steps["prefill"](jp, to_jax(batch))
    tl, tc = tm.prefill(tp, to_torch(batch), return_all_logits=True)
    n_img = tm.cfg.n_img_tokens // tm.cfg.vision_pool_window ** 2
    assert tl.shape == (2, n_img + 6, tm.cfg.vocab_size)
    close(tl, jl)
    assert int(tc["len"]) == int(jc["len"]) == n_img + 6
    # decode on from the image + text prefill (KV padded to 16 rows)
    jl1, jcache = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, to_jax(batch), max_len=16)
    tl1, tcache = tm.prefill(tp, to_torch(batch), max_len=16)
    close(tl1, jl1)
    nxt = np.asarray(jnp.argmax(jl1, -1))[:, None].astype(np.int32)
    for _ in range(2):
        jl1, jcache = steps["decode"](jp, jnp.asarray(nxt), jcache)
        tl1, tcache = tm.decode_step(tp, torch.tensor(nxt), tcache)
        close(tl1, jl1)
        nxt = np.asarray(jnp.argmax(jl1, -1))[:, None].astype(np.int32)


def test_vlm_text_only_chunk_matches_jax():
    jm, steps, jp, tm, tp = family_pair(VLM)
    toks = tokens(3, 2, 8, tm.cfg.vocab_size)
    jcache = jm.init_cache(2, 8)
    jcache["len"] = jnp.zeros((), jnp.int32)
    tcache = tm.init_cache(2, 8, device="cpu")
    tcache["len"] = torch.zeros((), dtype=torch.int32)
    jl, _ = steps["chunk"](jp, jnp.asarray(toks), jcache)
    tl, _ = tm.prefill_chunk(tp, torch.tensor(toks), tcache)
    close(tl, jl)


def test_vlm_loss_over_text_and_grads_match_jax():
    cfg = family_pair(VLM)[3].cfg
    batch = {"tokens": tokens(4, 2, 7, cfg.vocab_size),
             "img_embeds": _img(5, 2, cfg)}
    check_loss_and_grads(VLM, batch)


# ------------------------------------------------------------------ encdec
def _encdec_batch(cfg, seed, b=2, s_src=8, s_tgt=6):
    rng = np.random.default_rng(seed)
    return {"src_embeds": rng.standard_normal(
                (b, s_src, cfg.d_src)).astype(np.float32) * 2.0,
            "tgt_tokens": rng.integers(0, cfg.vocab_size,
                                       (b, s_tgt)).astype(np.int32)}


def test_encdec_encode_prefill_and_decode_match_jax():
    jm, steps, jp, tm, tp = family_pair(ENCDEC)
    batch = _encdec_batch(tm.cfg, 1)
    close(tm.encode(tp, torch.tensor(batch["src_embeds"])),
          jax.jit(jm.encode)(jp, jnp.asarray(batch["src_embeds"])))
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, to_jax(batch), max_len=10)
    tl, tc = tm.prefill(tp, to_torch(batch), max_len=10)
    close(tl, jl)
    jleaves = jax.tree_util.tree_leaves(jc["layers"])
    tleaves = tree_leaves(tc["layers"])
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    for t, j in zip(tleaves, jleaves):
        close(t, j)
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for _ in range(3):
        jl, jc = steps["decode"](jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.tensor(nxt), tc)
        close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    assert int(tc["len"]) == int(jc["len"]) == 9


def test_encdec_loss_and_grads_match_jax():
    cfg = family_pair(ENCDEC)[3].cfg
    check_loss_and_grads(ENCDEC, _encdec_batch(cfg, 2))


def test_encdec_decode_matches_prefill_continuation():
    _, _, _, tm, tp = family_pair(ENCDEC)
    batch = to_torch(_encdec_batch(tm.cfg, 3, s_tgt=7))
    full, _ = tm.prefill(tp, batch)
    part = dict(batch, tgt_tokens=batch["tgt_tokens"][:, :-1])
    _, cache = tm.prefill(tp, part, max_len=7)
    dec, _ = tm.decode_step(tp, batch["tgt_tokens"][:, -1:], cache)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-3)
    assert tuple(cache["layers"]["cross"][0].shape)[2] == 4  # pooled 8 -> 4


def test_spiking_encdec_ignores_the_encoder_as_jax_does():
    """Under qk_spiking the token attention returns before it reads the
    cross K/V: two different sources give the same logits, in JAX and in
    the port, and the port's equal JAX's."""
    jm, steps, jp, tm, tp = family_pair(ENCDEC, spiking=True,
                                        attention_kind="qk_spiking")
    a = _encdec_batch(tm.cfg, 4)
    b = dict(a, src_embeds=-a["src_embeds"])
    tla, _ = tm.prefill(tp, to_torch(a), return_all_logits=True)
    tlb, _ = tm.prefill(tp, to_torch(b), return_all_logits=True)
    jla, _ = steps["prefill"](jp, to_jax(a))
    jlb, _ = steps["prefill"](jp, to_jax(b))
    assert torch.equal(tla, tlb)
    np.testing.assert_array_equal(np.asarray(jla), np.asarray(jlb))
    close(tla, jla)


# ------------------------------------------------------------ input specs
def test_shapes_and_cells_match_jax():
    assert {k: (v.name, v.kind, v.seq_len, v.global_batch)
            for k, v in SHAPES.items()} == {
        k: (v.name, v.kind, v.seq_len, v.global_batch)
        for k, v in JSHAPES.items()}
    for name in ARCHS:
        assert cells_for(get_config(name)) == jcells_for(jget(name)), name
    q = dict(spiking=True, attention_kind="qk_spiking")
    assert cells_for(get_config("qwen3-1.7b", **q)) == jcells_for(
        jget("qwen3-1.7b", **q))


# one cell of each family (a decode cell shows the cache's tree)
SPEC_CELLS = [("qwen3-1.7b", "decode_32k"), ("olmoe-1b-7b", "prefill_32k"),
              ("mamba2-130m", "long_500k"), ("zamba2-7b", "decode_32k"),
              ("phi-3-vision-4.2b", "train_4k"),
              ("seamless-m4t-large-v2", "decode_32k")]


@pytest.mark.parametrize("arch,cell", SPEC_CELLS)
def test_input_specs_match_jax_eval_shape(arch, cell):
    want = jbuild(jget(arch)).input_specs(JSHAPES[cell])
    got = build_model(get_config(arch)).input_specs(SHAPES[cell])
    jleaves, jtree = jax.tree_util.tree_flatten(want)
    tleaves = tree_leaves(got)
    assert len(tleaves) == len(jleaves) > 0
    for t, j in zip(tleaves, jleaves):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape), (arch, cell)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), (arch, cell)
    assert sorted(got) == sorted(want)


def test_engine_and_launcher_refuse_the_encdec_family():
    """As in the reference, the engine cannot serve an encoder-decoder:
    the launcher and the engine say so."""
    from repro_torch.launch import serve
    from repro_torch.serve import Engine, EngineConfig

    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", ENCDEC, "--reduced", "--device", "cpu"])
    _, _, _, tm, tp = family_pair(ENCDEC)
    with pytest.raises(ValueError, match="encoder-decoder"):
        Engine(tm, tp, EngineConfig())
