"""The port's bit-packed spike format against the JAX package on the CPU:
the packed helpers of ``core/events.py``, the pack/unpack wrappers, the
packed patch extraction and pooling, the packed operands of the fused PE
and spike-matmul wrappers (their plain versions here), the ops-layer
format handling, and the BN fold the packed forward is built on.

Inputs are numpy arrays made from a seed and handed to both frameworks.
Words, ``vld_cnt`` and ``occ`` maps must be bit-equal, bit 31 (the sign of
an int32 word) included. A fused PE spike may differ only where the f64
membrane current lies within 1e-4 of ``v_th`` (the two frameworks sum the
f32 products in another order); spike-matmul currents match at rtol 1e-5,
atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import quant as jquant
from repro.kernels.fused_pe import fused_pe as jax_fused_pe
from repro.kernels.packed import pack_spikes as jax_pack_spikes
from repro.kernels.packed import unpack_spikes as jax_unpack_spikes
from repro.kernels.spike_matmul import spike_matmul as jax_spike_matmul
from repro.models import nn as jnn
from repro_torch import ops
from repro_torch.core import events as tev
from repro_torch.core import quant as tquant
from repro_torch.kernels import _build
from repro_torch.kernels.fused_pe import fused_pe
from repro_torch.kernels.packed import pack_spikes, unpack_spikes
from repro_torch.kernels.spike_matmul import spike_matmul
from repro_torch.models import nn as tnn

RTOL = ATOL = 1e-5
NEAR_VTH = 1e-4
DENSITIES = [0.0, 0.1, 0.5, 1.0]
# (M, K): ragged in both, a block-aligned one, one word short of a block
SHAPES = [(200, 300), (256, 256), (5, 33), (130, 96)]


def spikes_np(rng, shape, density, bit31=False):
    x = (rng.random(shape) < density).astype(np.int8)
    if bit31:
        x[..., 31::32] = 1            # every word's sign bit
    return x


def eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def to_torch_ps(jps):
    """A JAX PackedSpikes as the port's (same words and maps)."""
    return tev.PackedSpikes(
        torch.tensor(np.array(jps.words)), torch.tensor(np.array(jps.vld_cnt)),
        tuple(jps.shape), jps.block_m, jps.block_k,
        None if jps.occ is None else torch.tensor(np.array(jps.occ)))


# ----------------------------------------------------------- core helpers
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("bit31", [False, True])
def test_packed_helpers_bit_equal_to_jax(shape, density, bit31):
    rng = np.random.default_rng([*shape, int(density * 10), int(bit31)])
    x = spikes_np(rng, shape, density, bit31)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jp = jev.pack_spikes_ref(jx, with_occ=True)
    tp = tev.pack_spikes_ref(tx, with_occ=True)
    eq(tp.words, jp.words)
    eq(tp.vld_cnt, jp.vld_cnt)
    eq(tp.occ, jp.occ)
    assert tp.shape == tuple(jp.shape) and tp.padded_shape == jp.padded_shape
    assert (tp.packed_bytes, tp.dense_bytes) == (jp.packed_bytes,
                                                 jp.dense_bytes)
    if bit31 and density > 0:
        assert bool((tp.words < 0).any())
    padded = np.asarray(jev.pad_to_blocks(jx, 128, 128))
    eq(tev.pack_words(torch.tensor(padded)), jev.pack_words(jnp.asarray(padded)))
    eq(tev.unpack_words(tp.words), jev.unpack_words(jp.words))
    eq(tev.popcount_block_map(tp.words, 128, 128),
       jev.popcount_block_map(jp.words, 128, 128))
    eq(tev.popcount_block_map(tp.words, 128, 64),
       jev.popcount_block_map(jp.words, 128, 64))
    eq(tev.word_occupancy_map(tp.words, 128, 128),
       jev.word_occupancy_map(jp.words, 128, 128))
    eq(tev.word_occupancy_map_dense(torch.tensor(padded), 128, 128),
       jev.word_occupancy_map_dense(jnp.asarray(padded), 128, 128))
    eq(tev.unpack_spikes_ref(tp), jev.unpack_spikes_ref(jp))
    eq(tev.unpack_spikes_ref(tp), x)
    np.testing.assert_array_equal(tev.pad_lane_mask(shape[1],
                                                    tp.words.shape[1]),
                                  jev.pad_lane_mask(shape[1],
                                                    jp.words.shape[1]))
    assert tev.check_packed_invariants(tp) == jev.check_packed_invariants(jp)


def test_word_occupancy_wraps_bit_31_as_jax_does():
    """A 1024-wide block has 32 word columns: occupancy bit 31 is the sign
    of the int32 map, in both packages."""
    x = np.zeros((4, 1024), np.int8)
    x[1, 31 * 32 + 5] = 1
    x[2, 0] = 1
    jw = jev.pack_words(jnp.asarray(x))
    tw = tev.pack_words(torch.tensor(x))
    got = tev.word_occupancy_map(tw, 4, 1024)
    eq(got, jev.word_occupancy_map(jw, 4, 1024))
    assert int(got) == -(2 ** 31) + 1


@pytest.mark.parametrize("rows", [1, 130, 256])
def test_packed_from_words_matches_jax(rows):
    rng = np.random.default_rng(rows)
    words = rng.integers(-2 ** 31, 2 ** 31, (2, rows, 8), dtype=np.int64
                         ).astype(np.int32)
    shape = (2, rows, 256)
    jp = jev.packed_from_words(jnp.asarray(words), shape, with_occ=True)
    tp = tev.packed_from_words(torch.tensor(words), shape, with_occ=True)
    eq(tp.words, jp.words)
    eq(tp.vld_cnt, jp.vld_cnt)
    eq(tp.occ, jp.occ)
    assert tp.shape == tuple(jp.shape)
    sub, jsub = tp[1], jp[1]
    assert sub.shape == tuple(jsub.shape)
    eq(sub.words, jsub.words)


@pytest.mark.parametrize("corrupt", ["none", "pad_col", "pad_row", "vld",
                                     "occ"])
def test_check_packed_invariants_matches_jax(corrupt):
    rng = np.random.default_rng(11)
    x = spikes_np(rng, (100, 70), 0.4)
    jp = jev.pack_spikes_ref(jnp.asarray(x), with_occ=True)
    words = np.array(jp.words)
    vld, occ = np.array(jp.vld_cnt), np.array(jp.occ)
    if corrupt == "pad_col":
        words[3, 2] |= 1 << 20            # column 84 >= k = 70
    elif corrupt == "pad_row":
        words[120, 0] = 1
    elif corrupt == "vld":
        vld[0, 0] += 1
    elif corrupt == "occ":
        occ[0, 0] ^= 8
    jbad = jev.PackedSpikes(jnp.asarray(words), jnp.asarray(vld), (100, 70),
                            occ=jnp.asarray(occ))
    want = jev.check_packed_invariants(jbad)
    assert tev.check_packed_invariants(to_torch_ps(jbad)) == want
    assert want["ok"] == (corrupt == "none")


# -------------------------------------------------------- pack and unpack
@pytest.mark.parametrize("shape", [(200, 300), (2, 130, 64), (1, 2, 40, 33)])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_pack_unpack_wrappers_match_jax(shape, density):
    """The wrappers (plain versions on CPU tensors) against JAX's Pallas
    pack/unpack in interpret mode, with leading dims and padding."""
    rng = np.random.default_rng([*shape, int(density * 10)])
    x = spikes_np(rng, shape, density, bit31=density > 0)
    jp = jax_pack_spikes(jnp.asarray(x))
    tp = pack_spikes(torch.tensor(x))
    eq(tp.words, jp.words)
    eq(tp.vld_cnt, jp.vld_cnt)
    eq(tp.occ, jp.occ)
    assert tp.shape == tuple(jp.shape)
    back = unpack_spikes(tp)
    assert back.dtype == torch.int8
    eq(back, jax_unpack_spikes(jp))
    eq(back, x)
    eq(unpack_spikes(tp, dtype=torch.float32),
       jax_unpack_spikes(jp, dtype=jnp.float32))


# ----------------------------------------------- packed im2col and pooling
@pytest.mark.parametrize("c,kh,stride", [(64, 3, 1), (8, 3, 2), (200, 1, 2),
                                         (130, 3, 2)])
def test_im2col_packed_matches_jax(c, kh, stride):
    rng = np.random.default_rng(c + kh + stride)
    x = spikes_np(rng, (2, 9, 7, c), 0.4, bit31=True)
    # channels padded to whole 128-wide blocks, then packed
    xp = np.zeros((*x.shape[:-1], -(-c // 128) * 128), np.int8)
    xp[..., :c] = x
    words = np.asarray(jev.pack_words(jnp.asarray(xp)))
    jw = jnn.im2col_packed(jnp.asarray(words), kh, kh, stride)
    tw = tnn.im2col_packed(torch.tensor(words), kh, kh, stride)
    eq(tw, jw)
    # the words of im2col(packed) unpack to im2col(dense) of the padded map
    eq(tev.unpack_words(tw), jnn.im2col(jnp.asarray(xp), kh, kh, stride))


@pytest.mark.parametrize("h,window", [(8, 2), (9, 2), (12, 3)])
def test_max_pool_packed_matches_jax(h, window):
    rng = np.random.default_rng(h + window)
    x = spikes_np(rng, (2, h, h, 64), 0.3, bit31=True)
    words = np.asarray(jev.pack_words(jnp.asarray(
        np.pad(x, ((0, 0), (0, 0), (0, 0), (0, 64))))))
    tw = tnn.max_pool_packed(torch.tensor(words), window)
    eq(tw, jnn.max_pool_packed(jnp.asarray(words), window))
    eq(tev.unpack_words(tw)[..., :64],
       jnn.max_pool(jnp.asarray(x, jnp.float32), window))


# ---------------------------------------------------- packed fused PE pass
FUSED_CASES = [
    # (packed x, q: None | "dense" | "packed", residual: None | "int8" |
    #  "f32" | "packed", packed out) — each flag alone, then the forward's
    #  combinations: x+out, x+q+out, x+packed residual+out
    (True, None, None, False),
    (False, "packed", None, False),
    (False, None, "packed", False),
    (False, None, None, True),
    (True, None, None, True),
    (True, "packed", None, True),
    (True, None, "packed", True),
    (True, None, "f32", True),
]


@pytest.mark.parametrize("px,qkind,rkind,pout", FUSED_CASES)
@pytest.mark.parametrize("density", [0.1, 0.5, 1.0])
def test_fused_pe_packed_matches_jax(px, qkind, rkind, pout, density):
    m, k, n = 200, 150, 90
    rng = np.random.default_rng([m, k, n, int(density * 10), int(px),
                                 int(pout), len(qkind or ""),
                                 len(rkind or "")])
    x = spikes_np(rng, (m, k), 1.0 - density)
    w = (rng.standard_normal((k, n)) * (2.0 / np.sqrt(k))).astype(np.float32)
    b = (0.6 + 0.4 * rng.standard_normal(n)).astype(np.float32)
    q = spikes_np(rng, (m, n), 0.01) if qkind else None
    r = None
    if rkind == "f32":
        r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
    elif rkind:
        r = spikes_np(rng, (m, n), 0.3)

    def operand(a, packed, to_jax):
        if a is None:
            return None
        if to_jax:
            return jev.pack_spikes_ref(jnp.asarray(a)) if packed \
                else jnp.asarray(a)
        return tev.pack_spikes_ref(torch.tensor(a)) if packed \
            else torch.tensor(a)

    fmt = "packed" if pout else "dense"
    pq, pr = qkind == "packed", rkind == "packed"
    spk, vld = fused_pe(operand(x, px, False), torch.tensor(w),
                        bias=torch.tensor(b), residual=operand(r, pr, False),
                        q=operand(q, pq, False), out_format=fmt)
    j = jax_fused_pe(operand(x, px, True), jnp.asarray(w),
                     bias=jnp.asarray(b), residual=operand(r, pr, True),
                     q=operand(q, pq, True), out_format=fmt)
    cur = x.astype(np.float64) @ w.astype(np.float64) + b
    if r is not None:
        cur = cur + r
    near = np.abs(cur - 1.0) < NEAR_VTH
    if pout:
        assert isinstance(spk, tev.PackedSpikes) and spk.shape == (m, n)
        assert tev.check_packed_invariants(spk)["ok"]
        got, want = tev.unpack_spikes_ref(spk), jev.unpack_spikes_ref(
            j.spikes)
        eq(spk.vld_cnt, np.asarray(vld))
    else:
        got, want = spk, j.spikes
    bad = (got.numpy() != np.asarray(want)) & ~near
    assert not bad.any(), f"{int(bad.sum())} spikes differ away from v_th"
    if (got.numpy() == np.asarray(want)).all():
        eq(vld, j.vld_next)
        if pout:
            eq(spk.words, j.spikes.words)


# -------------------------------------------------------- packed matmul
@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (200, 150, 90),
                                   (1, 7, 5)])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_spike_matmul_packed_matches_jax(m, k, n, density):
    rng = np.random.default_rng([m, k, n, int(density * 10)])
    x = spikes_np(rng, (m, k), density, bit31=density > 0)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    got = spike_matmul(tev.pack_spikes_ref(torch.tensor(x)), torch.tensor(w))
    want = jax_spike_matmul(jev.pack_spikes_ref(jnp.asarray(x)),
                            jnp.asarray(w))
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               spike_matmul(torch.tensor(x),
                                            torch.tensor(w)).numpy(),
                               rtol=0, atol=0)


def test_packed_operands_check_their_block_grid():
    x = tev.pack_spikes_ref(torch.ones((8, 64), dtype=torch.int8),
                            block_m=64, block_k=64)
    with pytest.raises(ValueError, match="re-pack"):
        spike_matmul(x, torch.ones((64, 8)))
    ok = tev.pack_spikes_ref(torch.ones((8, 64), dtype=torch.int8))
    with pytest.raises(ValueError, match="packed residual"):
        fused_pe(ok, torch.ones((64, 8)), residual=tev.pack_spikes_ref(
            torch.ones((8, 16), dtype=torch.int8)))


def test_packed_cpu_calls_count_no_launch():
    _build.reset_launches()
    x = torch.ones((8, 40), dtype=torch.int8)
    ps = pack_spikes(x)
    unpack_spikes(ps)
    spike_matmul(ps, torch.ones((40, 8)))
    fused_pe(ps, torch.ones((40, 8)), out_format="packed")
    assert set(_build.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("kernel", ["pack_spikes", "unpack_spikes"])
def test_pack_unpack_other_devices_raise(kernel):
    meta = torch.empty((8, 40), dtype=torch.int8, device="meta")
    call = {"pack_spikes": lambda: pack_spikes(meta),
            "unpack_spikes": lambda: unpack_spikes(tev.PackedSpikes(
                torch.empty((128, 4), dtype=torch.int32, device="meta"),
                torch.empty((1, 1), dtype=torch.int32, device="meta"),
                (8, 40)))}[kernel]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        call()


# ---------------------------------------------------------- the ops layer
@pytest.mark.parametrize("policy", ["fused_packed", "reference"])
def test_ops_pack_unpack_round_trip(policy):
    rng = np.random.default_rng(5)
    x = torch.tensor(spikes_np(rng, (1, 200, 70), 0.3, bit31=True))
    st = ops.pack(x, policy=policy)
    assert st.is_packed and st.shape == (1, 200, 70)
    assert ops.pack(st) is st
    assert torch.equal(ops.unpack(st, policy=policy), x)
    assert torch.equal(st.to_dense(), x)
    assert float(st.count()) == float(x.sum())
    assert st.hbm_bytes == 4 * (256 * 4 + 2 * 1)
    assert st.dense_bytes == 256 * 128
    assert (st.occ is not None) == (policy == "fused_packed")


def test_policy_none_inherits_the_operand_format():
    rng = np.random.default_rng(6)
    x = torch.tensor(spikes_np(rng, (1, 130, 64), 0.5))
    packed = ops.pack(x)
    w = torch.tensor(rng.standard_normal((64, 40)).astype(np.float32))
    out = ops.fused_pe_layer(packed, w, bias=torch.full((40,), 0.2))
    assert out.spikes.is_packed
    dense = ops.fused_pe_layer(x, w, bias=torch.full((40,), 0.2))
    assert not dense.spikes.is_packed
    assert torch.equal(out.spikes.to_dense(), dense.spikes.data)
    assert torch.equal(out.vld_next, dense.vld_next)
    ref = ops.fused_pe_layer(packed, w, bias=torch.full((40,), 0.2),
                             policy="reference_packed")
    assert ref.spikes.is_packed
    assert torch.equal(ref.spikes.data, out.spikes.data)


@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_ops_im2col_and_pool_convert_formats(fmt):
    """A dense map under a packed policy is packed first (and the other
    way round), and both formats give the same patches and pooled map."""
    rng = np.random.default_rng(7)
    b, h, c = 2, 6, 40
    x = torch.tensor(spikes_np(rng, (1, b * h * h, c), 0.3))
    src = ops.pack(x) if fmt == "dense" else ops.SpikeTensor.dense(x)
    pol = "fused_dense" if fmt == "dense" else "fused_packed"
    pat, hw = ops.im2col(src, (b, h, h, c), 3, 3, 1, policy=pol)
    pool, hw2 = ops.pool(src, (b, h, h, c), policy=pol)
    assert pat.fmt == fmt and pool.fmt == fmt
    want_pat, _ = ops.im2col(x, (b, h, h, c), 3, 3, 1, policy="reference")
    want_pool, _ = ops.pool(x, (b, h, h, c), policy="reference")
    if fmt == "packed":
        dense_pat = pat.to_dense().reshape(1, b * h * h, 9, -1)[..., :c]
        assert torch.equal(dense_pat.reshape(want_pat.data.shape),
                           want_pat.data)
        assert torch.equal(pool.to_dense(), want_pool.data)
    else:
        assert torch.equal(pat.data, want_pat.data)
        assert torch.equal(pool.data, want_pool.data)
    assert hw == (h, h) and hw2 == (h // 2, h // 2)


# ------------------------------------------------------------- BN fold
def test_bn_fold_bit_equal_to_jax_on_1e5_values():
    """``sqrt`` must be correctly rounded, as ``jnp.sqrt`` is: folded
    weights and biases are bit-equal to JAX's on 10**5 seeded channels."""
    rng = np.random.default_rng(12)
    n = 100_000
    var = rng.uniform(0.5, 1.5, n).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    beta = rng.standard_normal(n).astype(np.float32)
    mean = (0.1 * rng.standard_normal(n)).astype(np.float32)
    w_conv = rng.standard_normal((1, 1, 1, n)).astype(np.float32)
    w_lin = rng.standard_normal((1, n)).astype(np.float32)
    stats = (gamma, beta, mean, var)
    for fold_j, fold_t, w in ((jquant.fuse_bn_into_conv,
                               tquant.fuse_bn_into_conv, w_conv),
                              (jquant.fuse_bn_into_linear,
                               tquant.fuse_bn_into_linear, w_lin)):
        jw, jb = fold_j(jnp.asarray(w), None, *map(jnp.asarray, stats))
        tw, tb = fold_t(torch.tensor(w), None, *map(torch.tensor, stats))
        eq(tw, jw)
        eq(tb, jb)
