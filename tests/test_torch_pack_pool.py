"""The pack kernel and the W2TTFS head kernel on the CPU: the port's
wrappers (their plain versions here) against JAX's Pallas kernels in
interpret mode, and numpy twins of the pack kernel's own steps (its
16-byte-to-16-bit gather, and its lane map: which lane loads which
segment, the shuffles that join a word and a group of four words, the
stores and the block counters) against the plain pack.

Inputs are numpy arrays made from a seed and handed to both frameworks.
Packed words, ``vld_cnt`` and ``occ`` must be bit-equal, bit 31 (the sign
of an int32 word) included; the head's logits agree at rtol 1e-5, atol
1e-5 (the FC sums in another order), and are bit-equal across the spike
map's dtypes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed import pack_spikes as jax_pack_spikes
from repro.kernels.w2ttfs_pool import w2ttfs_pool_fc as jax_w2ttfs
from repro_torch.kernels.packed import pack_spikes
from repro_torch.kernels.packed.ops import pack_plan
from repro_torch.kernels.packed.ref import (gather16_twin, pack_lanes_twin,
                                            pack_spikes_ref)
from repro_torch.kernels.w2ttfs_pool import w2ttfs_pool_fc
from repro_torch.kernels.w2ttfs_pool.ops import w2ttfs_plan

RTOL = ATOL = 1e-5
# [nb, M, K] trains: k = 64 padded to 128 (the stem's and res1's maps),
# ragged K and M
TRAINS = [(4, 200, 64), (2, 130, 300), (3, 77, 33)]


def spikes_np(rng, shape, density):
    """0/1 int8 spikes; with density > 0 column 31 of every word fires, so
    bit 31 (the sign of the word) is set in every word."""
    x = (rng.random(shape) < density).astype(np.int8)
    if density > 0:
        x[..., 31::32] = 1
    return x


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -------------------------------------------------------------- the pack
@pytest.mark.parametrize("shape", TRAINS)
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
def test_pack_trains_match_jax_and_the_lane_map(shape, density):
    """The port's pack of a [nb, M, K] train against JAX's Pallas pack in
    interpret mode, and the kernel's lane map (its twin) against both,
    each group of four words stored exactly once."""
    rng = np.random.default_rng([*shape, int(density * 10)])
    x = spikes_np(rng, shape, density)
    jp = jax_pack_spikes(jnp.asarray(x))
    tp = pack_spikes(torch.tensor(x))
    eq(tp.words, jp.words)
    eq(tp.vld_cnt, jp.vld_cnt)
    eq(tp.occ, jp.occ)
    words, vld, occ, stores = pack_lanes_twin(x, pack_plan(shape[-1]))
    eq(words, jp.words)
    eq(vld, jp.vld_cnt)
    eq(occ, jp.occ)
    assert (stores == 1).all()
    if density > 0:
        assert (words[:, :shape[1], :shape[2] // 32] < 0).all()


def test_gather16_twin_is_exact_on_every_01_pattern():
    """All 2**16 patterns of 16 zero/one bytes give their own bits; any
    nonzero byte value counts as a spike."""
    pat = np.arange(1 << 16)
    segs = ((pat[:, None] >> np.arange(16)) & 1).astype(np.int8)
    eq(gather16_twin(segs), pat)
    rng = np.random.default_rng(5)
    values = rng.choice(np.array([-128, -1, 1, 2, 64, 127], np.int8),
                        segs.shape)
    eq(gather16_twin(segs * values), pat)


@pytest.mark.parametrize("k", [1, 16, 31, 32, 48, 64, 96, 100, 128, 160,
                               256, 300, 384, 512, 640, 2048])
@pytest.mark.parametrize("m", [130, 700])
def test_pack_lane_map_covers_every_word_once(k, m):
    """For every k the lane map stores each row's four words of each block
    once (padded rows and columns too; units that run past the last row
    block store nothing there), its words and maps equal the plain pack's,
    and each load's row block is the one the kernel counts it in (the twin
    asserts it)."""
    rng = np.random.default_rng([k, m])
    x = spikes_np(rng, (2, m, k), 0.3)
    words, vld, occ, stores = pack_lanes_twin(x, pack_plan(k))
    ref = pack_spikes_ref(torch.tensor(x), with_occ=True)
    eq(words, ref.words)
    eq(vld, ref.vld_cnt)
    eq(occ, ref.occ)
    mp = -(-m // 128) * 128
    assert stores.shape == (2, mp, -(-k // 128)) and (stores == 1).all()


def test_pack_plan_at_the_main_path_widths():
    """k = 64 gives 4 segments a row (a warp covers 8 rows, no lane on the
    padding; a unit is 4 row blocks); 128, 256 and 512 give 8 (a unit is
    2 row blocks by one column block)."""
    assert [pack_plan(k) for k in (64, 128, 256, 512)] == [4, 8, 8, 8]
    assert [pack_plan(k) for k in (1, 32, 33, 300, 6144)] == [2, 2, 4, 8, 8]


# -------------------------------------------------------------- the head
SPIKE_DTYPES = [(torch.int8, jnp.int8), (torch.bfloat16, jnp.bfloat16),
                (torch.float32, jnp.float32)]


@pytest.mark.parametrize("b,h,c,window,classes", [(8, 4, 64, 4, 10),
                                                  (3, 4, 32, 2, 100)])
@pytest.mark.parametrize("dtypes", SPIKE_DTYPES, ids=["int8", "bf16", "f32"])
def test_w2ttfs_head_dtypes_match_jax(b, h, c, window, classes, dtypes):
    """The head on an int8, bf16 or f32 spike map against JAX's Pallas
    kernel in interpret mode on the same map (it casts inside its body)."""
    tdt, jdt = dtypes
    rng = np.random.default_rng([b, h, c, window, classes])
    s = (rng.random((b, h, h, c)) < 0.3).astype(np.float32)
    feats = (h // window) ** 2 * c
    fc_w = rng.standard_normal((feats, classes)).astype(np.float32)
    fc_b = rng.standard_normal(classes).astype(np.float32)
    got = w2ttfs_pool_fc(torch.tensor(s).to(tdt), torch.tensor(fc_w),
                         torch.tensor(fc_b), window=window)
    want = jax_w2ttfs(jnp.asarray(s).astype(jdt), jnp.asarray(fc_w),
                      jnp.asarray(fc_b), window=window)
    assert got.dtype == torch.float32 and got.shape == (b, classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_w2ttfs_head_int8_map_equals_f32_map_bitwise():
    """Under the plain version the logits of the int8 map (what the fused
    policies hand the head) equal those of the f32 and bf16 maps bit for
    bit: the window counts are exact integers in any dtype."""
    rng = np.random.default_rng(9)
    s = torch.tensor((rng.random((16, 4, 4, 64)) < 0.4).astype(np.int8))
    fc_w = torch.tensor(rng.standard_normal((64, 10)).astype(np.float32))
    fc_b = torch.tensor(rng.standard_normal(10).astype(np.float32))
    want = w2ttfs_pool_fc(s.to(torch.float32), fc_w, fc_b, window=4)
    for dt in (torch.int8, torch.bfloat16):
        assert torch.equal(w2ttfs_pool_fc(s.to(dt), fc_w, fc_b, window=4),
                           want)


def test_w2ttfs_plan():
    """256 images take 2 a CTA (128 CTAs on 132 SMs); the main path's
    512 x 10 fc_w and CIFAR-100's 512 x 100 are one shared-memory chunk; a
    wide map takes fewer images a CTA, a large fc_w chunks."""
    assert w2ttfs_plan(256, 512, 10) == (2, 512, 4 * (2 * 512 + 25 * 2 * 10
                                                       + 2 * 10 + 512 * 10))
    assert w2ttfs_plan(256, 512, 100).rows_chunk == 512
    assert w2ttfs_plan(256, 512, 100).smem <= 227 * 1024
    assert w2ttfs_plan(4096, 512, 10).block_b == 8
    assert w2ttfs_plan(4096, 8192, 10).block_b == 2
    assert w2ttfs_plan(301, 64, 10).block_b == 3
    big = w2ttfs_plan(8, 512, 1000)
    assert big.rows_chunk < 512 and big.smem <= 227 * 1024
