"""The scalar flash attention route and the unpack kernel on the CPU:
their plans, their lane maps and their arithmetic, against the JAX package.

- ``flash_plan``: the scalar route's query rows a CTA and its grid at the
  timed shapes (B 1, H 16, S 248 / 512 / 2048 / 8192), and ``flash_cta``'s
  order (the longest causal q tiles first, every CTA once).
- ``flash_tile_twin``, the route's blocking order (q tiles of the plan's
  rows, 64-key tiles, the running m / l / acc update a tile), against JAX's
  Pallas kernel in interpret mode at S 64 and 300, f32, D 32 / 96 / 112,
  causal and full, at rtol = atol = 1e-5 (f32 sums in another order); with
  q scaled by 8, against the f64 result within twice the plain version's
  own error (the GPU tests' witness).
- ``pick_route``: bf16 at a head dim TMA can address (D % 8 == 0) takes
  the wgmma route at the next instance; the rest the scalar route.
- ``unpack_plan`` and the unpack kernel's lane map (``unpack_lanes_twin``):
  every element of the extent stored once, nothing past it, every word of
  the extent loaded once (none of the padding), bits equal to
  ``unpack_words``; and ``unpack_spikes_ref`` in int8 / bf16 / f32 against
  JAX's ``unpack_spikes_pallas(..., dtype=...)`` in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.packed import unpack_spikes_pallas
from repro_torch.kernels.flash_attention import (attention_ref, flash_cta,
                                                 flash_plan, flash_tile_twin,
                                                 pick_route, wgmma_instance)
from repro_torch.kernels.packed import ops as P
from repro_torch.kernels.packed.ref import (pack_spikes_ref,
                                            unpack_lanes_twin,
                                            unpack_spikes_ref, unpack_words)

RTOL = ATOL = 1e-5


def _qkv(seed, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, s, h, d)).astype(np.float32),
            rng.standard_normal((1, s, hkv, d)).astype(np.float32),
            rng.standard_normal((1, s, hkv, d)).astype(np.float32))


# ----------------------------------------------------------- flash plan
# (B, S, H) -> (rows a CTA, CTAs): the timed shapes (B 1, H 16) and two
# more; 132 SMs
PLANS = [((1, 248, 16), (32, 128)), ((1, 512, 16), (32, 256)),
         ((1, 2048, 16), (128, 256)), ((1, 8192, 16), (128, 1024)),
         ((1, 1024, 16), (64, 256)), ((4, 300, 32), (128, 384))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_flash_plan_fills_the_card(shape, want):
    b, s, h = shape
    plan = flash_plan(b, s, h)
    assert (plan.rows, plan.ctas) == want
    assert plan.q_tiles == -(-s // plan.rows)
    assert plan.ctas >= 132 or plan.rows == 32


@pytest.mark.parametrize("shape", [s for s, _ in PLANS[:4]])
def test_flash_cta_order_is_longest_first(shape):
    """Each (q tile, b * H + h) once, the q tiles non-increasing over the
    grid, so the causal sweeps start longest first."""
    b, s, h = shape
    plan = flash_plan(b, s, h)
    ctas = [flash_cta(plan, b * h, i) for i in range(plan.ctas)]
    assert sorted(ctas) == [(t, bh) for t in range(plan.q_tiles)
                            for bh in range(b * h)]
    tiles = [t for t, _ in ctas]
    assert tiles == sorted(tiles, reverse=True)


# (S, H, Hkv, D, causal): the twin at the plan's rows against JAX's kernel
TWIN_CASES = [(s, h, hkv, d, causal) for s, h, hkv in ((64, 2, 1),
                                                       (300, 2, 2))
              for d in (32, 96, 112) for causal in (True, False)]


@pytest.mark.parametrize("s,h,hkv,d,causal", TWIN_CASES)
def test_flash_tile_twin_matches_jax(s, h, hkv, d, causal):
    q, k, v = _qkv(s + d + h, s, h, hkv, d)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), q_block=s,
                     kv_block=s, causal=causal, interpret=True)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    for rows in {flash_plan(1, s, h).rows, 128}:
        got = flash_tile_twin(tq, tk, tv, causal, rows=rows)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def _attention_f64(q, k, v, causal):
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qh = torch.tensor(q).double().transpose(1, 2)
    kh, vh = (torch.tensor(t).double().repeat_interleave(g, dim=2)
              .transpose(1, 2) for t in (k, v))
    sc = (qh @ kh.transpose(-1, -2)) * d ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones((s, s), dtype=torch.bool).tril(),
                            -1e300)
    return (torch.softmax(sc, dim=-1) @ vh).transpose(1, 2)


@pytest.mark.parametrize("s,h,hkv,d,causal", [(300, 2, 1, 112, True),
                                              (256, 2, 2, 96, False),
                                              (64, 2, 1, 128, True)])
def test_flash_tile_twin_scaled_against_f64(s, h, hkv, d, causal):
    """q scaled by 8: the twin's error against the f64 result within twice
    the plain version's (``_flash_witness`` in the GPU tests)."""
    q, k, v = _qkv(s * d, s, h, hkv, d)
    q = q * np.float32(8.0)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    exact = _attention_f64(q, k, v, causal)
    got = flash_tile_twin(tq, tk, tv, causal, rows=flash_plan(1, s, h).rows)
    plain = attention_ref(tq, tk, tv, causal=causal)
    err = (got.double() - exact).abs().max().item()
    err_plain = (plain.double() - exact).abs().max().item()
    assert err <= 2 * err_plain, (err, err_plain)


# (D, route, wgmma instance): bf16 at D % 8 == 0 on the wgmma route at the
# smallest instance that holds D; a row TMA cannot address (D % 8 != 0)
# on the scalar route
ROUTES = [(48, "wgmma", 64), (96, "wgmma", 128), (112, "wgmma", 128),
          (32, "wgmma", 32), (64, "wgmma", 64), (128, "wgmma", 128),
          (16, "wgmma", 32), (44, "scalar", None), (36, "scalar", None),
          (100, "scalar", None)]


@pytest.mark.parametrize("d,route,inst", ROUTES)
def test_pick_route_pads_bf16_to_a_wgmma_instance(d, route, inst):
    q = torch.zeros((1, 2, 2, d), dtype=torch.bfloat16)
    assert pick_route(q) == route
    if inst is not None:
        assert wgmma_instance(d) == inst
    assert pick_route(q.float()) == "scalar"


# ------------------------------------------------------------- unpacker
# (nb, m, k): the packed KD step's maps (k 64, 128, 256, 512), k 640, and
# ragged ones
UNPACK_SHAPES = [(1, 300, 64), (2, 130, 128), (1, 129, 256), (1, 40, 512),
                 (2, 77, 640), (1, 50, 96), (3, 33, 33), (1, 129, 200)]
PER_CHUNK = {torch.int8: 16, torch.bfloat16: 8, torch.float32: 4}


@pytest.mark.parametrize("k,g", [(64, 64), (128, 128), (256, 128),
                                 (512, 128), (640, 128), (192, 64),
                                 (96, 32), (33, 0), (200, 0), (1, 0)])
def test_unpack_plan(k, g):
    assert P.unpack_plan(k) == g


def test_unpack_segment_halves_where_unaligned():
    assert P.unpack_segment(512, 16, 0, 0) == 128
    assert P.unpack_segment(512, 16, 8, 0) == 64        # words 8-byte aligned
    assert P.unpack_segment(512, 16, 4, 0) == 32
    assert P.unpack_segment(512, 16, 0, 4) == 0         # out misaligned
    assert P.unpack_segment(512, 6, 0, 0) == 64         # rows of 6 words
    assert P.unpack_segment(33, 4, 0, 0) == 0


def _packed(seed, nb, m, k, density=0.3):
    rng = np.random.default_rng(seed)
    x = (rng.random((nb, m, k)) < density).astype(np.int8)
    if k >= 32:
        x[..., 31::32] = 1                  # every word's sign bit
    return pack_spikes_ref(torch.tensor(x)), x


@pytest.mark.parametrize("dtype", list(PER_CHUNK))
@pytest.mark.parametrize("nb,m,k", UNPACK_SHAPES)
def test_unpack_lane_map_covers_the_extent_once(nb, m, k, dtype):
    ps, x = _packed(nb * m + k, nb, m, k)
    words = ps.words.numpy()
    g = P.unpack_plan(k)
    bits, stores, loads = unpack_lanes_twin(words, m, k, g, PER_CHUNK[dtype])
    np.testing.assert_array_equal(bits, x)
    np.testing.assert_array_equal(
        bits, unpack_words(ps.words)[..., :m, :k].numpy())
    assert (stores == 1).all()
    need = -(-k // 32)
    assert loads[:, m:].sum() == 0 and loads[..., need:].sum() == 0
    assert (loads[:, :m, :need] == 1).all() if g else \
        (loads[:, :m, :need] >= 1).all()


@pytest.mark.parametrize("dtype", [(torch.int8, jnp.int8),
                                   (torch.bfloat16, jnp.bfloat16),
                                   (torch.float32, jnp.float32)])
@pytest.mark.parametrize("m,k", [(300, 64), (130, 640), (40, 33)])
def test_unpack_ref_matches_jax_in_each_dtype(m, k, dtype):
    tdt, jdt = dtype
    ps, x = _packed(m + k, 1, m, k)
    want = np.asarray(unpack_spikes_pallas(
        jnp.asarray(ps.words[0].numpy()), dtype=jdt,
        interpret=True))[:m, :k].astype(np.float32)
    got = unpack_spikes_ref(ps, tdt)
    assert got.dtype == tdt and got.shape == (1, m, k)
    np.testing.assert_array_equal(got[0].float().numpy(), want)
    np.testing.assert_array_equal(got[0].float().numpy(), x[0])
    assert torch.equal(P.unpack_spikes(ps, dtype=tdt), got)
