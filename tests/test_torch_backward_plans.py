"""The KD backward's spike-matmul kernels on the CPU: the arithmetic the dw
kernel runs on the tensor cores, and the cut of the work both kernels plan
in Python.

* ``split_g_bf16x3``, the twin of the dw kernel's split of g into three bf16
  terms: the terms sum back to g exactly for |g| >= 2**-110 (every term
  within bf16's range; below it the last term's bits run under bf16's
  least step, and the sum is within half of it, 2**-134, of g), over f32
  bit patterns, up to the largest finite f32 (the first two terms round
  toward zero, so neither they nor their sum overflow).
* ``spike_matmul_dw_split_ref``, dw as the kernel forms it (three products
  of exact bf16 terms), against JAX's ``spike_matmul_dw_pallas`` and
  ``spike_matmul_dw_gated_pallas`` in interpret mode, within the gate
  ``chip_smoke.py`` holds the kernel to: DW_C sqrt(n) u |x|^T |g|, n the
  chain of f32 adds the wrapper's plan gives (``dw_plan(...).chain``).
* ``dw_plan`` and ``dx_plan``: every 128-row block of M in exactly one
  run, every column of K and N in exactly one tile, the chain length, and
  dx's tile widths at the training path's K.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from repro.core.events import block_count_map_2d as jax_count
from repro.core.events import compact_kmap as jax_compact_kmap
from repro.core.events import word_occupancy_map_dense as jax_occ
from repro.kernels.spike_matmul.backward import (spike_matmul_dw_gated_pallas,
                                                 spike_matmul_dw_pallas)
from repro_torch.kernels.spike_matmul import (DW_TILE_K, DW_TILE_N, TILE,
                                              dw_plan, dx_plan,
                                              spike_matmul_dw_split_ref,
                                              split_g_bf16x3, vld_map)

DW_C = 3.0          # chip_smoke.DW_C: the dw gate's constant
U = 2.0 ** -24      # f32's unit roundoff
EXACT_FROM = 2.0 ** -110
# the KD step's dx / dw launches (M, K, N): the fused PE passes and the
# shortcut matmuls of QKFResNet-11 at batch 256, and ragged ones
PATH = [(262144, 576, 64), (65536, 576, 128), (65536, 1152, 128),
        (16384, 1152, 256), (16384, 2304, 256), (4096, 2304, 512),
        (4096, 4608, 512), (4096, 512, 512), (65536, 64, 128),
        (16384, 128, 256), (4096, 256, 512)]
RAGGED = [(4059, 500, 300), (4059, 200, 300), (300, 201, 150), (1, 1, 1),
          (129, 129, 65)]


def _split_sum(g: torch.Tensor) -> torch.Tensor:
    g1, g2, g3 = split_g_bf16x3(g)
    assert g1.dtype == g2.dtype == g3.dtype == torch.bfloat16
    part = g1.float() + g2.float()
    assert bool(torch.isfinite(part).all())
    return part + g3.float()


def _check_split(g: torch.Tensor) -> None:
    got = _split_sum(g)
    exact = g.abs() >= EXACT_FROM
    assert torch.equal(got[exact], g[exact])
    assert float((got - g).abs().max()) <= 2.0 ** -134


def _f32(bits: np.ndarray) -> torch.Tensor:
    return torch.tensor(bits.astype(np.uint32).view(np.float32).copy())


def test_split_bf16x3_sums_back_on_random_bit_patterns():
    """A million finite f32 bit patterns, every exponent, both signs, and
    the extremes: zero, the least subnormal, the least normal, 2**-110 and
    the largest finite value."""
    rng = np.random.default_rng(20)
    bits = rng.integers(0, 2 ** 32, 1_000_000, dtype=np.uint64)
    g = _f32(bits)
    g = g[torch.isfinite(g)]
    assert g.numel() > 990_000
    _check_split(g)
    edges = np.array([0, 1, 0x00800000, 0x08800000, 0x7F7FFFFF, 0x7F7F8000,
                      0x7F7F7FFF, 0x3F800001, 0x3F80FFFF], dtype=np.uint64)
    _check_split(torch.cat([_f32(edges), -_f32(edges)]))


@given(st.integers(min_value=0, max_value=1),
       st.integers(min_value=0, max_value=254),
       st.integers(min_value=0, max_value=2 ** 23 - 1))
def test_split_bf16x3_property(sign, exponent, mantissa):
    """Any finite f32 (sign, biased exponent, mantissa): the terms are g's
    high 16 bits, those of the remainder r = g - g1, and r - g2 rounded to
    nearest, and they sum back to g (within 2**-134 below 2**-110)."""
    bits = np.array([(sign << 31) | (exponent << 23) | mantissa],
                    dtype=np.uint64)
    g = _f32(bits)
    g1, g2, g3 = split_g_bf16x3(g)
    high = (g.view(torch.int32) & -65536).view(torch.float32)
    assert torch.equal(g1.float(), high)
    r = g - high
    assert torch.equal(g2.float(),
                       (r.view(torch.int32) & -65536).view(torch.float32))
    assert torch.equal(g3, (r - g2.float()).to(torch.bfloat16))
    _check_split(g)


# ------------------------------------------------- dw against JAX's kernels
def _spikes(rng, m, k, density):
    x = (rng.random((m, k)) < density).astype(np.int8)
    x[128:256] = 0                       # a silent row block
    x[:, 256:384] = 0                    # a silent column block
    return x


def _limit(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    m, k = x.shape
    chain = dw_plan(m, k, g.shape[1]).chain
    return DW_C * math.sqrt(chain) * U * (np.abs(x.astype(np.float64)).T
                                          @ np.abs(g.astype(np.float64)))


def _within(got: torch.Tensor, want, limit: np.ndarray) -> None:
    diff = np.abs(got.numpy().astype(np.float64)
                  - np.asarray(want, np.float64))
    assert bool((diff <= limit).all()), float((diff - limit).max())


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("m,k,n", [(512, 512, 128), (1024, 384, 256)])
def test_three_piece_dw_matches_pallas(m, k, n, density):
    rng = np.random.default_rng([m, k, int(density * 10)])
    x = _spikes(rng, m, k, density)
    g = rng.standard_normal((m, n)).astype(np.float32)
    g[::7] *= 1e3                       # rows of other scales
    xi = jnp.asarray(x)
    want = spike_matmul_dw_pallas(xi, jnp.asarray(g),
                                  jax_count(xi, TILE, TILE), interpret=True)
    xt = torch.tensor(x)
    got = spike_matmul_dw_split_ref(xt, torch.tensor(g), vld_map(xt))
    _within(got, want, _limit(x, g))
    exact = x.astype(np.float64).T @ g.astype(np.float64)
    _within(got, exact, _limit(x, g))
    if density == 0.0:
        assert not bool(got.any())


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("density", [0.1, 0.5])
def test_three_piece_dw_matches_gated_pallas(density, two_level):
    m, k, n = 768, 512, 128
    rng = np.random.default_rng([int(density * 10), int(two_level)])
    x = _spikes(rng, m, k, density)
    x[:, 32:64] = 0                      # a silent stripe: occ bits clear
    g = rng.standard_normal((m, n)).astype(np.float32)
    xi = jnp.asarray(x)
    nact_t, mmap = jax_compact_kmap(jax_count(xi, TILE, TILE).T)
    occ = jax_occ(xi, TILE, TILE) if two_level else None
    want = spike_matmul_dw_gated_pallas(xi, jnp.asarray(g), nact_t, mmap, occ,
                                        two_level=two_level, interpret=True)
    xt = torch.tensor(x)
    got = spike_matmul_dw_split_ref(xt, torch.tensor(g), vld_map(xt))
    _within(got, want, _limit(x, g))


# ------------------------------------------------------------- the planners
@pytest.mark.parametrize("m,k,n", PATH + RAGGED)
def test_dw_plan_cuts_every_block_once(m, k, n):
    plan = dw_plan(m, k, n)
    gm = max(1, -(-m // TILE))
    runs = [range(s * plan.per, min(gm, (s + 1) * plan.per))
            for s in range(plan.splits)]
    assert all(len(r) > 0 for r in runs)
    seen = [b for r in runs for b in r]
    assert seen == list(range(gm))       # every block once, in order
    # the CTAs' tiles: 128 rows of dw (one vld column block) by 64 columns
    k_tiles = [range(i * DW_TILE_K, (i + 1) * DW_TILE_K)
               for i in range(-(-k // DW_TILE_K))]
    n_tiles = [range(i * DW_TILE_N, (i + 1) * DW_TILE_N)
               for i in range(-(-n // DW_TILE_N))]
    assert [c for t in k_tiles for c in t][:k] == list(range(k))
    assert [c for t in n_tiles for c in t][:n] == list(range(n))
    assert len(k_tiles) * DW_TILE_K - k < DW_TILE_K
    assert len(n_tiles) * DW_TILE_N - n < DW_TILE_N
    # a 16-row slice's three wgmma accumulations, the run's adds of its
    # slices (4 a block: a warpgroup's 64 rows), the warpgroups' sum, then
    # the partials
    assert plan.chain == 3 + (TILE // 2 // 16) * plan.per + 1 + plan.splits


def test_dw_plan_tiles_res1_unpadded_in_n():
    """N = 64 (res1) is one 64-wide n tile, not half of a 128-wide one."""
    assert -(-64 // DW_TILE_N) * DW_TILE_N == 64


@pytest.mark.parametrize("m,k,n", PATH + RAGGED)
def test_dx_plan_covers_k_once(m, k, n):
    plan = dx_plan(m, n, k)
    assert plan.block_k in (64, 128, 192)
    assert plan.mtiles == max(1, -(-m // TILE))
    assert (plan.ktiles - 1) * plan.block_k < max(k, 1) \
        <= plan.ktiles * plan.block_k
    cols = [c for t in range(plan.ktiles)
            for c in range(t * plan.block_k, (t + 1) * plan.block_k)]
    assert cols[:k] == list(range(k))


@pytest.mark.parametrize("m,k,n", [s for s in PATH if s[1] % 192 == 0])
def test_dx_plan_leaves_no_padded_column_at_the_path_k(m, k, n):
    """K = 576 .. 4608 (9 * 64 channels and up) are cut in 192-wide tiles
    with no padded column; the old 128-wide tiles computed 640 at res1."""
    plan = dx_plan(m, n, k)
    assert plan.block_k == 192 and plan.ktiles * 192 == k
