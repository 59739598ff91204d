"""The spike matmul's tile (``csrc/spike_matmul.cu``) on the CPU: what
surrounds the kernel, and its arithmetic, against the JAX package.

  * ``tile_plan`` cuts every output into exactly one tile, 128 rows by 64,
    128 or 192 columns, with no padded column at N = 64 .. 512;
  * the tile's operands (x at its own rows and K, w read in place) give
    the plain result of the 128-padded operands the tile took before;
  * JAX's ``spike_matmul_pallas`` and ``spike_matmul_gated_pallas`` (in
    interpret mode, through JAX's wrapper) against the port at ragged
    shapes, K = 64 under a 128-wide block, int8 and packed x, all three
    skips (rtol 1e-5, atol 1e-5: the f32 sums run in another order);
  * ``tile_steps``, the twin of the kernel's k walk, visits only kept steps
    below K, ascending, and its chain over them is the plain chain
    (``sequential_product``) bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed import pack_spikes as jax_pack_spikes
from repro.kernels.spike_matmul import spike_matmul as jax_spike_matmul
from repro_torch.core import events as tev
from repro_torch.kernels.spike_matmul.ref import sequential_product
from repro_torch.kernels.spike_matmul import ops as S
from repro_torch.kernels.spike_matmul import ref as R

RTOL = ATOL = 1e-5
SKIPS = ("dense", "gated", "two_level")


def spikes_np(rng, m, k, block_k, density=0.3):
    """0/1 int8 spikes with row block 1 silent, about half the other
    (128, block_k) blocks silent, and the 32-column stripes (s + row block)
    % 3 == 0 clear inside every block (the two-level skip's target)."""
    x = rng.random((m, k)) < density
    gm, gk = -(-m // 128), -(-k // block_k)
    keep = rng.random((gm, gk)) >= 0.5
    keep[min(1, gm - 1)] = False
    stripes = (np.arange(-(-k // 32))[None, :] + np.arange(gm)[:, None]) % 3
    rows, cols = np.arange(m) // 128, np.arange(k)
    x &= keep[rows][:, cols // block_k] & (stripes[rows][:, cols // 32] != 0)
    return x.astype(np.int8)


def port_x(x: np.ndarray, packed: bool, block_k: int):
    t = torch.tensor(x)
    return tev.pack_spikes_ref(t, block_k=block_k) if packed else t


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("n", [64, 128, 192, 256, 512])
@pytest.mark.parametrize("k", [64, 128, 576, 1152, 2304, 4608])
@pytest.mark.parametrize("m", [248, 4096, 16384, 65536, 262144])
def test_tile_plan_covers_every_output_once(m, n, k):
    plan = S.tile_plan(m, n, k)
    assert plan.block_n in (64, 128, 192)
    assert (plan.mtiles - 1) * 128 < m <= plan.mtiles * 128
    assert (plan.ntiles - 1) * plan.block_n < n <= plan.ntiles * plan.block_n
    # each column in exactly one tile: the tiles' column ranges partition
    # [0, ntiles * block_n), and the columns past N are none of N's
    cover = np.zeros(plan.ntiles * plan.block_n, np.int64)
    for t in range(plan.ntiles):
        cover[t * plan.block_n:(t + 1) * plan.block_n] += 1
    assert (cover == 1).all()
    assert n % plan.block_n == 0, "a padded column"
    if n == 64:
        assert plan.block_n == 64


def test_tile_plan_widths_at_the_main_path_shapes():
    """The shortcuts take 128-wide tiles, the res1 convs 64-wide ones."""
    assert S.tile_plan(65536, 128, 64).block_n == 128
    assert S.tile_plan(16384, 256, 128).block_n == 128
    assert S.tile_plan(4096, 512, 256).block_n == 128
    assert S.tile_plan(262144, 64, 576).block_n == 64


# -------------------------------------------------------------- operands
OPERAND_CASES = [
    # (m, k, n, block_k, block_n)
    (260, 64, 128, 128, 128),     # res2's shortcut: K = 64 under bk 128
    (300, 200, 150, 128, 128),
    (130, 500, 70, 256, 256),
    (129, 37, 5, 128, 128),       # K not a multiple of 16
]


@pytest.mark.parametrize("m,k,n,block_k,block_n", OPERAND_CASES)
@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("packed", [False, True])
def test_unpadded_operands_give_the_padded_result(m, k, n, block_k, block_n,
                                                  skip, packed):
    rng = np.random.default_rng([m, k, n, len(skip), int(packed)])
    x = spikes_np(rng, m, k, block_k)
    w = torch.tensor(rng.standard_normal((k, n)).astype(np.float32))
    tx = port_x(x, packed, block_k)
    args = S.spike_matmul_operands(tx, w, block_n=block_n, block_k=block_k,
                                   skip=skip)
    xp, wf, route, pk = args
    assert pk == packed and wf is w            # w read in place
    if not packed:
        assert xp.dtype == torch.int8 and xp.shape[0] == m
        assert k <= xp.shape[1] < k + S.X_ROW_ALIGN
        assert xp.shape[1] % S.X_ROW_ALIGN == 0
    # the operands the tile took before: an int8 x padded to whole blocks
    # (a packed x's words, as now), w padded to whole blocks
    old_x = xp if packed else tev.pad_to_blocks(torch.tensor(x), 128,
                                                block_k)
    kp = old_x.shape[1] * (tev.LANE_BITS if packed else 1)
    old_w = S.weight_operand(w, kp, block_k, block_n)
    gated = skip != "dense"
    plain = S.spike_matmul_gated_block_ref if gated else \
        S.spike_matmul_block_ref
    new = plain(*args)
    old = plain(old_x, old_w, route, packed)
    assert new.shape == (xp.shape[0], n)
    torch.testing.assert_close(new[:m], old[:m, :n], rtol=RTOL, atol=ATOL)
    # the same masked map and weights: the chain the kernel forms is the same
    # bit for bit
    kw = dict(gate=route) if gated else dict(vld=route)
    nx = R.x_map(xp, packed, k)
    ox = R.x_map(old_x, packed, kp)
    nmask = R.launch_mask(*nx.shape, **kw)
    omask = R.launch_mask(*ox.shape, **kw)
    assert torch.equal((nx * nmask)[:m], (ox * omask)[:m, :k])
    assert not bool((ox * omask)[:, k:].any())
    assert torch.equal(sequential_product(nx, w, nmask)[:m],
                       sequential_product(ox, old_w, omask)[:m, :n])


# --------------------------------------------------------------------- JAX
JAX_CASES = [
    # (m, k, n, block_k)
    (260, 64, 100, 128),
    (140, 300, 70, 256),
]


@pytest.mark.parametrize("m,k,n,block_k", JAX_CASES)
@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("packed", [False, True])
def test_spike_matmul_matches_jax_at_ragged_shapes(m, k, n, block_k, skip,
                                                   packed):
    rng = np.random.default_rng([m, k, n, block_k, len(skip), int(packed)])
    x = spikes_np(rng, m, k, block_k)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    blocks = dict(block_n=128, block_k=block_k)
    jx = (jax_pack_spikes(jnp.asarray(x), block_k=block_k) if packed
          else jnp.asarray(x))
    want = jax_spike_matmul(jx, jnp.asarray(w), skip=skip, block_m=128,
                            **blocks)
    got = S.spike_matmul(port_x(x, packed, block_k), torch.tensor(w),
                         skip=skip, **blocks)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------------ k walk
WALK_CASES = [(64, 128), (200, 128), (500, 256), (1152, 128)]


@pytest.mark.parametrize("k,block_k", WALK_CASES)
@pytest.mark.parametrize("skip", SKIPS)
def test_tile_walk_visits_kept_steps_below_k_ascending(k, block_k, skip):
    m, n = 300, 24
    rng = np.random.default_rng([k, block_k, len(skip)])
    x = spikes_np(rng, m, k, block_k)
    w = torch.tensor(rng.standard_normal((k, n)).astype(np.float32))
    xp, wf, route, _ = S.spike_matmul_operands(
        torch.tensor(x), w, block_k=block_k, skip=skip)
    kw = dict(gate=route) if skip != "dense" else dict(vld=route)
    mask = R.launch_mask(*R.x_map(xp, False, k).shape, **kw)
    out = torch.zeros((m, n), dtype=torch.float32)
    for rb in range(-(-m // 128)):
        steps = R.tile_steps(k, rb, **kw)
        assert steps == sorted(set(steps)) and all(0 <= s < k for s in steps)
        assert all(s % 32 == 0 for s in steps)
        rows = slice(128 * rb, min(m, 128 * rb + 128))
        # exactly the stripes the route keeps below K
        kept = [s for s in range(0, k, 32) if bool(mask[rows.start, s])]
        assert steps == kept
        xs = torch.tensor(x[rows]).to(torch.float32)
        acc = torch.zeros((xs.shape[0], n), dtype=torch.float32)
        for s in steps:
            for kk in range(s, min(s + 32, k)):
                acc = acc + xs[:, kk:kk + 1] * w[kk]
        out[rows] = acc
    assert torch.equal(out, sequential_product(torch.tensor(x), w,
                                               mask[:m]))
