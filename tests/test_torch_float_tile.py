"""The fused PE's float-x tile (``csrc/event_gemm.cuh``, launched from
``csrc/fused_pe_float.cu``) on the CPU: what surrounds the kernel, and its
function, against the JAX package.

  * ``float_tile_plan`` cuts every output into exactly one 64 x 256 tile,
    and ``float_tile_runs`` gives each tile to exactly one CTA; at the LM
    training step's [1032, 2048] @ [2048, 2048] its CTAs fit one wave of
    132 SMs at the resident CTAs it assumes, each about one full tile's
    cost;
  * a float x's operands (x and q at their own rows, no vld map) give the
    plain result of the 128-row-padded operands the tile took before;
  * JAX's ``fused_pe_pallas`` (in interpret mode, through JAX's wrapper)
    against the port's CPU path on a dense f32 x at ragged rows (65, 137,
    200), the head-blocked mask with q int8 and packed, the emitted
    current, and 128- and 256-wide count tiles (rtol = atol = 1e-5 on the
    currents: the f32 sums run in another order; spikes equal away from
    v_th, and vld_next the block counts of the spikes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.kernels.fused_pe import fused_pe as jax_fused_pe
from repro_torch.core import events as tev
from repro_torch.kernels import fused_pe as F
from repro_torch.kernels.fused_pe import ops as FO

RTOL = ATOL = 1e-5
V_TH = 1.0
NEAR_VTH = 1e-4


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("n", [128, 256, 384, 2048, 4096])
@pytest.mark.parametrize("m", [1, 31, 33, 64, 65, 129, 248, 1024, 1032,
                               4096, 16384])
def test_float_tile_plan_covers_every_output_once(m, n):
    plan = F.float_tile_plan(m, n, 2048)
    assert (plan.block_m, plan.block_n) == (64, 256)
    assert (plan.mtiles - 1) * 64 < max(m, 1) <= plan.mtiles * 64
    assert (plan.ntiles - 1) * 256 < n <= plan.ntiles * 256
    assert plan.full == (plan.mtiles - 1) * plan.ntiles
    runs = F.float_tile_runs(plan)
    assert len(runs) == plan.ctas <= FO.SMS * FO.FLOAT_TILE_RESIDENT
    # the runs partition the tiles, in order, and the tiles the outputs
    tiles = [t for r in runs for t in r]
    assert tiles == list(range(plan.mtiles * plan.ntiles))
    cover = np.zeros((plan.mtiles * 64, plan.ntiles * 256), np.int64)
    for t in tiles:
        r, c = divmod(t, plan.ntiles)
        cover[64 * r:64 * r + 64, 256 * c:256 * c + 256] += 1
    assert (cover == 1).all()
    # each CTA's run costs at most one full tile more than the average
    cost = [plan.cost(r.stop) - plan.cost(r.start) for r in runs]
    total = plan.cost(plan.mtiles * plan.ntiles)
    assert sum(cost) == total
    assert max(cost) <= -(-total // plan.ctas) + 2


def test_float_tile_plan_at_the_lm_step_is_one_balanced_wave():
    """8 x 129 rows: 128 full tiles and 8 tail tiles of 8 live rows, 132
    CTAs, each a full tile or two tail tiles (2 halves of a tile's time);
    at 1024 rows 128 CTAs of one tile each."""
    plan = F.float_tile_plan(1032, 2048, 2048)
    assert (plan.mtiles, plan.ntiles, plan.full, plan.tail) == (17, 8, 128, 1)
    assert plan.ctas == 132 <= FO.SMS * FO.FLOAT_TILE_RESIDENT
    runs = F.float_tile_runs(plan)
    assert all(plan.cost(r.stop) - plan.cost(r.start) == 2 for r in runs)
    assert [len(r) for r in runs] == [1] * 128 + [2] * 4
    plan = F.float_tile_plan(1024, 2048, 2048)
    assert (plan.ctas, plan.full, plan.tail) == (128, 120, 2)
    assert [len(r) for r in F.float_tile_runs(plan)] == [1] * 128
    # more tiles than SMs: every SM busy, runs within one tile of each other
    plan = F.float_tile_plan(16384, 2048, 2048)
    lengths = {len(r) for r in F.float_tile_runs(plan)}
    assert plan.ctas == 132 and lengths <= {15, 16}


# -------------------------------------------------------------- operands
def _float_case(rng, m, k, n, dtype, q_kind, h, dh):
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
    w = torch.tensor((rng.standard_normal((k, n)) / np.sqrt(k)).astype(
        np.float32))
    qs = torch.tensor((rng.random((m, n)) < 0.3).astype(np.int8))
    q = {None: None, "int8": qs, "packed": tev.pack_spikes_ref(qs)}[q_kind]
    kw = dict(q=q, qk_threshold=float(dh) * 0.3,
              heads=None if q is None else (h, dh))
    return x, w, kw


OPERAND_CASES = [(65, 200, 144, torch.float32, "int8", 3, 48),
                 (137, 128, 256, torch.bfloat16, "packed", 4, 64),
                 (200, 384, 300, torch.float32, None, 1, 300),
                 (1, 64, 128, torch.bfloat16, "int8", 2, 64)]


@pytest.mark.parametrize("m,k,n,dtype,q_kind,h,dh", OPERAND_CASES)
@pytest.mark.parametrize("block_n", [128, 256])
@pytest.mark.parametrize("emit", [False, True])
def test_own_row_operands_give_the_padded_result(m, k, n, dtype, q_kind, h,
                                                 dh, block_n, emit):
    """x and q at their own rows and no vld map (x's columns padded to the
    block, copied only then), and the same launch on the operands the tile
    took before (rows padded to 128, an all-ones vld map): the plain
    version gives the same outputs, bit for bit."""
    rng = np.random.default_rng(m + k + n)
    x, w, kw = _float_case(rng, m, k, n, dtype, q_kind, h, dh)
    bias = torch.tensor(rng.standard_normal(n).astype(np.float32)) * 0.1
    for fmt in ("dense", "packed"):
        args = F.fused_pe_operands(x, w, bias=bias, out_format=fmt,
                                   emit_current=emit, block_n=block_n, **kw)
        xp, vld, qp = args[0], args[2], args[5]
        assert xp.shape == (m, -(-k // 128) * 128) and vld is None
        assert xp.data_ptr() % 16 == 0
        if qp is not None:
            assert qp.shape[0] == (128 * -(-m // 128) if q_kind == "packed"
                                   else m)
        old = (tev.pad_to_blocks(xp, 128, 1),
               args[1], torch.ones((-(-m // 128), xp.shape[1] // 128),
                                   dtype=torch.int32), *args[3:5],
               None if qp is None else tev.pad_to_blocks(qp, 128, 1),
               *args[6:])
        padded = F.fused_pe_tile_operands(args)
        for got, want in zip(padded, old):
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want)
        a, b = F.fused_pe_block_ref(*args), F.fused_pe_block_ref(*old)
        assert len(a) == len(b) == 2 + emit
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        spikes, vld_next = F.fused_pe(x, w, bias=bias, out_format=fmt,
                                      emit_current=emit, block_n=block_n,
                                      **kw)[:2]
        words = spikes.words if fmt == "packed" else spikes
        want = a[0] if fmt == "packed" else a[0][:m, :n]
        assert torch.equal(words, want) and torch.equal(vld_next, a[1])


# ------------------------------------------------------------- against JAX
JAX_CASES = [(65, 192, 4, 64, None, 128),
             (137, 256, 4, 64, "int8", 256),
             (200, 160, 3, 48, "packed", 128),
             (200, 320, 4, 64, "int8", 256)]


@pytest.mark.parametrize("m,k,h,dh,q_kind,block_n", JAX_CASES)
def test_float_x_matches_jax_at_ragged_rows(m, k, h, dh, q_kind, block_n):
    """The port's CPU path (the plain version on the float-x tile's
    operands) against JAX's ``fused_pe_pallas`` in interpret mode through
    JAX's wrapper, on a dense f32 x with the emitted current, int8 and
    packed out."""
    rng = np.random.default_rng(m * 3 + k)
    n = h * dh
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    qs = (rng.random((m, n)) < 0.3).astype(np.int8)
    kw = dict(v_th=V_TH, emit_current=True, block_n=block_n)
    tq = jq = None
    if q_kind is not None:
        kw.update(qk_threshold=float(dh) * 0.3, heads=(h, dh))
        tq = (tev.pack_spikes_ref(torch.tensor(qs)) if q_kind == "packed"
              else torch.tensor(qs))
        jq = (jev.pack_spikes_ref(jnp.asarray(qs)) if q_kind == "packed"
              else jnp.asarray(qs))
    cur64 = x.astype(np.float64) @ w.astype(np.float64)
    for fmt in ("dense", "packed"):
        spk, vld, cur = F.fused_pe(torch.tensor(x), torch.tensor(w), q=tq,
                                   out_format=fmt, **kw)
        j = jax_fused_pe(jnp.asarray(x), jnp.asarray(w), q=jq,
                         out_format=fmt, interpret=True, **kw)
        np.testing.assert_allclose(cur.numpy(), np.asarray(j.current),
                                   rtol=RTOL, atol=ATOL)
        if fmt == "packed":
            got = tev.unpack_spikes_ref(spk).numpy()
            want = np.asarray(jev.unpack_spikes_ref(j.spikes))
        else:
            got, want = spk.numpy(), np.asarray(j.spikes)
        near = np.abs(cur64 - V_TH) < NEAR_VTH
        assert not ((got != want) & ~near).any()
        own = tev.block_count_map_2d(tev.pad_to_blocks(
            torch.tensor(got), 128, block_n), 128, block_n)
        np.testing.assert_array_equal(vld.numpy(), own.numpy())
        if not (got != want).any():
            np.testing.assert_array_equal(vld.numpy(),
                                          np.asarray(j.vld_next))
        assert 0 < got.mean() < 0.5
