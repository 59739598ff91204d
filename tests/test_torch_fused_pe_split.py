"""The fused PE's spike-x product as the tensor-core tile forms it
(``csrc/event_wgmma.cuh``), on the CPU: w split exactly into three bf16
terms, the 32-deep k steps of the route's walk (``k_steps``), and each
step's three products joined to the f32 sum (``split_product``).

The plain twin (``fused_pe_block_ref(..., split=True)``) is held against
JAX's ``fused_pe_pallas`` (interpret mode, through the JAX wrapper, as
``tests/test_torch_kernels.py`` runs it) on seeded numpy inputs: int8 and
packed x, with and without the LIF state and the emitted current, under
the three skips. Spikes are equal wherever the f64 membrane potential lies
farther than 1e-4 from v_th (the f32 sums run in another order); the
current and v_next agree within rtol 1e-5, atol 1e-4, the gates the card
holds the kernel to. The split is made once per weight (``weight_split``)
and again after an in-place update.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_pe import fused_pe as jax_fused_pe
from repro.kernels.packed import pack_spikes as jax_pack_spikes
from repro_torch.core.events import (compact_kmap, unpack_words,
                                    word_occupancy_map_dense)
from repro_torch.kernels import fused_pe as F
from repro_torch.kernels.spike_matmul import split_g_bf16x3
from repro_torch.kernels.spike_matmul.ref import block_skip_mask
from repro_torch.kernels.spike_matmul.ops import weight_operand
from test_torch_packed import to_torch_ps

RTOL, ATOL = 1e-5, 1e-4
NEAR_VTH = 1e-4
V_TH = 0.9


def spikes_np(rng, shape, density=0.3):
    """Seeded 0/1 int8 spikes; rows 128-255 silent where there are any, and
    every third 32-column stripe of rows 0-127, so the block and stripe
    skips have something to leave out."""
    x = (rng.random(shape) < density).astype(np.int8)
    if shape[0] > 128:
        x[128:256] = 0
    cols = np.arange(shape[1])
    x[:128, (cols // 32) % 3 == 1] = 0
    return x


def t(a):
    return None if a is None else torch.tensor(np.array(a))


def j(a):
    return None if a is None else jnp.asarray(a)


# (M, K, N): ragged in every dim, two column tiles, and bk 256's grid
SHAPES = [(200, 300, 130), (300, 257, 100), (260, 512, 200)]
# (packed x / residual / out, state: None, "hard" or "soft", emit_current,
# skip, residual, q)
CASES = [
    (False, None, False, "dense", "f32", True),
    (False, None, True, "gated", None, False),
    (False, "hard", False, "two_level", "f32", False),
    (False, "soft", True, "dense", "spikes", True),
    (False, "hard", True, "gated", "f32", True),
    (True, None, False, "dense", "spikes", True),
    (True, None, True, "two_level", None, False),
    (True, "soft", False, "gated", "spikes", True),
    (True, "hard", True, "dense", "spikes", False),
    (True, "soft", True, "two_level", "f32", True),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_split_twin_matches_pallas(case):
    packed, state, emit, skip, res, with_q = CASES[case]
    m, k, n = SHAPES[case % len(SHAPES)]
    block_k = 256 if k == 512 else 128
    rng = np.random.default_rng(700 + case)
    x = spikes_np(rng, (m, k), 0.25)
    w = (rng.standard_normal((k, n)) * 2.0 / np.sqrt(k)).astype(np.float32)
    b = (0.3 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    r = None
    if res == "f32":
        r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
    elif res == "spikes":
        r = spikes_np(rng, (m, n), 0.3)
    q = (rng.random((m, 64)) < 0.02).astype(np.int8) if with_q else None
    v = s = None
    kw = dict(v_th=V_TH, out_format="packed" if packed else "dense",
              skip=skip, block_k=block_k, emit_current=emit)
    if state is not None:
        v = rng.standard_normal((m, n)).astype(np.float32)
        s = (rng.random((m, n)) < 0.5).astype(np.int8)
        kw.update(tau=0.7 if state == "soft" else 0.5,
                  soft_reset=state == "soft")
    jx, jr, jq = j(x), j(r), j(q)
    tx, tr, tq = t(x), t(r), t(q)
    if packed:
        jx = jax_pack_spikes(jx, block_k=block_k)
        tx = to_torch_ps(jx)
        if res == "spikes":
            jr = jax_pack_spikes(jr)
            tr = to_torch_ps(jr)
        if q is not None:
            jq = jax_pack_spikes(jq)
            tq = to_torch_ps(jq)
    jo = jax_fused_pe(jx, j(w), bias=j(b), residual=jr, q=jq, v_prev=j(v),
                      s_prev=j(s), **kw)
    args = F.fused_pe_operands(tx, t(w), bias=t(b), residual=tr, q=tq,
                               v_prev=t(v), s_prev=t(s), **kw)
    outs = F.fused_pe_block_ref(*args, split=True)
    spk = unpack_words(outs[0]) if packed else outs[0]
    j_spk = np.asarray(jo.spikes.words if packed else jo.spikes)
    if packed:
        j_spk = np.asarray(unpack_words(torch.tensor(j_spk)))
    spk, j_spk = spk[:m, :n].numpy(), j_spk[:m, :n]

    # the f64 membrane potential, before the threshold
    cur = x.astype(np.float64) @ w.astype(np.float64) + b
    if r is not None:
        cur = cur + r
    pot = cur
    if state is not None:
        pot = kw["tau"] * v.astype(np.float64) * (1.0 - s) + cur
    near = np.abs(pot - V_TH) < NEAR_VTH
    assert not ((spk != j_spk) & ~near).any()
    assert 0 < int(spk.sum()) < m * n
    rest = list(outs[2:])
    if state is not None:
        np.testing.assert_allclose(rest.pop(0).numpy(), np.asarray(jo.v_next),
                                   rtol=RTOL, atol=ATOL)
    if emit:
        np.testing.assert_allclose(rest.pop(0).numpy(),
                                   np.asarray(jo.current), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("skip", ["gated", "two_level"])
@pytest.mark.parametrize("block_k", [128, 256])
def test_split_twin_same_bits_under_every_skip(skip, block_k):
    """The twin's product under a gated walk is the dense skip's bit for
    bit: a step the walk leaves out has an all-zero x, whose three products
    would have joined the sum as exact zeros."""
    rng = np.random.default_rng(block_k)
    m, k, n = 384, 768, 130
    x = spikes_np(rng, (m, k), 0.3)
    x[256:, 256:] = 0                         # a silent block past row 256
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    kw = dict(block_k=block_k, emit_current=True, v_th=V_TH)
    dense = F.fused_pe_operands(t(x), t(w), **kw)
    gated = F.fused_pe_operands(t(x), t(w), skip=skip, **kw)
    d_out = F.fused_pe_block_ref(*dense, split=True)
    g_out = F.fused_pe_block_ref(*gated, split=True)
    assert all(torch.equal(a, c) for a, c in zip(d_out, g_out))


def test_split_is_exact_and_a_single_spike_reads_its_row():
    """w1 + w2 + w3 is w for normal weights, each term a bf16, and a row of
    x with one spike gives that row of w exactly."""
    rng = np.random.default_rng(5)
    w = torch.tensor((rng.standard_normal((256, 128)) * 0.05)
                     .astype(np.float32))
    w[0, :4] = torch.tensor([3.0e38, -1e-30, 2.0 ** -100, 0.0])
    ws = F.split_weight(w)
    assert ws.shape == (3, 256, 128) and ws.dtype == torch.bfloat16
    assert torch.equal((ws[0].float() + ws[1].float()) + ws[2].float(), w)
    assert all(torch.equal(a, c) for a, c in zip(ws, split_g_bf16x3(w)))
    x = torch.zeros((128, 256), dtype=torch.int8)
    x[torch.arange(128), torch.arange(128) * 2] = 1
    vld = torch.ones((1, 2), dtype=torch.int32)
    out = F.split_product(x, w, vld)
    assert torch.equal(out, w[torch.arange(128) * 2])


@pytest.mark.parametrize("state", [False, True])
def test_split_twin_rechecks_the_near_threshold_outputs(state):
    """An output whose membrane potential lies within RECHECK_BAND of v_th
    takes the scalar tile's ascending chain (``sequential_product``), as
    the kernel's recheck does; every other output the three-term sum."""
    rng = np.random.default_rng(13)
    m, k, n = 256, 300, 130
    x = t(spikes_np(rng, (m, k), 0.3))
    w = t((rng.standard_normal((k, n)) * 0.1).astype(np.float32))
    b = t((0.3 * rng.standard_normal(n)).astype(np.float32))
    kw = dict(bias=b, emit_current=True)
    if state:
        kw.update(v_prev=t(rng.standard_normal((m, n)).astype(np.float32)),
                  s_prev=t((rng.random((m, n)) < 0.5).astype(np.int8)),
                  tau=0.7)
    xp, wp, vld, bp = F.fused_pe_operands(x, w, **kw)[:4]
    split = (F.split_product(xp, wp, vld) + bp)[:m, :n]
    seq = (F.sequential_product(xp, wp, block_skip_mask(vld, xp.shape))
           + bp)[:m, :n]
    v = split if not state else 0.7 * kw["v_prev"] * (
        1.0 - kw["s_prev"].float()) + split
    v_th = float(v[5, 7])             # one output exactly at the threshold
    args = F.fused_pe_operands(x, w, v_th=v_th, **kw)
    cur = F.fused_pe_block_ref(*args, split=True)[-1]
    near = (v - v_th).abs() < F.RECHECK_BAND
    assert bool(near[5, 7]) and int(near.sum()) < m * n // 10
    assert torch.equal(cur[near], seq[near])
    assert torch.equal(cur[~near], split[~near])


def _vld(rng, gm, gk):
    vld = (rng.random((gm, gk)) < 0.6).astype(np.int32) * 7
    vld[1] = 0                                 # a wholly silent row block
    return torch.tensor(vld)


@pytest.mark.parametrize("bk", [128, 256])
def test_k_steps_cover_each_kept_block_once(bk):
    """The walk visits every 32-deep step of each block the dense skip
    keeps, once, in ascending k, stripe-aligned; the gated walk the same
    steps; the two-level walk exactly those whose occ bit is set."""
    rng = np.random.default_rng(bk)
    gm, gk = 4, 5
    vld = _vld(rng, gm, gk)
    nact, kmap = compact_kmap(vld)
    occ = torch.tensor(rng.integers(0, 1 << (bk // 32), (gm, gk)),
                       dtype=torch.int32)
    per = bk // F.STEP
    for rb in range(gm):
        dense = F.k_steps(vld, None, bk, rb)
        kept = [kb for kb in range(gk) if vld[rb, kb] != 0]
        assert dense == [kb * bk + s * F.STEP for kb in kept
                         for s in range(per)]
        assert dense == sorted(set(dense))
        assert all(k0 % F.STEP == 0 for k0 in dense)
        assert F.k_steps(vld, (nact, kmap, None), bk, rb) == dense
        two = F.k_steps(vld, (nact, kmap, occ), bk, rb)
        assert two == [k0 for k0 in dense
                       if (int(occ[rb, k0 // bk]) >> (k0 % bk // F.STEP)) & 1]
    assert F.k_steps(vld, None, bk, 1) == []


def test_k_steps_two_level_skips_only_silent_stripes():
    """On a real occupancy map the two-level walk leaves out exactly the
    steps whose 32 columns are silent in every row of the block."""
    rng = np.random.default_rng(9)
    x = torch.tensor(spikes_np(rng, (384, 512), 0.05))
    vld = F.fused_pe_operands(x, torch.zeros((512, 64)))[2]
    nact, kmap = compact_kmap(vld)
    occ = word_occupancy_map_dense(x, 128, 128)
    for rb in range(3):
        steps = F.k_steps(vld, (nact, kmap, occ), 128, rb)
        rows = x[128 * rb:128 * rb + 128]
        live = [k0 for k0 in range(0, 512, F.STEP)
                if bool(rows[:, k0:k0 + F.STEP].any())]
        assert steps == live


def test_weight_split_made_once_per_parameter_set():
    """The split is cached on the caller's w: two launches' operands share
    one split; an in-place update of w makes a new one, of the new values;
    another padding makes its own."""
    rng = np.random.default_rng(11)
    x = torch.tensor(spikes_np(rng, (200, 300)))
    w = torch.tensor((rng.standard_normal((300, 100)) * 0.1)
                     .astype(np.float32))
    first = F.fused_pe_operands(x, w)[15]
    assert F.fused_pe_operands(x, w)[15] is first
    assert F.fused_pe_operands(x, w.clone())[15] is not first
    wide = F.fused_pe_operands(x, w, block_n=256)[15]
    assert wide is not first and wide.shape == (3, 384, 256)
    with torch.no_grad():
        w.add_(0.25)
    again = F.fused_pe_operands(x, w)[15]
    assert again is not first
    assert torch.equal(again, F.split_weight(weight_operand(w, 384)))
    assert F.fused_pe_operands(x, w)[15] is again
    # a float x reads w itself
    assert F.fused_pe_operands(x.float(), w)[15] is None


@pytest.mark.parametrize("packed", [False, True])
def test_train_steps_are_views_of_one_copy(packed):
    """A train laid out once (``train_operands``): each step's launch reads
    its x and residual operands, and the steps before it, as views of that
    one copy, and gives the outputs of operands padded step by step; a
    step past the first, asked for it, also returns the state it decided
    on (the plain version's: v_prev)."""
    from repro_torch.kernels.packed import pack_spikes_ref

    rng = np.random.default_rng(13)
    steps, m, k, n = 3, 200, 300, 100
    x = torch.tensor(np.stack([spikes_np(rng, (m, k)) for _ in range(steps)]))
    w = torch.tensor((rng.standard_normal((k, n)) * 2.0 / np.sqrt(k))
                     .astype(np.float32))
    if packed:
        x = pack_spikes_ref(x)
        r = pack_spikes_ref(torch.tensor(
            np.stack([spikes_np(rng, (m, n)) for _ in range(steps)])))
    else:
        r = torch.tensor((0.5 * rng.standard_normal((steps, m, n)))
                         .astype(np.float32))
    xh, rh = F.train_operands(x, r, 128, 128)
    v = torch.tensor(rng.standard_normal((m, n)).astype(np.float32))
    s = torch.tensor((rng.random((m, n)) < 0.5).astype(np.int8))
    for ti in range(steps):
        kw = dict(residual=r[ti], v_prev=v, s_prev=s, v_th=V_TH,
                  emit_current=True)
        args = F.fused_pe_operands(x[ti], w, train=(xh, rh, ti), **kw)
        assert args[0].data_ptr() == xh[ti].data_ptr()
        assert args[4].data_ptr() == rh[ti].data_ptr()
        state = args[14]
        if ti == 0:
            assert state.x_hist is None and state.r_hist is None
        else:
            assert state.x_hist.data_ptr() == xh.data_ptr()
            assert state.r_hist.data_ptr() == rh.data_ptr()
            assert state.x_hist.shape[0] == state.r_hist.shape[0] == ti
        out = F.fused_pe_block_ref(*args, state_out=True)
        alone = F.fused_pe_block_ref(*F.fused_pe_operands(x[ti], w, **kw))
        assert len(F.fused_pe_block_ref(*args)) == len(alone)
        assert len(out) == len(alone) + (ti > 0)
        assert all(torch.equal(a, c) for a, c in zip(out, alone))
        if ti > 0:
            assert torch.equal(out[-1], v)
    if not packed:   # a step that is not the padded operand is refused
        with pytest.raises(ValueError, match="padded"):
            F.fused_pe_operands(x[0], w, v_prev=v, s_prev=s,
                                train=(xh[:, :, :128], None, 0))


@pytest.mark.parametrize("policy", ["fused_dense", "fused_packed"])
def test_forwards_of_one_model_share_one_split(policy, monkeypatch):
    """The spike-x tile's bf16 split is made once per conv parameter: a
    second forward of the same deployed model (the conv matrix a reshape
    of the parameter, or, packed, a padded copy of it) makes none."""
    from repro_torch.kernels.fused_pe import ops as fops
    from repro_torch.models import snn_cnn as tsnn

    made = []
    split = fops.split_weight
    monkeypatch.setattr(fops, "split_weight",
                        lambda wp: made.append(wp.shape) or split(wp))
    cfg = tsnn.SNNCNNConfig(arch="qkfresnet11", image_size=16,
                            width_mult=0.125)
    fused = tsnn.fuse_model(
        tsnn.init(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg)
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        first, _, _ = tsnn.forward(fused, x, cfg, policy=policy)
        once = len(made)
        again, _, _ = tsnn.forward(fused, x, cfg, policy=policy)
    assert once > 0
    assert len(made) == once
    assert torch.equal(first, again)


def test_lif_step_takes_the_forward_spikes():
    """The training step's backward on the forward's own spikes (a spike
    the kernel decided on a replayed state): their values are the
    forward's, the reset follows them, and the surrogate gradient through
    the membrane potential is the one the re-thresholded step has."""
    from repro_torch.core.lif import LIFConfig
    from repro_torch.ops.grad import _lif_step

    cfg = LIFConfig()
    base = torch.tensor([0.99, 1.01, 0.5, 1.7])
    fired = torch.tensor([1.0, 0.0, 0.0, 1.0])
    zeros = torch.zeros(4)
    cur = base.clone().requires_grad_(True)
    s, v_next = _lif_step(cur, zeros, zeros, cfg, fired=fired)
    assert torch.equal(s.detach(), fired)
    assert torch.equal(v_next.detach(), base * (1.0 - fired))
    g = torch.autograd.grad(s.sum(), cur)[0]
    ref = base.clone().requires_grad_(True)
    s_ref, _ = _lif_step(ref, zeros, zeros, cfg)
    assert torch.equal(s_ref.detach(), (base >= cfg.v_th).float())
    assert torch.equal(g, torch.autograd.grad(s_ref.sum(), ref)[0])
