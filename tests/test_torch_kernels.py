"""The port's four kernel wrappers on the CPU (their plain versions) against
the JAX package: the JAX wrapper (Pallas in interpret mode, as
``tests/test_kernel_parity.py`` runs it) and the JAX ``ref.py``.

Inputs are numpy arrays made from a seed and handed to both frameworks.
Spike maps and ``vld_next`` maps must match exactly; a spike may differ
only where the membrane current lies within 1e-4 of ``v_th``, because the
two frameworks sum the f32 products in another order. f32 outputs match at
rtol 1e-5, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_pe import fused_pe as jax_fused_pe
from repro.kernels.fused_pe import fused_pe_ref as jax_fused_pe_ref
from repro.kernels.lif_update import lif_update as jax_lif_update
from repro.kernels.lif_update import lif_update_ref as jax_lif_update_ref
from repro.kernels.spike_matmul import spike_matmul as jax_spike_matmul
from repro.kernels.spike_matmul import spike_matmul_ref as jax_spike_matmul_ref
from repro.kernels.w2ttfs_pool import w2ttfs_pool_fc as jax_w2ttfs
from repro.kernels.w2ttfs_pool import w2ttfs_pool_fc_ref as jax_w2ttfs_ref
from repro_torch.kernels import _build
from repro_torch.kernels.fused_pe import fused_pe
from repro_torch.kernels.lif_update import lif_update
from repro_torch.kernels.spike_matmul import spike_matmul
from repro_torch.kernels.w2ttfs_pool import w2ttfs_pool_fc

RTOL = ATOL = 1e-5
NEAR_VTH = 1e-4
V_TH = 1.0
# fraction of zero entries; 1.0 is the all-silent map (every block skipped)
SPARSITY = [0.0, 0.5, 0.9, 1.0]


def spikes_np(rng, shape, sparsity, silent_row_block=True):
    """0/1 int8 map; the second 128-row block (when there is one) is
    silent, so the block skip runs even on a dense map."""
    x = (rng.random(shape) >= sparsity).astype(np.int8)
    if silent_row_block and shape[0] > 128:
        x[128:256] = 0
    return x


def assert_spikes_match(got, want, current, v_th=V_TH):
    """Equal spikes, except where ``current`` (the f64 membrane current)
    lies within ``NEAR_VTH`` of the threshold: there the order of the f32
    sums may decide the comparison."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    near = np.abs(np.asarray(current, np.float64) - v_th) < NEAR_VTH
    bad = (got != want) & ~near
    assert not bad.any(), f"{int(bad.sum())} spikes differ away from v_th"


def cpu(a):
    return torch.tensor(a)


# ------------------------------------------------------------- lif_update
@pytest.mark.parametrize("shape", [(37, 53), (256, 64)])
@pytest.mark.parametrize("sparsity", SPARSITY)
@pytest.mark.parametrize("soft_reset", [False, True])
def test_lif_update_matches_jax(shape, sparsity, soft_reset):
    rng = np.random.default_rng([*shape, int(sparsity * 10), int(soft_reset)])
    cur = (1.0 + rng.standard_normal(shape)).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    sp = 1 - spikes_np(rng, shape, sparsity, silent_row_block=False)
    kw = dict(tau=0.5, v_th=V_TH, soft_reset=soft_reset)
    spk, vn = lif_update(cpu(cur), cpu(vp), cpu(sp), **kw)
    assert spk.dtype == torch.int8 and vn.dtype == torch.float32
    v64 = 0.5 * vp.astype(np.float64) * (1 - sp) + cur
    for j_spk, j_vn in (jax_lif_update(jnp.asarray(cur), jnp.asarray(vp),
                                       jnp.asarray(sp), **kw),
                        jax_lif_update_ref(jnp.asarray(cur), jnp.asarray(vp),
                                           jnp.asarray(sp), **kw)):
        assert_spikes_match(spk.numpy(), j_spk, v64)
        same = np.asarray(j_spk) == spk.numpy()
        np.testing.assert_allclose(vn.numpy()[same], np.asarray(j_vn)[same],
                                   rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------- spike_matmul
@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (200, 150, 90),
                                   (1, 7, 5)])
@pytest.mark.parametrize("sparsity", SPARSITY)
def test_spike_matmul_matches_jax(m, k, n, sparsity):
    rng = np.random.default_rng(m * 1000 + k + int(sparsity * 10))
    x = spikes_np(rng, (m, k), sparsity)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    got = spike_matmul(cpu(x), cpu(w)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    for want in (jax_spike_matmul(jnp.asarray(x), jnp.asarray(w)),
                 jax_spike_matmul_ref(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    if sparsity == 1.0:
        assert not got.any()


def test_spike_matmul_takes_a_producers_vld_map():
    """A ``vld_cnt`` passed in is what the skip obeys: a block it marks
    silent contributes nothing, as in the JAX kernel."""
    rng = np.random.default_rng(7)
    x = spikes_np(rng, (256, 256), 0.5, silent_row_block=False)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    vld = np.array([[3, 0], [0, 5]], np.int32)
    got = spike_matmul(cpu(x), cpu(w), vld_cnt=cpu(vld)).numpy()
    want = jax_spike_matmul(jnp.asarray(x), jnp.asarray(w),
                            vld_cnt=jnp.asarray(vld))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="vld_cnt grid"):
        spike_matmul(cpu(x), cpu(w), vld_cnt=cpu(vld[:1]))


# --------------------------------------------------------------- fused_pe
FUSED_CASES = [
    # (m, k, n, bias, residual, q)
    (256, 256, 256, True, None, False),
    (200, 150, 90, True, "f32", False),
    (200, 150, 90, False, "int8", False),
    (130, 250, 70, True, None, True),
    (130, 250, 70, True, "int8", True),
]


@pytest.mark.parametrize("m,k,n,bias,residual,with_q", FUSED_CASES)
@pytest.mark.parametrize("sparsity", SPARSITY)
def test_fused_pe_matches_jax(m, k, n, bias, residual, with_q, sparsity):
    rng = np.random.default_rng(m + k + n + int(sparsity * 10))
    x = spikes_np(rng, (m, k), sparsity)
    w = (rng.standard_normal((k, n)) * (2.0 / np.sqrt(k))).astype(np.float32)
    b = ((0.6 + 0.4 * rng.standard_normal(n)).astype(np.float32)
         if bias else None)
    r = None
    if residual == "f32":
        r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
    elif residual == "int8":
        r = spikes_np(rng, (m, n), 0.7)
    # a sparse Q: the whole-row mask (rowsum >= 1) cuts some rows
    q = spikes_np(rng, (m, n), 0.99) if with_q else None
    if with_q:
        rows = (q.sum(axis=1) >= 1)
        assert rows.any() and not rows.all()

    def opt(a, conv):
        return None if a is None else conv(a)

    spk, vld = fused_pe(cpu(x), cpu(w), bias=opt(b, cpu),
                        residual=opt(r, cpu), q=opt(q, cpu), v_th=V_TH)
    assert spk.dtype == torch.int8 and vld.dtype == torch.int32
    cur = x.astype(np.float64) @ w.astype(np.float64)
    if b is not None:
        cur = cur + b
    if r is not None:
        cur = cur + r
    jkw = dict(bias=opt(b, jnp.asarray), residual=opt(r, jnp.asarray),
               q=opt(q, jnp.asarray), v_th=V_TH)
    j_out = jax_fused_pe(jnp.asarray(x), jnp.asarray(w), **jkw)
    j_spk, _, j_vld = jax_fused_pe_ref(jnp.asarray(x), jnp.asarray(w), **jkw)
    for want_spk, want_vld in ((j_out.spikes, j_out.vld_next),
                               (j_spk, j_vld)):
        assert_spikes_match(spk.numpy(), want_spk, cur)
        if (spk.numpy() == np.asarray(want_spk)).all():
            np.testing.assert_array_equal(vld.numpy(), np.asarray(want_vld))
    # vld_next is always the block count of the port's own spikes
    mp, np_ = -(-m // 128) * 128, -(-n // 128) * 128
    padded = np.zeros((mp, np_), np.int64)
    padded[:m, :n] = spk.numpy() != 0
    np.testing.assert_array_equal(
        vld.numpy(), padded.reshape(mp // 128, 128, np_ // 128, 128
                                    ).sum(axis=(1, 3)))
    if sparsity == 1.0 and b is None and r is None:
        assert not spk.any()


def test_fused_pe_vld_next_chains_into_the_next_layer():
    """The emitted map is the block count of the emitted spikes and drives
    the next layer's skip, as the JAX dataflow chains it."""
    rng = np.random.default_rng(3)
    x = spikes_np(rng, (256, 128), 0.5)
    w1 = (rng.standard_normal((128, 200)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((200, 64)) * 0.2).astype(np.float32)
    b1 = np.full(200, 0.9, np.float32)
    spk, vld = fused_pe(cpu(x), cpu(w1), bias=cpu(b1))
    j1 = jax_fused_pe(jnp.asarray(x), jnp.asarray(w1), bias=jnp.asarray(b1))
    np.testing.assert_array_equal(spk.numpy(), np.asarray(j1.spikes))
    np.testing.assert_array_equal(vld.numpy(), np.asarray(j1.vld_next))
    assert (vld.numpy() == 0).any() and (vld.numpy() > 0).any()
    out = spike_matmul(spk, cpu(w2), vld_cnt=vld).numpy()
    j2 = jax_spike_matmul(j1.spikes, jnp.asarray(w2), vld_cnt=j1.vld_next)
    np.testing.assert_allclose(out, np.asarray(j2), rtol=RTOL, atol=ATOL)


def test_bias_alone_never_fires_padded_rows_or_columns():
    """All-silent x with a bias above v_th: every valid neuron fires and
    no padded row or column does (the vld counts say so)."""
    x = torch.zeros((100, 40), dtype=torch.int8)
    w = torch.ones((40, 70))
    spk, vld = fused_pe(x, w, bias=torch.full((70,), 2.0))
    assert spk.shape == (100, 70) and bool(spk.all())
    assert vld.tolist() == [[100 * 70]]


# ------------------------------------------------------------ w2ttfs_pool
@pytest.mark.parametrize("b,h,c,window", [(3, 4, 32, 4), (5, 8, 16, 4),
                                          (2, 4, 8, 2)])
@pytest.mark.parametrize("sparsity", SPARSITY)
def test_w2ttfs_pool_matches_jax(b, h, c, window, sparsity):
    rng = np.random.default_rng(b * 100 + h + c + window)
    s = (rng.random((b, h, h, c)) >= sparsity).astype(np.float32)
    feats = (h // window) ** 2 * c
    fc_w = rng.standard_normal((feats, 10)).astype(np.float32)
    fc_b = rng.standard_normal(10).astype(np.float32)
    got = w2ttfs_pool_fc(cpu(s), cpu(fc_w), cpu(fc_b), window=window)
    assert got.dtype == torch.float32 and got.shape == (b, 10)
    args = (jnp.asarray(s), jnp.asarray(fc_w), jnp.asarray(fc_b))
    for want in (jax_w2ttfs(*args, window=window),
                 jax_w2ttfs_ref(*args, window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


# ------------------------------------------------------- the device split
def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    """On the CPU no wrapper counts a launch (and none needs the CUDA
    library, which this machine cannot build)."""
    _build.reset_launches()
    x = torch.ones((8, 8), dtype=torch.int8)
    w = torch.ones((8, 8))
    spike_matmul(x, w)
    fused_pe(x, w)
    lif_update(w, w, w)
    w2ttfs_pool_fc(torch.ones((1, 2, 2, 8)), torch.ones((8, 3)),
                   torch.zeros(3), window=2)
    assert set(_build.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("kernel", ["spike_matmul", "fused_pe",
                                    "lif_update", "w2ttfs_pool"])
def test_other_devices_raise_instead_of_falling_back(kernel):
    """A tensor that is neither on the CPU nor on a CUDA device is refused:
    no wrapper quietly runs its plain version for it."""
    _build.reset_launches()
    meta = dict(device="meta")
    x = torch.empty((8, 8), dtype=torch.int8, **meta)
    w = torch.empty((8, 8), **meta)
    call = {
        "spike_matmul": lambda: spike_matmul(x, w),
        "fused_pe": lambda: fused_pe(x, w),
        "lif_update": lambda: lif_update(w, w, w),
        "w2ttfs_pool": lambda: w2ttfs_pool_fc(
            torch.empty((1, 2, 2, 8), **meta), torch.empty((8, 3), **meta),
            torch.empty(3, **meta), window=2),
    }[kernel]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        call()
    assert _build.LAUNCHES[kernel] == 0
