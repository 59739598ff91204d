"""Card-only checks of the port: each hand-written kernel, and each packed
variant, against its plain version on the GPU, the deployed forward's
launch counts under ``fused_dense`` and ``fused_packed``, and the KD
training step on the card against the same step on the plain versions.
Marked ``gpu``; without a CUDA device every test skips. On a machine with
one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Imports only torch and the port, so it runs where JAX is not installed.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

# the KD training kernels, which an inference forward never launches, the
# softmax attention kernel, which only ops.attention launches, and the
# gated routes, which only the auto policies or an explicit skip launch
NO_BACKWARD = {"spike_matmul_dx": 0, "spike_matmul_dw": 0, "qk_attention": 0,
               "flash_attention": 0,
               "fused_pe_gated": 0, "spike_matmul_gated": 0,
               "spike_matmul_dw_gated": 0}


@pytest.fixture
def cuda():
    """The card; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _spikes(gen, m, k, density, dev):
    x = torch.rand((m, k), generator=gen, device=dev) < density
    x[128:256] = False                        # one silent row block
    return x.to(torch.int8)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
def test_spike_matmul_kernel_matches_plain(cuda, density):
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _spikes(gen, 300, 200, density, cuda)
    w = torch.randn((200, 150), generator=gen, device=cuda)
    args = K.spike_matmul_operands(x, w)
    torch.testing.assert_close(K.spike_matmul_cuda(*args),
                               K.spike_matmul_block_ref(*args),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
def test_fused_pe_kernel_matches_plain(cuda, density):
    from repro_torch.core.events import block_count_map_2d
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.spike_matmul import spike_matmul_block_ref

    gen = torch.Generator(device=cuda).manual_seed(1)
    m, k, n = 300, 200, 150
    x = _spikes(gen, m, k, density, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.15
    b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=cuda)
    r = 0.5 * torch.randn((m, n), generator=gen, device=cuda)
    q = _spikes(gen, m, n, 0.005, cuda)
    args = K.fused_pe_operands(x, w, bias=b, residual=r, q=q)
    spk, vld = K.fused_pe_cuda(*args)
    ref_spk, _ = K.fused_pe_block_ref(*args)
    cur = spike_matmul_block_ref(*args[:3]) + args[3] + args[4]
    near = (cur - 1.0).abs() < 1e-4
    assert not bool(((spk != ref_spk) & ~near).any())
    # the kernel's per-tile count of its own spikes, flips near v_th or not
    assert torch.equal(vld, block_count_map_2d(spk, 128, 128))


def test_lif_update_kernel_matches_plain(cuda):
    from repro_torch.kernels import lif_update as K

    gen = torch.Generator(device=cuda).manual_seed(2)
    n = 100003
    cur = 1.0 + torch.randn((n,), generator=gen, device=cuda)
    vp = torch.randn((n,), generator=gen, device=cuda)
    sp = (torch.rand((n,), generator=gen, device=cuda) < 0.3).float()
    for soft in (False, True):
        spk, vn = K.lif_update_cuda(cur, vp, sp, 0.5, 1.0, soft)
        ref_spk, ref_vn = K.lif_update_ref(cur, vp, sp, 0.5, 1.0, soft)
        assert torch.equal(spk, ref_spk) and torch.equal(vn, ref_vn)


def test_w2ttfs_kernel_matches_plain(cuda):
    from repro_torch.kernels import w2ttfs_pool as K

    gen = torch.Generator(device=cuda).manual_seed(3)
    s = (torch.rand((5, 8, 8, 64), generator=gen, device=cuda) < 0.3).float()
    fc_w = torch.randn((4 * 64, 10), generator=gen, device=cuda)
    fc_b = torch.randn((10,), generator=gen, device=cuda)
    torch.testing.assert_close(K.w2ttfs_pool_cuda(s, fc_w, fc_b, 4),
                               K.w2ttfs_pool_fc_ref(s, fc_w, fc_b, 4),
                               rtol=1e-5, atol=1e-4)


def test_fused_forward_launches_every_kernel(cuda):
    from repro_torch.kernels import _build
    from repro_torch.models import snn_cnn

    cfg = snn_cnn.SNNCNNConfig(arch="qkfresnet11", width_mult=0.125,
                               image_size=16)
    fused = snn_cnn.fuse_model(
        snn_cnn.init(torch.Generator().manual_seed(0), cfg), cfg)
    img = torch.rand((2, 16, 16, 3), device=cuda)
    _build.reset_launches()
    logits, _, _ = snn_cnn.forward(fused, img, cfg, policy="fused_dense")
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"lif_update": 1, "fused_pe": 13,
                                     "spike_matmul": 3, "w2ttfs_pool": 1,
                                     "pack_spikes": 0, "unpack_spikes": 0,
                                     **NO_BACKWARD}
    ref, _, _ = snn_cnn.forward(fused, img, cfg, policy="reference")
    assert logits.device.type == "cuda"
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-5)


def test_packed_forward_launches_every_kernel(cuda):
    """Under fused_packed the forward packs once, unpacks once, and runs
    every fused PE pass and shortcut matmul on packed operands; its spikes
    are those of fused_dense, so the logits are too."""
    from repro_torch.kernels import _build
    from repro_torch.models import snn_cnn

    cfg = snn_cnn.SNNCNNConfig(arch="qkfresnet11", width_mult=0.125,
                               image_size=16)
    fused = snn_cnn.fuse_model(
        snn_cnn.init(torch.Generator().manual_seed(0), cfg), cfg)
    img = torch.rand((2, 16, 16, 3), device=cuda)
    dense, _, d_aux = snn_cnn.forward(fused, img, cfg, policy="fused_dense")
    _build.reset_launches()
    with _build.capture_launches() as captured:
        logits, _, aux = snn_cnn.forward(fused, img, cfg,
                                         policy="fused_packed")
        torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"lif_update": 1, "fused_pe": 13,
                                     "spike_matmul": 3, "w2ttfs_pool": 1,
                                     "pack_spikes": 1, "unpack_spikes": 1,
                                     **NO_BACKWARD}
    for name, args, _, _ in captured:
        if name == "fused_pe":
            assert args[10].x and args[10].out
        elif name == "spike_matmul":
            assert args[3] is True
    assert torch.equal(logits, dense)
    for key in d_aux["spikes"]:
        assert float(aux["spikes"][key]) == float(d_aux["spikes"][key]), key


# ------------------------------------------------------------ packed format
def _ragged_spikes(gen, shape, density, dev):
    """0/1 int8 spikes; with density > 0 column 31 of every word fires, so
    bit 31 (the sign of the word) is exercised."""
    x = torch.rand(shape, generator=gen, device=dev) < density
    if density > 0:
        x[..., 31::32] = True
    return x.to(torch.int8)


@pytest.mark.parametrize("shape", [(262144, 64), (3, 300, 200), (130, 33)])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_pack_unpack_kernels_match_plain(cuda, shape, density):
    from repro_torch.core.events import check_packed_invariants
    from repro_torch.kernels import packed as P

    gen = torch.Generator(device=cuda).manual_seed(4)
    x = _ragged_spikes(gen, shape, density, cuda)
    x3 = x.reshape(-1, *shape[-2:])
    words, vld, occ = P.pack_spikes_cuda(x3)
    ref = P.pack_spikes_ref(x3, with_occ=True)
    assert torch.equal(words, ref.words)
    assert torch.equal(vld, ref.vld_cnt) and torch.equal(occ, ref.occ)
    assert torch.equal(P.unpack_spikes_cuda(words), P.unpack_words(words))
    ps = P.pack_spikes(x)
    assert check_packed_invariants(ps)["ok"]
    assert torch.equal(P.unpack_spikes(ps), x)        # exact round trip


FUSED_PACKINGS = [
    # (packed x, packed q, packed residual, packed out); None = no operand
    (True, None, None, False), (False, None, None, True),
    (True, None, None, True), (True, True, None, True),
    (True, None, True, True), (False, True, None, False),
    (False, None, True, False), (True, False, False, True),
]


@pytest.mark.parametrize("px,pq,pr,pout", FUSED_PACKINGS)
@pytest.mark.parametrize("density", [0.1, 0.5])
def test_fused_pe_packed_variants_match_plain(cuda, px, pq, pr, pout,
                                              density):
    """Each packed variant against the plain version (which unpacks, runs
    the dense plain version and packs). Spikes must agree away from v_th;
    vld_next and the packed output's invariants are checked whatever the
    spikes do."""
    from repro_torch.core.events import (PackedSpikes,
                                         check_packed_invariants,
                                         pack_spikes_ref, popcount_block_map,
                                         unpack_words)
    from repro_torch.core.events import block_count_map_2d
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.spike_matmul import spike_matmul_block_ref

    gen = torch.Generator(device=cuda).manual_seed(5)
    m, k, n = 300, 200, 150
    x = _spikes(gen, m, k, density, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.15
    b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=cuda)
    q = r = None
    if pq is not None:
        q = _spikes(gen, m, n, 0.005, cuda)
        q = pack_spikes_ref(q) if pq else q
    if pr is not None:
        r = _spikes(gen, m, n, 0.3, cuda)
        r = pack_spikes_ref(r) if pr else r
    xs = pack_spikes_ref(x) if px else x
    args = K.fused_pe_operands(xs, w, bias=b, residual=r, q=q,
                               out_format="packed" if pout else "dense")
    spk, vld = K.fused_pe_cuda(*args)
    ref_spk, ref_vld = K.fused_pe_block_ref(*args)
    packing = args[10]
    dense_of = (lambda t: unpack_words(t)) if pout else (lambda t: t)
    xp = unpack_words(args[0]) if px else args[0]
    res = 0.0
    if args[4] is not None:
        res = unpack_words(args[4], torch.float32) if pr else args[4]
    cur = spike_matmul_block_ref(xp, args[1], args[2]) + args[3] + res
    near = (cur - 1.0).abs() < 1e-4
    assert not bool(((dense_of(spk) != dense_of(ref_spk)) & ~near).any())
    if pout:
        out = PackedSpikes(spk, vld, (m, n))
        assert check_packed_invariants(out)["ok"]
        assert torch.equal(vld, popcount_block_map(spk, 128, 128))
    else:
        assert torch.equal(vld, block_count_map_2d(spk, 128, 128))
    assert packing.flags == (int(px) | int(bool(pq)) << 1
                             | int(bool(pr)) << 2 | int(pout) << 3)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
def test_spike_matmul_packed_matches_plain(cuda, density):
    from repro_torch.core.events import pack_spikes_ref
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _spikes(gen, 300, 200, density, cuda)
    w = torch.randn((200, 150), generator=gen, device=cuda)
    args = K.spike_matmul_operands(pack_spikes_ref(x), w)
    assert args[-1] is True
    out = K.spike_matmul_cuda(*args)
    torch.testing.assert_close(out, K.spike_matmul_block_ref(*args),
                               rtol=1e-5, atol=1e-4)
    dense = K.spike_matmul_cuda(*K.spike_matmul_operands(x, w))
    assert torch.equal(out[:300, :150], dense[:300, :150])


# ---------------------------------------------------------- KD training
@pytest.mark.parametrize("surrogate", ["atan", "sigmoid", "triangle", "rect",
                                       None])
@pytest.mark.parametrize("m,n,k", [(300, 150, 200), (1024, 64, 576)])
def test_spike_matmul_dx_kernel_matches_plain(cuda, surrogate, m, n, k):
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(10)
    g = torch.randn((m, n), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda)
    v = None if surrogate is None else \
        1.0 + 0.5 * torch.randn((m, n), generator=gen, device=cuda)
    surr = surrogate or "atan"
    dx, dv = K.spike_matmul_dx_cuda(g, w, v, surr, 2.0, 1.0)
    rdx, rdv = K.spike_matmul_dx_ref(g, w, v, surrogate=surr, alpha=2.0,
                                     v_th=1.0)
    torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dv, rdv, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("m,n,k", [(300, 150, 200), (8192, 64, 576)])
def test_spike_matmul_dw_kernel_matches_plain(cuda, density, m, n, k):
    """Within tolerance of the plain version, the same bits on a second
    launch, and exactly 0 where x is silent."""
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(11)
    x = _spikes(gen, m, k, density, cuda)
    x[:, :128] = 0                           # a silent k block: dw rows 0
    g = torch.randn((m, n), generator=gen, device=cuda)
    vld = K.vld_map(x)
    dw = K.spike_matmul_dw_cuda(x, g, vld)
    torch.testing.assert_close(dw, K.spike_matmul_dw_ref(x, g, vld),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(dw, K.spike_matmul_dw_cuda(x, g, vld))
    assert not bool(dw[:128].any())


# (M, K, N) of the KD step's dx and dw launches (QKFResNet-11 at batch
# 256: the fused PE passes, then the shortcut matmuls) and ragged ones: M
# not a multiple of 128, K % 4 != 0 (dx's scalar stores, dw's byte-wise x
# copies), K % 16 != 0 (dw's 4-byte copies), N % 4 != 0 (scalar loads)
BACKWARD_SHAPES = [(262144, 576, 64), (65536, 576, 128), (65536, 1152, 128),
                   (16384, 1152, 256), (16384, 2304, 256), (4096, 2304, 512),
                   (4096, 4608, 512), (4096, 512, 512), (65536, 64, 128),
                   (16384, 128, 256), (4096, 256, 512), (4059, 500, 300),
                   (4059, 200, 300), (300, 201, 150), (1000, 130, 66)]


@pytest.mark.parametrize("surrogate", ["atan", "sigmoid", "triangle", "rect",
                                       None])
@pytest.mark.parametrize("m,k,n", BACKWARD_SHAPES)
def test_dx_kernel_at_path_shapes(cuda, m, k, n, surrogate):
    """dx and dv within rtol 1e-5, atol 1e-4 of the plain version at every
    tile width the planner picks, for the four surrogates and without v."""
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    g = torch.randn((m, n), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * (2.0 / k ** 0.5)
    v = None if surrogate is None else \
        1.0 + 0.5 * torch.randn((m, n), generator=gen, device=cuda)
    surr = surrogate or "atan"
    dx, dv = K.spike_matmul_dx_cuda(g, w, v, surr, 2.0, 1.0)
    rdx, rdv = K.spike_matmul_dx_ref(g, w, v, surrogate=surr, alpha=2.0,
                                     v_th=1.0)
    torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dv, rdv, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,n", BACKWARD_SHAPES)
def test_dw_kernel_at_path_shapes(cuda, m, k, n):
    """dw within the f64 gate of chip_smoke.check_dw (3 sqrt(n) u |x|^T|g|,
    n the plan's chain of adds); the same bits on a second launch, under
    the gated and two-level walks, and for packed x under every skip; NaN
    in the g rows of wholly silent row blocks changes no bit."""
    from repro_torch.kernels import spike_matmul as K
    from repro_torch.kernels.packed import pack_spikes

    gen = torch.Generator(device=cuda).manual_seed(m + 2 * k + 3 * n)
    x = _spikes(gen, m, k, 0.2, cuda)
    x[:, 128:256] = 0                             # a silent column block
    g = torch.randn((m, n), generator=gen, device=cuda)
    vld = K.vld_map(x)
    dw = K.spike_matmul_dw_cuda(x, g, vld)
    x64, g64 = x.to(torch.float64), g.to(torch.float64)
    limit = 3.0 * K.dw_plan(m, k, n).chain ** 0.5 * 2.0 ** -24 * (
        x64.abs().T @ g64.abs())
    assert bool(((dw.to(torch.float64) - x64.T @ g64).abs() <= limit).all())
    assert torch.equal(dw, K.spike_matmul_dw_cuda(x, g, vld))
    for skip in ("gated", "two_level"):
        gate = K.dw_gate(x, vld, skip)
        assert torch.equal(dw, K.spike_matmul_dw_gated_cuda(x, g, gate))
    xp = pack_spikes(x)
    for skip in ("dense", "gated", "two_level"):
        assert torch.equal(dw, K.spike_matmul_dw(xp, g, skip=skip))
    silent = (vld == 0).all(dim=1).repeat_interleave(128)[:m]
    if bool(silent.any()):
        g_nan = g.clone()
        g_nan[silent] = float("nan")
        assert torch.equal(dw, K.spike_matmul_dw_cuda(x, g_nan, vld))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("threshold", [1.0, 3.0])
def test_qk_attention_kernel_bit_equal(cuda, dtype, threshold):
    from repro_torch.kernels import qk_attention as K

    gen = torch.Generator(device=cuda).manual_seed(12)
    q = (torch.rand((3, 300, 200), generator=gen, device=cuda) < 0.01)
    k = (torch.rand((3, 300, 200), generator=gen, device=cuda) < 0.3)
    q, k = q.to(dtype), k.to(dtype)
    out = K.qk_attention_cuda(q.reshape(-1, 200), k.reshape(-1, 200),
                              threshold)
    assert torch.equal(out.reshape(q.shape),
                       K.qk_attention_ref(q, k, threshold=threshold))


@pytest.mark.parametrize("packed_out", [False, True])
def test_fused_pe_emit_current_matches_plain(cuda, packed_out):
    """The current within tolerance of the plain version's, and the
    kernel's spikes exactly its own current thresholded, then masked."""
    from repro_torch.core.events import unpack_words
    from repro_torch.kernels import fused_pe as K

    gen = torch.Generator(device=cuda).manual_seed(13)
    m, k, n = 300, 200, 150
    x = _spikes(gen, m, k, 0.3, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.15
    b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=cuda)
    r = 0.5 * torch.randn((m, n), generator=gen, device=cuda)
    q = _spikes(gen, m, n, 0.005, cuda)
    args = K.fused_pe_operands(x, w, bias=b, residual=r, q=q,
                               out_format="packed" if packed_out
                               else "dense", emit_current=True)
    spk, _, cur = K.fused_pe_cuda(*args)
    _, _, ref_cur = K.fused_pe_block_ref(*args)
    torch.testing.assert_close(cur, ref_cur, rtol=1e-5, atol=1e-4)
    spk = (unpack_words(spk) if packed_out else spk)[:m, :n]
    own = (cur >= 1.0) & (q.float().sum(dim=1, keepdim=True) >= 1.0)
    assert torch.equal(spk, own.to(torch.int8))


@pytest.mark.parametrize("bn_fold", [True, False])
def test_train_step_on_card_matches_plain_versions(cuda, bn_fold):
    """Two fused_dense+grad KD steps of QKFResNet-11 at width 0.25 on the
    card (the kernels) against the same steps on the CPU (the plain
    versions): per-layer spike totals within 0.1 %, the loss within rtol
    1e-4, every gradient leaf within a relative L2 error of 1e-3."""
    from repro_torch.core.kd import KDConfig
    from repro_torch.data.synthetic import SyntheticImageDataset
    from repro_torch.kernels import _build
    from repro_torch.models import ann_cnn, snn_cnn
    from repro_torch.optim import cosine_lr, sgd_init
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves, tree_map

    cfg = snn_cnn.SNNCNNConfig(arch="qkfresnet11", width_mult=0.25,
                               bn_fold=bn_fold)
    tcfg = ann_cnn.ANNCNNConfig(arch="resnet18", width_mult=0.25)
    var = snn_cnn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for p in var["params"]:
        for key, sub in p.items():
            if key.startswith("bn"):
                sub["bias"].fill_(0.5)
    tvar = ann_cnn.init(torch.Generator().manual_seed(1), tcfg,
                        device="cpu")
    ds = SyntheticImageDataset(seed=0)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        record = {"aux": [], "grads": [], "metrics": []}

        def student(p, s, x, policy=None, record=record):
            out = snn_cnn.forward({"params": p, "state": s}, x, cfg,
                                  train=True, policy=policy)
            record["aux"].append(out[2])
            return out

        grad_fn = trainer.make_kd_grad_fn(
            student, lambda tp, x: ann_cnn.apply(tp, x, tcfg)[0],
            tree_map(lambda a: a.to(dev), tvar), kd=KDConfig(alpha=0.7),
            policy="fused_dense+grad")
        v = tree_map(lambda a: a.to(dev), var)
        params, opt, state = v["params"], sgd_init(v["params"]), v["state"]
        _build.reset_launches()
        for i in range(2):
            x, y = ds.batch(i, 16)
            batch = {"images": torch.tensor(x, device=dev),
                     "labels": torch.tensor(y, device=dev)}
            loss, metrics, state, grads = grad_fn(params, state, batch)
            record["grads"].append([g.cpu() for g in tree_leaves(grads)])
            record["metrics"].append(float(loss))
            params, opt = trainer.sgd_update(
                grads, opt, params, lr=cosine_lr(0.1, 10)(opt.step),
                momentum=0.9, weight_decay=5e-4)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            assert launches["spike_matmul_dx"] == 32
            assert launches["spike_matmul_dw"] == 32
            assert launches["fused_pe"] == (26 if bn_fold else 0)
            assert launches["qk_attention"] == (0 if bn_fold else 2)
        runs[dev.type] = record
    card, plain = runs["cuda"], runs["cpu"]
    for i in range(2):
        assert card["metrics"][i] == pytest.approx(plain["metrics"][i],
                                                   rel=1e-4)
        for key, val in plain["aux"][i]["spikes"].items():
            a, b = float(card["aux"][i]["spikes"][key]), float(val)
            assert abs(a - b) <= 1e-3 * max(b, 1.0), (i, key, a, b)
        for a, b in zip(card["grads"][i], plain["grads"][i]):
            assert float((a - b).norm()) <= 1e-3 * max(float(b.norm()),
                                                       1e-12)


# ------------------------------------------------- gated and two-level skips
def _gated_spikes(gen, m, k, silent, block_k, dev):
    """0/1 int8 spikes whose (128, block_k) blocks are silent with
    probability ``silent`` (row block 0 wholly, so nact = 0 there), with
    every third 32-column stripe of each block silent, clustered."""
    x = torch.rand((m, k), generator=gen, device=dev) < 0.3
    gm, gk = -(-m // 128), -(-k // block_k)
    keep = torch.rand((gm, gk), generator=gen, device=dev) >= silent
    keep[0] = False
    stripe_on = ((torch.arange(-(-k // 32), device=dev)[None, :]
                  + torch.arange(gm, device=dev)[:, None]) % 3) != 0
    rows = torch.arange(m, device=dev) // 128
    cols = torch.arange(k, device=dev)
    x &= keep[rows][:, cols // block_k] & stripe_on[rows][:, cols // 32]
    return x.to(torch.int8)


GATED_BLOCKS = [(128, 128), (256, 256), (256, 128)]


@pytest.mark.parametrize("skip", ["gated", "two_level"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("block_n,block_k", GATED_BLOCKS)
@pytest.mark.parametrize("silent", [0.5, 1.0])
def test_gated_spike_matmul_matches_plain_and_dense_skip(
        cuda, skip, packed, block_n, block_k, silent):
    from repro_torch.core.events import pack_spikes_ref
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(20)
    x = _gated_spikes(gen, 1000, 1200, silent, block_k, cuda)
    if packed:
        x = pack_spikes_ref(x, block_k=block_k)
    w = torch.randn((1200, 512), generator=gen, device=cuda)
    blocks = dict(block_n=block_n, block_k=block_k)
    args = K.spike_matmul_operands(x, w, skip=skip, **blocks)
    out = K.spike_matmul_gated_cuda(*args)
    torch.testing.assert_close(out, K.spike_matmul_gated_block_ref(*args),
                               rtol=1e-5, atol=1e-4)
    dense = K.spike_matmul_cuda(*K.spike_matmul_operands(x, w, **blocks))
    assert torch.equal(out, dense)
    assert int(args[2].nact[0]) == 0


@pytest.mark.parametrize("skip", ["gated", "two_level"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("block_n,block_k", GATED_BLOCKS)
def test_gated_fused_pe_matches_plain_and_dense_skip(cuda, skip, packed,
                                                     block_n, block_k):
    """Residual and q (int8, with the emitted current; or packed in and
    out, with a packed shortcut), a 256-wide output tile's vld_next summed
    over its two CTAs."""
    from repro_torch.core.events import (block_count_map_2d, pack_spikes_ref,
                                         unpack_words)
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.spike_matmul import spike_matmul_gated_block_ref

    gen = torch.Generator(device=cuda).manual_seed(21)
    m, k, n = 1000, 1200, 512
    x = _gated_spikes(gen, m, k, 0.5, block_k, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.12
    b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=cuda)
    q = _spikes(gen, m, n, 0.005, cuda)
    if packed:
        r = pack_spikes_ref(_spikes(gen, m, n, 0.3, cuda), block_k=block_n)
        kw = dict(x=pack_spikes_ref(x, block_k=block_k), residual=r,
                  q=pack_spikes_ref(q), out_format="packed")
    else:
        r = 0.5 * torch.randn((m, n), generator=gen, device=cuda)
        kw = dict(x=x, residual=r, q=q, emit_current=True)
    kw.update(w=w, bias=b, block_n=block_n, block_k=block_k)
    args = K.fused_pe_operands(skip=skip, **kw)
    out = K.fused_pe_cuda(*args)
    dense = K.fused_pe_cuda(*K.fused_pe_operands(**kw))
    assert all(torch.equal(a, c) for a, c in zip(out, dense))
    ref = K.fused_pe_block_ref(*args)
    spk, ref_spk = out[0], ref[0]
    if packed:
        spk, ref_spk = unpack_words(spk), unpack_words(ref_spk)
        res = unpack_words(args[4], torch.float32)
    else:
        res = args[4]
        torch.testing.assert_close(out[2], ref[2], rtol=1e-5, atol=1e-4)
    xs = unpack_words(args[0]) if packed else args[0]
    cur = spike_matmul_gated_block_ref(xs, args[1], args[12]) + args[3] + res
    near = (cur - 1.0).abs() < 1e-4
    assert not bool(((spk != ref_spk) & ~near).any())
    assert torch.equal(out[1], block_count_map_2d(spk, 128, block_n))


@pytest.mark.parametrize("skip", ["gated", "two_level"])
@pytest.mark.parametrize("silent", [0.0, 0.5, 0.9, 1.0])
def test_gated_dw_bit_equal_to_dense_skip(cuda, skip, silent):
    """The gated dw is the dense-skip dw's bits (same runs, same order);
    NaN in the g rows of wholly silent row blocks changes no bit."""
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(22)
    m, k, n = 8192, 576, 64
    x = _gated_spikes(gen, m, k, silent, 128, cuda)
    g = torch.randn((m, n), generator=gen, device=cuda)
    vld = K.vld_map(x)
    gate = K.dw_gate(x, vld, skip)
    dw = K.spike_matmul_dw_gated_cuda(x, g, gate)
    assert torch.equal(dw, K.spike_matmul_dw_cuda(x, g, vld))
    torch.testing.assert_close(dw, K.spike_matmul_dw_gated_ref(x, g, gate),
                               rtol=1e-4, atol=1e-3)
    silent_rows = (vld == 0).all(dim=1).repeat_interleave(128)[:m]
    assert bool(silent_rows.any())
    g_nan = g.clone()
    g_nan[silent_rows] = float("nan")
    assert torch.equal(dw, K.spike_matmul_dw_gated_cuda(x, g_nan, gate))


@pytest.mark.parametrize("policy", ["auto", "auto_packed"])
@pytest.mark.parametrize("wide", [False, True])
def test_auto_forward_launches_the_gated_kernels_it_plans(cuda, policy, wide,
                                                          monkeypatch):
    """With every plan forced to the fused kernels under skip="gated" (and,
    ``wide``, 256-wide N tiles wherever N allows: width 0.5, so resblock 4
    and the QKFormer tile 256 wide and pass that grid on), an auto forward
    launches the gated fused PE and spike matmul routes only, and its
    logits are the fixed policy's bits."""
    from repro_torch import ops
    from repro_torch.kernels import _build
    from repro_torch.models import snn_cnn
    from repro_torch.ops import autotune

    def gated(self, m, k, n, *, fmt, active_frac, occ_frac, block_m,
              block_n, block_k, allow_reference, allow_wide_n=True):
        bn = 2 * block_n if wide and allow_wide_n and n % (2 * block_n) == 0 \
            else block_n
        return autotune.KernelPlan("fused", "gated", block_m, bn, block_k,
                                   0.0, 0.0, active_frac, occ_frac)

    cfg = snn_cnn.SNNCNNConfig(arch="qkfresnet11",
                               width_mult=0.5 if wide else 0.125,
                               image_size=16)
    fused = snn_cnn.fuse_model(
        snn_cnn.init(torch.Generator().manual_seed(0), cfg), cfg)
    img = torch.rand((2, 16, 16, 3), device=cuda)
    fixed = "fused_packed" if policy == "auto_packed" else "fused_dense"
    want, _, _ = snn_cnn.forward(fused, img, cfg, policy=fixed)
    ops.get_tuner().reset()
    monkeypatch.setattr(autotune.AutoTuner, "_enumerate", gated)
    _build.reset_launches()
    with _build.capture_launches() as captured:
        logits, _, _ = snn_cnn.forward(fused, img, cfg, policy=policy)
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert launches["fused_pe_gated"] == 13 and launches["fused_pe"] == 0
    assert launches["spike_matmul_gated"] == 3
    assert launches["spike_matmul"] == 0
    widths = {args[11] for name, args, _, _ in captured
              if name == "fused_pe_gated"}
    assert widths == ({128, 256} if wide else {128})
    assert torch.equal(logits, want)
    ops.get_tuner().reset()


# ------------------------------------------- the spiking LM's fused PE pass
# (dh, h, x dtype, packed q, packed out, M): dh 128 / 64 / 16 divide the
# tile, 48 does not (a head straddles two tiles); decode's 16 rows and a
# ragged prefill
HEAD_VARIANTS = [
    (128, 4, torch.bfloat16, False, False, 16),
    (128, 4, torch.float32, True, True, 2000),
    (64, 4, torch.bfloat16, True, False, 300),
    (16, 16, torch.float32, False, True, 16),
    (16, 16, torch.bfloat16, True, True, 700),
    (48, 6, torch.float32, True, False, 200),
    (48, 6, torch.bfloat16, False, True, 16),
]


@pytest.mark.parametrize("dh,h,dtype,pq,pout,m", HEAD_VARIANTS)
def test_fused_pe_heads_dense_x_matches_plain(cuda, dh, h, dtype, pq, pout,
                                              m):
    """The head-blocked, dense-activation variant against its plain
    version: spikes equal away from v_th, vld_next the count of the
    kernel's own spikes, the packed output the int8 output's words."""
    from repro_torch.core.events import (block_count_map_2d, pack_spikes_ref,
                                         unpack_words)
    from repro_torch.kernels import fused_pe as K

    gen = torch.Generator(device=cuda).manual_seed(m + dh)
    k, n = 512, h * dh
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    q = (torch.rand((m, n), generator=gen, device=cuda) < 0.05).to(
        torch.int8)
    thr = float(1 + dh // 32)
    q_op = pack_spikes_ref(q) if pq else q
    outs = {}
    for fmt in ("dense", "packed"):
        args = K.fused_pe_operands(x, w, q=q_op, qk_threshold=thr,
                                   out_format=fmt, heads=(h, dh))
        spk, vld = K.fused_pe_cuda(*args)
        ref_spk, ref_vld = K.fused_pe_block_ref(*args)
        if fmt == "packed":
            spk, ref_spk = unpack_words(spk), unpack_words(ref_spk)
        cur = x.float() @ w
        near = torch.zeros_like(spk, dtype=torch.bool)
        near[:m, :n] = (cur - 1.0).abs() < 1e-4
        assert not bool(((spk != ref_spk) & ~near).any())
        assert torch.equal(vld, block_count_map_2d(spk, 128, 128))
        assert not bool(spk[m:].any()) and not bool(spk[:, n:].any())
        outs[fmt] = spk
    assert torch.equal(outs["dense"], outs["packed"])
    gate = (q.float().reshape(m, h, dh).sum(-1) >= thr)
    assert 0.0 < float(gate.float().mean()) < 1.0


def test_spiking_lm_decode_launches_the_kernels(cuda):
    """A decode tick of the reduced spiking LM under the fused policies
    launches two fused PE passes and one spike matmul a layer, and gives
    the reference's tokens and spike totals (f32 activations)."""
    from repro_torch.configs import build_model, get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.models import layers
    from repro_torch.models.lm import LM, spike_totals
    from repro_torch.ops import with_policy

    cfg = reduced(get_config("qwen3-1.7b", spiking=True,
                             attention_kind="qk_spiking"), n_layers=3)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (5, 1), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    got = {}
    for policy in ("reference", "fused_dense", "fused_packed"):
        model = LM(with_policy(cfg, policy))
        cache = model.init_cache(5, 16, device=cuda)
        _build.reset_launches()
        with layers.spike_log() as log:
            logits, _ = model.decode_step(params, toks, cache)
        torch.cuda.synchronize()
        got[policy] = (logits.argmax(-1), spike_totals(log, cfg.n_layers))
        if policy != "reference":
            assert _build.LAUNCHES["fused_pe"] == 2 * cfg.n_layers
            assert _build.LAUNCHES["spike_matmul"] == cfg.n_layers
            assert _build.LAUNCHES["pack_spikes"] == 0
    for policy in ("fused_dense", "fused_packed"):
        assert torch.equal(got[policy][0], got["reference"][0])
        for kind, tot in got["reference"][1].items():
            # f32 sums in another order may flip a spike at v_th
            diff = (got[policy][1][kind] - tot).abs()
            assert bool((diff <= (tot // 1000).clamp_min(1)).all()), (
                policy, kind)


# ------------------------------------------------ K9: softmax attention
# (s, h, hkv, d, causal): H/Hkv 16/8, 16/16 and 16/1; D 128, 64 and 32; S
# 64, a ragged causal 300 and 2048
FLASH_CASES = [
    (64, 16, 8, 128, True), (64, 16, 16, 64, False), (64, 16, 1, 32, True),
    (300, 16, 8, 128, True), (300, 16, 1, 64, True), (300, 16, 16, 32, True),
    (2048, 16, 8, 128, True), (2048, 16, 16, 64, False),
    (2048, 16, 1, 32, True),
]
# (s, h, hkv, d, causal, mul): the cases above at q's scale, S 1 and S 65
# (one row; one row past a tile), GQA 16/1 at D 128, and q scaled by 8
# (large scores: the running max moves, its correction matters), each f32
# and bf16
FLASH_UNIT = [c + (1.0,) for c in FLASH_CASES] + [
    (1, 16, 8, 128, True, 1.0), (65, 16, 8, 128, True, 1.0),
    (65, 16, 16, 64, False, 1.0), (300, 16, 1, 128, True, 1.0),
    (2048, 16, 1, 128, False, 1.0),
    (300, 16, 8, 128, True, 8.0), (2048, 16, 16, 64, False, 8.0),
]
FLASH_ALL = [c + (dt,) for c in FLASH_UNIT
             for dt in (torch.float32, torch.bfloat16)]


def _flash_gate(K, out, q, k, v, causal):
    """K9's output against its plain version's f32 result (before it
    rounds to q's dtype): rtol 1e-5, atol 1e-5 (IEEE f32 sums in another
    order), and in bf16 half a bf16 ulp more (rtol 2**-8 + 1e-5) for the
    output's one rounding to nearest."""
    ref = K.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    rtol = 1e-5 if out.dtype == torch.float32 else 2.0 ** -8 + 1e-5
    assert out.dtype == q.dtype and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=1e-5)


def _attention_f64(q, k, v, causal):
    """Softmax attention of q [B,S,H,D], k and v [B,S,Hkv,D] in f64."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qh = q.double().transpose(1, 2)
    kh, vh = (t.double().repeat_interleave(g, dim=2).transpose(1, 2)
              for t in (k, v))
    sc = (qh @ kh.transpose(-1, -2)) * d ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones((s, s), dtype=torch.bool,
                                        device=q.device).tril(), -1e300)
    return (torch.softmax(sc, dim=-1) @ vh).transpose(1, 2)


def _flash_witness(K, out, q, k, v, causal):
    """An f32 output at scores far from unit scale, where the f32 gate
    against the plain version cannot hold (it scales the product, the
    reference's kernel and the scalar route scale q first, and each
    rounding of s moves p = exp(s - m) by as much relative): the kernel's
    max abs error against the f64 result within twice the plain version's
    own, a rule JAX's own kernel meets (tests/test_torch_attention.py)."""
    exact = _attention_f64(q, k, v, causal)
    plain = K.attention_ref(q, k, v, causal=causal)
    err = (out.double() - exact).abs().max()
    err_plain = (plain.double() - exact).abs().max()
    assert bool(torch.isfinite(out).all())
    assert err <= 2 * err_plain, (float(err), float(err_plain))


@pytest.mark.parametrize("s,h,hkv,d,causal,mul,dtype", FLASH_ALL)
def test_flash_attention_kernel_matches_plain(cuda, s, h, hkv, d, causal,
                                              mul, dtype):
    """K9 through ``flash_attention`` (one launch, counted, on
    ``pick_route``'s route: wgmma for bf16, scalar for f32) and, for bf16,
    again on the scalar route, each against its plain version
    (``_flash_gate``; f32 with q scaled by 8 against the f64 result,
    ``_flash_witness``); causal or full, grouped KV, a ragged sequence."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as K

    gen = torch.Generator(device=cuda).manual_seed(s + d + hkv)
    q = (torch.randn((1, s, h, d), generator=gen, device=cuda)
         * mul).to(dtype)
    k = torch.randn((1, s, hkv, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((1, s, hkv, d), generator=gen, device=cuda).to(dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "scalar"
    assert K.pick_route(q) == route
    _build.reset_launches()
    with _build.capture_launches() as cap:
        out = K.flash_attention(q, k, v, causal=causal, q_block=s,
                                kv_block=s)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == 1
    assert [launch.route for launch in cap] == [route]
    if dtype == torch.float32 and mul != 1.0:
        _flash_witness(K, out, q, k, v, causal)
    else:
        _flash_gate(K, out, q, k, v, causal)
    if dtype == torch.bfloat16:
        _flash_gate(K, K.flash_attention_cuda(q, k, v, causal,
                                              route="scalar"),
                    q, k, v, causal)
        torch.cuda.synchronize()


def test_flash_attention_bf16_at_d48_takes_the_scalar_route(cuda):
    """bf16 at a head dim the wgmma route has no instance for (48) runs on
    the scalar route, and the wgmma route refuses it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as K

    gen = torch.Generator(device=cuda).manual_seed(48)
    q, k, v = (torch.randn((1, 300, hh, 48), generator=gen,
                           device=cuda).to(torch.bfloat16)
               for hh in (16, 8, 8))
    assert K.pick_route(q) == "scalar"
    with _build.capture_launches() as cap:
        out = K.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert [launch.route for launch in cap] == ["scalar"]
    _flash_gate(K, out, q, k, v, True)
    with pytest.raises(ValueError, match="wgmma route takes bf16"):
        K.flash_attention_cuda(q, k, v, True, route="wgmma")


@pytest.mark.parametrize("pv", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_wgmma_tile_descriptors_match_matmul(cuda, d, pv):
    """One tile through the wgmma route's shared-memory layouts (TMA boxes,
    128- or 64-byte swizzle) and descriptors, alone: QK^T's K-major A and
    B (a b^T, 64 x 64 over D) and PV's register A with an MN-major B
    through the transpose bit (p v, p split in three bf16 terms), against
    torch.matmul in f32 at rtol = atol = 1e-5 (f32 sums in another
    order). A wrong stride or swizzle field gives wrong numbers, not an
    error."""
    from repro_torch.kernels import flash_attention as K

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(d + pv)
    a = torch.randn((64, d), generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn((64, d), generator=gen, device=cuda).to(torch.bfloat16)
    if pv:
        p = torch.rand((64, 64), generator=gen, device=cuda)
        got, want = K.wgmma_tile_cuda(a, b, p), p @ b.float()
    else:
        got, want = K.wgmma_tile_cuda(a, b), a.float() @ b.float().T
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_flash_attention_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels import flash_attention as K

    q = torch.zeros((1, 8, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="head dim 256"):
        K.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        K.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="wgmma route takes bf16"):
        K.flash_attention_cuda(q, q, q, route="wgmma")
    with pytest.raises(ValueError, match="not one of"):
        K.flash_attention_cuda(q, q, q, route="tile")


def _direct_softmax(model, params, prompt, chunk, max_new, dev):
    """One request the way a one-slot engine runs it, with its shapes:
    the prompt padded to its 8-token bucket, prefilled whole or in chunks,
    its rows written into a pool of max_len 32, then decode steps with a
    [1] length vector."""
    s = len(prompt)
    bucket = -(-s // 8) * 8
    toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    toks[0, :s] = torch.tensor(prompt, device=dev)
    if chunk:
        cache = model.init_cache(1, bucket, device=dev)
        cache["len"] = torch.zeros((), dtype=torch.int32, device=dev)
        for lo in range(0, bucket, chunk):
            logits, cache = model.prefill_chunk(params, toks[:, lo:lo + chunk],
                                                cache)
            if lo <= s - 1 < lo + chunk:
                first = logits[0, s - 1 - lo]
    else:
        logits, cache = model.prefill(params, {"tokens": toks},
                                      return_all_logits=True)
        first = logits[0, s - 1]
    pool = model.init_cache(1, 32, device=dev)
    for dst, src in zip(pool["layers"], cache["layers"]):
        dst[:, :, :bucket] = src
    out = [int(first.argmax())]
    for i in range(max_new - 1):
        pool["len"] = torch.tensor([s + i], dtype=torch.int32, device=dev)
        lg, pool = model.decode_step(
            params, torch.tensor([[out[-1]]], device=dev), pool)
        out.append(int(lg[0].argmax()))
    return out


@pytest.mark.parametrize("chunk", [0, 4])
def test_softmax_engine_on_the_card_equals_a_direct_loop(cuda, chunk):
    """A few ticks of the reduced softmax qwen3-1.7b (bf16 activations,
    one slot) through the engine on the card give a direct prefill /
    decode loop's greedy tokens at the engine's shapes; the softmax LM
    launches no kernel of the port (its products are cuBLAS, as the
    reference's are XLA's)."""
    import numpy as np

    from repro_torch.configs import build_model, get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.serve import Engine, EngineConfig

    cfg = reduced(get_config("qwen3-1.7b"), dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in (5, 11, 3)]
    _build.reset_launches()
    eng = Engine(model, params, EngineConfig(
        max_slots=1, max_len=32, prefill_pad=8, prefill_chunk=chunk))
    uids = [eng.submit(p, max_new=5) for p in prompts]
    fin = {r.uid: r.out for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values())
    want = [_direct_softmax(model, params, p, chunk, 5, cuda)
            for p in prompts]
    assert [fin[u] for u in uids] == want


# ------------------------------------- LIF state (T > 1) and packed-x dw
# (packed x / residual / out, residual, q, skip, emit_current, soft, tau)
STATE_VARIANTS = [
    (False, "f32", None, "dense", False, False, 0.5),
    (False, "f32", "row", "gated", True, True, 0.7),
    (False, "spikes", "row", "two_level", False, False, 0.7),
    (True, "spikes", "row", "dense", False, True, 0.5),
    (True, "spikes", None, "gated", True, False, 0.5),
    (True, None, "row", "two_level", False, True, 0.7),
]


@pytest.mark.parametrize("packed,res,q_kind,skip,emit,soft,tau",
                         STATE_VARIANTS)
def test_fused_pe_state_matches_plain(cuda, packed, res, q_kind, skip, emit,
                                      soft, tau):
    """The stateful fused PE against its plain version: spikes equal away
    from v_th, v_next within rtol 1e-5 / atol 1e-4 there, vld_next the
    count of its own spikes; the packed launch bit-equal to the int8 launch
    on the same spikes, and a gated route bit-equal to the dense skip."""
    from repro_torch.core.events import block_count_map_2d, unpack_words
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.packed import pack_spikes_ref
    from repro_torch.kernels.spike_matmul import (
        spike_matmul_block_ref, spike_matmul_gated_block_ref)

    gen = torch.Generator(device=cuda).manual_seed(21)
    m, k, n = 300, 257, 150
    x = _spikes(gen, m, k, 0.2, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.15
    b = 0.3 + 0.3 * torch.randn((n,), generator=gen, device=cuda)
    r = None
    if res == "f32":
        r = 0.5 * torch.randn((m, n), generator=gen, device=cuda)
    elif res == "spikes":
        r = _spikes(gen, m, n, 0.3, cuda)
    q = _spikes(gen, m, 64, 0.02, cuda) if q_kind else None
    v = torch.randn((m, n), generator=gen, device=cuda)
    s = (torch.rand((m, n), generator=gen, device=cuda) < 0.5).float()

    def launch(pack, route):
        def p(a):
            return None if a is None else pack_spikes_ref(a) if pack else a
        args = K.fused_pe_operands(
            p(x), w, bias=b, residual=p(r) if res == "spikes" else r,
            q=p(q), out_format="packed" if pack else "dense",
            emit_current=emit, skip=route, v_prev=v, s_prev=s, tau=tau,
            soft_reset=soft)
        outs = K.fused_pe_cuda(*args)
        spk = unpack_words(outs[0]) if pack else outs[0]
        return args, (spk, *outs[1:])

    args, k_out = launch(packed, skip)
    p_out = K.fused_pe_block_ref(*args)
    p_spk = unpack_words(p_out[0]) if packed else p_out[0]
    rp = args[4]
    cur = spike_matmul_block_ref(*args[:3], packed) if skip == "dense" \
        else spike_matmul_gated_block_ref(args[0], args[1], args[12], packed)
    cur = cur + args[3]
    if rp is not None:
        cur = cur + (unpack_words(rp, torch.float32) if packed else rp)
    vv = 0.0 * cur
    vv[:m, :n] = tau * v * (1.0 - s)
    near = ((vv + cur) - 1.0).abs() < 1e-4
    assert not bool(((k_out[0] != p_spk) & ~near).any())
    assert torch.equal(k_out[1], block_count_map_2d(k_out[0], 128, 128))
    ok = ~near[:m, :n]
    torch.testing.assert_close(k_out[2][ok], p_out[2][ok], rtol=1e-5,
                               atol=1e-4)
    if emit:
        torch.testing.assert_close(k_out[3], p_out[3], rtol=1e-5, atol=1e-4)
    if packed:
        _, int8_out = launch(False, skip)
        assert all(torch.equal(a, b_) for a, b_ in zip(k_out, int8_out))
    if skip != "dense":
        _, dense_out = launch(packed, "dense")
        assert all(torch.equal(a, b_) for a, b_ in zip(k_out, dense_out))


@pytest.mark.parametrize("skip", ["dense", "gated", "two_level"])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
def test_dw_packed_operand_bit_equal_to_int8(cuda, skip, density):
    """dw over a packed x: the int8 launch's bits on the unpacked spikes,
    within tolerance of the plain version, and 0 in a silent k block."""
    from repro_torch.kernels import spike_matmul as K
    from repro_torch.kernels.packed import pack_spikes

    gen = torch.Generator(device=cuda).manual_seed(22)
    m, k, n = 8192, 576, 64
    x = _spikes(gen, m, k, density, cuda)
    x[:, :128] = 0
    g = torch.randn((m, n), generator=gen, device=cuda)
    got = K.spike_matmul_dw(pack_spikes(x), g, skip=skip)
    assert torch.equal(got, K.spike_matmul_dw(x, g, skip=skip))
    torch.testing.assert_close(got, K.spike_matmul_dw_ref(x, g), rtol=1e-5,
                               atol=1e-3)
    assert not bool(got[:128].any())


@pytest.mark.parametrize("policy", ["fused_dense", "fused_packed"])
def test_two_step_forward_launches_the_state_kernel(cuda, policy):
    """QKFResNet-11 at T = 2: each fused PE pass once a step, the stem LIF,
    shortcut matmuls and head once a step; packed, the stem pack and one
    pack of every stateful pass's steps, and the K pass's q and the head
    unpacked; logits within 1e-5 of the reference, packed equal to dense."""
    from repro_torch.kernels import _build
    from repro_torch.models import snn_cnn

    cfg = snn_cnn.SNNCNNConfig(arch="qkfresnet11", width_mult=0.125,
                               image_size=16, timesteps=2)
    fused = snn_cnn.fuse_model(
        snn_cnn.init(torch.Generator().manual_seed(0), cfg), cfg)
    img = torch.rand((2, 16, 16, 3), device=cuda)
    _build.reset_launches()
    logits, _, _ = snn_cnn.forward(fused, img, cfg, policy=policy)
    torch.cuda.synchronize()
    packed = policy == "fused_packed"
    assert dict(_build.LAUNCHES) == {
        "lif_update": 2, "fused_pe": 26, "spike_matmul": 6,
        "w2ttfs_pool": 2, "pack_spikes": 14 if packed else 0,
        "unpack_spikes": 3 if packed else 0, **NO_BACKWARD}
    ref, _, _ = snn_cnn.forward(fused, img, cfg, policy="reference")
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-5)
    if packed:
        dense, _, _ = snn_cnn.forward(fused, img, cfg, policy="fused_dense")
        assert torch.equal(logits, dense)


def test_packed_scan_on_a_wide_grid_matches_plain(cuda):
    """A T > 1 packed layer on a 256-wide output grid (a plan the tuner may
    make): the steps packed by the 128 x 128 pack kernel and re-gridded,
    bit-equal to the plain pack of the same spikes on that grid."""
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.packed import pack_spikes_ref

    gen = torch.Generator(device=cuda).manual_seed(23)
    x = (torch.rand((2, 300, 200), generator=gen, device=cuda) < 0.3).to(
        torch.int8)
    w = torch.randn((200, 300), generator=gen, device=cuda) * 0.15
    ps, vld = K.fused_pe_layer(x, w, out_format="packed", block_n=256)
    dense, vld_d = K.fused_pe_layer(x, w, block_n=256)
    ref = pack_spikes_ref(dense, block_m=128, block_k=256)
    assert (ps.block_m, ps.block_k) == (128, 256)
    assert torch.equal(ps.words, ref.words)
    assert torch.equal(ps.vld_cnt, ref.vld_cnt)
    assert torch.equal(vld, vld_d) and int(vld.sum()) == int(dense.sum())


# ----------------------------------------- the decode route (K2 and K3)
# M live rows: one, a ragged few, a decode tick of 16, a ragged 33 (the
# 64-row tile), a 64-token prefill chunk
DECODE_ROWS_CASES = [1, 7, 16, 33, 64]


def _same(a, b):
    a, b = ((a,), (b,)) if isinstance(a, torch.Tensor) else (a, b)
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def _both_routes(K, args):
    """The decode route on its own operands and on the 128-row tile's,
    and the tile route on the tile's, for one fused PE launch."""
    tile = K.fused_pe_tile_operands(args)
    return (K.fused_pe_cuda(*args, route="decode"),
            K.fused_pe_cuda(*tile, route="decode"), K.fused_pe_cuda(*tile))


@pytest.mark.parametrize("m", DECODE_ROWS_CASES)
@pytest.mark.parametrize("dh,h,dtype,pq,pout",
                         [v[:5] for v in HEAD_VARIANTS])
def test_decode_route_heads_bit_equal_to_tile(cuda, m, dh, h, dtype, pq,
                                             pout):
    """The LM's head-blocked, dense-activation pass (the HEAD_VARIANTS
    axes, with a bias) on the decode route: spikes, vld_next and packed
    words equal to the 128-row tile's bit for bit, padded rows included,
    on the decode route's own operands and on the tile's."""
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.packed import pack_spikes_ref

    gen = torch.Generator(device=cuda).manual_seed(m * 7 + dh)
    k, n = 512, h * dh
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    b = 0.2 * torch.randn((n,), generator=gen, device=cuda)
    q = (torch.rand((m, n), generator=gen, device=cuda) < 0.05).to(
        torch.int8)
    args = K.fused_pe_operands(
        x, w, bias=b, q=pack_spikes_ref(q) if pq else q,
        qk_threshold=float(1 + dh // 32),
        out_format="packed" if pout else "dense", heads=(h, dh),
        route="decode")
    assert args[0].shape[0] == m and args[2] is None
    own, on_tile, tile = _both_routes(K, args)
    assert _same(own, tile) and _same(on_tile, tile)


@pytest.mark.parametrize("m", DECODE_ROWS_CASES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
def test_decode_route_spike_matmul_bit_equal_to_tile(cuda, m, packed,
                                                     density):
    """K3 on the decode route, int8 and packed x with a silent 128-column
    block: the f32 output equal to the 128-row tile's bit for bit, padded
    rows included, and to the plain version within rtol 1e-5 / atol 1e-4
    (f32 sums in another order than torch.matmul's)."""
    from repro_torch.kernels import spike_matmul as K
    from repro_torch.kernels.packed import pack_spikes_ref

    gen = torch.Generator(device=cuda).manual_seed(41 + m)
    k, n = 640, 272
    x = (torch.rand((m, k), generator=gen, device=cuda) < density).to(
        torch.int8)
    x[:, 256:384] = 0
    w = torch.randn((k, n), generator=gen, device=cuda)
    args = K.spike_matmul_operands(pack_spikes_ref(x) if packed else x, w,
                                   route="decode")
    assert args[0].shape[0] == m
    tile = K.spike_matmul_tile_operands(args)
    out = K.spike_matmul_cuda(*args, route="decode")
    ref = K.spike_matmul_cuda(*tile)
    assert torch.equal(out, ref)
    assert not bool(out[m:].any())
    torch.testing.assert_close(out, K.spike_matmul_block_ref(*tile),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [16, 64, 65, 200])
@pytest.mark.parametrize("skip", ["dense", "gated"])
def test_wrappers_take_the_decode_route_by_shape(cuda, m, skip):
    """fused_pe launches the decode route exactly for a dense activation x
    of M <= 64 rows (a spike x keeps the tile), spike_matmul exactly when M
    <= 64 and the skip is dense (pick_route); each gives the plain
    version's spikes and sums whichever route it took."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_pe as F
    from repro_torch.kernels import spike_matmul as S

    gen = torch.Generator(device=cuda).manual_seed(51 + m)
    x = _spikes(gen, m, 256, 0.3, cuda)
    a = torch.randn((m, 256), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((256, 128), generator=gen, device=cuda) * 0.2
    with _build.capture_launches() as captured:
        spk_a, _ = F.fused_pe(a, w)
        spk, _ = F.fused_pe(x, w, skip=skip)
        out = S.spike_matmul(x, w, skip=skip)
        torch.cuda.synchronize()
    assert [launch.route for launch in captured] == [
        "decode" if m <= 64 else "tile", "tile", S.pick_route(m, skip)]
    for xx, got in ((a, spk_a), (x, spk)):
        ref_spk, _ = F.fused_pe(xx.cpu(), w.cpu(),
                                skip="dense" if xx is a else skip)
        cur = xx.float().cpu() @ w.cpu()
        near = (cur - 1.0).abs() < 1e-4
        assert not bool(((got.cpu() != ref_spk) & ~near).any())
    torch.testing.assert_close(out.cpu(), S.spike_matmul(x.cpu(), w.cpu(),
                                                         skip=skip),
                               rtol=1e-5, atol=1e-4)
