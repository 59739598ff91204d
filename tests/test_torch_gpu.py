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
    m, k = shape[-2:]
    assert torch.equal(P.unpack_spikes_cuda(words, m, k),
                       P.unpack_words(words)[..., :m, :k])
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


# -------------------------------------------- the spike matmul's tile (K3/K4)
def _launch_checked(K, args, gated: bool):
    """A launch into a NaN-filled buffer: every output written, and the
    same bits as a launch into a fresh one."""
    launch = K.spike_matmul_gated_cuda if gated else K.spike_matmul_cuda
    out = launch(*args)
    buf = torch.full_like(out, float("nan"))
    assert launch(*args, out=buf) is buf
    assert not bool(buf.isnan().any())
    assert torch.equal(buf, out)
    return out


# (M, K, N, block_k): ragged M, K and N, K = 64 under a 128-wide block, K
# not a multiple of 16, N of 4, 64 or 192, and 256-wide blocks
TILE_SHAPES = [(4059, 200, 300, 128), (1000, 1200, 512, 256),
               (300, 64, 100, 128), (129, 37, 5, 128), (700, 576, 64, 128),
               (520, 640, 192, 256)]


@pytest.mark.parametrize("m,k,n,block_k", TILE_SHAPES)
@pytest.mark.parametrize("skip", ["dense", "gated", "two_level"])
def test_spike_matmul_tile_bit_equal_to_the_chain(cuda, m, k, n, block_k,
                                                  skip):
    """K3 (dense skip) and K4 (gated, two-level) on int8 and packed x:
    bit-equal to the ascending f32 chain, packed bits equal to int8 bits,
    the gated walks equal to the dense skip, NaN-filled outputs fully
    written."""
    from repro_torch.core.events import pack_spikes_ref
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = _gated_spikes(gen, m, k, 0.5, block_k, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda)
    blocks = dict(block_k=block_k)
    gated = skip != "dense"
    outs = []
    for xx in (x, pack_spikes_ref(x, block_k=block_k)):
        args = K.spike_matmul_operands(xx, w, skip=skip, **blocks)
        assert args[1] is w
        out = _launch_checked(K, args, gated)
        assert torch.equal(out, K.spike_matmul_chain_ref(*args))
        outs.append(out[:m])
    assert torch.equal(outs[0], outs[1])
    dense = K.spike_matmul_cuda(*K.spike_matmul_operands(x, w, **blocks))
    assert torch.equal(outs[0], dense)


def test_spike_matmul_tile_at_an_lm_prefill(cuda):
    """A 248-row launch at K = N = 2048 (the LM's wo over a prefill): the
    tile, bit-equal to the chain and to the decode route on its first 64
    rows."""
    from repro_torch.kernels import spike_matmul as K

    gen = torch.Generator(device=cuda).manual_seed(248)
    x = (torch.rand((248, 2048), generator=gen, device=cuda) < 0.1).to(
        torch.int8)
    x[:, 256:512] = 0
    w = torch.randn((2048, 2048), generator=gen, device=cuda)
    assert K.pick_route(248, "dense") == "tile"
    args = K.spike_matmul_operands(x, w)
    out = _launch_checked(K, args, False)
    assert torch.equal(out, K.spike_matmul_chain_ref(*args))
    dec = K.spike_matmul_operands(x[:64], w, route="decode")
    assert torch.equal(K.spike_matmul_cuda(*dec, route="decode")[:64],
                       out[:64])


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
    """bf16 at a head dim the wgmma route has no instance for: at 48 (a
    row TMA can address) it now runs on the wgmma route's 64 instance, the
    columns past 48 zero-filled; at 44 (88-byte rows, no TMA stride) on
    the scalar route, which the wgmma route refuses."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as K

    gen = torch.Generator(device=cuda).manual_seed(48)
    for d, route in ((48, "wgmma"), (44, "scalar")):
        q, k, v = (torch.randn((1, 300, hh, d), generator=gen,
                               device=cuda).to(torch.bfloat16)
                   for hh in (16, 8, 8))
        assert K.pick_route(q) == route
        with _build.capture_launches() as cap:
            out = K.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert [launch.route for launch in cap] == [route]
        _flash_gate(K, out, q, k, v, True)
    with pytest.raises(ValueError, match="wgmma route takes bf16"):
        K.flash_attention_cuda(q, k, v, True, route="wgmma")


# (S, H, Hkv): the scalar route's three row plans (32, 64 and 128 rows a
# CTA: 300 x 4 heads, 1000 x 16, 2100 x 16), ragged against its 64-key
# tiles and its q tiles; D 32 / 64 / 96 / 112 / 128 (the 16-byte copies'
# instances), 48 (the 64 instance, columns past 48 zero) and 37 (the
# general instance, 4-byte copies), f32 and bf16, causal and full
SCALAR_SEQS = [(300, 4, 2), (1000, 16, 8), (2100, 16, 4)]
SCALAR_DIMS = [32, 64, 96, 112, 128, 48, 37]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SCALAR_DIMS)
@pytest.mark.parametrize("s,h,hkv", SCALAR_SEQS)
def test_flash_scalar_route_matches_plain(cuda, s, h, hkv, d, dtype,
                                          causal):
    """The scalar route against its plain version (``_flash_gate``) on
    each row plan (``flash_plan``), at every instance of D, f32 and bf16
    (widened on load), causal and full, ragged S, grouped KV."""
    from repro_torch.kernels import flash_attention as K

    gen = torch.Generator(device=cuda).manual_seed(s + d + h)
    q = torch.randn((1, s, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((1, s, hkv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    out = K.flash_attention_cuda(q, k, v, causal, route="scalar")
    torch.cuda.synchronize()
    _flash_gate(K, out, q, k, v, causal)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_scalar_route_takes_misaligned_f32(cuda, d):
    """f32 operands 4 bytes past a 16-byte boundary take the general
    instance's 4-byte copies, against the plain version."""
    from repro_torch.kernels import flash_attention as K

    gen = torch.Generator(device=cuda).manual_seed(d)
    shapes = ((1, 500, 16, d), (1, 500, 8, d), (1, 500, 8, d))
    ops = []
    for shape in shapes:
        n = 1
        for x in shape:
            n *= x
        buf = torch.randn((n + 1,), generator=gen, device=cuda)
        ops.append(buf[1:].view(shape))
    assert ops[0].data_ptr() % 16
    out = K.flash_attention_cuda(*ops, True, route="scalar")
    torch.cuda.synchronize()
    _flash_gate(K, out, *ops, True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [48, 96, 112])
def test_flash_wgmma_route_at_a_padded_head_dim(cuda, d, causal):
    """bf16 at D 48, 96 and 112 on the wgmma route (the 64 and 128
    instances, TMA filling the columns past D with zeros, the epilogue
    storing only D), one counted launch, against the plain version; the
    output's bytes past each row's D are the next row's, so a stray store
    shows as a wrong value."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as K

    gen = torch.Generator(device=cuda).manual_seed(d + causal)
    q = torch.randn((2, 700, 16, d), generator=gen,
                    device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((2, 700, 8, d), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    assert K.pick_route(q) == "wgmma"
    _build.reset_launches()
    with _build.capture_launches() as cap:
        out = K.flash_attention(q, k, v, causal=causal, q_block=700,
                                kv_block=700)
    torch.cuda.synchronize()
    assert [launch.route for launch in cap] == ["wgmma"]
    _flash_gate(K, out, q, k, v, causal)


# the unpacker at the packed KD step's maps (res1 to res4 and the QKFormer,
# at T = 1 and as the T = 4 trains), the head's map, and ragged ones
UNPACK_SHAPES = [(262144, 64), (65536, 128), (16384, 256), (4096, 512),
                 (4, 262144, 64), (4, 4096, 512), (3, 300, 200), (130, 33),
                 (2, 77, 640)]
UNPACK_SENTINEL = {torch.int8: 127, torch.bfloat16: float("nan"),
            torch.float32: float("nan")}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("shape", UNPACK_SHAPES)
def test_unpack_kernel_writes_the_extent(cuda, shape, dtype, aligned):
    """The unpacker in each dtype into an output inside a buffer filled
    with a sentinel, 16-byte aligned or one element past it (the
    element-wise path): the extent bit-equal to the plain version (every
    element written), every byte around it untouched."""
    from repro_torch.kernels import packed as P

    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = _ragged_spikes(gen, shape, 0.3, cuda)
    ps = P.pack_spikes_ref(x.reshape(-1, *shape[-2:]))
    m, k = shape[-2:]
    ref = P.unpack_spikes_ref(ps, dtype)
    n, pad = ref.numel(), 16
    buf = torch.full((n + 2 * pad,), UNPACK_SENTINEL[dtype], dtype=dtype,
                     device=cuda)
    off = pad if aligned else pad + 1
    out = buf[off:off + n].view(ref.shape)
    got = P.unpack_spikes_cuda(ps.words, m, k, dtype, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, ref)
    rest = torch.cat([buf[:off], buf[off + n:]])
    if dtype == torch.int8:
        assert bool((rest == 127).all())
    else:
        assert bool(rest.isnan().all())


def test_unpack_spikes_writes_the_callers_dtype(cuda):
    """``unpack_spikes(ps, dtype=)``: one counted launch, in the dtype
    asked, equal to the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import packed as P

    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _ragged_spikes(gen, (2, 4096, 512), 0.2, cuda)
    ps = P.pack_spikes(x)
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        _build.reset_launches()
        got = P.unpack_spikes(ps, dtype=dtype)
        assert _build.LAUNCHES["unpack_spikes"] == 1
        assert got.dtype == dtype
        assert torch.equal(got, x.to(dtype))


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
    """The decode route on its own operands and on the tile's padded ones,
    and the tile route on the padded ones, for one fused PE launch."""
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
    words equal to the tile route's bit for bit, padded rows included,
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
    assert torch.equal(out, K.spike_matmul_chain_ref(*tile))
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


# K2's spike-x tile on the tensor cores (csrc/event_wgmma.cuh): every fused
# PE pass of the int8 main path at batch 256 (M, K, N; res1 has N = 64),
# the packed path's K where it differs, and ragged extents
SPIKE_TILE_SHAPES = [
    (262144, 576, 64), (262144, 1152, 64), (65536, 576, 128),
    (65536, 1152, 128), (16384, 1152, 256), (16384, 2304, 256),
    (4096, 2304, 512), (4096, 4608, 512), (4096, 512, 512), (4059, 500, 300),
    (130, 33, 70),
]


def _spike_tile_launches(K, x, w, pack, **kw):
    """The int8 launch's operands and outputs, and the packed launch's on
    the same spikes (spikes unpacked)."""
    from repro_torch.core.events import unpack_words
    from repro_torch.kernels.packed import pack_spikes_ref

    outs = []
    for packed in (False, True) if pack else (False,):
        xx = pack_spikes_ref(x, block_k=kw.get("block_k", 128)) if packed \
            else x
        args = K.fused_pe_operands(xx, w, out_format="packed" if packed
                                   else "dense", **kw)
        out = K.fused_pe_cuda(*args)
        outs.append((args, (unpack_words(out[0]) if packed else out[0],
                            *out[1:])))
    return outs


@pytest.mark.parametrize("m,k,n", SPIKE_TILE_SHAPES)
def test_spike_x_tile_at_path_shapes(cuda, m, k, n):
    """At each pass shape, with a residual and the emitted current: the
    current within rtol 1e-5 / atol 1e-4 of the plain version's, the spikes
    exactly that current thresholded, padding silent, vld_next the count of
    its own spikes; a second launch bit-equal; the packed launch bit-equal
    to the int8 one."""
    from repro_torch.core.events import block_count_map_2d
    from repro_torch.kernels import fused_pe as K

    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = _spikes(gen, m, k, 0.3, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * (2.0 / k ** 0.5)
    b = 0.3 + 0.3 * torch.randn((n,), generator=gen, device=cuda)
    r = 0.5 * torch.randn((m, n), generator=gen, device=cuda)
    (args, out), (_, packed_out) = _spike_tile_launches(
        K, x, w, True, bias=b, residual=r, emit_current=True)
    spk, vld, cur = out
    ref_cur = K.fused_pe_block_ref(*args)[2]
    torch.testing.assert_close(cur, ref_cur, rtol=1e-5, atol=1e-4)
    assert torch.equal(spk[:m, :n], (cur >= 1.0).to(torch.int8))
    assert not bool(spk[m:].any()) and not bool(spk[:, n:].any())
    assert torch.equal(vld, block_count_map_2d(spk, 128, 128))
    again = K.fused_pe_cuda(*args)
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    assert all(torch.equal(a, c) for a, c in zip(out, packed_out))


@pytest.mark.parametrize("skip", ["gated", "two_level"])
@pytest.mark.parametrize("block_n,block_k", [(128, 128), (256, 128),
                                             (128, 256), (256, 256)])
@pytest.mark.parametrize("state", [None, "hard", "soft"])
def test_spike_x_tile_skips_widths_and_state(cuda, skip, block_n, block_k,
                                             state):
    """A gated or two-level launch bit-equal to the dense skip's, at 128- and
    256-wide blocks, stateless and with a hard or soft reset; v_next and
    the current within the plain version's gates away from v_th; the
    packed launch bit-equal to the int8 one."""
    from repro_torch.kernels import fused_pe as K

    gen = torch.Generator(device=cuda).manual_seed(block_n + block_k)
    m, k, n = 4059, 1100, 300
    x = _gated_spikes(gen, m, k, 0.5, block_k, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * (2.0 / k ** 0.5)
    b = 0.3 + 0.3 * torch.randn((n,), generator=gen, device=cuda)
    kw = dict(bias=b, emit_current=True, block_n=block_n, block_k=block_k)
    if state is not None:
        kw.update(v_prev=torch.randn((m, n), generator=gen, device=cuda),
                  s_prev=(torch.rand((m, n), generator=gen, device=cuda)
                          < 0.5).to(torch.int8),
                  tau=0.7, soft_reset=state == "soft")
    (args, out), (_, packed_out) = _spike_tile_launches(
        K, x, w, True, skip=skip, **kw)
    (_, dense_out), = _spike_tile_launches(K, x, w, False, **kw)
    assert all(torch.equal(a, c) for a, c in zip(out, dense_out))
    assert all(torch.equal(a, c) for a, c in zip(out, packed_out))
    ref = K.fused_pe_block_ref(*args)
    torch.testing.assert_close(out[-1], ref[-1], rtol=1e-5, atol=1e-4)
    if state is not None:
        v = args[14].tau * args[14].v_prev * (
            1.0 - args[14].s_prev.float()) + ref[-1]
        far = (v - 1.0).abs() >= 1e-4
        torch.testing.assert_close(out[2][far], ref[2][far], rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("skip", ["dense", "two_level"])
def test_spike_x_tile_rechecks_near_threshold_on_the_scalar_chain(cuda, packed,
                                                                  skip):
    """v_th set to one output's own potential: every output within the
    recheck band of it takes the scalar tile's ascending f32 chain
    (``sequential_product``) bit for bit, the rest the tensor-core sum;
    the spikes are the emitted current thresholded."""
    from repro_torch.core.events import unpack_words
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.packed import pack_spikes_ref
    from repro_torch.kernels.spike_matmul.ref import block_skip_mask

    gen = torch.Generator(device=cuda).manual_seed(31)
    m, k, n = 300, 1100, 150
    x = _spikes(gen, m, k, 0.3, cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * (2.0 / k ** 0.5)
    b = 0.3 * torch.randn((n,), generator=gen, device=cuda)
    xx = pack_spikes_ref(x) if packed else x
    fmt = "packed" if packed else "dense"
    # v_th far from every potential: no recheck, the tensor-core sums
    args = K.fused_pe_operands(xx, w, bias=b, emit_current=True, skip=skip,
                               out_format=fmt, v_th=1e30)
    first = K.fused_pe_cuda(*args)[-1]
    v_th = float(first[7, 11])
    args = K.fused_pe_operands(xx, w, bias=b, emit_current=True, skip=skip,
                               out_format=fmt, v_th=v_th)
    spk, _, cur = K.fused_pe_cuda(*args)
    xp, wp, vld = K.fused_pe_operands(x, w)[:3]
    seq = (K.sequential_product(xp, wp, block_skip_mask(vld, xp.shape))
           + args[3])[:m, :n]
    near = (first - v_th).abs() < K.RECHECK_BAND
    assert bool(near[7, 11])
    assert torch.equal(cur[near], seq[near])
    assert torch.equal(cur[~near], first[~near])
    spk = (unpack_words(spk) if packed else spk)[:m, :n]
    assert torch.equal(spk, (cur >= v_th).to(torch.int8))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_spike_x_tile_train_matches_the_scalar_chain(cuda, packed, soft):
    """A T = 4 scan through the stateful launch, each step's recheck
    replaying the steps before it: every step's spikes equal those of the
    plain recurrence on the scalar tile's chain (``sequential_product``),
    bit for bit."""
    from repro_torch.core.events import unpack_words
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.packed import pack_spikes_ref

    gen = torch.Generator(device=cuda).manual_seed(41)
    t, m, k, n = 4, 2048, 512, 256
    x = torch.stack([_spikes(gen, m, k, 0.3, cuda) for _ in range(t)])
    w = torch.randn((k, n), generator=gen, device=cuda) * (2.0 / k ** 0.5)
    b = 0.3 * torch.randn((n,), generator=gen, device=cuda)
    r = 0.3 * torch.randn((t, m, n), generator=gen, device=cuda)
    spk, _ = K.fused_pe_layer(pack_spikes_ref(x) if packed else x, w,
                              bias=b, residual=r, tau=0.7, soft_reset=soft,
                              out_format="packed" if packed else "dense")
    if packed:
        spk = unpack_words(spk.words)[:, :m, :n]
    xp, wp = K.fused_pe_operands(x[0], w)[:2]
    v = torch.zeros((m, n), device=cuda)
    s = torch.zeros_like(v)
    for ti in range(t):
        xt = K.fused_pe_operands(x[ti], w)[0]
        prod = K.sequential_product(xt, wp,
                                    torch.ones_like(xt, dtype=torch.bool))
        cur = (prod[:m, :n] + b) + r[ti]
        v = 0.7 * v * (1.0 - s) + cur
        fire = (v >= 1.0).float()
        assert torch.equal(spk[ti], fire.to(torch.int8)), f"step {ti}"
        v = v - fire if soft else v * (1.0 - fire)
        s = fire


@pytest.mark.parametrize("packed", [False, True])
def test_spike_x_tile_train_step_writes_no_operand(cuda, packed):
    """The steps of a T = 4 train launched one by one on views of one
    padded copy (``train_operands``), each replaying the steps before it
    near v_th: no launch writes an operand; the spikes are the emitted
    current plus the decayed state the launch returns last (v_prev, but
    where it replayed; asked for with ``state_out``) thresholded, and that
    state lies within rtol 1e-5, atol 1e-4 of v_prev."""
    from repro_torch.core.events import unpack_words
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.packed import pack_spikes_ref

    gen = torch.Generator(device=cuda).manual_seed(43)
    t, m, k, n = 4, 2048, 512, 256
    x = torch.stack([_spikes(gen, m, k, 0.3, cuda) for _ in range(t)])
    w = torch.randn((k, n), generator=gen, device=cuda) * (2.0 / k ** 0.5)
    b = 0.3 * torch.randn((n,), generator=gen, device=cuda)
    r = 0.3 * torch.randn((t, m, n), generator=gen, device=cuda)
    xx = pack_spikes_ref(x) if packed else x
    xh, rh = K.train_operands(xx, r, 128, 128)
    held = (xh.clone(), rh.clone())
    v = torch.zeros((m, n), device=cuda)
    s = torch.zeros((m, n), dtype=torch.int8, device=cuda)
    for ti in range(t):
        args = K.fused_pe_operands(xx[ti], w, bias=b, residual=r[ti],
                                   v_prev=v, s_prev=s, tau=0.7,
                                   emit_current=True, train=(xh, rh, ti),
                                   out_format="packed" if packed else "dense")
        v0, s0 = v.clone(), s.clone()
        outs = K.fused_pe_cuda(*args, state_out=True)
        assert torch.equal(v, v0) and torch.equal(s, s0)
        assert torch.equal(xh, held[0]) and torch.equal(rh, held[1])
        spk, _, v_next, cur = outs[:4]
        used = outs[4] if ti else v
        assert len(outs) == 4 + (ti > 0)
        torch.testing.assert_close(used, v, rtol=1e-5, atol=1e-4)
        spk = (unpack_words(spk) if packed else spk)[:m, :n]
        own = (0.7 * used * (1.0 - s.float()) + cur) >= 1.0
        assert torch.equal(spk, own.to(torch.int8)), f"step {ti}"
        v, s = v_next, spk


# ------------------------------------------- the pack kernel and the head
SENTINEL = 0x7F7F7F7F


def _pack_into_sentinel(P, x3):
    """The pack kernel's words and maps, launched into outputs filled with
    a sentinel: a word or map entry left unwritten stays 0x7f7f7f7f."""
    nb, m, k = x3.shape
    mp, kp = -(-m // 128) * 128, -(-k // 128) * 128
    out = tuple(torch.full(s, SENTINEL, dtype=torch.int32, device=x3.device)
                for s in ((nb, mp, kp // 32), (nb, mp // 128, kp // 128),
                          (nb, mp // 128, kp // 128)))
    return P.pack_spikes_cuda(x3, out=out)


def _misaligned(x):
    """x's values in a contiguous view whose data pointer is 16-byte
    misaligned (one byte past an aligned start)."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 1
    return view


@pytest.mark.parametrize("n", [64, 128, 256, 512])
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
def test_pack_kernel_bit_equal_on_trains(cuda, n, density):
    """A [4, M, N] train (the T = 4 launches' shape) at each main-path
    width, aligned and 16-byte misaligned (the byte loop): words, vld_cnt
    and occ bit-equal to the plain pack, every entry written."""
    from repro_torch.kernels import packed as P

    gen = torch.Generator(device=cuda).manual_seed(n)
    x = _ragged_spikes(gen, (4, 4096 + 64, n), density, cuda)
    ref = P.pack_spikes_ref(x, with_occ=True)
    for xx in (x, _misaligned(x)):
        words, vld, occ = _pack_into_sentinel(P, xx)
        assert torch.equal(words, ref.words)
        assert torch.equal(vld, ref.vld_cnt) and torch.equal(occ, ref.occ)


@pytest.mark.parametrize("shape", [(2, 4059, 300), (3, 130, 33),
                                   (1, 200, 48), (2, 129, 640)])
def test_pack_kernel_bit_equal_on_ragged_operands(cuda, shape):
    """Ragged k and m (the byte loop where k % 16 != 0), k % 32 == 16, and
    a k whose segments round up past its last block: bit-equal, every
    entry written, aligned and misaligned."""
    from repro_torch.kernels import packed as P

    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = _ragged_spikes(gen, shape, 0.3, cuda)
    ref = P.pack_spikes_ref(x, with_occ=True)
    for xx in (x, _misaligned(x)):
        words, vld, occ = _pack_into_sentinel(P, xx)
        assert torch.equal(words, ref.words)
        assert torch.equal(vld, ref.vld_cnt) and torch.equal(occ, ref.occ)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("b,h,c,window,classes", [(256, 4, 512, 4, 10),
                                                  (256, 4, 512, 4, 100),
                                                  (5, 8, 64, 4, 10),
                                                  (6, 4, 32, 2, 10),
                                                  (4, 2, 64, 1, 10),
                                                  (7, 6, 40, 3, 10),
                                                  (9, 2, 24, 1, 3),
                                                  (301, 4, 64, 4, 10),
                                                  (1100, 4, 64, 4, 10)])
def test_w2ttfs_kernel_dtypes_match_plain(cuda, dtype, b, h, c, window,
                                          classes):
    """The head on int8, bf16 and f32 maps within rtol 1e-5, atol 1e-4 of
    its plain version, and the same logits bit for bit whatever the
    dtype; 5, 256, 301 and 1100 images take 1, 2, 3 and 8 a CTA (301 a
    partial last CTA); window 3 and channels not a multiple of 16 bytes
    take the general loops; an int8 map of any values (not only
    spikes) within rtol 1e-5, atol 1e-3 (its logits are up to 127 times
    larger)."""
    from repro_torch.kernels import w2ttfs_pool as K

    gen = torch.Generator(device=cuda).manual_seed(b + c + classes)
    s = torch.rand((b, h, h, c), generator=gen, device=cuda) < 0.3
    feats = (h // window) ** 2 * c
    fc_w = torch.randn((feats, classes), generator=gen, device=cuda)
    fc_b = torch.randn((classes,), generator=gen, device=cuda)
    sd = s.to(dtype)
    out = K.w2ttfs_pool_cuda(sd, fc_w, fc_b, window)
    torch.testing.assert_close(out, K.w2ttfs_pool_fc_ref(sd, fc_w, fc_b,
                                                         window),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(out, K.w2ttfs_pool_cuda(s.to(torch.int8), fc_w, fc_b,
                                               window))
    if dtype == torch.int8:       # any int8 value: the biased integer sums
        v = torch.randint(-128, 128, s.shape, generator=gen, device=cuda,
                          dtype=torch.int8)
        torch.testing.assert_close(K.w2ttfs_pool_cuda(v, fc_w, fc_b, window),
                                   K.w2ttfs_pool_fc_ref(v, fc_w, fc_b, window),
                                   rtol=1e-5, atol=1e-3)


def test_packed_forward_at_four_steps_launch_counts(cuda):
    """QKFResNet-11 at T = 4 under fused_packed: the stem packs once and
    each of the 13 stateful passes packs its four steps in one launch;
    the K pass's q is unpacked once a step and the head's map once; the
    head runs once a step on the int8 map; logits equal fused_dense's."""
    from repro_torch.kernels import _build
    from repro_torch.models import snn_cnn

    cfg = snn_cnn.SNNCNNConfig(arch="qkfresnet11", width_mult=0.125,
                               image_size=16, timesteps=4)
    fused = snn_cnn.fuse_model(
        snn_cnn.init(torch.Generator().manual_seed(0), cfg), cfg)
    img = torch.rand((2, 16, 16, 3), device=cuda)
    dense, _, _ = snn_cnn.forward(fused, img, cfg, policy="fused_dense")
    _build.reset_launches()
    with _build.capture_launches() as captured:
        logits, _, _ = snn_cnn.forward(fused, img, cfg,
                                       policy="fused_packed")
        torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {
        "lif_update": 4, "fused_pe": 52, "spike_matmul": 12,
        "w2ttfs_pool": 4, "pack_spikes": 14, "unpack_spikes": 5,
        **NO_BACKWARD}
    heads = [a for name, a, _, _ in captured if name == "w2ttfs_pool"]
    assert all(a[0].dtype == torch.int8 for a in heads)
    assert torch.equal(logits, dense)


# ------------------------------------------------------------ LM training
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grouped", [False, True])
def test_fused_pe_heads_emit_current_on_a_dense_x(cuda, dtype, grouped):
    """K2 as the LM's training forward launches it: a dense x of 300 rows
    with the emitted current, and (``grouped``) a grouped wk repeated to
    the query heads with the head-blocked mask, in both output formats:
    the current within rtol 1e-5, atol 1e-4 of the plain version's (whose
    cuBLAS product sums in another order), the spikes exactly the kernel's
    own current thresholded and masked and equal to the plain version's
    away from v_th, vld_next their block counts; and the current bit-equal
    to the fused multiply-add chain over k ascending, the kernel's own
    order."""
    from repro_torch.core.events import block_count_map_2d, unpack_words
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.chain import fma_chain

    gen = torch.Generator(device=cuda).manual_seed(3)
    h, hkv, dh, k = 4, 2, 64, 384
    x = torch.randn((300, k), generator=gen, device=cuda).to(dtype)
    if grouped:
        w = (torch.randn((k, hkv, 1, dh), generator=gen, device=cuda)
             / k ** 0.5).expand(k, hkv, h // hkv, dh).reshape(k, h * dh)
        q = (torch.rand((300, h * dh), generator=gen, device=cuda)
             < 0.1).to(torch.int8)
        heads = (h, dh)
    else:
        w = torch.randn((k, h * dh), generator=gen, device=cuda) / k ** 0.5
        q = heads = None
    maps = []
    for fmt in ("dense", "packed"):
        args = K.fused_pe_operands(x, w.contiguous(), q=q, qk_threshold=6.0,
                                   out_format=fmt, emit_current=True,
                                   heads=heads)
        got, want = K.fused_pe_cuda(*args), K.fused_pe_block_ref(*args)
        assert len(got) == len(want) == 3
        cur = got[2]
        torch.testing.assert_close(cur, want[2], rtol=1e-5, atol=1e-4)
        assert torch.equal(cur, fma_chain(x, w))
        spk, ref = ((unpack_words(got[0]), unpack_words(want[0]))
                    if fmt == "packed" else (got[0], want[0]))
        gate = (K.head_gate(q, heads, 6.0).bool() if grouped
                else torch.ones_like(cur, dtype=torch.bool))
        assert torch.equal(spk[:300, :h * dh],
                           ((cur >= 1.0) & gate).to(torch.int8))
        near = torch.zeros_like(spk, dtype=torch.bool)
        near[:300, :h * dh] = (want[2] - 1.0).abs() < 1e-4
        assert not bool(((spk != ref) & ~near).any())
        assert torch.equal(got[1], block_count_map_2d(spk, 128, 128))
        maps.append(spk)
    assert torch.equal(maps[0], maps[1])
    assert 0 < float(maps[0].float().mean()) < 0.5


def test_lm_train_step_fused_against_reference(cuda):
    """One ``fused_dense+grad`` gradient of the spiking LM at 4 layers in
    f32 (qwen3-1.7b's widths cut to d_model 256, 4 / 2 heads of 64) against
    ``reference+grad`` on the card (loss within 1e-4 relative, spike totals
    within 0.1 %) and against the same step on the kernels' plain twins
    with their own sums (``chain_launchers``: loss and spike totals equal,
    each gradient leaf within 1e-3 relative L2; a cuBLAS product sums in
    another order, so a spike that flips at v_th against the reference
    carries into the later layers' gradients); the launches of the step as
    the code implies them."""
    import contextlib
    import dataclasses

    from repro_torch.configs import build_model, get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.chain import chain_launchers
    from repro_torch.models.layers import spike_log
    from repro_torch.models.lm import spike_totals
    from repro_torch.train import make_grad_fn
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(
        get_config("qwen3-1.7b", spiking=True, attention_kind="qk_spiking"),
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=1000, dtype=torch.float32)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 65), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    runs = {}
    for policy, swap in (("reference+grad", contextlib.nullcontext),
                         ("fused_dense+grad", contextlib.nullcontext),
                         ("chain twins", chain_launchers)):
        model = build_model(dataclasses.replace(
            cfg, policy="fused_dense+grad" if swap is chain_launchers
            else policy))
        _build.reset_launches()
        with swap(), spike_log() as log:
            loss, _, grads = make_grad_fn(model.loss)(params,
                                                      {"tokens": toks})
            torch.cuda.synchronize()
        runs[policy] = (float(loss), tree_leaves(grads),
                        spike_totals(log, 4), dict(_build.LAUNCHES))
    (loss_r, _, t_r, l_r), (loss, g, t, launches), (loss_c, g_c, t_c, l_c) \
        = runs["reference+grad"], runs["fused_dense+grad"], runs["chain twins"]
    assert not any(l_r.values()) and not any(l_c.values())
    assert {k: v for k, v in launches.items() if v} == {
        "fused_pe": 8, "spike_matmul": 4, "spike_matmul_dx": 4,
        "spike_matmul_dw": 4}
    assert abs(loss - loss_r) <= 1e-4 * abs(loss_r)
    for kind, ref in t_r.items():
        rel = (t[kind].double() - ref.double()).abs() / ref.double().clamp(
            min=1.0)
        assert float(rel.max()) <= 1e-3, kind
    assert loss == loss_c
    assert all(torch.equal(t[kind], ref) for kind, ref in t_c.items())
    for a, b in zip(g, g_c):
        d = torch.linalg.vector_norm((a - b).double())
        n = torch.linalg.vector_norm(b.double())
        assert float(d) <= 1e-3 * float(n)


# ------------------------------------------------------- the float-x tile
# the LM step's rows (8 x 129, a thin last tile of 8 rows), a ragged 65
# and 129 (one live row past whole 64-row tiles) and 100 (a last tile of 36
# rows on the full mapping, its last two row warps idle)
FLOAT_TILE_ROWS = [65, 100, 129, 1032]


def _float_tile_oracle(K, args):
    """A float-x launch's outputs from the fused multiply-add chain over k
    ascending (``fma_chain``, the tile's own sums) on the padded operands:
    ((sum + bias) + residual) thresholded, gated, masked to the valid
    extent; vld_next its block counts; the current at the valid extent."""
    from repro_torch.core.events import (block_count_map_2d, pack_words,
                                         unpack_words)
    from repro_torch.kernels.chain import fma_chain

    (xp, wp, vld, bp, rp, qp, m0, n0, v_th, qk, packing, block_n, _, heads,
     _, _) = K.fused_pe_tile_operands(args)
    cur = fma_chain(xp, wp)
    if bp is not None:
        cur = cur + bp.reshape(1, -1)
    if rp is not None:
        cur = cur + (unpack_words(rp, torch.float32) if packing.residual
                     else rp)
    spk = (cur >= v_th).to(torch.int8)
    if qp is not None:
        q = unpack_words(qp) if packing.q else qp
        if heads is not None:
            spk[:, :heads[0] * heads[1]] *= K.head_gate(q, heads, qk)
        else:
            spk *= (q.to(torch.float32).sum(dim=1, keepdim=True)
                    >= qk).to(torch.int8)
    spk[m0:] = 0
    spk[:, n0:] = 0
    return (pack_words(spk) if packing.out else spk,
            block_count_map_2d(spk, 128, block_n), cur[:m0, :n0])


def _filled_outputs(monkeypatch, K):
    """Every launch's spikes and current preset to 0x7f7f7f7f bytes, so an
    output the kernel does not write shows (vld_next is zeroed: the tile
    adds into it)."""
    real = K.ops.launch_outputs

    def filled(*a, **kw):
        spikes, vld_next, v_next, current = real(*a, **kw)
        spikes.view(torch.int8).fill_(0x7f)
        if current is not None:
            current.view(torch.int32).fill_(0x7f7f7f7f)
        return spikes, vld_next, v_next, current

    monkeypatch.setattr(K.ops, "launch_outputs", filled)


@pytest.mark.parametrize("m", FLOAT_TILE_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["wq", "wk", "bias and residual"])
def test_float_tile_is_the_fma_chain(cuda, monkeypatch, m, dtype, variant):
    """The float-x tile at the LM's widths (K = N = 2048): wq (no q), the
    grouped wk expanded to the query heads with the head-blocked mask (q
    int8 and packed), and a bias with an f32 and a packed residual under
    the whole-row mask; each with the emitted current and without, int8
    and packed out, block_n 128 and 256, into outputs preset to
    0x7f7f7f7f. The current is the fused multiply-add chain bit for bit,
    the spikes, packed words and vld_next are the chain's (every position
    written, padded rows included), the packed map is the int8 one, and
    the spikes equal the plain version's (cuBLAS's order) away from v_th."""
    from repro_torch.core.events import unpack_words
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.packed import pack_spikes_ref

    _filled_outputs(monkeypatch, K)
    gen = torch.Generator(device=cuda).manual_seed(m + 17 * len(variant))
    k = n = 2048
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    kw, qs = {}, [None]
    if variant == "wq":
        w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    elif variant == "wk":
        w = (torch.randn((k, 8, 1, 128), generator=gen, device=cuda)
             / k ** 0.5).expand(k, 8, 2, 128).reshape(k, n).contiguous()
        q = (x.to(torch.float32) @ w >= 1.0).to(torch.int8)
        qs = [q, pack_spikes_ref(q)]
        kw = dict(heads=(16, 128), qk_threshold=20.0)
    else:
        w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
        q = (torch.rand((m, 512), generator=gen, device=cuda) < 0.3
             ).to(torch.int8)
        qs = [q]
        r = (torch.rand((m, n), generator=gen, device=cuda) < 0.3
             ).to(torch.int8)
        kw = dict(bias=0.2 * torch.randn((n,), generator=gen, device=cuda),
                  qk_threshold=150.0)
    for block_n in (128, 256):
        residuals = ([None] if variant != "bias and residual" else
                     [0.5 * torch.randn((m, n), generator=gen, device=cuda),
                      pack_spikes_ref(r, block_m=128, block_k=block_n)])
        for qq in qs:
            for res in residuals:
                maps = []
                for emit in (True, False):
                    for fmt in ("dense", "packed"):
                        args = K.fused_pe_operands(
                            x, w, q=qq, residual=res, out_format=fmt,
                            emit_current=emit, block_n=block_n, **kw)
                        assert args[0].shape[0] == m and args[2] is None
                        got = K.fused_pe_cuda(*args)
                        spk, vld, cur = _float_tile_oracle(K, args)
                        what = (f"{variant} q {type(qq).__name__} residual "
                                f"{type(res).__name__} bn {block_n} emit "
                                f"{emit} {fmt}")
                        assert torch.equal(got[0], spk), what
                        assert torch.equal(got[1], vld), what
                        if emit:
                            assert torch.equal(got[2], cur), what
                        maps.append(unpack_words(got[0]) if fmt == "packed"
                                    else got[0])
                        want = K.fused_pe_block_ref(*args)
                        p_spk = (unpack_words(want[0]) if fmt == "packed"
                                 else want[0])
                        near = torch.zeros_like(p_spk, dtype=torch.bool)
                        near[:m, :n] = (cur - 1.0).abs() < 1e-4
                        assert not bool(((maps[-1] != p_spk) & ~near).any())
                assert all(torch.equal(maps[0], t) for t in maps[1:])


@pytest.mark.parametrize("m", [1, 33, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_tile_bit_equal_to_the_decode_route(cuda, m, dtype):
    """At most 64 rows (the LM's decode ticks and prefill chunks) the
    decode route gives the float-x tile's spikes, packed words and
    vld_next bit for bit, padded rows included, at the LM's widths."""
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.packed import pack_spikes_ref

    gen = torch.Generator(device=cuda).manual_seed(m)
    k = n = 2048
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    q = (torch.rand((m, n), generator=gen, device=cuda) < 0.05).to(
        torch.int8)
    for qq in (None, q, pack_spikes_ref(q)):
        for fmt in ("dense", "packed"):
            kw = dict(q=qq, out_format=fmt, qk_threshold=5.0,
                      heads=None if qq is None else (16, 128))
            args = K.fused_pe_operands(x, w, **kw)
            assert K.pick_route(x, "dense") == "decode"
            assert _same(K.fused_pe_cuda(*args, route="decode"),
                         K.fused_pe_cuda(*args))


# ------------------------------------------------ the other LM families
# (h, dh, k): the spiking olmoe-1b-7b's and phi-3-vision-4.2b's q / k
# passes (K2, head-blocked) and wo (K3) at their published widths
FAMILY_SHAPES = [(16, 128, 2048), (32, 96, 3072)]


@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("h,dh,k", FAMILY_SHAPES)
def test_family_k2_k3_shapes_match_plain(cuda, h, dh, k, m):
    """K2's head-blocked pass on a bf16 x and K3 on its masked spikes at
    the two families' widths (a decode tick's 16 rows, a chunk's 64)
    against their plain versions: spikes equal away from v_th, K3 at the
    plain version's tolerance."""
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels import spike_matmul as K3

    gen = torch.Generator(device=cuda).manual_seed(h + m)
    n = h * dh
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    q = (torch.rand((m, n), generator=gen, device=cuda) < 0.05).to(
        torch.int8)
    args = K.fused_pe_operands(x, w, q=q, qk_threshold=1.0, heads=(h, dh))
    spk, _ = K.fused_pe_cuda(*args)
    ref, _ = K.fused_pe_block_ref(*args)
    cur = x.float() @ w
    near = torch.zeros_like(spk, dtype=torch.bool)
    near[:m, :n] = (cur - 1.0).abs() < 1e-4
    assert not bool(((spk != ref) & ~near).any())
    wo = torch.randn((n, k), generator=gen, device=cuda) / n ** 0.5
    margs = K3.spike_matmul_operands(spk[:m, :n].contiguous(), wo)
    torch.testing.assert_close(K3.spike_matmul_cuda(*margs),
                               K3.spike_matmul_block_ref(*margs),
                               rtol=1e-5, atol=1e-4)


FAMILY_ARCHS = ["olmoe-1b-7b", "mamba2-130m", "zamba2-7b",
                "phi-3-vision-4.2b", "seamless-m4t-large-v2"]


def _family_batch(cfg, dev, gen):
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=dev,
                         generator=gen)
    if cfg.family == "encdec":
        return {"src_embeds": torch.randn((2, 8, cfg.d_src), device=dev,
                                          generator=gen),
                "tgt_tokens": toks}
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn(
            (2, cfg.n_img_tokens, cfg.d_vision), device=dev, generator=gen)
    return batch


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_prefill_and_decode_on_the_card(cuda, arch):
    """Each family at reduced width (f32): prefill and three decode steps
    on the card against the same calls on the CPU, on the same parameters
    (rtol = atol = 1e-3: TF32 is off, the products sum in another
    order)."""
    from repro_torch.configs import build_model, get_config, reduced
    from repro_torch.tree import tree_map

    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    batch = _family_batch(cfg, cuda,
                          torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for dev, p, b in ((cuda, params, batch),
                      ("cpu", cpu_params,
                       {k: v.cpu() for k, v in batch.items()})):
        logits, cache = model.prefill(p, b, max_len=20)
        steps = [logits]
        tok = logits.argmax(-1)[:, None]
        for _ in range(3):
            logits, cache = model.decode_step(p, tok, cache)
            steps.append(logits)
            tok = logits.argmax(-1)[:, None]
        out[str(dev)] = torch.stack(steps)
    got, want = out[str(cuda)].cpu(), out["cpu"]
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-130m", "zamba2-7b",
                                  "phi-3-vision-4.2b"])
def test_family_engine_on_the_card(cuda, arch):
    """The engine at reduced width on the card: every request finishes
    with its tokens, chunked prefill; the spiking qk_spiking moe and vlm
    under fused_dense launch K2 twice and K3 once a layer per decode tick
    and prefill chunk."""
    from repro_torch.configs import build_model, get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.serve import Engine, EngineConfig

    spiking = arch in ("olmoe-1b-7b", "phi-3-vision-4.2b")
    over = (dict(spiking=True, attention_kind="qk_spiking")
            if spiking else {})
    cfg = reduced(get_config(arch, **over))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    _build.reset_launches()
    eng = Engine(model, params, EngineConfig(
        max_slots=3, max_len=64, prefill_pad=8, prefill_chunk=8,
        policy="fused_dense" if spiking else None))
    gen = torch.Generator().manual_seed(2)
    uids = [eng.submit(torch.randint(0, cfg.vocab_size, (int(n),),
                                     generator=gen).numpy(), max_new=4)
            for n in (5, 19, 11, 30)]
    fin = {r.uid: r for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    assert all(len(fin[u].out) == 4 and fin[u].status == "done"
               for u in uids)
    st = eng.stats()
    calls = st["decode_ticks"] + st["prefill_calls"]
    launches = dict(_build.LAUNCHES)
    if spiking:
        assert launches["fused_pe"] == 2 * cfg.n_layers * calls
        assert launches["spike_matmul"] == cfg.n_layers * calls
    else:
        assert sum(launches.values()) == 0


# ------------------------------------------------- self-healing serving
def test_guarded_kernel_passes_its_result_through(cuda):
    """The degradation guard around a fused mode hands back the kernel's
    own result, bit for bit, launches the kernel once and demotes
    nothing."""
    from repro_torch import ops
    from repro_torch.kernels import _build
    from repro_torch.ops import fallback

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _spikes(gen, 300, 200, 0.3, cuda)
    w = torch.randn((200, 150), generator=gen, device=cuda)
    blocks = ops.DEFAULT_BLOCKS
    bare = ops.implementations("matmul")["matmul", "fused"](
        ops.SpikeTensor.dense(x), w,
        block_m=blocks.m, block_n=blocks.n, block_k=blocks.k, skip="dense")
    _build.reset_launches()
    out = ops.matmul(x, w, policy="fused_dense")
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    assert _build.LAUNCHES["spike_matmul"] == 1
    assert fallback.demotions() == []


@pytest.mark.parametrize("fault", ["shape", "out_of_memory"])
def test_a_real_kernel_error_on_the_card_propagates(cuda, fault):
    """On CUDA tensors a real ``RuntimeError`` inside a guarded fused
    wrapper (a shape mismatch torch raises, an allocation the card
    refuses) reaches the caller: no demotion, no call of the reference."""
    from repro_torch import ops
    from repro_torch.ops import fallback
    from repro_torch.ops.registry import _REGISTRY, lookup

    x = torch.ones((300, 200), device=cuda)
    w = torch.ones((200, 150), device=cuda)
    real = ops.implementations("matmul")["matmul", "fused"]
    called = []

    def failing(*args, **kwargs):
        if fault == "shape":
            torch.mm(w, w)
        else:
            torch.empty(1 << 50, device=cuda)
        return real(*args, **kwargs)

    def reference(*args, **kwargs):
        called.append(True)
        return x @ w

    saved = {m: _REGISTRY[("matmul", m)] for m in ("fused", "reference")}
    try:
        _REGISTRY[("matmul", "fused")] = failing
        _REGISTRY[("matmul", "reference")] = reference
        with pytest.raises(RuntimeError) as info:
            lookup("matmul", "fused")(ops.SpikeTensor.dense(x), w)
        assert not isinstance(info.value, fallback.InjectedKernelFault)
        if fault == "out_of_memory":
            assert isinstance(info.value, torch.cuda.OutOfMemoryError)
        assert fallback.demotions() == [] and called == []
    finally:
        _REGISTRY.update({("matmul", m): f for m, f in saved.items()})
        fallback.reset()


def test_chaos_trace_equals_the_kernel_only_run(cuda):
    """The reduced spiking LM under fused_packed on the card, two replicas
    sharing it, the guard on every tick: the chaos plan (a replica killed,
    NaN injections, a corrupted packed word, a consumer stall, dense_lif
    failed) gives every request once, done, with the tokens of a run whose
    only fault is the kernel fault; after a reset K2 launches again."""
    import warnings

    import numpy as np

    from repro_torch.configs import build_model, get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.ops import fallback, with_policy
    from repro_torch.serve import (EngineConfig, FaultPlan, ReplicaRouter,
                                   demo_chaos_plan)

    cfg = reduced(get_config("qwen3-1.7b", spiking=True,
                             attention_kind="qk_spiking"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    ecfg = EngineConfig(max_slots=4, max_len=64, prefill_pad=8,
                        prefill_chunk=8, policy="fused_packed",
                        integrity_every=1, quarantine_retries=3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20)))
               for _ in range(8)]

    def run(plan):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            router = ReplicaRouter(model, params, ecfg, n_replicas=2,
                                   faults=plan)
            uids = [router.submit(p, max_new=8) for p in prompts]
            fin = {r.uid: r for r in router.run_until_drained()}
        assert sorted(fin) == sorted(uids)
        assert all(r.status == "done" for r in fin.values())
        return router, uids, [fin[u].out for u in uids]

    try:
        _, _, want = run(FaultPlan(0).fail_kernel("dense_lif", 0))
        fallback.reset()
        plan = (demo_chaos_plan(0, n_replicas=2, kill_tick=6,
                                nan_ticks=(2, 5))
                .corrupt_word(4).stall_consumer(1, ticks=2))
        router, uids, got = run(plan)
        assert got == want
        st = router.stats()
        assert st["alive"] == [True, False] and st["failovers"] == 1
        assert [f["reason"] for f in st["failures"]] == [
            "step raised: injected replica death at tick 6"]
        assert sum(p.get("quarantined", 0) for p in st["per_replica"]) >= 3
        assert [d["op"] for d in fallback.demotions()] == ["dense_lif"]
        for u, toks in zip(uids, got):
            assert router.pop_output(u) == toks
            assert router.pop_output(u) == []
    finally:
        fallback.reset()
    fused = build_model(with_policy(cfg, "fused_packed"))
    cache = fused.init_cache(4, 16, device=cuda)
    _build.reset_launches()
    fused.decode_step(params, torch.zeros((4, 1), dtype=torch.int64,
                                          device=cuda), cache)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_pe"] == 2 * cfg.n_layers


# ------------------------------------------------------- the training driver
def test_driver_resumes_bit_equal_on_the_card(cuda, tmp_path):
    """``launch.train.main`` on the card (NCCL, a world of one) at reduced
    width under ``fused_dense+grad``: a checkpoint at step 2, a failure at
    3, the restore and remesh, then steps 3 and 4: the reference's events,
    and losses and final state bit-equal to the uninterrupted run's; the
    step's kernels launched; no process group left behind."""
    from repro_torch.kernels import _build
    from repro_torch.launch.train import main
    from repro_torch.tree import tree_leaves

    args = ["--reduced", "--spiking", "--qk-attention", "--policy",
            "fused_dense", "--steps", "5", "--batch", "4", "--seq", "32"]
    _build.reset_launches()
    cut = main(args + ["--ckpt-every", "2", "--simulate-failure", "3",
                       "--ckpt-dir", str(tmp_path / "cut")])
    assert _build.LAUNCHES["fused_pe"] > 0
    assert _build.LAUNCHES["spike_matmul_dw"] > 0
    whole = main(args + ["--ckpt-every", "100",
                         "--ckpt-dir", str(tmp_path / "whole")])
    assert [{k: v for k, v in e.items() if k != "path"}
            for e in cut.events] == [
        {"kind": "checkpoint", "step": 2}, {"kind": "failure", "step": 3},
        {"kind": "restore", "step": 2},
        {"kind": "remesh", "mesh": {"data": 1}, "resume_step": 3},
        {"kind": "checkpoint", "step": 4}]
    assert whole.events == [] and cut.losses == whole.losses
    a, b = tree_leaves(cut.state), tree_leaves(whole.state)
    assert len(a) == len(b)
    assert all(x.device.type == "cuda" and torch.equal(x, y)
               for x, y in zip(a, b))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("magnitude", [1.0, 3e4, 1e-20])
def test_compress_int8_on_the_card_equals_the_cpu(cuda, magnitude):
    """int8 compression divides by tensors, so the card's quotients are the
    CPU's (a host scalar divisor would be a reciprocal multiply there):
    q, scale, the dequantised values and, through NCCL at a world of one,
    ``compressed_psum_grads``'s means and residuals, bit for bit; the
    int8 ties at .5 rounded to even."""
    from repro_torch.launch import mesh
    from repro_torch.optim import (compress_int8, compressed_psum_grads,
                                   decompress_int8)

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1000, 333), generator=gen) * magnitude
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -2.5])
    for host in (x, ties):
        q, s = compress_int8(host.to(cuda))
        qh, sh = compress_int8(host)
        assert torch.equal(q.cpu(), qh) and torch.equal(s.cpu(), sh)
        assert torch.equal(decompress_int8(q, s).cpu(),
                           decompress_int8(qh, sh))
    assert compress_int8(ties.to(cuda))[0].tolist() == [127, 0, 2, 2, 0, -2,
                                                        126, -2]
    err = torch.randn((1000, 333), generator=gen) * 1e-3 * magnitude
    made = mesh.init_distributed(cuda)
    try:
        mean, new_err = compressed_psum_grads(
            {"blocks": [{"w": x.to(cuda)}, {"w": 2 * x.to(cuda)}]},
            {"blocks": [{"w": err.to(cuda)}, {"w": err.to(cuda)}]})
    finally:
        if made:
            mesh.shutdown_distributed()
    scale = torch.clamp(torch.maximum((x + err).abs().max(),
                                      (2 * x + err).abs().max()),
                        min=1e-12) / torch.tensor(127.0)
    for i, g in enumerate((x + err, 2 * x + err)):
        deq = torch.clamp(torch.round(g / scale), -127, 127).to(
            torch.int8).float() * scale
        assert torch.equal(mean["blocks"][i]["w"].cpu(), deq)
        assert torch.equal(new_err["blocks"][i]["w"].cpu(), g - deq)


def test_contract_sweep_outputs_on_the_card(cuda):
    """The contract sweep's fused cells on CUDA tensors (the kernels'
    pad and tile algebra at the ragged 130 x 96 x 72 included): every
    output's shapes, dtypes, formats and vld_cnt grids are those the sweep
    found on the CPU, with no downgrade and no demotion."""
    from repro_torch.analysis.contracts import device_check, verify_contracts
    from repro_torch.ops import fallback

    report = verify_contracts()
    assert not report.findings, [str(f) for f in report.findings]
    n, bad = device_check(cuda, report)
    assert n > 50 and not bad, bad[:10]
    assert fallback.demotions() == []


# ---------------------------------------------------------- the dry runs
@pytest.mark.parametrize("policy", ["reference+grad", "fused_dense+grad"])
def test_op_recorder_on_the_card_against_the_fake_trace(cuda, policy):
    """One ``make_train_step`` step of the reduced spiking qwen3-1.7b on
    the card (NCCL, a world of one) under ``launch.hlo_analysis``'s
    recorder, against ``launch.dryrun.trace_step`` of the same step on
    fake CPU tensors: the same argument bytes and all-reduces (a gradient
    leaf each and the metrics' one); under ``reference+grad`` the same
    ops, flops, bytes and memory fields; under ``fused_dense+grad`` each
    fused call one node (the dx / dw launches of its backward are no aten
    op, so the card's flops are at most the trace's)."""
    from repro_torch.analysis.abstract import (module_param_shapes,
                                               optimizer_shapes)
    from repro_torch.configs import build_model, get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, hlo_analysis, mesh
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.tree import tree_leaves

    cfg = reduced(get_config("qwen3-1.7b", spiking=True,
                             attention_kind="qk_spiking", policy=policy))
    model = build_model(cfg)
    shape = ShapeSpec("small", "train", 33, 4)
    params = module_param_shapes(model.init)
    one = mesh.Mesh((1, 1), ("data", "model"), device="cpu")
    fake, fake_out = dryrun.trace_step(model, shape, one, params,
                                       optimizer_shapes(adamw_init, params))
    made = mesh.init_distributed(cuda)
    try:
        state = train_state_init(model.init(
            torch.Generator(device=cuda).manual_seed(0), device=cuda))
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (4, 33), dtype=torch.int32, device=cuda)}
        step = make_train_step(
            model, schedule=constant_lr(3e-4), weight_decay=0.1,
            clip_norm=1.0, dp_group=mesh.Mesh(
                (1, 1), ("data", "model"), device=cuda).get_group("data"))
        with hlo_analysis.OpRecorder((state, batch), donated=state) as rec:
            out = step(state, batch)
        torch.cuda.synchronize()
    finally:
        if made:
            mesh.shutdown_distributed()
    a, b = hlo_analysis.analyze(fake.record), hlo_analysis.analyze(
        rec.record)
    ma, mb = fake.memory_analysis(fake_out), rec.memory_analysis(out)
    assert ma["argument_size_in_bytes"] == mb["argument_size_in_bytes"]
    n_leaves = len(tree_leaves(state.params))
    assert a["collectives"]["all-reduce"]["count"] == \
        b["collectives"]["all-reduce"]["count"] == n_leaves + 1
    if policy.startswith("reference"):
        assert [e["op"] for e in fake.record] == [e["op"] for e in
                                                  rec.record]
        assert a == b and ma == mb
    else:
        nodes = [e["op"] for e in rec.record if e.get("node")]
        assert nodes == [e["op"] for e in fake.record if e.get("node")]
        assert nodes and 0 < b["flops"] <= a["flops"]
