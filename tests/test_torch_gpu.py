"""Card-only checks of the port: each hand-written kernel, and each packed
variant, against its plain version on the GPU, and the deployed forward's
launch counts under ``fused_dense`` and ``fused_packed``. Marked ``gpu``;
without a CUDA device every test skips. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Imports only torch and the port, so it runs where JAX is not installed.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu


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
                                     "pack_spikes": 0, "unpack_spikes": 0}
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
                                     "pack_spikes": 1, "unpack_spikes": 1}
    for name, args, _ in captured:
        if name == "fused_pe":
            assert args[-1].x and args[-1].out
        elif name == "spike_matmul":
            assert args[-1] is True
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
    packing = args[-1]
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
