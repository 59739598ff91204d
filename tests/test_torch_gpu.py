"""Card-only checks of the port: each hand-written kernel against its plain
version on the GPU, and the deployed forward's launch counts. Marked
``gpu``; without a CUDA device every test skips. On a machine with one:

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
                                     "spike_matmul": 3, "w2ttfs_pool": 1}
    ref, _, _ = snn_cnn.forward(fused, img, cfg, policy="reference")
    assert logits.device.type == "cuda"
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-5)
