"""The decode route of the fused PE (K2) and spike matmul (K3) kernels, on
the CPU: the wrappers' choice of route as a plain function of the shapes,
and the operands and outputs a decode-route launch is given, built on CPU
tensors without launching anything. The decode route's operands padded
back to the 128-row tile's must be the tile route's operands exactly (zero
padded rows, the all-ones vld map of a float x), and the plain version on
them must give what the wrapper gives. The route's bits against the tile's
are checked on the card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core.events import PackedSpikes, pack_spikes_ref
from repro_torch.kernels import fused_pe as F
from repro_torch.kernels import spike_matmul as S


def _same(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    return a == b


def _spikes(rng, m, k, density=0.3):
    return torch.tensor((rng.random((m, k)) < density).astype(np.int8))


@pytest.mark.parametrize("m", [0, 1, 16, 63, 64, 65, 128, 300])
@pytest.mark.parametrize("skip", ["dense", "gated", "two_level"])
def test_pick_route_is_the_shape_rule(m, skip):
    """K3: the decode route for at most 64 live rows on the dense skip."""
    want = "decode" if skip == "dense" and m <= 64 else "tile"
    assert S.pick_route(m, skip) == want
    assert S.DECODE_ROWS == 64 and S.ROUTES == ("tile", "decode")


def test_pick_route_refuses_an_unknown_skip():
    with pytest.raises(ValueError):
        S.pick_route(16, "sparse")


def _x(rng, kind, m, k):
    xs = _spikes(rng, m, k)
    return {"bf16": torch.tensor(rng.standard_normal((m, k)).astype(
                np.float32)).to(torch.bfloat16),
            "f32": torch.tensor(rng.standard_normal((m, k)).astype(np.float32)),
            "int8": xs, "packed": pack_spikes_ref(xs)}[kind]


# what a fused PE launch carries beside x: nothing, a residual, the LIF
# state, or the emitted current
EXTRAS = ["none", "residual", "state", "current"]


def _extra(rng, extra, m, n):
    return {"none": {},
            "residual": {"residual": torch.tensor(
                rng.standard_normal((m, n)).astype(np.float32))},
            "state": {"v_prev": torch.zeros(m, n)},
            "current": {"emit_current": True}}[extra]


@pytest.mark.parametrize("m", [1, 64, 65])
@pytest.mark.parametrize("x_kind", ["bf16", "f32", "int8", "packed"])
@pytest.mark.parametrize("extra", EXTRAS)
def test_fused_pe_pick_route_takes_the_lm_projections_only(m, x_kind, extra):
    """K2: the decode route for a dense f32 or bf16 activation x of at most
    64 rows on the dense skip, without residual, state or emitted current
    (the LM's projections); every other launch keeps the 128-row tile."""
    rng = np.random.default_rng(m)
    x = _x(rng, x_kind, m, 128)
    kw = _extra(rng, extra, m, 128)
    want = ("decode" if x_kind in ("bf16", "f32") and m <= 64
            and extra == "none" else "tile")
    assert F.pick_route(x, "dense", **kw) == want
    if x_kind in ("int8", "packed"):
        assert F.pick_route(x, "gated", **kw) == "tile"


@pytest.mark.parametrize("skip", ["gated", "two_level"])
def test_decode_operands_take_the_dense_skip_only(skip):
    rng = np.random.default_rng(0)
    x, w = _spikes(rng, 16, 256), torch.randn(256, 128)
    with pytest.raises(ValueError):
        S.spike_matmul_operands(x, w, skip=skip, route="decode")
    with pytest.raises(ValueError):
        F.fused_pe_operands(x, w, skip=skip, route="decode")


@pytest.mark.parametrize("x_kind,extra", [
    ("int8", "none"), ("packed", "none"), ("bf16", "residual"),
    ("f32", "current"), ("int8", "state")])
def test_fused_pe_decode_operands_refuse_what_the_route_lacks(x_kind, extra):
    """The decode route has no instance for a spike x, a residual, the LIF
    state or the emitted current: asking for its operands raises."""
    rng = np.random.default_rng(1)
    x, w = _x(rng, x_kind, 16, 256), torch.randn(256, 128)
    with pytest.raises(ValueError, match="decode route"):
        F.fused_pe_operands(x, w, route="decode", **_extra(rng, extra, 16, 128))


@pytest.mark.parametrize("m", [1, 16, 33, 64])
@pytest.mark.parametrize("x_kind,q_kind,out_format", [
    ("bf16", None, "dense"), ("f32", "int8", "dense"),
    ("bf16", "packed", "packed"), ("f32", "packed", "dense"),
    ("bf16", "int8", "packed")])
def test_fused_pe_decode_operands_pad_back_to_the_tiles(m, x_kind, q_kind,
                                                        out_format):
    """x and q at their own m rows (columns padded; packed words come
    128-row padded), no vld map, in the tile's order; padded back, the
    tile route's operands tensor for tensor, and the plain version on them
    gives the wrapper's spikes."""
    rng = np.random.default_rng(m)
    k, h, dh = 200, 3, 48
    n = h * dh
    x = _x(rng, x_kind, m, k)
    w = torch.tensor((rng.standard_normal((k, n)) * 0.2).astype(np.float32))
    b = torch.tensor((rng.standard_normal(n) * 0.1).astype(np.float32))
    qs = _spikes(rng, m, n, 0.05)
    q = {None: None, "int8": qs, "packed": pack_spikes_ref(qs)}[q_kind]
    kw = dict(bias=b, q=q, qk_threshold=2.0, out_format=out_format,
              heads=None if q is None else (h, dh))
    dec = F.fused_pe_operands(x, w, route="decode", **kw)
    tile = F.fused_pe_operands(x, w, **kw)
    assert len(dec) == len(tile) == 15
    xp, vld, qp = dec[0], dec[2], dec[5]
    assert xp.shape[0] == m and vld is None and dec[4] is None
    if qp is not None:
        assert qp.shape[0] == (128 if q_kind == "packed" else m)
    back = F.fused_pe_tile_operands(dec)
    assert _same(back, tile)
    assert _same(F.fused_pe_tile_operands(tile), tile)
    for t in (back[0], back[5]):                   # the padded rows: zeros
        if t is not None and not t.dtype == torch.int32:
            assert not bool(t[m:].ne(0).any())
    spikes, vld_next = F.fused_pe_block_ref(*back)[:2]
    want, want_vld = F.fused_pe(x, w, **kw)
    if out_format == "packed":
        assert torch.equal(spikes, want.words)
    else:
        assert torch.equal(spikes[:m, :n], want)
    assert torch.equal(vld_next, want_vld)


def test_fused_pe_decode_operands_check_a_given_vld_grid():
    """A float x's producer-given count map is checked against the grid of
    its rows padded to 128, and kept."""
    x = torch.randn(16, 256)
    ok = torch.ones(1, 2, dtype=torch.int32)
    assert torch.equal(F.fused_pe_operands(x, torch.randn(256, 128), vld_cnt=ok,
                                           route="decode")[2], ok)
    with pytest.raises(ValueError):
        F.fused_pe_operands(x, torch.randn(256, 128),
                            vld_cnt=torch.ones(2, 2, dtype=torch.int32),
                            route="decode")


@pytest.mark.parametrize("m", [1, 7, 16, 33, 64])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("given_vld", [False, True])
def test_spike_matmul_decode_operands_pad_back_to_the_tiles(m, packed,
                                                            given_vld):
    """(x, w, vld, packed) in the tile's order: an int8 x at its own rows,
    its count map on the 128-row grid (computed, or a producer's, checked);
    a packed x's first m rows of words; padded back, the tile's
    operands."""
    rng = np.random.default_rng(100 + m)
    x = _spikes(rng, m, 300)
    x[:, 128:256] = 0
    w = torch.tensor(rng.standard_normal((300, 100)).astype(np.float32))
    tile = S.spike_matmul_operands(pack_spikes_ref(x) if packed else x, w)
    vld = tile[2] if given_vld else None
    dec = S.spike_matmul_operands(pack_spikes_ref(x) if packed else x, w,
                                  vld_cnt=vld, route="decode")
    assert len(dec) == 4 and dec[0].shape[0] == m and dec[3] == packed
    assert torch.equal(dec[2], tile[2]) and int(dec[2][0, 1]) == 0
    assert _same(S.spike_matmul_tile_operands(dec), tile)
    assert _same(S.spike_matmul_tile_operands(tile), tile)
    out = S.spike_matmul_block_ref(*S.spike_matmul_tile_operands(dec))
    torch.testing.assert_close(out[:m, :100], x.float() @ w, rtol=1e-5,
                               atol=1e-4)


def test_spike_matmul_decode_operands_check_the_vld_grid():
    rng = np.random.default_rng(3)
    x, w = _spikes(rng, 16, 256), torch.randn(256, 128)
    with pytest.raises(ValueError):
        S.spike_matmul_operands(x, w, vld_cnt=torch.ones(2, 2, dtype=torch.int32),
                                route="decode")


@pytest.mark.parametrize("route,block_n", [("decode", 128), ("decode", 256),
                                           ("tile", 128), ("tile", 256)])
@pytest.mark.parametrize("out_format", ["dense", "packed"])
def test_launch_outputs_at_the_padded_shape(route, block_n, out_format):
    """The spikes at the padded shape (the kernel writes every position,
    padded rows included); vld_next on the padded rows' (128, block_n)
    grid, zeroed only where the tile route's two CTAs of a 256-wide count
    tile add into it (the decode route's CTAs add into the count scratch);
    v_next and the current at the valid extent."""
    packing = F.Packing(out=out_format == "packed", current=True)
    spikes, vld_next, v_next, current = F.launch_outputs(
        256, 512, 16, 500, packing, block_n, True, route, "cpu")
    assert vld_next.shape == (2, 512 // block_n)
    assert vld_next.dtype == torch.int32
    if route == "tile" and block_n == 256:
        assert not bool(vld_next.any())
    assert spikes.shape == ((256, 16) if out_format == "packed"
                            else (256, 512))
    assert v_next.shape == current.shape == (16, 500)


def test_count_scratch_is_zeroed_and_kept_per_stream():
    """The decode route's count scratch: a zeroed int32 a count tile (its
    CTAs add their counts and arrivals into it), one buffer a (device,
    stream) reused across launches (each leaves it zero), grown when a
    launch has more tiles."""
    a = F.count_scratch("cpu", 11, 16)
    assert a.dtype == torch.int32 and a.numel() >= 16 and not bool(a.any())
    assert F.count_scratch("cpu", 11, 16) is a
    assert F.count_scratch("cpu", 12, 16) is not a
    big = F.count_scratch("cpu", 11, 4096)
    assert big.numel() >= 4096 and not bool(big.any())
    assert F.count_scratch("cpu", 11, 16) is big


def test_the_cuda_launchers_refuse_cpu_operands():
    """On the CPU a wrapper runs the plain version; the launchers, given CPU
    tensors, raise rather than fall back, on either route."""
    rng = np.random.default_rng(4)
    x, w = _spikes(rng, 16, 256), torch.randn(256, 128)
    a = torch.randn(16, 256)
    for route in S.ROUTES:
        with pytest.raises(ValueError, match="CUDA"):
            F.fused_pe_cuda(*F.fused_pe_operands(a, w, route=route),
                            route=route)
        with pytest.raises(ValueError, match="CUDA"):
            S.spike_matmul_cuda(*S.spike_matmul_operands(x, w, route=route),
                                route=route)


def test_a_packed_x_keeps_its_own_row_blocks():
    """A packed x arrives 128-row padded (PackedSpikes pins its grid): the
    decode route reads its first m rows of words, and its vld map on the
    128-row grid as it comes."""
    rng = np.random.default_rng(5)
    ps = pack_spikes_ref(_spikes(rng, 9, 256))
    assert isinstance(ps, PackedSpikes) and ps.words.shape == (128, 8)
    dec = S.spike_matmul_operands(ps, torch.randn(256, 64), route="decode")
    assert dec[0].shape == (9, 8) and dec[0].is_contiguous()
    assert torch.equal(dec[0], ps.words[:9]) and dec[2].shape == (1, 2)
