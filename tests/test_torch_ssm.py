"""The port's Mamba2 (SSD) layer and the ssm and hybrid LM families on
the CPU against the JAX package: ``_ssd_chunked`` against JAX's and against
a per-token recurrence written here in torch (chunks 4, 8 and 16, and the
``init_state`` continuation, as ``tests/test_ssd_oracle.py`` holds JAX's),
``rmsnorm_gated_apply``, ``mamba_apply`` (a remainder chunk, a conv tail,
the returned state, spiking mode) and ``mamba_decode_step`` against JAX's,
the reduced mamba2-130m and zamba2-7b through ``prefill``,
``prefill_chunk`` and ``decode_step`` (logits rtol 1e-5) with the cache
dtypes and shapes of JAX's ``init_cache``, their loss and gradients
(``jax.value_and_grad``: loss 1e-4, gradients 1e-3 relative L2), decode
equal to the continuation of a longer prefill (rtol 2e-3, as JAX's
``test_decode_matches_prefill_continuation_ssm``), and the port's engine
against JAX's engine, blocking and chunked (``tests/test_serve_engine.py``
holds JAX's engine to a direct loop): greedy tokens exactly.

Inputs are numpy arrays made from a seed; the parameters are JAX's,
carried across by ``convert``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jbuild
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.serve import Engine, EngineConfig
from repro_torch.tree import tree_leaves, tree_map
from torch_families import (check_loss_and_grads, close, family_pair,
                            tokens)

ARCHS = ["mamba2-130m", "zamba2-7b"]


def naive_ssd(xs, dt, A, Bm, Cm, state=None):
    """The per-token recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = C_t h_t, in torch f64."""
    xs, dt, A, Bm, Cm = (t.double() for t in (xs, dt, A, Bm, Cm))
    b, s, h, p = xs.shape
    hg = h // Bm.shape[-2]
    Bh = torch.repeat_interleave(Bm, hg, dim=-2)
    Ch = torch.repeat_interleave(Cm, hg, dim=-2)
    state = (torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float64)
             if state is None else state.double())
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)[:, :, None, None]
        upd = (dt[:, t, :, None] * xs[:, t])[..., None] * Bh[:, t, :, None, :]
        state = state * decay + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state


def _ssd_inputs(seed, b=2, s=16, h=4, p=8, g=2, n=6):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return xs, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk):
    arrs = _ssd_inputs(chunk)
    y, st = tssm._ssd_chunked(*(torch.tensor(a) for a in arrs), chunk)
    jy, jst = jssm._ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk)
    close(y, jy)
    close(st, jst)
    ny, nst = naive_ssd(*(torch.tensor(a) for a in arrs))
    torch.testing.assert_close(y.double(), ny, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st.double(), nst, rtol=1e-4, atol=1e-4)


def test_ssd_init_state_continuation():
    """Two halves carrying the state give the one pass, and JAX's halves."""
    xs, dt, A, Bm, Cm = (torch.tensor(a) for a in _ssd_inputs(1))
    y_full, st_full = tssm._ssd_chunked(xs, dt, A, Bm, Cm, 8)
    y1, st1 = tssm._ssd_chunked(xs[:, :8], dt[:, :8], A, Bm[:, :8],
                                Cm[:, :8], 8)
    y2, st2 = tssm._ssd_chunked(xs[:, 8:], dt[:, 8:], A, Bm[:, 8:],
                                Cm[:, 8:], 4, init_state=st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(st2, st_full, rtol=1e-4, atol=1e-4)
    j = [jnp.asarray(t[:, 8:].numpy()) for t in (xs, dt)]
    jy2, jst2 = jssm._ssd_chunked(j[0], j[1], jnp.asarray(A.numpy()),
                                  jnp.asarray(Bm[:, 8:].numpy()),
                                  jnp.asarray(Cm[:, 8:].numpy()), 4,
                                  init_state=jnp.asarray(st1.numpy()))
    close(y2, jy2)
    close(st2, jst2)
    with pytest.raises(ValueError):
        tssm._ssd_chunked(xs, dt, A, Bm, Cm, 5)


def test_rmsnorm_gated_matches_jax():
    rng = np.random.default_rng(2)
    x, z = (rng.standard_normal((3, 5, 32)).astype(np.float32)
            for _ in range(2))
    scale = rng.standard_normal(32).astype(np.float32)
    got = tlayers.rmsnorm_gated_apply({"scale": torch.tensor(scale)},
                                      torch.tensor(x), torch.tensor(z), 1e-6)
    want = jlayers.rmsnorm_gated_apply({"scale": jnp.asarray(scale)},
                                       jnp.asarray(x), jnp.asarray(z), 1e-6)
    close(got, want)


def _mamba_pair(spiking=False):
    jcfg = jreduced(jget("mamba2-130m"), spiking=spiking)
    tcfg = reduced(get_config("mamba2-130m"), spiking=spiking)
    jp = jssm.mamba_init(jax.random.PRNGKey(3), jcfg)
    tp = tree_map(lambda a: torch.tensor(np.array(a)),
                  jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("spiking", [False, True])
@pytest.mark.parametrize("s", [21, 2])           # a remainder chunk; < K-1
def test_mamba_apply_and_decode_match_jax(spiking, s):
    jcfg, tcfg, jp, tp = _mamba_pair(spiking)
    rng = np.random.default_rng(s)
    x = (rng.standard_normal((2, s, tcfg.d_model)) * 2.0).astype(np.float32)
    jy, jst = jssm.mamba_apply(jp, jcfg, jnp.asarray(x), return_state=True)
    ty, tst = tssm.mamba_apply(tp, tcfg, torch.tensor(x), return_state=True)
    close(ty, jy)
    for k in ("ssm", "conv"):
        close(tst[k], jst[k])
        assert tst[k].dtype == torch.float32
    # a continuation chunk from that state, and decode steps
    x2 = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jy2, jst2 = jssm.mamba_apply(jp, jcfg, jnp.asarray(x2), init_state=jst,
                                 return_state=True)
    ty2, tst2 = tssm.mamba_apply(tp, tcfg, torch.tensor(x2),
                                 init_state=tst, return_state=True)
    close(ty2, jy2)
    jstate, tstate = jst2, tst2
    for t in range(3):
        xt = x2[:, t:t + 1]
        jo, jstate = jssm.mamba_decode_step(jp, jcfg, jnp.asarray(xt),
                                            jstate)
        to, tstate = tssm.mamba_decode_step(tp, tcfg, torch.tensor(xt),
                                            tstate)
        close(to, jo)
        for k in ("ssm", "conv"):
            close(tstate[k], jstate[k])


# ------------------------------------------------------------------ the LMs
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_lm_prefill_chunk_and_decode_match_jax(arch):
    jm, steps, jp, tm, tp = family_pair(arch)
    toks = tokens(1, 2, 20, tm.cfg.vocab_size)
    jl, jc = steps["prefill"](jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                        return_all_logits=True)
    close(tl, jl)
    jleaves = jax.tree_util.tree_leaves(jc["layers"])
    assert len(tree_leaves(tc["layers"])) == len(jleaves)
    for t, j in zip(tree_leaves(tc["layers"]), jleaves):
        assert tuple(t.shape) == tuple(j.shape)
        close(t, j)
    jcache = jm.init_cache(2, 40)
    jcache["len"] = jnp.zeros((), jnp.int32)
    tcache = tm.init_cache(2, 40, device="cpu")
    tcache["len"] = torch.zeros((), dtype=torch.int32)
    toks = tokens(2, 2, 32, tm.cfg.vocab_size)
    for lo in (0, 16):                          # two chunks of ssm_chunk
        chunk = toks[:, lo:lo + 16]
        jl, jcache = steps["chunk"](jp, jnp.asarray(chunk), jcache)
        tl, tcache = tm.prefill_chunk(tp, torch.tensor(chunk), tcache)
        close(tl, jl)
    lens = np.array([32, 32], np.int32)
    jcache["len"], tcache["len"] = jnp.asarray(lens), torch.tensor(lens)
    nxt = toks[:, -1:]
    for _ in range(3):
        jl, jcache = steps["decode"](jp, jnp.asarray(nxt), jcache)
        tl, tcache = tm.decode_step(tp, torch.tensor(nxt), tcache)
        close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for t, j in zip(tree_leaves(tcache["layers"]),
                    jax.tree_util.tree_leaves(jcache["layers"])):
        close(t, j)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    """The cache tree of a bf16 model: the same leaves in the same order,
    shapes and dtypes (the ssm state f32, the conv state and KV bf16)."""
    jm = jbuild(jreduced(jget(arch), dtype=jnp.bfloat16))
    tm = build_model(reduced(get_config(arch), dtype=torch.bfloat16))
    jc, tc = jm.init_cache(3, 12), tm.init_cache(3, 12, device="cpu")
    jleaves = jax.tree_util.tree_leaves(jc["layers"])
    tleaves = tree_leaves(tc["layers"])
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert int(t.ne(0).sum()) == 0
    assert int(tc["len"]) == int(jc["len"]) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_lm_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch, {"tokens": tokens(3, 2, 20, 512)})


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_continuation(arch):
    _, _, _, tm, tp = family_pair(arch)
    toks = torch.tensor(tokens(4, 2, 17, tm.cfg.vocab_size))
    full, _ = tm.prefill(tp, {"tokens": toks})
    _, cache = tm.prefill(tp, {"tokens": toks[:, :-1]}, max_len=17)
    dec, _ = tm.decode_step(tp, toks[:, -1:], cache)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-3)


def _serve(eng_cls, cfg_cls, model, params, prompts, chunk):
    eng = eng_cls(model, params, cfg_cls(max_slots=3, max_len=64,
                                         prefill_pad=8, prefill_chunk=chunk))
    uids = [eng.submit(p, max_new=5) for p in prompts]
    fin = {r.uid: r.out for r in eng.run_until_drained()}
    return [fin[u] for u in uids], eng


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_jax_engine(arch, chunk):
    """More requests than slots, prompts at their true length; chunks of 8
    round up to ssm_chunk (16). Greedy tokens equal JAX's engine's."""
    jm, _, jp, tm, tp = family_pair(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, int(n)) for n in (5, 19, 19, 5)]
    jout, _ = _serve(JEngine, JEngineConfig, jm, jp, prompts, chunk)
    tout, eng = _serve(Engine, EngineConfig, tm, tp, prompts, chunk)
    assert tout == jout
    st = eng.stats()
    assert st["prefill_mode"] == ("chunked" if chunk else "blocking")
    if chunk:
        assert eng._chunk_size() == tm.cfg.ssm_chunk == 16


def test_chunked_engine_equals_blocking_and_writes_state_rows():
    """Chunked prefill on ssm_chunk bounds gives the blocking tokens; the
    pool's slot rows hold each slot's recurrent state."""
    _, _, _, tm, tp = family_pair("mamba2-130m")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, int(n)) for n in (23, 9, 33)]
    blocking, _ = _serve(Engine, EngineConfig, tm, tp, prompts, 0)
    chunked, eng = _serve(Engine, EngineConfig, tm, tp, prompts, 16)
    assert chunked == blocking
    assert eng._bucket_len(23) == 23          # no pad in a recurrence
    ssm = eng.cache["layers"]["ssm"]
    assert ssm.dtype == torch.float32 and float(ssm.abs().sum()) > 0.0


def test_launch_serve_runs_mamba2_on_the_cpu():
    from repro_torch.launch import serve

    st = serve.main(["--arch", "mamba2-130m", "--reduced", "--requests",
                     "3", "--max-new", "3", "--slots", "2", "--max-len",
                     "32", "--prefill-chunk", "8", "--device", "cpu"])
    assert st["n"] == 3 and st["device"] == "cpu"
    assert st["prefill_mode"] == "chunked" and st["prefill_chunks"] > 0
