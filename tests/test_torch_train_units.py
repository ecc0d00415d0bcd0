"""repro_torch's training building blocks against the reference's, one
function at a time, on the same numpy inputs (made from a seed) and the
same float32 weights: the full-sequence attention (``_attn_dense``,
``_attn_chunked``, ``attention_apply``'s self, cross and decode uses),
the chunked gated-linear-attention engine and the recurrent ``*_apply``
blocks, the warmup-cosine schedule and the AdamW update.

Tolerances: 1e-5 of the output's scale (fp32 sums in other orders, fp32
transcendental functions of the two libraries a few ulps apart); the
AdamW update 1e-6 relative, elementwise (the same fp32 operations in the
same order: only ``pow`` and ``sqrt`` may round a last bit apart); the
schedule 1e-7 relative.  The chunked attention runs at chunk 16 over 40
keys (a padded last chunk), the reference's ``layers.ATTN_CHUNK`` and
``ATTN_DENSE_MAX`` patched for the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.models import layers as R  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.config import ModelConfig as RefConfig  # noqa: E402
from repro.optim import AdamWState as RefState  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.optim import cosine_warmup as ref_cosine_warmup  # noqa: E402
from repro_torch.models import layers as P  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import Init  # noqa: E402
from repro_torch.models.weights import _map  # noqa: E402
from repro_torch.optim import AdamWState, adamw_update, cosine_warmup  # noqa: E402

TOL = 1e-5


def _cfgs(**kw):
    base = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=96, vocab_size=97, remat=False)
    base.update(kw)
    return RefConfig(**base), ModelConfig(**base)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _weights(init, cfg, *args):
    """The port's seed-3 init of a block as a numpy tree: both sides' weights."""
    return _map(lambda _, t: t.numpy(), init(Init(3, "cpu"), cfg, *args))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# --- attention -----------------------------------------------------------------

def _qkv(seed, B=2, Sq=40, Sk=40, KV=2, G=2, hd=16):
    return (_rand(seed, B, Sq, KV, G, hd), _rand(seed + 1, B, Sk, KV, hd),
            _rand(seed + 2, B, Sk, KV, hd))


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (True, 8, 50.0),
                                                   (False, None, 3.0)])
def test_attn_dense_matches(causal, window, softcap):
    q, k, v = _qkv(1)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    qp, kp = pos[:, None, None, :, None], pos[:, None, None, None, :]
    mask = np.ones((2, 1, 1, 40, 40), bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    want = R._attn_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                         softcap)
    _close(P._attn_dense(_t(q), _t(k), _t(v), torch.from_numpy(mask), softcap), want)


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (True, 8, 50.0),
                                                   (False, None, None)])
def test_attn_chunked_matches_reference_and_dense(causal, window, softcap, monkeypatch):
    monkeypatch.setattr(R, "ATTN_CHUNK", 16)  # 40 keys: chunks 16, 16, 8 + 8 padded
    q, k, v = _qkv(5)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    want = R._attn_chunked(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), window, softcap,
                           causal)
    tq, tk, tv, tp = _t(q), _t(k), _t(v), torch.from_numpy(pos.copy())
    got = P._attn_chunked(tq, tk, tv, tp, tp, window, softcap, causal, chunk=16)
    _close(got, want)
    qp, kp = tp[:, None, None, :, None], tp[:, None, None, None, :]
    mask = torch.ones((2, 1, 1, 40, 40), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    _close(got, P._attn_dense(tq, tk, tv, mask, softcap).numpy())


def _attn_case(seed, window=None, softcap=None, **kw):
    rc, pc = _cfgs(attn_logit_softcap=softcap, **kw)
    w = _weights(P.init_attention, pc)
    return rc, pc, w, params_from_numpy(w, "cpu")


@pytest.mark.parametrize("window,softcap,chunked", [(None, None, False), (8, 50.0, False),
                                                    (8, 50.0, True)])
def test_attention_apply_self_matches(window, softcap, chunked, monkeypatch):
    rc, pc, w, pw = _attn_case(7, window, softcap)
    if chunked:  # S x S > ATTN_DENSE_MAX^2: the chunked online softmax
        for mod in (R, P):
            monkeypatch.setattr(mod, "ATTN_DENSE_MAX", 16)
            monkeypatch.setattr(mod, "ATTN_CHUNK", 16)
    x = _rand(8, 2, 40, 64)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    want = jax.jit(lambda p, x, pos: R.attention_apply(p, x, rc, positions=pos,
                                                       layer_window=window))(w, x, pos)
    got = P.attention_apply(pw, _t(x), pc, positions=torch.from_numpy(pos), layer_window=window)
    _close(got, want)


def test_attention_apply_cross_matches():
    rc, pc, w, pw = _attn_case(9)
    x, enc = _rand(10, 2, 12, 64), _rand(11, 2, 20, 64)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want = R.attention_apply(w, jnp.asarray(x), rc, positions=jnp.asarray(pos), is_causal=False,
                             x_kv=jnp.asarray(enc))
    got = P.attention_apply(pw, _t(x), pc, positions=torch.from_numpy(pos), is_causal=False,
                            x_kv=_t(enc))
    _close(got, want)


@pytest.mark.parametrize("window", [None, 4])
def test_attention_apply_decode_with_cache_matches(window):
    rc, pc, w, pw = _attn_case(12, softcap=50.0)
    K, V = _rand(13, 2, 16, 2, 16), _rand(14, 2, 16, 2, 16)
    x = _rand(15, 2, 1, 64)
    pos = np.full((2, 1), 9, np.int32)
    want, (wK, wV) = R.attention_apply(w, jnp.asarray(x), rc, positions=jnp.asarray(pos),
                                       layer_window=window, kv_cache=(jnp.asarray(K),
                                                                      jnp.asarray(V)),
                                       cache_len=9)
    tK, tV = _t(K), _t(V)
    got, (gK, gV) = P.attention_apply(pw, _t(x), pc, positions=torch.from_numpy(pos),
                                      layer_window=window, kv_cache=(tK, tV),
                                      cache_len=torch.tensor(9))
    _close(got, want)
    _close(gK, wK)
    _close(gV, wV)
    assert torch.equal(tK, _t(K)), "the given cache must stay untouched"


# --- the chunked gated linear attention and the recurrent blocks ------------------

def _gla_inputs(seed, B=2, S=64, H=3, dk=8, dv=5):
    q, k, v = _rand(seed, B, S, H, dk), _rand(seed + 1, B, S, H, dk), _rand(seed + 2, B, S, H, dv)
    log_a = -np.abs(_rand(seed + 3, B, S, H, scale=2.0))  # some decays past the -60 clip
    w = np.abs(_rand(seed + 4, B, S, H))
    return q, k, v, log_a, w


def test_chunked_gla_matches_reference_and_steps():
    q, k, v, la, w = _gla_inputs(20)
    want_y, want_s = RS.chunked_gla(*(jnp.asarray(a) for a in (q, k, v, la, w)), chunk=16)
    got_y, got_s = PS.chunked_gla(*(_t(a) for a in (q, k, v, la, w)), chunk=16)
    _close(got_y, want_y)
    _close(got_s, want_s)
    # the same recurrence one position at a time
    st = torch.zeros((2, 3, 8, 5))
    ys = []
    for t in range(64):
        y, st = PS.gla_step(*(_t(a[:, t]) for a in (q, k, v, la, w)), st)
        ys.append(y)
    _close(torch.stack(ys, 1), got_y.numpy())
    _close(st, got_s.numpy())


def test_chunked_gla_state_carries_across_calls():
    q, k, v, la, w = (_t(a) for a in _gla_inputs(30))
    y, s = PS.chunked_gla(q, k, v, la, w, chunk=16)
    y1, s1 = PS.chunked_gla(q[:, :32], k[:, :32], v[:, :32], la[:, :32], w[:, :32], chunk=16)
    y2, s2 = PS.chunked_gla(q[:, 32:], k[:, 32:], v[:, 32:], la[:, 32:], w[:, 32:], s1, chunk=16)
    _close(torch.cat([y1, y2], 1), y.numpy())
    _close(s2, s.numpy())
    with pytest.raises(AssertionError, match="chunk multiple"):
        PS.chunked_gla(q[:, :40], k[:, :40], v[:, :40], la[:, :40], w[:, :40], chunk=16)


def test_mlstm_apply_matches():
    rc, pc = _cfgs(family="ssm")
    w = _weights(PS.init_mlstm, pc)
    x = _rand(40, 2, 32, 64)
    st0 = _rand(41, 2, 4, 16, 16, scale=0.1)
    want, ws = RS.mlstm_apply(jax.tree.map(jnp.asarray, w), jnp.asarray(x), rc, jnp.asarray(st0))
    got, gs = PS.mlstm_apply(params_from_numpy(w, "cpu"), _t(x), pc, _t(st0))
    _close(got, want)
    _close(gs, ws)


def test_slstm_apply_matches():
    rc, pc = _cfgs(family="ssm")
    w = _weights(PS.init_slstm, pc)
    x = _rand(50, 2, 24, 64)
    want, ws = jax.jit(lambda p, x: RS.slstm_apply(p, x, rc))(w, x)
    got, gs = PS.slstm_apply(params_from_numpy(w, "cpu"), _t(x), pc)
    _close(got, want)
    for g, r in zip(gs, ws):
        _close(g, r)


def test_mamba2_apply_matches_with_states():
    rc, pc = _cfgs(family="hybrid", ssm_state=8, hybrid_attn_every=2)
    w = _weights(PS.init_mamba2, pc)
    x = _rand(60, 2, 32, 64, scale=0.5)
    st0 = _rand(61, 2, 4, 8, 32, scale=0.1)
    cv0 = _rand(62, 2, 3, 128 + 16, scale=0.5)
    want = jax.jit(lambda p, x, s, c: RS.mamba2_apply(p, x, rc, s, c))(w, x, st0, cv0)
    got = PS.mamba2_apply(params_from_numpy(w, "cpu"), _t(x), pc, _t(st0), _t(cv0))
    for g, r in zip(got, want):
        _close(g, r)


# --- the schedule and the optimizer -----------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 140])
def test_cosine_warmup_matches(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    want = float(ref_cosine_warmup(jnp.int32(step), **kw))
    got = cosine_warmup(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-7, abs=1e-12)


def _tree(seed, scale, norm_at=0.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
                  "scale": (norm_at + rng.normal(size=5) * scale).astype(np.float32)},
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("grad_scale,clipped", [(10.0, True), (0.01, False)])
def test_adamw_update_matches(grad_scale, clipped):
    params, grads = _tree(1, 1.0, norm_at=1.0), _tree(2, grad_scale)
    m, v = _tree(3, 0.1), jax.tree.map(np.abs, _tree(4, 0.1))
    lr = 2e-3
    rp, rs, rg = ref_adamw_update(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                                                  grads),
                                  RefState(step=jnp.int32(4), m=jax.tree.map(jnp.asarray, m),
                                           v=jax.tree.map(jnp.asarray, v)), jnp.float32(lr))
    to = lambda t: params_from_numpy(t, "cpu")
    pp, pm, pv = to(params), to(m), to(v)
    state = AdamWState(step=torch.tensor(4, dtype=torch.int32), m=pm, v=pv)
    gp, gs, gg = adamw_update(pp, to(grads), state, torch.tensor(lr))
    assert gp is pp and gs.m is pm and gs.v is pv, "updated in place"
    assert int(gs.step) == 5 and int(state.step) == 4
    assert (float(gg) > 1.0) == clipped
    assert float(gg) == pytest.approx(float(rg), rel=1e-6)
    for got, want in ((gp, rp), (gs.m, rs.m), (gs.v, rs.v)):
        flat_g = _map(lambda _, t: t.numpy(), got)
        for g, r in zip(jax.tree.leaves(flat_g), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=1e-12)
