"""repro_torch's recurrent decode steps against the reference's, one
function at a time: ``gla_step``, ``mlstm_step``, ``slstm_step`` and
``mamba2_step`` (its conv state included), on the same numpy inputs (made
from a seed) and the same float32 weights (the reference's init carried by
``params_from_numpy``), within 1e-5 of the output's scale (fp32 sums in
other orders, the two libraries' fp32 transcendental functions a few ulps
apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.models import ssm as RS  # noqa: E402
from repro.models.config import ModelConfig as RefConfig  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = 1e-5


def _cfgs(**kw):
    base = dict(name="t", family="ssm", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=96, vocab_size=97, remat=False)
    base.update(kw)
    return RefConfig(**base), ModelConfig(**base)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _jit(fn, cfg):
    """The reference's ``fn(params, x, cfg, *rest)`` jitted with cfg fixed."""
    return jax.jit(lambda params, x, *rest: fn(params, x, cfg, *rest))


def _close(got, want, tol=TOL):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_gla_step_matches():
    B, H, dk, dv = 2, 3, 8, 5
    q, k = _rand(6, B, H, dk), _rand(7, B, H, dk)
    v, state = _rand(8, B, H, dv), _rand(9, B, H, dk, dv)
    log_a = -np.abs(_rand(10, B, H)) * 3
    log_a[0, 0] = -100.0  # clipped at -60
    w = _rand(11, B, H)
    y, st = PS.gla_step(*map(_t, (q, k, v, log_a, w, state)))
    y_r, st_r = RS.gla_step(*map(jnp.asarray, (q, k, v, log_a, w, state)))
    _close(y, y_r)
    _close(st, st_r)


def test_mlstm_step_matches():
    ref_cfg, cfg = _cfgs(family="ssm", num_heads=4)
    ref = jax.jit(RS.init_mlstm, static_argnums=1)(jax.random.PRNGKey(1), ref_cfg)
    x = _rand(12, 2, 1, 64)
    state = _rand(13, 2, 4, 16, 16, scale=0.3)
    out, st = PS.mlstm_step(_carry(ref), _t(x), cfg, _t(state))
    out_r, st_r = _jit(RS.mlstm_step, ref_cfg)(ref, jnp.asarray(x), jnp.asarray(state))
    _close(out, out_r)
    _close(st, st_r)


def test_slstm_step_matches():
    ref_cfg, cfg = _cfgs(family="ssm", num_heads=4)
    ref = jax.jit(RS.init_slstm, static_argnums=1)(jax.random.PRNGKey(2), ref_cfg)
    x = _rand(14, 2, 1, 64)
    shape = (2, 4, 16)
    carry = [_rand(15, *shape), np.abs(_rand(16, *shape)) + 0.5, _rand(17, *shape),
             _rand(18, *shape)]
    carry[2][0, 0, :4] = -1e30  # a fresh state's stabilizer
    out, st = PS.slstm_step(_carry(ref), _t(x), cfg, tuple(map(_t, carry)))
    out_r, st_r = _jit(RS.slstm_step, ref_cfg)(ref, jnp.asarray(x),
                                               tuple(map(jnp.asarray, carry)))
    _close(out, out_r)
    for a, b in zip(st, st_r):
        _close(a, b)


def test_mamba2_step_matches_with_conv_state():
    ref_cfg, cfg = _cfgs(family="hybrid", ssm_state=8, num_heads=4, hybrid_attn_every=2)
    ref = jax.jit(RS.init_mamba2, static_argnums=1)(jax.random.PRNGKey(3), ref_cfg)
    params = _carry(ref)
    d_inner, N, H = 2 * 64, 8, 4
    x = _rand(19, 2, 1, 64)
    state = _rand(20, 2, H, N, d_inner // H, scale=0.5)
    conv = _rand(21, 2, ref_cfg.ssm_conv - 1, d_inner + 2 * N)
    out, st, cv = PS.mamba2_step(params, _t(x), cfg, _t(state), _t(conv))
    out_r, st_r, cv_r = _jit(RS.mamba2_step, ref_cfg)(ref, jnp.asarray(x), jnp.asarray(state),
                                                      jnp.asarray(conv))
    _close(out, out_r)
    _close(st, st_r)
    _close(cv, cv_r)
    np.testing.assert_array_equal(cv.numpy()[:, :-1], conv[:, 1:])  # the window slides
