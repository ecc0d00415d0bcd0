"""repro_torch's model building blocks against the reference's, one
function at a time (the recurrent steps: ``test_torch_models_ssm.py``), on the same numpy inputs (made from a seed) and the
same weights (the reference's init carried by ``params_from_numpy``).

Tolerances: float32 inputs and weights, 1e-5 relative to the output's
scale (fp32 sums in other orders, fp32 transcendental functions of the two
libraries a few ulps apart); the bf16 MLP case 4 bf16 ulps (2^-8 each) of
scale (the two round bf16 at other places).  The MoE case forces a
capacity overflow (capacity factor 0.25, a router that sends every token
to expert 0 first) so that the GShard drop is hit; its ``keep`` mask is
compared exactly.  ``decode_attn_plain(softcap=50.0)`` is held against
the reference's softcap (``layers._softcap``) applied to the scores of
``decode_attn_ref``'s math, within 1e-5 max|V|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.models import layers as R  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models.config import ModelConfig as RefConfig  # noqa: E402
from repro_torch.kernels.decode_attn.ops import decode_attn, decode_attn_plain  # noqa: E402
from repro_torch.models import layers as P  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = 1e-5
BF16_TOL = 4 * 2.0 ** -8


def _cfgs(**kw):
    base = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
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
    """The reference's ``fn(params, x, cfg, *rest)`` jitted with cfg fixed
    (one compile, where eager dispatch compiles op by op)."""
    return jax.jit(lambda params, x, *rest: fn(params, x, cfg, *rest))


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_rmsnorm_matches():
    x = _rand(0, 3, 5, 64, scale=7.0)
    scale = _rand(1, 64)
    _close(P.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6),
           R.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches(theta):
    x = _rand(2, 2, 6, 3, 16)
    pos = np.array([[0, 1, 2, 40, 41, 4095], [7, 8, 9, 10, 11, 12]], np.int32)
    _close(P.rope(_t(x), torch.from_numpy(pos), theta), R.rope(jnp.asarray(x), pos, theta))


def test_group_q_and_softcap_match():
    q = _rand(3, 2, 1, 8, 16)
    got = P._group_q(_t(q), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(R._group_q(jnp.asarray(q), 2)))
    s = _rand(4, 5, 7, scale=80.0)
    _close(P._softcap(_t(s), 50.0), R._softcap(jnp.asarray(s), 50.0))
    np.testing.assert_array_equal(P._softcap(_t(s), None).numpy(), s)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("bf16", [False, True])
def test_mlp_apply_matches(activation, bf16):
    ref = R.init_mlp(jax.random.PRNGKey(0), 64, 96, activation)
    params = _carry(ref)
    x = _rand(5, 2, 3, 64)
    xj = jnp.asarray(x)
    xt = _t(x)
    if bf16:
        ref = jax.tree.map(lambda a: a.astype(jnp.bfloat16), ref)
        params = {k: v.bfloat16() for k, v in params.items()}
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    got = P.mlp_apply(params, xt, activation)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close(got, R.mlp_apply(ref, xj, activation), BF16_TOL if bf16 else TOL)


@pytest.mark.parametrize("activation,shared,dense_res", [("swiglu", 1, False),
                                                        ("geglu", 0, True)])
def test_moe_apply_matches_under_overflow(activation, shared, dense_res):
    kw = dict(family="moe", num_experts=4, top_k=2, moe_d_ff=32, activation=activation,
              num_shared_experts=shared, shared_d_ff=48 if shared else 0,
              moe_dense_residual=dense_res, capacity_factor=0.25)
    ref_cfg, cfg = _cfgs(**kw)
    ref = jax.jit(RM.init_moe, static_argnums=1)(jax.random.PRNGKey(4), ref_cfg)
    router = np.asarray(ref["router"]).copy()
    router[:, 0] += 0.5  # expert 0 first for every token: past its capacity of 8
    ref = {**ref, "router": jnp.asarray(router)}
    params = _carry(ref)
    x = np.abs(_rand(22, 4, 16, 64))  # T = 64 tokens, positive: router column 0 wins
    out, aux = PM.moe_apply(params, _t(x), cfg)
    out_r, aux_r = _jit(RM.moe_apply, ref_cfg)(ref, jnp.asarray(x))
    _close(out, out_r)
    for name in ("load_balance", "router_z", "drop_frac"):
        _close(aux[name], aux_r[name])
    assert float(aux["drop_frac"]) > 0.2  # the capacity drop was hit
    bare, no_aux = PM.moe_apply(params, _t(x), cfg, with_aux=False)  # a decode step's call
    assert no_aux is None and torch.equal(bare, out)

    # the dispatch itself: the same keep mask, the same combined output
    xt = x.reshape(64, 64)
    probs = jax.nn.softmax(jnp.asarray(xt) @ ref["router"], axis=-1)
    gates, idx = jax.lax.top_k(probs, 2)
    gates = gates / gates.sum(-1, keepdims=True)
    comb_r, keep_r = jax.jit(lambda *a: RM._routed_local(*a, ref_cfg, 0, 4))(
        jnp.asarray(xt), idx, gates, ref["w_in_e"], ref["w_out_e"])
    comb, keep = PM._routed_local(_t(xt), torch.from_numpy(np.array(idx)).long(),
                                  _t(gates), params["w_in_e"], params["w_out_e"], cfg, 0, 4)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_r))
    assert not keep.numpy().all()
    _close(comb, comb_r)


def test_decode_attn_plain_softcap_matches_reference_math():
    B, S, KV, G, hd, pos, window = 2, 96, 2, 2, 32, 130, 64
    rng = np.random.default_rng(23)
    q = (rng.normal(size=(B, KV, G, hd)) * 3).astype(np.float32)
    K, V = rng.normal(size=(2, B, S, KV, hd)).astype(np.float32)
    kpos = np.stack([rng.permutation(np.arange(pos - S + 1, pos + 1)) for _ in range(B)])
    kpos = kpos.astype(np.int32)
    kpos[1, :10] = -1
    # decode_attn_ref with the reference's _softcap on its scores (decode.py:144-145)
    @jax.jit
    def capped_ref(q, K, V, kpos):
        s = jnp.einsum("bkgh,bskh->bkgs", q, K)
        s = R._softcap(s, 50.0)
        valid = (kpos >= 0) & (kpos <= pos) & (kpos > pos - window)
        s = jnp.where(valid[:, None, None, :], s, -1e30)
        w = jnp.exp(s - jnp.max(s, axis=-1, keepdims=True))
        w = w / jnp.sum(w, axis=-1, keepdims=True)
        return jnp.einsum("bkgs,bskh->bkgh", w, V)

    want = capped_ref(*map(jnp.asarray, (q, K, V, kpos)))
    args = (_t(q), _t(K), _t(V), torch.from_numpy(kpos), pos)
    got = decode_attn_plain(*args, window=window, softcap=50.0)
    tol = 1e-5 * float(np.abs(V).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    # the wrapper on the CPU is the plain version; the cap changes the answer
    assert torch.equal(decode_attn(*args, window=window, softcap=50.0), got)
    uncapped = decode_attn_plain(*args, window=window)
    assert float((uncapped - got).abs().max()) > 100 * tol


def test_decode_attn_softcap_none_is_unchanged():
    rng = np.random.default_rng(24)
    q, K, V = (_t(rng.normal(size=s)) for s in ((1, 2, 3, 8), (1, 20, 2, 8), (1, 20, 2, 8)))
    kpos = torch.arange(20, dtype=torch.int32)[None]
    a = decode_attn_plain(q, K, V, kpos, 15, window=8)
    b = decode_attn_plain(q, K, V, kpos, 15, window=8, softcap=None)
    assert torch.equal(a, b)


def test_port_config_is_the_reference_config():
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config, list_archs

    for arch in list_archs():
        for tf in (lambda c: c, lambda c: c.reduced()):
            port, ref = tf(get_config(arch)), tf(ref_get_config(arch))
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
            assert (port.hd, port.q_dim, port.kv_dim) == (ref.hd, ref.q_dim, ref.kv_dim)
