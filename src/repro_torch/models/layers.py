"""Shared neural building blocks — counterpart of ``repro/models/layers.py``:
norms, RoPE, attention (full / sliding / chunked online-softmax / decode
over a cache), gated MLPs.

Functional style over the carried param dict: ``init_*`` build param dicts
with the reference's leaf names; the ``*_apply`` functions are pure.
Compute dtype is bf16, accumulation fp32, params passed in as given.
``attention_apply`` is the training / prefill attention, written as the
reference writes it: einsums and an fp32 softmax, masked scores at -1e30,
the logit softcap before the mask (no library attention call applies
gemma2's cap, and no TPU kernel computes this function).  The decode
step's attention is ``models/decode.py``'s, through the ``decode_attn``
kernel.

Every ``init_*`` takes an :class:`Init` (a seeded ``torch.Generator`` on
the target device, or the ``meta`` device for shapes alone) and ``lead``,
the stacked layer axes in front of each leaf: a stacked tree is drawn
whole, leaf by leaf, as the reference's ``vmap`` over the layer keys
stacks it.  The draws cannot be the reference's (``jax.random`` has no
PyTorch counterpart); the shapes, dtypes, tree and scales are its.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.protocols.base import resolve_device
from .sharding import constrain, gated_halves, settle, shard_local, split_dim

__all__ = ["ATTN_CHUNK", "ATTN_DENSE_MAX", "Init", "_init", "init_rmsnorm", "rmsnorm", "rope",
           "init_attention", "_softcap", "_group_q", "_attn_dense", "_attn_chunked",
           "attention_apply", "init_mlp", "mlp_apply"]

ATTN_CHUNK = 1024  # KV chunk for memory-efficient attention
ATTN_DENSE_MAX = 8192  # use plain dense attention up to this seq len


class Init:
    """Where and how the port's ``init_*`` draw: N(0, 1) from a seeded
    generator on ``device`` (the card unless the caller names another), or
    nothing at all on the ``meta`` device."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gen = (None if self.device.type == "meta"
                    else torch.Generator(device=self.device).manual_seed(seed))

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)


def _init(rng: Init, shape, scale=None, dtype=torch.float32, lead=()):
    """N(0, scale^2) of ``lead + shape``; ``scale`` defaults to
    1 / sqrt(shape[0]) for a matrix and 1 otherwise (of the unstacked
    shape, as the reference's init sees it under ``vmap``)."""
    shape = tuple(shape)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0]) if len(shape) > 1 else 1.0
    return rng.normal(tuple(lead) + shape).mul_(scale).to(dtype)


# --- norms ------------------------------------------------------------------

def init_rmsnorm(rng: Init, d, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32, device=rng.device)}


def rmsnorm(params, x, eps=1e-6):
    xf = settle(x).float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# --- rotary embeddings --------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    # log(theta) in float32 as the reference takes it, as a Python number: a
    # tensor made on the card from a host value would wait for the card
    log_theta = float(torch.log(torch.tensor(theta, dtype=torch.float32)))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32,
                                                device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- attention ---------------------------------------------------------------

def init_attention(rng: Init, cfg, lead=()):
    D, Hq, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "wq": _init(rng, (D, Hq * hd), lead=lead),
        "wk": _init(rng, (D, Hkv * hd), lead=lead),
        "wv": _init(rng, (D, Hkv * hd), lead=lead),
        "wo": _init(rng, (Hq * hd, D), lead=lead),
    }


def _softcap(x, cap: Optional[float]):
    return x if cap is None else cap * torch.tanh(x / cap)


def _group_q(q, n_kv):
    """(B, S, H, hd) -> (B, S, KV, G, hd): head h = kv G + g."""
    H = q.shape[2]
    return split_dim(q, 2, (n_kv, H // n_kv))


def _attn_dense(q, k, v, mask, softcap):
    """q: (B, Sq, KV, G, hd); k / v: (B, Sk, KV, hd); mask broadcastable to
    (B, KV, G, Sq, Sk).  Scores in fp32, the softmax's weights in v's
    dtype.  -> (B, Sq, KV, G, hd)."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    scores = _softcap(scores, softcap)
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def _attn_chunked(q, k, v, qpos, kpos, window, softcap, is_causal, chunk=None):
    """Online-softmax attention over KV in chunks of ``chunk`` keys
    (``ATTN_CHUNK`` when None; memory ~ Sq x chunk).  q: (B, Sq, KV, G, hd);
    k / v: (B, Sk, KV, hd); qpos (B, Sq); kpos (B, Sk).  Keys are padded to
    a chunk multiple with kpos = -1, which masks them."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    C = min(ATTN_CHUNK if chunk is None else chunk, Sk)
    pad = (-Sk) % C
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=-1)
        Sk += pad
    qf = q.float()
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G, Sq), -math.inf, dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    qp = qpos[:, None, None, :, None]
    for c0 in range(0, Sk, C):
        kc, vc, pc = k[:, c0:c0 + C], v[:, c0:c0 + C], kpos[:, c0:c0 + C]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kc.float())
        s = _softcap(s, softcap)
        p_ = pc[:, None, None, None, :]
        valid = p_ >= 0  # padded keys are kpos == -1
        if is_causal:
            valid = valid & (qp >= p_)
        if window is not None:
            valid = valid & ((qp - p_) < window)
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p, vc.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / denom[..., None].clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B, Sq, KV, G, hd)


def _attend(core, q, k, v, aux, **kw):
    """``core(q, k, v, *aux, **kw)`` — q (B, Sq, KV, G, hd), k / v (B, Sk,
    KV, hd), each of ``aux`` (a mask or positions) of batch B or 1 — on each
    device's own rows and KV heads under sharding rules (``shard_local``;
    the core needs whole sequences); a plain call otherwise."""
    dims = ((0, 2), (0, 2), (0, 2)) + tuple((0 if a.shape[0] > 1 else None, None) for a in aux)
    return shard_local(lambda *a: core(*a, **kw), (q, k, v, *aux), dims,
                       ((tuple(q.shape), (0, 2)),))


def attention_apply(params, x, cfg, *, positions, layer_window: Optional[int] = None,
                    is_causal: bool = True, kv_cache=None, cache_len=None, x_kv=None):
    """General attention.

    * self-attention, train / prefill: x (B, S, D), kv_cache None;
    * cross-attention: x_kv (B, Sk, D) supplies K/V (no rope on either,
      no mask when ``is_causal`` is False);
    * decode: kv_cache = (K, V), each (B, Smax, KV, hd), cache_len an int
      or 0-d tensor, x (B, S, D): the new rows go to cache_len.. (a new
      cache: the given one is untouched); returns (out, new_cache).

    A sequence whose S x Sk exceeds ``ATTN_DENSE_MAX``^2 takes the chunked
    online softmax."""
    B, S, D = x.shape
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    src = x if x_kv is None else x_kv
    q = split_dim(x @ params["wq"], -1, (Hq, hd))
    k = split_dim(src @ params["wk"], -1, (Hkv, hd))
    v = split_dim(src @ params["wv"], -1, (Hkv, hd))

    if x_kv is None:  # rope only for self-attention
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_cache is None else positions[:, -1:], cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        K, V = kv_cache
        Smax = K.shape[1]
        # the start clamped so that the rows fit, as dynamic_update_slice does
        start = torch.as_tensor(cache_len, device=K.device).clamp(0, Smax - S)
        rows = start + torch.arange(S, device=K.device)
        K = K.index_copy(1, rows, k.to(K.dtype))
        V = V.index_copy(1, rows, v.to(V.dtype))
        new_cache = (K, V)
        kpos = torch.arange(Smax, device=K.device)[None, None, None, None, :]
        mask = kpos <= cache_len
        if layer_window is not None:
            mask = mask & (kpos > (cache_len - layer_window))
        out = _attend(_attn_dense, _group_q(q, Hkv), K, V, (mask,),
                      softcap=cfg.attn_logit_softcap)
    else:
        qg = _group_q(q, Hkv)
        Sk = k.shape[1]
        kpos = torch.arange(Sk, device=x.device)[None].expand(B, Sk)
        if S * Sk > ATTN_DENSE_MAX * ATTN_DENSE_MAX:
            out = _attend(_attn_chunked, qg, k, v, (positions, kpos), window=layer_window,
                          softcap=cfg.attn_logit_softcap, is_causal=is_causal)
        else:
            mask = torch.ones((1, 1, 1, S, Sk), dtype=torch.bool, device=x.device)
            qp, kp = positions[:, None, None, :, None], kpos[:, None, None, None, :]
            if is_causal:
                mask = mask & (qp >= kp)
            if layer_window is not None:
                mask = mask & ((qp - kp) < layer_window)
            out = _attend(_attn_dense, qg, k, v, (mask,), softcap=cfg.attn_logit_softcap)

    out = constrain(out.reshape(B, S, Hq * hd).to(x.dtype), "batch", None, "tensor")
    proj = out @ params["wo"]
    return (proj, new_cache) if kv_cache is not None else proj


# --- MLP ---------------------------------------------------------------------

def init_mlp(rng: Init, d_model, d_ff, activation, lead=()):
    width = 2 * d_ff if activation in ("swiglu", "geglu") else d_ff
    return {"wi": _init(rng, (d_model, width), lead=lead),
            "wo_mlp": _init(rng, (d_ff, d_model), lead=lead)}


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def mlp_apply(params, x, activation):
    """The MLP on x (B, S, D), or (T, D) for the MoE's shared and residual
    experts, where the reference's three names fall to (batch, None): the
    hidden dim replicated over the tensor axis, as there."""
    hidden = ("batch", None, "tensor")
    if activation in ("swiglu", "geglu"):
        g, u = (constrain(t, *hidden) for t in gated_halves(x, params["wi"]))
        act = F.silu(g) if activation == "swiglu" else _gelu(g)
        h = act * u
    else:
        h = _gelu(constrain(x @ params["wi"], *hidden))
    return h @ params["wo_mlp"]
