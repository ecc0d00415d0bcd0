"""Shared neural building blocks of the decode path — counterpart of
``repro/models/layers.py``: norms, RoPE, the attention projections, the
gated MLPs.

Functional style over the carried param dict: ``init_*`` build param dicts
with the reference's leaf names; the ``*_apply`` functions are pure.
Compute dtype is bf16, accumulation fp32, params passed in as given.  The
full-sequence attention (``attention_apply`` and its dense / chunked
kernels) serves the training forward and has no counterpart here yet.

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

__all__ = ["Init", "_init", "init_rmsnorm", "rmsnorm", "rope", "init_attention", "_softcap",
           "_group_q", "init_mlp", "mlp_apply"]


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
    xf = x.float()
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
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


# --- MLP ---------------------------------------------------------------------

def init_mlp(rng: Init, d_model, d_ff, activation, lead=()):
    width = 2 * d_ff if activation in ("swiglu", "geglu") else d_ff
    return {"wi": _init(rng, (d_model, width), lead=lead),
            "wo_mlp": _init(rng, (d_ff, d_model), lead=lead)}


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def mlp_apply(params, x, activation):
    h = x @ params["wi"]
    if activation in ("swiglu", "geglu"):
        g, u = h.chunk(2, dim=-1)
        act = F.silu(g) if activation == "swiglu" else _gelu(g)
        h = act * u
    else:
        h = _gelu(h)
    return h @ params["wo_mlp"]
