"""Recurrent sequence-mixing blocks, one decode step each — counterpart of
``repro/models/ssm.py``: the gated-linear-attention step (the shared
engine), mLSTM + sLSTM (xlstm-125m, arXiv:2405.04517) and Mamba2/SSD
(zamba2-2.7b, arXiv:2411.15242).

The shared engine's step, with per-head scalar decay a = exp(log_a),
log_a <= 0:

    C_t = a_t C_{t-1} + w_t k_t v_t^T          (state  (dk, dv) per head)
    y_t = C_t^T q_t

The reference's deviations from the papers hold here too: the mLSTM input
gate is a sigmoid gate; sLSTM keeps exponential gating with the m_t
stabilizer.  The chunked full-sequence engine (``chunked_gla``) and the
``*_apply`` functions serve the training forward and have no counterpart
here yet; ``slstm_step`` is one step of the cell, as the reference's runs
``slstm_apply``'s scan over one position.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Init, _init

__all__ = ["gla_step", "init_mlstm", "_mlstm_qkv_gates", "mlstm_step", "init_slstm",
           "_slstm_cell", "slstm_step", "init_mamba2", "_mamba_proj", "_causal_conv",
           "mamba2_step"]


def gla_step(q, k, v, log_a, w, state):
    """Single decode step.  q, k: (B, H, dk); v: (B, H, dv); log_a, w:
    (B, H); state (B, H, dk, dv) fp32."""
    a = torch.exp(log_a.clamp(-60.0, 0.0))[..., None, None]
    state = a * state + (w[..., None, None] * k[..., :, None] * v[..., None, :])
    y = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    return y.to(v.dtype), state


# --- mLSTM (xLSTM matrix-memory block) ---------------------------------------

def init_mlstm(rng: Init, cfg, lead=()):
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    return {
        "wq": _init(rng, (D, H * hd), lead=lead),
        "wk": _init(rng, (D, H * hd), lead=lead),
        "wv": _init(rng, (D, H * hd), lead=lead),
        "w_gates": _init(rng, (D, 2 * H), scale=0.02, lead=lead),  # input & forget pre-acts
        "w_og": _init(rng, (D, H * hd), scale=0.02, lead=lead),  # output gate
        "wo": _init(rng, (H * hd, D), lead=lead),
    }


def _mlstm_qkv_gates(params, x, cfg):
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.hd
    # sqrt(hd) rounded to x's dtype, as the reference casts it (a host number)
    root = float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(x.dtype))
    q = (x @ params["wq"]).reshape(B, S, H, hd) / root
    k = (x @ params["wk"]).reshape(B, S, H, hd) / root
    v = (x @ params["wv"]).reshape(B, S, H, hd)
    gates = (x @ params["w_gates"]).reshape(B, S, 2, H).float()
    log_f = F.logsigmoid(gates[:, :, 0] + 3.0)  # forget-gate bias init ~ open
    w_i = torch.sigmoid(gates[:, :, 1])
    og = torch.sigmoid((x @ params["w_og"]).reshape(B, S, H, hd).float())
    return q, k, v, log_f, w_i, og


def mlstm_step(params, x, cfg, state):
    """x: (B, 1, D); state (B, H, hd, hd) fp32."""
    q, k, v, log_f, w_i, og = _mlstm_qkv_gates(params, x, cfg)
    y, state = gla_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], w_i[:, 0], state)
    y = (og[:, 0] * y.float()).to(x.dtype)
    B = x.shape[0]
    return y.reshape(B, 1, -1) @ params["wo"], state


# --- sLSTM (scalar-memory, exponential gating + stabilizer) -------------------

def init_slstm(rng: Init, cfg, lead=()):
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    return {
        "wi": _init(rng, (D, 4 * H * hd), lead=lead),  # z, i, f, o pre-activations
        "r_h": _init(rng, (H, hd, 4 * hd), scale=0.02, lead=lead),  # head-local recurrence
        "wo": _init(rng, (H * hd, D), lead=lead),
    }


def _slstm_cell(pre, carry, H, hd):
    """pre: (B, 4, H, hd) pre-activations (input + recurrent)."""
    c, nrm, m, h = carry
    z = torch.tanh(pre[:, 0])
    i_t = pre[:, 1]
    f_t = pre[:, 2]
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    c = f_p * c + i_p * z
    nrm = f_p * nrm + i_p
    h = o * c / nrm.clamp_min(1.0)
    return (c, nrm, m_new, h)


def slstm_step(params, x, cfg, state):
    """x: (B, 1, D); state (c, n, m, h), each (B, H, hd) fp32."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.hd
    pre_x = (x @ params["wi"]).reshape(B, 4, H, hd).float()
    rec = torch.einsum("bhd,hdk->bhk", state[3].to(x.dtype), params["r_h"])  # (B, H, 4 hd)
    rec = rec.reshape(B, H, 4, hd).transpose(1, 2)
    state = _slstm_cell(pre_x + rec.float(), state, H, hd)
    y = state[3].reshape(B, 1, H * hd).to(x.dtype)
    return y @ params["wo"], state


# --- Mamba2 / SSD -------------------------------------------------------------

def init_mamba2(rng: Init, cfg, lead=()):
    D = cfg.d_model
    d_inner = cfg.ssm_expand * D
    H = cfg.num_heads
    N = cfg.ssm_state
    lead = tuple(lead)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=rng.device))
    # in_proj emits [gate z (d_inner), x (d_inner), B (N), C (N), dt (H)]
    return {
        "w_ssm_in": _init(rng, (D, 2 * d_inner + 2 * N + H), lead=lead),
        "conv_w": _init(rng, (cfg.ssm_conv, d_inner + 2 * N), scale=0.5, lead=lead),
        "a_log": a_log.expand(lead + (H,)).clone(),
        "dt_bias": torch.zeros(lead + (H,), dtype=torch.float32, device=rng.device),
        "w_ssm_out": _init(rng, (d_inner, D), lead=lead),
        "norm_scale": torch.ones(lead + (d_inner,), dtype=torch.float32, device=rng.device),
    }


def _mamba_proj(params, x, cfg):
    D = x.shape[-1]
    d_inner = cfg.ssm_expand * D
    H, N = cfg.num_heads, cfg.ssm_state
    proj = x @ params["w_ssm_in"]
    z, xin, Bmat, Cmat, dt = torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)
    return z, xin, Bmat, Cmat, dt, d_inner, H, N


def _causal_conv(seq, w, state=None):
    """Depthwise causal conv.  seq: (B, S, C); w: (K, C); state: (B, K-1, C)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((seq.shape[0], K - 1, seq.shape[2]), dtype=seq.dtype,
                          device=seq.device)
    else:
        pad = state.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)
    # the taps' sum and the silu in fp32, rounded once: XLA computes the
    # reference's fused elementwise chain so (PyTorch would round each op)
    ff, wf = full.float(), w.float()
    out = sum(ff[:, i:i + seq.shape[1]] * wf[i] for i in range(K))
    new_state = full[:, -(K - 1):] if K > 1 else state
    return F.silu(out).to(seq.dtype), new_state


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba2_step(params, x, cfg, state, conv_state):
    """x: (B, 1, D); state (B, H, N, hd) fp32; conv_state (B, K-1, d_inner + 2N)."""
    B = x.shape[0]
    z, xin, Bm, Cm, dt, d_inner, H, N = _mamba_proj(params, x, cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"], conv_state)
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    hd = d_inner // H
    dt = _softplus(dt.float() + params["dt_bias"])[:, 0]  # (B, H)
    log_a = -torch.exp(params["a_log"])[None] * dt
    q = Cm[:, 0, None, :].expand(B, H, N)
    k = Bm[:, 0, None, :].expand(B, H, N)
    v = (xin[:, 0].reshape(B, H, hd).float() * dt[..., None]).to(x.dtype)
    y, state = gla_step(q, k, v, log_a, torch.ones_like(dt), state)
    y = y.reshape(B, 1, d_inner)
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    y = (yf * params["norm_scale"]).to(x.dtype) * F.silu(z)
    return y @ params["w_ssm_out"], state, conv_state
