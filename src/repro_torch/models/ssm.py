"""Recurrent sequence-mixing blocks — counterpart of ``repro/models/ssm.py``:
chunked gated linear attention (the shared engine) and its single step,
mLSTM + sLSTM (xlstm-125m, arXiv:2405.04517) and Mamba2/SSD (zamba2-2.7b,
arXiv:2411.15242), each as a full-sequence ``*_apply`` (training and
prefill) and a one-position ``*_step`` (decode).

The shared engine computes, exactly and in chunks of ``chunk`` steps, with
per-step per-head scalar decay a = exp(log_a), log_a <= 0:

    C_t = a_t C_{t-1} + w_t k_t v_t^T          (state  (dk, dv) per head)
    y_t = C_t^T q_t

Within a chunk the contraction is a masked (q k^T)-style product; a Python
loop over the chunks carries the state, where the reference scans.  Every
exponential is of a non-positive number.  The reference's deviations from
the papers hold here too: the mLSTM input gate is a sigmoid gate; sLSTM
keeps exponential gating with the m_t stabilizer, one position at a time
(``slstm_step`` is one step of the cell, as the reference's runs
``slstm_apply``'s scan over one position).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Init, _init
from .sharding import shard_local, split_dim

__all__ = ["SSM_CHUNK", "chunked_gla", "gla_step", "init_mlstm", "_mlstm_qkv_gates",
           "mlstm_apply", "mlstm_step", "init_slstm", "_slstm_cell", "slstm_apply", "slstm_step",
           "init_mamba2", "_mamba_proj", "_causal_conv", "mamba2_apply", "mamba2_step"]

SSM_CHUNK = 128


def chunked_gla(q, k, v, log_a, w, state=None, chunk: int = SSM_CHUNK):
    """q, k: (B, S, H, dk); v: (B, S, H, dv); log_a, w: (B, S, H); state
    (B, H, dk, dv) fp32 (zeros when None).  S must be a multiple of the
    chunk (min(chunk, S)).  Returns (y (B, S, H, dv) in v's dtype, the
    final state).  Under sharding rules each device scans its own rows and
    heads (``shard_local``)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    return shard_local(lambda *a: _chunked_gla(*a, chunk=chunk), (q, k, v, log_a, w, state),
                       ((0, 2),) * 5 + ((0, 1),),
                       (((B, S, H, dv), (0, 2)), ((B, H, dk, dv), (0, 1))))


def _chunked_gla(q, k, v, log_a, w, state, chunk):
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    C = min(chunk, S)
    n = S // C
    assert S % C == 0, "sequence length must be a chunk multiple"
    if state is None:
        state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)

    def chunks(a, *tail):  # (B, S, H, *tail) -> (n, B, H, C, *tail) fp32
        return a.reshape(B, n, C, H, *tail).transpose(2, 3).transpose(0, 1).float()

    qc, kc, vc = chunks(q, dk), chunks(k, dk), chunks(v, dv)
    lac, wc = chunks(log_a), chunks(w)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=q.device))  # s <= t
    ys = []
    for i in range(n):
        qq, kk, vv, la, ww = qc[i], kc[i], vc[i], lac[i], wc[i]  # (B, H, C, dk) ... (B, H, C)
        L = torch.cumsum(la, dim=-1)  # (B, H, C) inclusive
        # intra-chunk: y[t] += sum_{s<=t} exp(L_t - L_s) w_s (q_t . k_s) v_s
        scores = torch.einsum("bhtd,bhsd->bhts", qq, kk)
        decay = torch.exp((L[..., :, None] - L[..., None, :]).clamp(-60.0, 0.0))
        scores = scores * decay * ww[..., None, :]
        scores = torch.where(tri, scores, 0.0)
        y = torch.einsum("bhts,bhsv->bhtv", scores, vv)
        # cross-chunk: y[t] += exp(L_t) q_t^T state
        y = y + torch.exp(L)[..., None] * torch.einsum("bhtd,bhdv->bhtv", qq, state)
        # state: st' = exp(L_end) st + sum_s exp(L_end - L_s) w_s k_s v_s^T
        Lend = L[..., -1:]
        wdec = torch.exp((Lend - L).clamp(-60.0, 0.0)) * ww  # (B, H, C)
        state = torch.exp(Lend)[..., None] * state + torch.einsum(
            "bhs,bhsd,bhsv->bhdv", wdec, kk, vv)
        ys.append(y)
    y = torch.stack(ys).transpose(0, 1).transpose(2, 3).reshape(B, S, H, dv)
    return y.to(v.dtype), state


def gla_step(q, k, v, log_a, w, state):
    """Single decode step.  q, k: (B, H, dk); v: (B, H, dv); log_a, w:
    (B, H); state (B, H, dk, dv) fp32."""
    B, H = q.shape[:2]
    return shard_local(_gla_step, (q, k, v, log_a, w, state), ((0, 1),) * 6,
                       (((B, H, v.shape[-1]), (0, 1)), (tuple(state.shape), (0, 1))))


def _gla_step(q, k, v, log_a, w, state):
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
    H, hd = cfg.num_heads, cfg.hd
    # sqrt(hd) rounded to x's dtype, as the reference casts it (a host number)
    root = float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(x.dtype))
    q = split_dim(x @ params["wq"], -1, (H, hd)) / root
    k = split_dim(x @ params["wk"], -1, (H, hd)) / root
    v = split_dim(x @ params["wv"], -1, (H, hd))
    gates = split_dim(x @ params["w_gates"], -1, (2, H)).float()
    f_pre = gates[:, :, 0] + 3.0  # forget-gate bias init ~ open
    log_f = shard_local(F.logsigmoid, (f_pre,), ((0, 2),), ((tuple(f_pre.shape), (0, 2)),))
    w_i = torch.sigmoid(gates[:, :, 1])
    og = torch.sigmoid(split_dim(x @ params["w_og"], -1, (H, hd)).float())
    return q, k, v, log_f, w_i, og


def mlstm_apply(params, x, cfg, state=None):
    """x: (B, S, D); state (B, H, hd, hd) fp32 or None -> (out, state)."""
    q, k, v, log_f, w_i, og = _mlstm_qkv_gates(params, x, cfg)
    y, state = chunked_gla(q, k, v, log_f, w_i, state)
    y = (og * y.float()).to(x.dtype)
    B, S = x.shape[:2]
    return y.reshape(B, S, -1) @ params["wo"], state


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


def slstm_apply(params, x, cfg, state=None):
    """x: (B, S, D); state (c, n, m, h), each (B, H, hd) fp32, or None (m
    at -1e30) -> (out, state).  The recurrence runs one position at a time
    on ``_slstm_cell``."""
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.hd
    if state is None:
        z = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        state = (z, z, torch.full((B, H, hd), -1e30, dtype=torch.float32, device=x.device), z)
    pre_x = split_dim(x @ params["wi"], -1, (4, H, hd)).float()
    head = (0, 1)
    y, *state = shard_local(
        lambda p, r, *st: _slstm_scan(p, r, tuple(st), x.dtype),
        (pre_x, params["r_h"], *state), ((0, 3), (None, 0)) + (head,) * 4,
        (((B, S, H, hd), (0, 2)),) + (((B, H, hd), head),) * 4)
    return y.reshape(B, S, H * hd).to(x.dtype) @ params["wo"], tuple(state)


def _slstm_scan(pre_x, rmat, state, dtype):
    """The sLSTM recurrence over pre_x (B, S, 4, H, hd) -> (the hidden
    states (B, S, H, hd) fp32, *the final state)."""
    B, S, _, H, hd = pre_x.shape
    hs = []
    for t in range(S):
        # previous hidden (B, H, hd) -> 4 gate pre-activations, head-local
        rec = torch.einsum("bhd,hdk->bhk", state[3].to(dtype), rmat)  # (B, H, 4 hd)
        rec = rec.reshape(B, H, 4, hd).transpose(1, 2)
        state = _slstm_cell(pre_x[:, t] + rec.float(), state, H, hd)
        hs.append(state[3])
    return (torch.stack(hs, dim=1), *state)


def slstm_step(params, x, cfg, state):
    """x: (B, 1, D); state (c, n, m, h), each (B, H, hd) fp32."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.hd
    pre_x = split_dim(x @ params["wi"], -1, (4, H, hd))[:, 0].float()
    head = (0, 1)
    state = shard_local(lambda p, r, *st: _slstm_scan(p[:, None], r, st, x.dtype)[1:],
                        (pre_x, params["r_h"], *state), ((0, 2), (None, 0)) + (head,) * 4,
                        (((B, H, hd), head),) * 4)
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


def mamba2_apply(params, x, cfg, state=None, conv_state=None):
    """x: (B, S, D); state (B, H, N, hd) fp32 or None; conv_state
    (B, K-1, d_inner + 2N) or None -> (out, state, conv_state).  SSD is the
    shared engine with q = C, k = B (shared across heads), v = x dt."""
    B, S, D = x.shape
    z, xin, Bm, Cm, dt, d_inner, H, N = _mamba_proj(params, x, cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"], conv_state)
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    hd = d_inner // H
    dt = _softplus(dt.float() + params["dt_bias"])  # (B, S, H)
    log_a = -torch.exp(params["a_log"])[None, None] * dt  # <= 0
    q = Cm[:, :, None, :].expand(B, S, H, N)
    k = Bm[:, :, None, :].expand(B, S, H, N)
    v = (split_dim(xin, -1, (H, hd)).float() * dt[..., None]).to(x.dtype)
    y, state = chunked_gla(q, k, v, log_a, torch.ones_like(dt), state)
    y = y.reshape(B, S, d_inner)
    # gated RMS norm, then the out-projection
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    y = (yf * params["norm_scale"]).to(x.dtype) * F.silu(z)
    return y @ params["w_ssm_out"], state, conv_state


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
    v = (split_dim(xin[:, 0], -1, (H, hd)).float() * dt[..., None]).to(x.dtype)
    y, state = gla_step(q, k, v, log_a, torch.ones_like(dt), state)
    y = y.reshape(B, 1, d_inner)
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    y = (yf * params["norm_scale"]).to(x.dtype) * F.silu(z)
    return y @ params["w_ssm_out"], state, conv_state
