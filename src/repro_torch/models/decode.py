"""Single-token decode with caches for every family — counterpart of
``repro/models/decode.py``.

Cache design (the reference's tree, leaf names and stacked layer axes):
  * full KV cache  (B, S_max, KV, hd)  for global-attention layers,
  * ring KV cache  (B, window, KV, hd) + kpos (B, window) for sliding-window
    layers (gemma2 local layers stay O(window) at any context),
  * mLSTM/SSD matrix state (B, H, dk, dv), sLSTM scalar carries, mamba conv
    state: O(1) in context length,
  * whisper: decoder self caches + cross K/V, zero-initialised as the
    reference's are; the port adds one all-zero kpos row (``cross_kpos``)
    for the cross attention's kernel call (every slot valid at pos 0).

The state is allocated once and updated in place: the new K/V row and its
position go to slot ``pos % size`` by an indexed copy on the device, the
recurrent states are copied into their layer's slice.  ``pos`` is a 0-d
int32 tensor on the state's device, read by the attention kernel without a
host sync.  :func:`decode_step` loops over the stacked layer axis in Python
(views of the stacked params and caches, no copies; each layer's weights
through ``gather_layer_params``, a no-op without sharding rules) where the
reference scans, and returns the state as the reference's does.

Every attention layer, self and cross, goes through
``repro_torch.kernels.decode_attn.ops.decode_attn`` (the hand-written
Hopper kernel for CUDA tensors, its plain version for CPU tensors), the
attention logit softcap included.  ``decode_state_specs`` gives the
state's sharding by leaf name, as the reference's.
"""
from __future__ import annotations

import math

import torch

from ..core.protocols.base import resolve_device
from ..kernels.decode_attn.ops import decode_attn
from .backbone import COMPUTE_DTYPE
from .config import ModelConfig
from .layers import _group_q, mlp_apply, rmsnorm, rope
from .moe import moe_apply
from .sharding import (constrain, current_rules, fit_spec_to_mesh, gather_layer_params,
                       lookup, ring_write, shard_local, split_dim)
from . import ssm

__all__ = ["init_decode_state", "decode_step", "attn_launches_per_step", "decode_state_specs"]


# --- cache construction -------------------------------------------------------

def _kv_cache(cfg, lead, B, size, device, dtype):
    shape = tuple(lead) + (B, size, cfg.num_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kpos": torch.full(tuple(lead) + (B, size), -1, dtype=torch.int32, device=device),
    }


def init_decode_state(cfg: ModelConfig, B: int, max_len: int, device=None, dtype=None):
    """The decode state of ``B`` sequences of up to ``max_len`` positions on
    ``device`` (the card unless the caller names another): empty caches
    (kpos -1), zero recurrent states; K/V and the conv state in ``dtype``
    (``COMPUTE_DTYPE`` by default: the compute cast's), the rest fp32."""
    fam = cfg.family
    win = cfg.sliding_window
    dev = resolve_device(device)
    cdt = COMPUTE_DTYPE if dtype is None else dtype
    f32 = dict(dtype=torch.float32, device=dev)
    if fam in ("dense", "vlm", "moe"):
        if cfg.local_global_alternating:
            n = (cfg.num_layers // 2,)
            local = min(win or max_len, max_len)
            return {"pairs": {"local": _kv_cache(cfg, n, B, local, dev, cdt),
                              "global": _kv_cache(cfg, n, B, max_len, dev, cdt)}}
        size = min(win, max_len) if win else max_len
        return {"layers": _kv_cache(cfg, (cfg.num_layers,), B, size, dev, cdt)}
    if fam == "ssm":
        H, hd = cfg.num_heads, cfg.hd
        n = (cfg.num_layers // 2, B, H, hd)
        return {"pairs": {
            "mlstm_state": torch.zeros(n + (hd,), **f32),
            "slstm_c": torch.zeros(n, **f32),
            "slstm_n": torch.zeros(n, **f32),
            "slstm_m": torch.full(n, -1e30, **f32),
            "slstm_h": torch.zeros(n, **f32),
        }}
    if fam == "hybrid":
        H, N = cfg.num_heads, cfg.ssm_state
        d_inner = cfg.ssm_expand * cfg.d_model
        k_every = cfg.hybrid_attn_every
        n_super = cfg.num_layers // k_every
        lead = (n_super, k_every, B)
        return {"blocks": {
            "mamba_layers": {
                "ssm_state": torch.zeros(lead + (H, N, d_inner // H), **f32),
                "conv_state": torch.zeros(lead + (cfg.ssm_conv - 1, d_inner + 2 * N),
                                          dtype=cdt, device=dev),
            },
            "attn": _kv_cache(cfg, (n_super,), B, min(win, max_len) if win else max_len, dev,
                              cdt),
        }}
    if fam == "encdec":
        L = cfg.num_layers
        cross = (L, B, cfg.enc_seq, cfg.num_kv_heads, cfg.hd)
        return {
            "dec_layers": {
                **_kv_cache(cfg, (L,), B, max_len, dev, cdt),
                "cross_k": torch.zeros(cross, dtype=cdt, device=dev),
                "cross_v": torch.zeros(cross, dtype=cdt, device=dev),
            },
            "cross_kpos": torch.zeros((B, cfg.enc_seq), dtype=torch.int32, device=dev),
        }
    raise ValueError(fam)


def attn_launches_per_step(cfg: ModelConfig) -> int:
    """``decode_attn`` calls one :func:`decode_step` makes: one per
    attention layer, self and cross; none for the xLSTM family."""
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return cfg.num_layers
    if fam == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    if fam == "encdec":
        return 2 * cfg.num_layers
    return 0


_CACHE_SPECS = {
    "k": ("batch", "seq", "tensor", None),
    "v": ("batch", "seq", "tensor", None),
    "kpos": ("batch", "seq"),
    "cross_k": ("batch", None, "tensor", None),
    "cross_v": ("batch", None, "tensor", None),
    "mlstm_state": ("batch", "tensor", None, None),
    "ssm_state": ("batch", "tensor", None, None),
    "conv_state": ("batch", None, "tensor"),
    "slstm_c": ("batch", "tensor", None),
    "slstm_n": ("batch", "tensor", None),
    "slstm_m": ("batch", "tensor", None),
    "slstm_h": ("batch", "tensor", None),
}


def decode_state_specs(state_tree, mesh=None):
    """The spec tree of a decode state, by leaf name (rules-resolved), as
    :func:`repro_torch.models.sharding.tree_param_specs` gives a parameter
    tree's.  A leaf the reference has no rule for (the port's
    ``cross_kpos``) is replicated."""
    rules = current_rules()

    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
                continue
            axes = [rules.get(a, None) if a else None for a in _CACHE_SPECS.get(name, ())]
            spec = (None,) * (leaf.ndim - len(axes)) + tuple(axes)
            out[name] = fit_spec_to_mesh(spec, leaf.shape, mesh)
        return out

    return walk(state_tree)


def _at(tree, i):
    """Layer ``i`` of a stacked tree: views, no copies."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# --- decode attention ----------------------------------------------------------

def _attn_decode(ap, x, cfg, cache, pos, window):
    """x: (B, 1, D); cache {k, v, kpos} (written in place); pos: 0-d int32
    on x's device.  Ring-indexed: the new row goes to slot pos % size."""
    B = x.shape[0]
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    pos_arr = pos.reshape(1, 1).expand(B, 1)
    q = rope(split_dim(x @ ap["wq"], -1, (Hq, hd)), pos_arr, cfg.rope_theta)
    k_new = rope(split_dim(x @ ap["wk"], -1, (Hkv, hd)), pos_arr, cfg.rope_theta)
    v_new = split_dim(x @ ap["wv"], -1, (Hkv, hd))
    K, V, kpos = cache["k"], cache["v"], cache["kpos"]
    slot = (pos % K.shape[1]).reshape(1).long()
    ring_write((K, V, kpos), (k_new.to(K.dtype), v_new.to(V.dtype), pos_arr.to(kpos.dtype)),
               slot)
    qg = _group_q(q, Hkv)[:, 0].contiguous()  # (B, KV, G, hd), head h = kv G + g
    out = _attend(qg, K, V, kpos, pos, window=window, softcap=cfg.attn_logit_softcap)
    return out.reshape(B, 1, Hq * hd).to(x.dtype) @ ap["wo"]


def _attend(qg, K, V, kpos, pos, window=None, softcap=None):
    """``decode_attn`` on each device's own rows and KV heads under
    sharding rules (a sequence sharded over a mesh axis is gathered: the
    kernel attends to whole rows); a plain call otherwise."""
    return shard_local(
        lambda q, k, v, kp: decode_attn(q.contiguous(), k.contiguous(), v.contiguous(),
                                        kp.contiguous(), pos, window=window, softcap=softcap),
        (qg, K, V, kpos), ((0, 1), (0, 2), (0, 2), (0, None)), ((tuple(qg.shape), (0, 1)),))


def _attn_cross_decode(ap, x, cfg, cross_k, cross_v, cross_kpos):
    """Unmasked attention of x's query (no rope) over the cross K/V: the
    all-zero kpos row at pos 0 makes every slot valid."""
    B = x.shape[0]
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    qg = _group_q(split_dim(x @ ap["wq"], -1, (Hq, hd)), Hkv)[:, 0].contiguous()
    out = _attend(qg, cross_k, cross_v, cross_kpos, 0)
    return out.reshape(B, 1, Hq * hd).to(x.dtype) @ ap["wo"]


# --- per-family decode blocks ---------------------------------------------------

def _dense_decode(bp, x, cfg, cache, pos, window):
    x = x + _attn_decode(bp["attn"], rmsnorm(bp["ln1"], x, cfg.norm_eps), cfg, cache, pos,
                         window)
    return x + mlp_apply(bp["mlp"], rmsnorm(bp["ln2"], x, cfg.norm_eps), cfg.activation)


def decode_step(params, cfg: ModelConfig, state, tokens, pos, moe_aux=None):
    """tokens: (B, 1) integer; pos: 0-d int32 tensor on the state's device
    (the current cache length).  ``params``: the compute-cast tree
    (``cast_compute``); the step computes in its embedding's dtype, the
    state's (``init_decode_state``).  Updates ``state`` in place and returns
    (logits (B, 1, V), state).  ``moe_aux``: a list that collects each MoE
    layer's aux dict, computed only when it is given (the reference
    discards them in decode)."""
    tables = gather_layer_params({k: params[k] for k in ("embedding", "unembed") if k in params})
    x = lookup(tables["embedding"], tokens)
    if cfg.embed_scale:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(x.dtype))
    # under sharding rules the token rows leave the table's fsdp sharding
    # here, as the training forward's constraint does (XLA chooses alone)
    x = constrain(x, "batch", None, None)
    fam = cfg.family
    eps = cfg.norm_eps

    if fam in ("dense", "vlm", "moe"):
        if cfg.local_global_alternating:
            layers, caches = params["layers"], state["pairs"]
            for i in range(cfg.num_layers // 2):
                bp, c = gather_layer_params(_at(layers, i)), _at(caches, i)
                x = _dense_decode(bp["local"], x, cfg, c["local"], pos, cfg.sliding_window)
                x = _dense_decode(bp["global"], x, cfg, c["global"], pos, None)
        elif fam == "moe":
            for i in range(cfg.num_layers):
                bp, c = gather_layer_params(_at(params["layers"], i)), _at(state["layers"], i)
                x = x + _attn_decode(bp["attn"], rmsnorm(bp["ln1"], x, eps), cfg, c, pos,
                                     cfg.sliding_window)
                mo, aux = moe_apply(bp["moe"], rmsnorm(bp["ln2"], x, eps), cfg,
                                    with_aux=moe_aux is not None)
                x = x + mo
                if moe_aux is not None:
                    moe_aux.append(aux)
        else:
            for i in range(cfg.num_layers):
                x = _dense_decode(gather_layer_params(_at(params["layers"], i)), x, cfg,
                                  _at(state["layers"], i), pos, cfg.sliding_window)
    elif fam == "ssm":
        for i in range(cfg.num_layers // 2):
            bp, c = gather_layer_params(_at(params["layers"], i)), _at(state["pairs"], i)
            o, ms = ssm.mlstm_step(bp["mlstm"], rmsnorm(bp["ln_m"], x, eps), cfg,
                                   c["mlstm_state"])
            x = x + o
            carry = (c["slstm_c"], c["slstm_n"], c["slstm_m"], c["slstm_h"])
            o, carry = ssm.slstm_step(bp["slstm"], rmsnorm(bp["ln_s"], x, eps), cfg, carry)
            x = x + o
            c["mlstm_state"].copy_(ms)
            for name, new in zip(("slstm_c", "slstm_n", "slstm_m", "slstm_h"), carry):
                c[name].copy_(new)
    elif fam == "hybrid":
        shared = params["shared_attn"]
        for i in range(cfg.num_layers // cfg.hybrid_attn_every):
            bp, c = _at(params["blocks"], i), _at(state["blocks"], i)
            for j in range(cfg.hybrid_attn_every):
                mp, mc = gather_layer_params(_at(bp["mamba_layers"], j)), _at(c["mamba_layers"], j)
                o, s_new, cv_new = ssm.mamba2_step(mp["mamba"], rmsnorm(mp["ln1"], x, eps), cfg,
                                                   mc["ssm_state"], mc["conv_state"])
                x = x + o
                mc["ssm_state"].copy_(s_new)
                mc["conv_state"].copy_(cv_new)
            x = _dense_decode(shared, x, cfg, c["attn"], pos, cfg.sliding_window)
    elif fam == "encdec":
        for i in range(cfg.num_layers):
            bp, c = gather_layer_params(_at(params["dec_layers"], i)), _at(state["dec_layers"], i)
            x = x + _attn_decode(bp["attn"], rmsnorm(bp["ln1"], x, eps), cfg, c, pos, None)
            x = x + _attn_cross_decode(bp["xattn"], rmsnorm(bp["ln_x"], x, eps), cfg,
                                       c["cross_k"], c["cross_v"], state["cross_kpos"])
            x = x + mlp_apply(bp["mlp"], rmsnorm(bp["ln2"], x, eps), cfg.activation)
    else:
        raise ValueError(fam)

    x = rmsnorm(params["ln_f"], x, eps)
    unembed = tables["embedding"].T if cfg.tie_embeddings else tables["unembed"]
    logits = x @ unembed
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits.float() / cap).to(logits.dtype)
    return logits, state
