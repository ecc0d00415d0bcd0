"""Backbone assembly for all six architecture families — counterpart of
``repro/models/backbone.py``: the parameter trees and the training /
prefill ``forward``.

The tree, its leaf names and its stacked leading layer axes are the
reference's, so a reference tree carries over leaf for leaf
(``models/weights.py``):

  dense              layers: L blocks          (gemma2: layers: L/2 (local, global) pairs)
  moe                layers: L blocks with an MoE FFN
  ssm (xlstm)        layers: L/2 (mLSTM, sLSTM) pairs
  hybrid (zamba2)    blocks: L/k super-blocks of k mamba layers, plus ONE
                     weight-shared attention block (shared_attn)
  encdec (whisper)   enc_layers, dec_layers (self-attn + cross-attn + MLP)
  vlm (internvl)     layers as dense, plus the patch projector

``forward`` applies the stacked layers in a Python loop where the
reference scans: each stacked leaf is split into its layers with one
``unbind(0)`` a call (the backward of ``leaf[i]`` would write a
zero-filled copy of the whole stacked leaf for every layer).  Remat
(``cfg.remat``) is ``torch.utils.checkpoint`` per layer, or per group of
layers with ``cfg.remat_blocks``, as the reference's ``jax.checkpoint``
per scan step or per inner scan.  The decode step is ``models/decode.py``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import (Init, _init, attention_apply, init_attention, init_mlp, init_rmsnorm,
                     mlp_apply, rmsnorm)
from .moe import init_moe, moe_apply
from .sharding import batch_like, constrain, gather_layer_params, lookup
from . import ssm

__all__ = ["COMPUTE_DTYPE", "init_model", "cast_compute", "param_count", "forward"]

COMPUTE_DTYPE = torch.bfloat16


# --- per-family block init (``lead``: the stacked layer axes) -----------------

def _init_dense_block(rng, cfg, lead):
    return {
        "ln1": init_rmsnorm(rng, cfg.d_model, lead),
        "attn": init_attention(rng, cfg, lead),
        "ln2": init_rmsnorm(rng, cfg.d_model, lead),
        "mlp": init_mlp(rng, cfg.d_model, cfg.d_ff, cfg.activation, lead),
    }


def _init_moe_block(rng, cfg, lead):
    return {
        "ln1": init_rmsnorm(rng, cfg.d_model, lead),
        "attn": init_attention(rng, cfg, lead),
        "ln2": init_rmsnorm(rng, cfg.d_model, lead),
        "moe": init_moe(rng, cfg, lead),
    }


def _init_mamba_block(rng, cfg, lead):
    return {"ln1": init_rmsnorm(rng, cfg.d_model, lead), "mamba": ssm.init_mamba2(rng, cfg, lead)}


def _init_xlstm_pair(rng, cfg, lead):
    return {
        "ln_m": init_rmsnorm(rng, cfg.d_model, lead),
        "mlstm": ssm.init_mlstm(rng, cfg, lead),
        "ln_s": init_rmsnorm(rng, cfg.d_model, lead),
        "slstm": ssm.init_slstm(rng, cfg, lead),
    }


def _init_encdec_dec_block(rng, cfg, lead):
    return {
        "ln1": init_rmsnorm(rng, cfg.d_model, lead),
        "attn": init_attention(rng, cfg, lead),
        "ln_x": init_rmsnorm(rng, cfg.d_model, lead),
        "xattn": init_attention(rng, cfg, lead),
        "ln2": init_rmsnorm(rng, cfg.d_model, lead),
        "mlp": init_mlp(rng, cfg.d_model, cfg.d_ff, cfg.activation, lead),
    }


def init_model(cfg: ModelConfig, seed: int = 0, device=None):
    """The fp32 parameter tree on ``device`` (the card unless the caller
    names another; ``"meta"``: shapes alone), drawn from a generator seeded
    with ``seed``.  Each ``_init_*`` draws its stacked layer axes (``lead``)
    whole, leaf by leaf."""
    rng = Init(seed, device)
    params = {"embedding": _init(rng, (cfg.vocab_size, cfg.d_model), scale=0.02)}
    if not cfg.tie_embeddings:
        params["unembed"] = _init(rng, (cfg.d_model, cfg.vocab_size), scale=0.02)
    params["ln_f"] = init_rmsnorm(rng, cfg.d_model)

    fam = cfg.family
    if fam in ("dense", "vlm"):
        if cfg.local_global_alternating:
            lead = (cfg.num_layers // 2,)
            params["layers"] = {"local": _init_dense_block(rng, cfg, lead),
                                "global": _init_dense_block(rng, cfg, lead)}
        else:
            params["layers"] = _init_dense_block(rng, cfg, (cfg.num_layers,))
        if fam == "vlm":
            params["patch_proj"] = _init(rng, (cfg.d_model, cfg.d_model))
    elif fam == "moe":
        params["layers"] = _init_moe_block(rng, cfg, (cfg.num_layers,))
    elif fam == "ssm":
        params["layers"] = _init_xlstm_pair(rng, cfg, (cfg.num_layers // 2,))
    elif fam == "hybrid":
        k_every = cfg.hybrid_attn_every
        lead = (cfg.num_layers // k_every, k_every)
        params["blocks"] = {"mamba_layers": _init_mamba_block(rng, cfg, lead)}
        params["shared_attn"] = _init_dense_block(rng, cfg, ())
    elif fam == "encdec":
        params["enc_layers"] = _init_dense_block(rng, cfg, (cfg.enc_layers,))
        params["dec_layers"] = _init_encdec_dec_block(rng, cfg, (cfg.num_layers,))
        params["ln_enc"] = init_rmsnorm(rng, cfg.d_model)
        params["enc_pos_proj"] = _init(rng, (cfg.d_model, cfg.d_model))
    else:
        raise ValueError(f"unknown family {fam}")
    return params


# --- block apply (train / prefill) --------------------------------------------

def _dense_block_apply(bp, x, cfg, positions, window, is_causal=True):
    h = attention_apply(bp["attn"], rmsnorm(bp["ln1"], x, cfg.norm_eps), cfg,
                        positions=positions, layer_window=window, is_causal=is_causal)
    x = constrain(x + h, "batch", None, None)
    h = mlp_apply(bp["mlp"], rmsnorm(bp["ln2"], x, cfg.norm_eps), cfg.activation)
    return constrain(x + h, "batch", None, None)


def _moe_block_apply(bp, x, cfg, positions):
    h = attention_apply(bp["attn"], rmsnorm(bp["ln1"], x, cfg.norm_eps), cfg,
                        positions=positions, layer_window=cfg.sliding_window)
    x = x + h
    h, aux = moe_apply(bp["moe"], rmsnorm(bp["ln2"], x, cfg.norm_eps), cfg)
    aux = {k: v for k, v in aux.items() if k != "router_probs"}  # the reference's three
    return constrain(x + h, "batch", None, None), aux


def _xlstm_pair_apply(bp, x, cfg):
    h, _ = ssm.mlstm_apply(bp["mlstm"], rmsnorm(bp["ln_m"], x, cfg.norm_eps), cfg)
    x = x + h
    h, _ = ssm.slstm_apply(bp["slstm"], rmsnorm(bp["ln_s"], x, cfg.norm_eps), cfg)
    return constrain(x + h, "batch", None, None)


def _mamba_block_apply(bp, x, cfg):
    h, _, _ = ssm.mamba2_apply(bp["mamba"], rmsnorm(bp["ln1"], x, cfg.norm_eps), cfg)
    return constrain(x + h, "batch", None, None)


def _unstack(tree):
    """A stacked tree as the list of its layers: each leaf split by one
    ``unbind(0)``."""
    parts = {k: _unstack(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _scan(fn, x, stacked, cfg, with_aux=False):
    """``fn(layer_params, h) -> h`` (``-> (h, aux)`` with ``with_aux``) over
    the layers of ``stacked`` in order, each layer's weights gathered
    first (``gather_layer_params``: one layer at a time, under sharding
    rules).  With ``cfg.remat`` each layer is
    recomputed in the backward (``torch.utils.checkpoint``); with
    ``cfg.remat_blocks`` = g dividing the L layers (g < L), each group of
    L / g layers instead.  Returns h, or (h, [aux of each layer])."""
    layers = _unstack(stacked)
    L, groups = len(layers), cfg.remat_blocks
    auxs = []

    def run(group, h):
        out = []
        for lp in group:
            r = fn(gather_layer_params(lp), h)
            h = r[0] if with_aux else r
            out.append(r[1] if with_aux else None)
        return h, out

    if cfg.remat and groups and L % groups == 0 and groups < L:
        inner = L // groups
        for g in range(groups):
            x, out = checkpoint(run, layers[g * inner:(g + 1) * inner], x, use_reentrant=False)
            auxs += out
    else:
        for lp in layers:
            x, out = (checkpoint(run, [lp], x, use_reentrant=False) if cfg.remat
                      else run([lp], x))
            auxs += out
    return (x, auxs) if with_aux else x


_KEEP_F32 = {"scale", "a_log", "dt_bias", "norm_scale", "bias"}


def cast_compute(params, dtype=None):
    """The compute cast (``dtype``, ``COMPUTE_DTYPE`` by default) of the
    fp32 matrix leaves; norm scales and the SSM time constants stay fp32
    (matched by leaf name).  A new tree: the fp32 tree it was given is
    untouched (the serving entry point casts once, where the reference
    casts in every step).  The decode step computes in the dtype of the
    tree it is given."""
    dtype = COMPUTE_DTYPE if dtype is None else dtype

    def cast(tree):
        out = {}
        for name, a in tree.items():
            if isinstance(a, dict):
                out[name] = cast(a)
            elif name in _KEEP_F32 or a.dtype != torch.float32:
                out[name] = a
            else:
                out[name] = a.to(dtype)
        return out

    return cast(params)


def forward(params, cfg: ModelConfig, batch: dict, kind: str = "train", dtype=None):
    """-> (logits (B, S, V) in the compute dtype, aux).  ``params``: the
    fp32 master tree, cast inside (``dtype``, ``COMPUTE_DTYPE`` by
    default), so gradients reach it; batch: tokens (B, S) integer, plus
    enc_embed (B, enc_seq, D) for encdec and patch_embed (B, num_patches,
    D) for vlm.  aux: the MoE family's load_balance, router_z and
    drop_frac, each averaged over the layers; empty otherwise.  ``kind``
    ("train" or "prefill") computes the same, as the reference's."""
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    params = cast_compute(params, dtype)
    tables = gather_layer_params({k: params[k] for k in ("embedding", "unembed") if k in params})
    tokens = batch["tokens"]
    B, S = tokens.shape
    eps = cfg.norm_eps
    x = lookup(tables["embedding"], tokens)
    if cfg.embed_scale:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(dtype))
    x = constrain(x, "batch", None, None)
    aux = {}

    if cfg.family == "vlm":
        patches = batch["patch_embed"].to(dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
    S_eff = x.shape[1]
    positions = batch_like(torch.arange(S_eff, device=x.device)[None].expand(B, S_eff), x)

    if cfg.family in ("dense", "vlm"):
        if cfg.local_global_alternating:
            def pair(bp, h):
                h = _dense_block_apply(bp["local"], h, cfg, positions, cfg.sliding_window)
                return _dense_block_apply(bp["global"], h, cfg, positions, None)
            x = _scan(pair, x, params["layers"], cfg)
        else:
            x = _scan(lambda bp, h: _dense_block_apply(bp, h, cfg, positions, cfg.sliding_window),
                      x, params["layers"], cfg)
    elif cfg.family == "moe":
        x, auxs = _scan(lambda bp, h: _moe_block_apply(bp, h, cfg, positions), x,
                        params["layers"], cfg, with_aux=True)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    elif cfg.family == "ssm":
        x = _scan(lambda bp, h: _xlstm_pair_apply(bp, h, cfg), x, params["layers"], cfg)
    elif cfg.family == "hybrid":
        shared = params["shared_attn"]

        def superblock(bp, h):
            h = _scan(lambda mp, hh: _mamba_block_apply(mp, hh, cfg), h, bp["mamba_layers"], cfg)
            return _dense_block_apply(shared, h, cfg, positions, cfg.sliding_window)

        x = _scan(superblock, x, params["blocks"], cfg)
    elif cfg.family == "encdec":
        enc = batch["enc_embed"].to(dtype) @ params["enc_pos_proj"]
        enc_pos = batch_like(torch.arange(enc.shape[1], device=x.device)[None].expand(
            B, enc.shape[1]), x)
        enc = _scan(lambda bp, h: _dense_block_apply(bp, h, cfg, enc_pos, None, is_causal=False),
                    enc, params["enc_layers"], cfg)
        enc = rmsnorm(params["ln_enc"], enc, eps)

        def dec_block(bp, h):
            h = h + attention_apply(bp["attn"], rmsnorm(bp["ln1"], h, eps), cfg,
                                    positions=positions)
            h = h + attention_apply(bp["xattn"], rmsnorm(bp["ln_x"], h, eps), cfg,
                                    positions=positions, is_causal=False, x_kv=enc)
            return constrain(h + mlp_apply(bp["mlp"], rmsnorm(bp["ln2"], h, eps), cfg.activation),
                             "batch", None, None)

        x = _scan(dec_block, x, params["dec_layers"], cfg)
    else:
        raise ValueError(f"unknown family {cfg.family}")

    x = rmsnorm(params["ln_f"], x, eps)
    if cfg.family == "vlm":  # logits over the token positions only
        x = x[:, -S:]
    unembed = tables["embedding"].T if cfg.tie_embeddings else tables["unembed"]
    logits = x @ unembed
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits.float() / cap).to(logits.dtype)
    logits = constrain(logits, "batch", None, "tensor")
    return logits, aux


def param_count(params) -> int:
    """Number of parameters in a tree (works on the ``meta`` device)."""
    return sum(param_count(a) if isinstance(a, dict) else a.numel() for a in params.values())
