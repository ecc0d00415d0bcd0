"""Parameter trees for all six architecture families — counterpart of
``repro/models/backbone.py``'s init half.

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

The training / prefill ``forward`` has no counterpart here yet; the decode
step is ``models/decode.py``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import Init, _init, init_attention, init_mlp, init_rmsnorm
from .moe import init_moe
from . import ssm

__all__ = ["COMPUTE_DTYPE", "init_model", "cast_compute", "param_count"]

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


def param_count(params) -> int:
    """Number of parameters in a tree (works on the ``meta`` device)."""
    return sum(param_count(a) if isinstance(a, dict) else a.numel() for a in params.values())
