"""Configurations of the port — counterpart of ``repro.configs``: the
paper's GP experiment configs (``gp_paper``) and the registry of the ten
LLM architectures (one module each under ``legacy``, exact values from the
cited source).  ``input_specs`` builds stand-ins for every model input of
a (config, shape) pair — tensors of the reference's shapes and dtypes on
the ``meta`` device, or on a fake device under ``FakeTensorMode``, with
no allocation.
"""
from __future__ import annotations

import importlib

import torch

from . import gp_paper  # noqa: F401
from ..models.config import ModelConfig, ShapeConfig

__all__ = ["ARCHS", "get_config", "list_archs", "input_specs"]

ARCHS = [
    "gemma_7b",
    "whisper_medium",
    "internvl2_2b",
    "mistral_large_123b",
    "arctic_480b",
    "stablelm_12b",
    "gemma2_2b",
    "xlstm_125m",
    "qwen2_moe_a2_7b",
    "zamba2_2_7b",
]


def get_config(arch_id: str) -> ModelConfig:
    """The config of ``arch_id`` ("gemma2-2b", "qwen2-moe-a2.7b", or the
    module name)."""
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f".legacy.{mod_name}", __package__).CONFIG


def list_archs():
    """Canonical assigned ids (e.g. 'qwen2-moe-a2.7b')."""
    return [importlib.import_module(f".legacy.{a}", __package__).CONFIG.name for a in ARCHS]


def input_specs(cfg: ModelConfig, shape: ShapeConfig, batch_override=None, device="meta"):
    """The batch of a train / prefill step as empty tensors on ``device``:
    int32 tokens (B, S) [and labels for train], bf16 enc_embed (B, enc_seq,
    D) for encdec and patch_embed (B, num_patches, D) for vlm.  Decode
    state stand-ins come from ``init_decode_state`` on the same device."""
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def empty(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    batch = {"tokens": empty((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = empty((B, S), torch.int32)
    if cfg.family == "encdec":
        batch["enc_embed"] = empty((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        batch["patch_embed"] = empty((B, cfg.num_patches, cfg.d_model), torch.bfloat16)
    return batch
