"""Configurations of the port — counterpart of ``repro.configs``: the
paper's GP experiment configs (``gp_paper``) and the registry of the ten
LLM architectures (one module each under ``legacy``, exact values from the
cited source).  The reference's ``input_specs`` (shape stand-ins for the
dry run) has no counterpart here yet.
"""
from __future__ import annotations

import importlib

from . import gp_paper  # noqa: F401
from ..models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "list_archs"]

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
