"""Step factories — counterpart of ``repro/models/steps.py``'s decode step.
The train and prefill steps (and ``init_train_state`` with the optimizer)
serve training and have no counterpart here yet.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .decode import decode_step as _decode_step

__all__ = ["make_decode_step"]


def make_decode_step(cfg: ModelConfig):
    """(params, state, tokens (B, 1), pos) -> (next_tokens (B, 1) int32,
    state): one decode step and the greedy argmax of its fp32 logits (the
    first index among equal maxima, as ``jnp.argmax``).  ``params`` is the
    compute-cast tree."""

    def step(params, state, tokens, pos):
        logits, state = _decode_step(params, cfg, state, tokens, pos)
        nxt = torch.argmax(logits[:, -1].float(), dim=-1)
        return nxt[:, None].to(torch.int32), state

    return step
