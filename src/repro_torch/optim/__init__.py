"""The optimizer of the port's LLM training (counterpart of ``repro.optim``):
AdamW with global-norm clipping, updated in place, and the warmup-cosine
learning-rate schedule."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm  # noqa: F401
from .schedules import cosine_warmup  # noqa: F401

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm", "cosine_warmup"]
