"""Learning-rate schedules — counterpart of ``repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(step, *, peak_lr, warmup_steps, total_steps, min_ratio=0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``.  ``step``: a 0-d
    tensor (the result is an fp32 0-d tensor on its device, computed there:
    no host sync) or a number."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
