"""AdamW with global-norm clipping over a nested dict of tensors —
counterpart of ``repro/optim/adamw.py``, with the reference's arithmetic:
the gradients clipped to global norm ``clip_norm`` (floor 1e-9 on the
norm), b1 0.9, b2 0.95, eps added outside the root of v̂, decoupled
weight decay on every leaf (norm scales included), bias correction at
t = step + 1.

The reference maps pure functions over its trees and returns new ones;
here the params and the moments are updated in place, leaf by leaf, so a
step holds one leaf's temporaries at a time, not a second copy of every
tree.  ``step`` and ``lr`` are 0-d tensors on the params' device: an
update makes no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "global_norm", "adamw_update"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, the updates applied so far
    m: dict
    v: dict


def _leaves(tree):
    """The leaves in the reference's flattening order (keys sorted)."""
    for _, a in sorted(tree.items()):
        if isinstance(a, dict):
            yield from _leaves(a)
        else:
            yield a


def _zeros(tree):
    return {k: _zeros(a) if isinstance(a, dict) else torch.zeros_like(a, dtype=torch.float32)
            for k, a in tree.items()}


def adamw_init(params) -> AdamWState:
    """Zero moments in fp32 beside each leaf, step 0 on the params' device."""
    device = next(_leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=_zeros(params), v=_zeros(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0):
    """One AdamW step: ``params``, ``state.m`` and ``state.v`` updated in
    place.  Returns (params, the new state (step + 1), the gradients'
    global norm before clipping)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state.m), _leaves(state.v)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        vh = (v / c2).sqrt_().add_(eps)
        delta = (m / c1).div_(vh)
        del vh
        delta.add_(weight_decay * p.float())
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
