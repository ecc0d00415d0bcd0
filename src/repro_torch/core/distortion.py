"""Inner-product distortion measures (paper eqs. 6 and 7) — the part of
``repro/core/distortion.py`` the host oracles need.  The distortion
measures themselves come with queue 1, slice 6 in ROADMAP.md.
"""
from __future__ import annotations

import torch

__all__ = ["second_moment"]


def second_moment(Y) -> torch.Tensor:
    """S_y = (1/n) Y^T Y on Y's device — samples are modeled zero-mean
    (paper §3)."""
    Y = torch.as_tensor(Y)
    return Y.T @ Y / Y.shape[0]
