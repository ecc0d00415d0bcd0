"""Inner-product distortion measures (paper eqs. 6 and 7) — counterpart of
``repro/core/distortion.py``, as tensor ops on the operands' device.
"""
from __future__ import annotations

import torch

__all__ = ["second_moment", "distortion_pairwise", "distortion_quadratic"]


def second_moment(Y) -> torch.Tensor:
    """S_y = (1/n) Y^T Y on Y's device — samples are modeled zero-mean
    (paper §3)."""
    Y = torch.as_tensor(Y)
    return Y.T @ Y / Y.shape[0]


def distortion_pairwise(X, Xhat, Y) -> torch.Tensor:
    """Eq. (6): (1/n^2) sum_ij (<x_i,y_j> - <xhat_i,y_j>)^2."""
    E = (X - Xhat) @ Y.T  # (n, n_y)
    return torch.sum(E**2) / (X.shape[0] * Y.shape[0])


def distortion_quadratic(X, Xhat, Sy) -> torch.Tensor:
    """Eq. (7): (1/n) sum_i (x_i - xhat_i)^T S_y (x_i - xhat_i).  ``Sy`` may
    be a host array; it is cast to the residual's dtype and device."""
    E = X - Xhat
    S = torch.as_tensor(Sy, dtype=E.dtype, device=E.device)
    return torch.mean(torch.einsum("nd,de,ne->n", E, S, E))
