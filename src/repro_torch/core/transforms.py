"""The decorrelating transform of §4.2 — the part of
``repro/core/transforms.py`` the host oracles need (host-side numpy, as in
the reference).  The Theorem-3 dimension reduction and the PCA baseline
come with queue 1, slice 6 in ROADMAP.md.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .rate_distortion import product_eigs

__all__ = ["DecorrelatingTransform", "make_decorrelating_transform"]


class DecorrelatingTransform(NamedTuple):
    """x' = T x has independent (Gaussian) dims with variances ``variances``;
    x  = T_inv x' inverts it.  T = U^T Qy^{1/2}, T_inv = Qy^{-1/2} U (§4.2)."""

    T: np.ndarray
    T_inv: np.ndarray
    variances: np.ndarray  # Lambda (eigenvalues of Qx Qy), descending


def make_decorrelating_transform(Qx, Qy) -> DecorrelatingTransform:
    lam, U, Qy_half, Qy_inv_half = product_eigs(Qx, Qy)
    return DecorrelatingTransform(T=U.T @ Qy_half, T_inv=Qy_inv_half @ U, variances=lam)
