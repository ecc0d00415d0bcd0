"""Rate-distortion theory of the inner-product problem (paper §4.1) — the
two eigen-helpers of ``repro/core/rate_distortion.py`` that the §4.2
decorrelating transform is built from.  The Theorem-1 curve and the
Theorem-2 test channel come with queue 1, slice 6 in ROADMAP.md.

These run on the host in float64 numpy with ``np.linalg.eigh``, as the
reference's do, so the host oracle's transforms and rates are the
reference's numbers on the same second moments.
"""
from __future__ import annotations

import numpy as np

__all__ = ["product_eigs"]


def _sqrt_psd(Q):
    """Symmetric PSD square root (and inverse sqrt) via eigh."""
    w, v = np.linalg.eigh(np.asarray(Q, dtype=np.float64))
    w = np.clip(w, 0.0, None)
    s = np.sqrt(w)
    half = (v * s) @ v.T
    inv_s = np.where(s > 1e-12 * s.max(), 1.0 / np.where(s == 0, 1.0, s), 0.0)
    inv_half = (v * inv_s) @ v.T
    return half, inv_half


def product_eigs(Qx, Qy):
    """Eigendecomposition of Qy^{1/2} Qx Qy^{1/2} = U Lambda U^T (eq. 25/33).

    Returns (Lambda_desc, U, Qy_half, Qy_inv_half).  Lambda equals the
    eigenvalues of Qx @ Qy (real, >= 0, since both are PSD)."""
    Qy_half, Qy_inv_half = _sqrt_psd(Qy)
    B = Qy_half @ np.asarray(Qx, dtype=np.float64) @ Qy_half
    B = 0.5 * (B + B.T)
    lam, U = np.linalg.eigh(B)
    order = np.argsort(lam)[::-1]
    return np.clip(lam[order], 0.0, None), U[:, order], Qy_half, Qy_inv_half
