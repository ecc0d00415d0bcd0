"""Linear transforms of the paper — counterpart of
``repro/core/transforms.py``: the decorrelating transform of §4.2, the
inner-product-optimal dimension reduction of Theorem 3 (§4.3) and the PCA
baseline it is compared against.

The transforms are built on the host in float64 numpy with the reference's
numpy calls, so both packages build the same bases from the same second
moments; :func:`dr_encode` / :func:`dr_decode` are tensor ops on the
symbols' device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .rate_distortion import _sqrt_psd, product_eigs

__all__ = [
    "DecorrelatingTransform",
    "make_decorrelating_transform",
    "DimReduction",
    "make_dim_reduction",
    "make_pca",
    "dr_encode",
    "dr_decode",
]


class DecorrelatingTransform(NamedTuple):
    """x' = T x has independent (Gaussian) dims with variances ``variances``;
    x  = T_inv x' inverts it.  T = U^T Qy^{1/2}, T_inv = Qy^{-1/2} U (§4.2)."""

    T: np.ndarray
    T_inv: np.ndarray
    variances: np.ndarray  # Lambda (eigenvalues of Qx Qy), descending


def make_decorrelating_transform(Qx, Qy) -> DecorrelatingTransform:
    lam, U, Qy_half, Qy_inv_half = product_eigs(Qx, Qy)
    return DecorrelatingTransform(T=U.T @ Qy_half, T_inv=Qy_inv_half @ U, variances=lam)


class DimReduction(NamedTuple):
    """Theorem-3 reduction: U (d, m) basis; encoder P (m, d) with z = P x;
    decoder x̂ = U z.  ``left_out`` is the claimed distortion (the sum of
    the d - m smallest eigenvalues of Sx Sy)."""

    U: np.ndarray
    P: np.ndarray
    eigenvalues: np.ndarray
    left_out: float


def _right_eigvecs_product(Sx, Sy):
    """Right eigenvectors of Sx @ Sy via the symmetric surrogate
    B = Sy^{1/2} Sx Sy^{1/2} = W M W^T  =>  V = Sy^{-1/2} W (unit columns):
    Sx Sy (Sy^{-1/2} w) = Sy^{-1/2} B w = mu Sy^{-1/2} w."""
    Sy_half, Sy_inv_half = _sqrt_psd(Sy)
    B = Sy_half @ np.asarray(Sx, dtype=np.float64) @ Sy_half
    B = 0.5 * (B + B.T)
    mu, W = np.linalg.eigh(B)
    order = np.argsort(mu)[::-1]
    mu, W = np.clip(mu[order], 0.0, None), W[:, order]
    V = Sy_inv_half @ W
    V = V / np.maximum(np.linalg.norm(V, axis=0, keepdims=True), 1e-30)
    return mu, V


def make_dim_reduction(Sx, Sy, m: int) -> DimReduction:
    """Theorem 3: keep the top-m right eigenvectors of Sx Sy; z by eq. (48),
    z = (U^T Sy U)^{-1} U^T Sy x, the Sy-metric projection."""
    mu, V = _right_eigvecs_product(Sx, Sy)
    U = V[:, :m]
    Sy = np.asarray(Sy, dtype=np.float64)
    P = np.linalg.solve(U.T @ Sy @ U, U.T @ Sy)
    return DimReduction(U=U, P=P, eigenvalues=mu, left_out=float(mu[m:].sum()))


def make_pca(Sx, m: int) -> DimReduction:
    """The PCA baseline: top-m eigenvectors of Sx, orthogonal projection."""
    w, v = np.linalg.eigh(np.asarray(Sx, dtype=np.float64))
    order = np.argsort(w)[::-1]
    w, v = w[order], v[:, order]
    U = v[:, :m]
    return DimReduction(U=U, P=U.T, eigenvalues=np.clip(w, 0, None),
                        left_out=float(w[m:].sum()))


def dr_encode(dr: DimReduction, X: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, m), on X's device and in X's dtype."""
    return X @ torch.as_tensor(dr.P, dtype=X.dtype, device=X.device).T


def dr_decode(dr: DimReduction, Z: torch.Tensor) -> torch.Tensor:
    """(n, m) -> (n, d), on Z's device and in Z's dtype."""
    return Z @ torch.as_tensor(dr.U, dtype=Z.dtype, device=Z.device).T
