"""Nyström completion of the gram matrix (paper §5, eq. 61) — counterpart
of ``repro/core/nystrom.py``.

Given the first K rows ``G_KN`` of an N x N gram (the center's exact block
plus the quantization-estimated cross blocks), approximate
``Ghat = G_NK G_KK^{-1} G_KN`` and serve its GP posterior in woodbury form,
factorized once at fit time.  ``exact_diag=`` pins the completion's
diagonal to the exact prior variances (the FITC correction), and
:func:`nystrom_cross` maps test points through the same completion.  The
streaming Cholesky updates
(``chol_update*``/``chol_append*``) come with the streaming slice.
"""
from __future__ import annotations

import torch

from .linalg_safe import DEFAULT_JITTER, chol_jittered, chol_safe

__all__ = [
    "nystrom_complete",
    "nystrom_complete_map",
    "nystrom_cross",
    "nystrom_cross_mapped",
    "nystrom_kinv",
    "nystrom_factors",
    "nystrom_apply",
    "nystrom_serve_cache",
    "nystrom_apply_cached",
]


def _col(B, L):
    """(B as a matrix, whether it was a vector): a vector has one axis
    fewer than the (..., K, K) factor ``L`` it is solved against."""
    vec = B.dim() == L.dim() - 1
    return (B[..., None] if vec else B), vec


def _tri_solve(L, B):
    """L^{-1} B for lower-triangular L (..., K, K); B (..., K) or (..., K, t)."""
    Bm, vec = _col(B, L)
    out = torch.linalg.solve_triangular(L, Bm, upper=False)
    return out[..., 0] if vec else out


def _cho_solve(L, B):
    """(L L^T)^{-1} B; B (..., K) or (..., K, t)."""
    Bm, vec = _col(B, L)
    out = torch.cholesky_solve(Bm, L)
    return out[..., 0] if vec else out


def _mv(A, v):
    """A v for A (..., a, b) and v (..., b)."""
    return (A @ v[..., None])[..., 0]


def _kk_jitter(G_KK):
    """Per matrix: DEFAULT_JITTER x trace / K (batched over leading axes)."""
    return DEFAULT_JITTER * torch.diagonal(G_KK, dim1=-2, dim2=-1).sum(-1) / G_KK.shape[-1]


def _map(G_KK, G_KN):
    """(L_KK, W): L_KK = chol(G_KK + one-shot jitter), W = L_KK^{-1} G_KN."""
    L = chol_jittered(G_KK, _kk_jitter(G_KK))
    return L, _tri_solve(L, G_KN)  # (K, K), (K, N)


def nystrom_complete(G_KK, G_KN, exact_diag=None):
    """Ghat = G_NK G_KK^{-1} G_KN (eq. 61); one-shot jitter, differentiable
    (the training loss runs through it).  ``exact_diag`` (N,): the true
    diagonal to pin (FITC: Ghat's diagonal is raised to it, never lowered)."""
    return nystrom_complete_map(G_KK, G_KN, exact_diag)[0]


def nystrom_complete_map(G_KK, G_KN, exact_diag=None):
    """:func:`nystrom_complete` with the map it went through:
    (Ghat, L_KK, W), Ghat = W^T W (+ the pinned diagonal)."""
    L, W = _map(G_KK, G_KN)
    Ghat = W.mT @ W
    if exact_diag is not None:
        gap = torch.clamp(exact_diag - torch.diagonal(Ghat, dim1=-2, dim2=-1), min=0.0)
        Ghat = Ghat + torch.diag_embed(gap)
    return Ghat, L, W


def nystrom_cross(G_KK, G_KN, G_star_K):
    """Test-train covariance through the same Nyström map:
    Q_*N = G_*K G_KK^{-1} G_KN (the FITC test covariance)."""
    return nystrom_cross_mapped(*_map(G_KK, G_KN), G_star_K)


def nystrom_cross_mapped(L_KK, W, G_star_K):
    """:func:`nystrom_cross` from the (L_KK, W) of
    :func:`nystrom_complete_map`: (L_KK^{-1} G_*K^T)^T W."""
    return _tri_solve(L_KK, G_star_K.mT).mT @ W


def nystrom_kinv(W, L_M, s2, v):
    """(Ghat + s2 I)^{-1} v in woodbury form:
    (s2 I + W^T W)^{-1} = (I - W^T (s2 I + W W^T)^{-1} W) / s2."""
    v_m, vec = _col(v, W)
    t = _cho_solve(L_M, W @ v_m)
    out = (v_m - W.mT @ t) / s2
    return out[..., 0] if vec else out


def nystrom_factors(G_KK, G_KN, y, noise_var) -> dict:
    """Fit-time factorization of the Nyström predictive, computed once:
    ``L_KK`` = chol(G_KK + jitter), ``W`` = L_KK^{-1} G_KN,
    ``L_M`` = chol(s2 I + W W^T), ``alpha`` = (Ghat + s2 I)^{-1} y."""
    K = G_KK.shape[-1]
    L = chol_safe(G_KK, _kk_jitter(G_KK))
    W = _tri_solve(L, G_KN)  # (K, N)
    s2 = noise_var + DEFAULT_JITTER
    M = s2 * torch.eye(K, dtype=W.dtype, device=W.device) + W @ W.mT
    Lm = chol_safe(M)
    alpha = nystrom_kinv(W, Lm, s2, y)
    return {"L_KK": L, "W": W, "L_M": Lm, "alpha": alpha}


def nystrom_apply(factors, G_star_K, g_star_star, noise_var):
    """Query-time Nyström predictive from :func:`nystrom_factors`:
    O(t N K) triangular solves, no factorization."""
    L, W, Lm, alpha = factors["L_KK"], factors["W"], factors["L_M"], factors["alpha"]
    s2 = noise_var + DEFAULT_JITTER
    B = _tri_solve(L, G_star_K.mT)  # (K, t)
    G_sN = B.mT @ W  # (t, N)
    mean = _mv(G_sN, alpha)
    V = nystrom_kinv(W, Lm, s2, G_sN.mT)  # (N, t), column by column
    var = g_star_star - torch.sum(G_sN.mT * V, dim=-2)
    return mean, torch.clamp(var, min=1e-12)


def nystrom_serve_cache(factors) -> dict:
    """K-sized serve operands from :func:`nystrom_factors`:
    ``Ainv`` = L_KK^{-1}, ``U`` = W W^T, ``walpha`` = W alpha."""
    L, W, alpha = factors["L_KK"], factors["W"], factors["alpha"]
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return {"Ainv": _tri_solve(L, eye), "U": W @ W.mT, "walpha": _mv(W, alpha)}


def nystrom_apply_cached(factors, G_star_K, g_star_star, noise_var):
    """:func:`nystrom_apply` from the :func:`nystrom_serve_cache` operands:
    with B = L_KK^{-1} G_*K^T, mean = B^T (W alpha) and
    quad = diag(B^T P B), P = (U - U M^{-1} U) / s2 — K-sized matmuls only."""
    Ainv, U, Lm, walpha = (
        factors["Ainv"], factors["U"], factors["L_M"], factors["walpha"],
    )
    s2 = noise_var + DEFAULT_JITTER
    B = Ainv @ G_star_K.mT  # (K, t)
    mean = _mv(B.mT, walpha)
    P = (U - U @ _cho_solve(Lm, U)) / s2  # (K, K)
    var = g_star_star - torch.sum(B * (P @ B), dim=-2)
    return mean, torch.clamp(var, min=1e-12)
