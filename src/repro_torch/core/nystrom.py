"""Nyström completion of the gram matrix (paper §5, eq. 61) — counterpart
of ``repro/core/nystrom.py``.

Given the first K rows ``G_KN`` of an N x N gram (the center's exact block
plus the quantization-estimated cross blocks), approximate
``Ghat = G_NK G_KK^{-1} G_KN`` and serve its GP posterior in woodbury form,
factorized once at fit time.  ``exact_diag=`` pins the completion's
diagonal to the exact prior variances (the FITC correction), and
:func:`nystrom_cross` maps test points through the same completion.

Streaming ``update`` grows the cached factors without refactorizing them:
:func:`chol_update` / :func:`chol_update_rank` take the woodbury core
``L_M`` through rank-1 Givens sweeps, and :func:`chol_append` /
:func:`chol_append_at` border a dense factor with new rows, factorizing
only the new Schur block.  Each takes leading batch axes, so broadcast's m
views or poe's m experts grow in one call.
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
    "nystrom_posterior",
    "chol_update",
    "chol_update_rank",
    "chol_append",
    "chol_append_at",
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
    """(L L^T)^{-1} B; B (..., K) or (..., K, t) — by two triangular
    solves, the same bits as ``torch.cholesky_solve`` on the CPU.  On the
    card, ``cholesky_solve`` over a batch of factors goes through MAGMA and
    waits on the host every call; the triangular solves stay on the
    stream, so a request that uses this never synchronizes."""
    Bm, vec = _col(B, L)
    out = torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, Bm, upper=False), upper=True)
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


def nystrom_posterior(G_KK, G_KN, y, noise_var, G_star_K, g_star_star):
    """GP posterior with the Nyström gram in O(N K^2) woodbury form:
    :func:`nystrom_factors` then :func:`nystrom_apply` — the host oracles'
    one-shot predictive.  (The reference's ``exact_diag=`` branch hands the
    (t, K) cross-gram to an (N, N) dense posterior, which fails unless
    K == N, and no caller passes it; the port leaves it out.  The FITC
    predictive goes through ``nystrom_cross`` and the dense posterior.)"""
    f = nystrom_factors(G_KK, G_KN, y, noise_var)
    return nystrom_apply(f, G_star_K, g_star_star, noise_var)


# --------------------------------------------------------------------------
# streaming factor maintenance (base.update)
# --------------------------------------------------------------------------


def _givens_sweep_(L, x):
    """chol(L L^T + x x^T) IN PLACE in ``L`` (and ``x`` used up): the classic
    Givens sweep, column by column, O(K^2).  Batched over leading axes:
    L (..., K, K), x (..., K).  Column k rotates (L[k, k], x[k]) onto the
    diagonal and carries the rotation down the rows below k, as the
    reference's sweep does with its ``where(idx > k, ...)`` masks."""
    K = L.shape[-1]
    for k in range(K):
        Lkk, xk = L[..., k, k], x[..., k]
        r = torch.sqrt(Lkk * Lkk + xk * xk)
        c, s = (r / Lkk)[..., None], (xk / Lkk)[..., None]
        col, xb = L[..., k + 1:, k], x[..., k + 1:]
        newcol = (col + s * xb) / c
        x[..., k + 1:] = c * xb - s * newcol
        L[..., k + 1:, k] = newcol
        L[..., k, k] = r
    return L


def chol_update(L, x):
    """Rank-1 Cholesky update chol(L L^T + x x^T) in O(K^2) — the Givens
    sweep on copies (the inputs are unchanged).  L (..., K, K), x (..., K)."""
    return _givens_sweep_(L.clone(), x.clone())


def chol_update_rank(L, V):
    """Rank-k update chol(L L^T + V V^T): one rank-1 sweep per column of V
    (..., K, n_new) in turn — O(n_new K^2), never refactorizes the K x K.
    Batched: broadcast's m views are one sweep per column, not m."""
    L = L.clone()
    for i in range(V.shape[-1]):
        _givens_sweep_(L, V[..., i].clone())
    return L


def chol_append(L, C_on, C_nn):
    """Grow a Cholesky factor by appended rows/cols WITHOUT refactorizing the
    existing block: given L = chol(A) and the bordered matrix
    [[A, C_on], [C_on^T, C_nn]], return its (n+k, n+k) factor
    [[L, 0], [X^T, chol(S)]], X = L^{-1} C_on, S = C_nn - X^T X.  Only the
    new k x k Schur block is factorized — O(n k^2 + k^3)."""
    X = _tri_solve(L, C_on)  # (..., n, k)
    S = C_nn - X.mT @ X
    n, k = C_on.shape[-2:]
    top = torch.cat([L, L.new_zeros(L.shape[:-1] + (k,))], dim=-1)
    bot = torch.cat([X.mT, chol_safe(S)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def chol_append_at(L, C_on, C_nn, pos: int):
    """Capacity-aware :func:`chol_append`: the bordered rows written at slot
    ``pos`` of a copy of the padded-capacity factor instead of growing it.

    ``L`` (..., C, C) holds the live block in ``[:pos, :pos]`` and the
    identity pattern in every padded slot (``streaming._pad_chol``);
    ``C_on`` (..., C, k) is zero at every row >= ``pos``.  Then the forward
    solve is exact: the padded rows of X = L^{-1} C_on come out zero, so
    S = C_nn - X^T X is the true Schur complement of the live block, and the
    written rows [X^T | chol(S)] are :func:`chol_append`'s in the occupied
    slots."""
    k = C_on.shape[-1]
    X = _tri_solve(L, C_on)  # (..., C, k)
    S = C_nn - X.mT @ X
    rows = X.mT.clone()  # (..., k, C)
    rows[..., :, pos:pos + k] = chol_safe(S)
    out = L.clone()
    out[..., pos:pos + k, :] = rows
    return out
