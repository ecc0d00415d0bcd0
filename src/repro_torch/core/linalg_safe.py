"""Guarded Cholesky factorizations — counterpart of ``repro/core/linalg_safe.py``.

* :data:`DEFAULT_JITTER` — the one pinned constant (1e-6).
* :func:`chol_jittered` — ``cholesky(M + eps I)`` in one shot; used under
  autograd (training losses).
* :func:`chol_safe` — fit-time factorizations: the first attempt is the
  same expression, and only matrices whose factorization fails are
  retried with geometrically growing jitter.  ``torch.linalg.cholesky``
  raises where ``jnp.linalg.cholesky`` returns NaNs, so failure is read
  from ``torch.linalg.cholesky_ex``'s ``info`` (and a non-finite factor).
* :func:`eigh_sym` — the one ``eigh`` home.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_JITTER", "chol_jittered", "chol_safe", "eigh_sym"]

DEFAULT_JITTER = 1e-6


def eigh_sym(M):
    """Eigendecomposition of a symmetric matrix (ascending eigenvalues).
    Reads one triangle only: callers symmetrize where the input is
    symmetric only up to roundoff."""
    return torch.linalg.eigh(M)


def _eye(M):
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def chol_jittered(M, eps):
    """``cholesky(M + eps * I)`` — one shot, differentiable.  ``eps`` is the
    full jitter (a python float or a tensor broadcasting over M's batch)."""
    eps = torch.as_tensor(eps, dtype=M.dtype, device=M.device)
    return torch.linalg.cholesky(M + eps[..., None, None] * _eye(M))


def _failed(L, info):
    return (info != 0) | ~torch.isfinite(L).flatten(-2).all(-1)


def chol_safe(M, eps=0.0, *, growth=10.0, max_tries=6):
    """Cholesky with geometric jitter escalation on failed factors.

    First attempt ``cholesky(M + eps I)``.  A matrix whose factorization
    fails is retried with ``M + (eps + base * growth**t) I`` for
    t = 0..max_tries-1, ``base = max(eps, DEFAULT_JITTER * (|tr M|/n +
    DEFAULT_JITTER))``.  Batched: each matrix escalates on its own, and a
    matrix that factored keeps its first factor.  Still failing after the
    last try, the factor is the NaN matrix, as in the reference."""
    eye = _eye(M)
    eps = torch.as_tensor(eps, dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(M + eps[..., None, None] * eye)
    bad = _failed(L, info)
    if not bool(bad.any()):  # one host sync, at fit time only
        return L
    n = M.shape[-1]
    scale = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1).abs() / n
    base = torch.maximum(eps, DEFAULT_JITTER * (scale + DEFAULT_JITTER))
    for t in range(max_tries):
        jitter = eps + base * growth ** t
        L_new, info = torch.linalg.cholesky_ex(M + jitter[..., None, None] * eye)
        L = torch.where(bad[..., None, None], L_new, L)
        bad = bad & _failed(L_new, info)
        if not bool(bad.any()):
            return L
    return torch.where(bad[..., None, None], torch.full_like(L, float("nan")), L)
