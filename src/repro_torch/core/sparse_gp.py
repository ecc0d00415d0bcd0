"""Titsias (2009) variational sparse GP (SGPR) and the paper's Fig.-7
variant — counterpart of ``repro/core/sparse_gp.py``: quantize the
*inducing* points with the per-symbol scheme instead of the full dataset,
the paper's remedy for the very-low-rate regime where shipping many
low-quality samples loses to shipping few good ones.

Every function takes leading batch axes on ``Z``, ``X``, ``y`` and the
hyperparameters: one independent SGPR per leading index (the Fig. 7 script
trains every machine's at once, and the summed ELBO's gradient is each
machine's own).  Inner products go through the ``gram`` kernel under
``gram_backend="pallas"``, one launch per product over the whole batch.
The prior variances k(x, x) come from ``prior_diag`` (the reference takes
the diagonal of an n x n gram: the same values, up to the rounding of
|x - x|^2).  The one random draw, the initial inducing rows, is
:func:`inducing_init`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .gp import (
    GPParams, _inner_products, init_params, kernel_from_inner, make_adam_step, prior_diag,
)
from .linalg_safe import DEFAULT_JITTER, chol_jittered

__all__ = ["SGPR", "train_sgpr", "elbo", "inducing_init"]


def inducing_init(n: int, m: int, seed: int) -> torch.Tensor:
    """``m`` distinct row indices of ``n``: the initial inducing inputs,
    drawn on the CPU from a generator seeded with ``seed`` (the reference
    draws ``jax.random.choice(PRNGKey(seed), n, (m,), replace=False)``)."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(int(seed)))[:m]


def _inner(A, B, backend: str):
    """A_b B_b^T for every leading index b (A may be shared, 2-D); under the
    pallas backend one ``gram`` launch over the flattened batch."""
    if A.dim() == 2 and B.dim() == 2:
        return _inner_products(A, B, backend)
    if backend != "pallas":
        return A @ B.mT
    a, c, d = A.shape[-2], B.shape[-2], B.shape[-1]
    lead = B.shape[:-2]
    nb = math.prod(lead)
    full = _inner_products(A.reshape(-1, d), B.reshape(-1, d), backend)
    if A.dim() == 2:  # (a, nb c) -> (nb, a, c)
        return full.reshape(a, nb, c).permute(1, 0, 2).reshape(*lead, a, c)
    full = full.reshape(nb, a, nb, c)
    return torch.diagonal(full, dim1=0, dim2=2).permute(2, 0, 1).reshape(*lead, a, c)


def _at(params: GPParams, k: int) -> GPParams:
    """The hyperparameters with ``k`` trailing unit axes (to broadcast
    against per-batch vectors, k = 1, or matrices, k = 2)."""
    return GPParams(*(a.reshape(*a.shape, *([1] * k)) for a in params))


def _k(kernel: str, params: GPParams, A, B, backend: str):
    return kernel_from_inner(kernel, _at(params, 2), _inner(A, B, backend),
                             torch.sum(A**2, -1), torch.sum(B**2, -1))


def _chol(K):
    # the ELBO sits under autograd: one-shot jitter only
    return chol_jittered(K, DEFAULT_JITTER)


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class _Terms(NamedTuple):
    s2: torch.Tensor  # (...) noise variance + jitter
    L: torch.Tensor  # chol(Kmm)
    A: torch.Tensor  # L^{-1} Kmn / s
    Lb: torch.Tensor  # chol(I + A A^T)
    c: torch.Tensor  # Lb^{-1} A y / s


def _terms(params: GPParams, Z, X, y, kernel: str, backend: str) -> _Terms:
    s2 = torch.exp(params.log_noise) + DEFAULT_JITTER
    s = torch.sqrt(s2)
    L = _chol(_k(kernel, params, Z, Z, backend))
    A = _solve_lower(L, _k(kernel, params, Z, X, backend)) / s[..., None, None]
    m = Z.shape[-2]
    Lb = _chol(torch.eye(m, dtype=A.dtype, device=A.device) + A @ A.mT)
    c = _solve_lower(Lb, A @ y[..., None])[..., 0] / s[..., None]
    return _Terms(s2, L, A, Lb, c)


def elbo(params: GPParams, Z, X, y, kernel: str, gram_backend: str = "xla"):
    """Titsias ELBO:  log N(y | 0, Qnn + s2 I) - tr(Knn - Qnn) / (2 s2),
    with Qnn = Knm Kmm^{-1} Kmn, in O(n m^2).  Shapes (..., m, d),
    (..., n, d), (..., n) -> (...)."""
    t = _terms(params, Z, X, y, kernel, gram_backend)
    n = X.shape[-2]
    knn_diag = prior_diag(kernel, _at(params, 1), torch.sum(X**2, -1))
    log_det = torch.sum(torch.log(torch.diagonal(t.Lb, dim1=-2, dim2=-1)), -1) \
        + 0.5 * n * torch.log(2 * math.pi * t.s2)
    quad = 0.5 * torch.sum(y * y, -1) / t.s2 - 0.5 * torch.sum(t.c * t.c, -1)
    trace_term = 0.5 * (torch.sum(knn_diag, -1) / t.s2 - torch.sum(t.A * t.A, (-2, -1)))
    return -(log_det + quad + trace_term)


@dataclasses.dataclass
class SGPR:
    """A trained sparse GP: hyperparameters, inducing inputs Z (..., m, d)
    and the data (..., n, d), (..., n) it was fitted on, as tensors on one
    device."""

    kernel: str
    params: GPParams
    Z: torch.Tensor
    X: torch.Tensor
    y: torch.Tensor
    gram_backend: str = "xla"

    def _terms(self) -> _Terms:
        return _terms(self.params, self.Z, self.X, self.y, self.kernel, self.gram_backend)

    def predict(self, X_star):
        """The standard SGPR predictive (Titsias eq. 6) at ``X_star`` (t, d),
        shared by every batch entry: (mean, var) of shape (..., t)."""
        X_star = torch.as_tensor(X_star, dtype=torch.float32, device=self.Z.device)
        t = self._terms()
        Ksm = _k(self.kernel, self.params, X_star, self.Z, self.gram_backend)  # (..., t, m)
        sq = torch.sum(X_star**2, -1).expand(*t.s2.shape, X_star.shape[0])
        kss = prior_diag(self.kernel, _at(self.params, 1), sq)
        tmp1 = _solve_lower(t.L, Ksm.mT)  # (..., m, t)
        tmp2 = _solve_lower(t.Lb, tmp1)
        mean = (tmp2.mT @ t.c[..., None])[..., 0]
        var = kss - torch.sum(tmp1**2, -2) + torch.sum(tmp2**2, -2)
        return mean, torch.clamp(var, min=1e-12)

    def compact(self):
        """The transmit-side summary the paper quantizes: the inducing
        inputs Z."""
        return self.Z

    def qu(self):
        """The variational posterior q(u) = N(m_u, S_u) at the inducing
        points, the machine-local summary a distributed sparse GP ships
        (Fig. 7): (m_u (..., m), diag(S_u) (..., m)), with m_u = L Lb^{-T} c
        and S_u = L B^{-1} L^T."""
        t = self._terms()
        m_u = (t.L @ torch.linalg.solve_triangular(t.Lb.mT, t.c[..., None], upper=True))[..., 0]
        V = _solve_lower(t.Lb, t.L.mT)  # (..., m, m)
        return m_u, torch.clamp(torch.sum(V * V, -2), min=1e-8)


class _State(NamedTuple):
    """What the SGPR's Adam moves: the hyperparameters and Z."""

    log_a: torch.Tensor
    log_b: torch.Tensor
    log_noise: torch.Tensor
    Z: torch.Tensor


def train_sgpr(X, y, num_inducing: int, kernel: str = "se", params: GPParams | None = None,
               steps: int = 300, lr: float = 0.02, seed: int = 0,
               gram_backend: str = "xla") -> SGPR:
    """Maximize the ELBO over the hyperparameters AND the inducing inputs
    with ``steps`` Adam steps (the reference's update rule), on X's device.
    X (..., n, d) and y (..., n) tensors; with leading axes, one SGPR per
    leading index, the b-th (in row-major order) started from
    :func:`inducing_init` ``(n, num_inducing, seed + b)`` — the reference's
    ``key=PRNGKey(seed)`` for a single SGPR."""
    lead, n = X.shape[:-2], X.shape[-2]
    idx = torch.stack([inducing_init(n, num_inducing, seed + b)
                       for b in range(math.prod(lead))]).reshape(*lead, num_inducing)
    Z0 = torch.take_along_dim(X, idx.to(X.device, torch.long)[..., None], dim=-2)
    params = params if params is not None else init_params(device=X.device)
    state = _State(*(a.to(X.device).expand(lead).clone() for a in params), Z0)

    def loss(s):
        return -elbo(GPParams(s.log_a, s.log_b, s.log_noise), s.Z, X, y, kernel,
                     gram_backend).sum()

    step = make_adam_step(loss, lr)
    m = [torch.zeros_like(a) for a in state]
    v = [torch.zeros_like(a) for a in state]
    for i in range(steps):
        state, m, v = step(i, state, m, v)
    return SGPR(kernel=kernel, params=GPParams(*(a.detach() for a in state[:3])),
                Z=state.Z.detach(), X=X, y=y, gram_backend=gram_backend)
