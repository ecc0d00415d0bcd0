"""Exact Gaussian-process regression (paper §2) — counterpart of
``repro/core/gp.py``.

Kernels: the linear kernel (eq. 4) ``k = a x^T x' + b`` and the squared
exponential (eq. 65) ``k = s exp(-||x - x'||^2 / l^2)``, both written over
inner products so the quantized-wire paths can feed estimated inner
products straight in.  Hyperparameters are trained by Adam on the negative
log marginal likelihood, a Python loop over autograd with the reference's
update formula (not ``torch.optim.Adam``); :func:`train_gp` returns a
:class:`GPModel`, the trained GP bound to its inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from .linalg_safe import DEFAULT_JITTER, chol_jittered, chol_safe
from .registry import KERNELS, KernelSpec, register_kernel

__all__ = [
    "GPParams",
    "init_params",
    "linear_gram",
    "se_gram",
    "kernel_from_inner",
    "prior_diag",
    "gram_fn",
    "posterior_factors",
    "posterior_apply",
    "posterior_from_gram",
    "nlml_from_gram",
    "GPModel",
    "make_adam_step",
    "train_gp",
]


def _inner_products(X, X2, backend: str):
    """X @ X2^T, through the hand-written gram kernel for ``"pallas"``."""
    if backend == "pallas":
        from ..kernels.gram.ops import gram as gram_kernel

        return gram_kernel(X, X2)
    if backend != "xla":
        raise ValueError(f"unknown gram backend {backend!r}")
    return X @ X2.T


class GPParams(NamedTuple):
    """Unconstrained (log-space) hyperparameters, float32 scalar tensors.

    linear kernel: a = exp(log_a), b = exp(log_b)
    se kernel:     s = exp(log_a), l^2 = exp(log_b)
    noise:         sigma_eps^2 = exp(log_noise)
    """

    log_a: torch.Tensor
    log_b: torch.Tensor
    log_noise: torch.Tensor


def init_params(a=1.0, b=1.0, noise=0.1, device=None) -> GPParams:
    f = lambda v: torch.log(torch.tensor(v, dtype=torch.float32, device=device))
    return GPParams(log_a=f(a), log_b=f(b), log_noise=f(noise))


def linear_gram(params: GPParams, X, X2=None, *, backend: str = "xla"):
    """Eq. (4): k(x, x') = a <x, x'> + b."""
    X2 = X if X2 is None else X2
    return torch.exp(params.log_a) * _inner_products(X, X2, backend) + torch.exp(params.log_b)


def _sqdist(X, X2, backend: str = "xla"):
    n1 = torch.sum(X**2, -1, keepdim=True)
    n2 = torch.sum(X2**2, -1, keepdim=True)
    return torch.clamp(n1 + n2.T - 2.0 * _inner_products(X, X2, backend), min=0.0)


def se_gram(params: GPParams, X, X2=None, *, backend: str = "xla"):
    """Eq. (65): k = s exp(-||x - x'||^2 / l^2), via inner products."""
    X2 = X if X2 is None else X2
    return torch.exp(params.log_a) * torch.exp(
        -_sqdist(X, X2, backend) / torch.exp(params.log_b)
    )


def _linear_from_inner(params: GPParams, ip, sq_x, sq_x2):
    return torch.exp(params.log_a) * ip + torch.exp(params.log_b)


def _se_from_inner(params: GPParams, ip, sq_x, sq_x2):
    # batch-safe: leading axes of sq_x / sq_x2 broadcast against ip's
    sq = torch.clamp(sq_x[..., :, None] + sq_x2[..., None, :] - 2.0 * ip, min=0.0)
    return torch.exp(params.log_a) * torch.exp(-sq / torch.exp(params.log_b))


def _linear_prior_diag(params: GPParams, sq_x):
    return torch.exp(params.log_a) * sq_x + torch.exp(params.log_b)


def _se_prior_diag(params: GPParams, sq_x):
    return torch.exp(params.log_a).expand(sq_x.shape)


register_kernel(KernelSpec(
    name="linear", gram=linear_gram,
    from_inner=_linear_from_inner, prior_diag=_linear_prior_diag,
))
register_kernel(KernelSpec(
    name="se", gram=se_gram,
    from_inner=_se_from_inner, prior_diag=_se_prior_diag,
))


def kernel_from_inner(kernel: str, params: GPParams, ip, sq_x, sq_x2):
    """Gram block from inner products ``ip = X @ X2^T`` and squared norms."""
    return KERNELS.get(kernel).from_inner(params, ip, sq_x, sq_x2)


def prior_diag(kernel: str, params: GPParams, sq_x):
    """Prior variances k(x, x) from squared norms."""
    return KERNELS.get(kernel).prior_diag(params, sq_x)


def gram_fn(kernel: str, backend: str = "xla") -> Callable:
    fn = KERNELS.get(kernel).gram
    if backend == "xla":
        return fn
    return lambda params, X, X2=None: fn(params, X, X2, backend=backend)


def posterior_factors(G, y, noise_var):
    """Fit-time half of the dense GP predictive: factorize the train gram
    once into ``{"L": chol(G + noise I), "alpha": (G + noise I)^{-1} y}``.
    Batched over leading axes (G (..., n, n), y (..., n)); the noise is a
    scalar or broadcasts against the diagonal (..., n)."""
    noise = torch.as_tensor(noise_var, dtype=G.dtype, device=G.device)
    diag = torch.broadcast_to(noise, G.shape[:-1]) + DEFAULT_JITTER
    # fit-time: jitter already on the diagonal; escalate only if the factor
    # still fails (rank-deficient gram)
    L = chol_safe(G + torch.diag_embed(diag))
    alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
    return {"L": L, "alpha": alpha}


def posterior_apply(factors, G_star_n, g_star_star):
    """Query-time half: triangular solves against cached
    :func:`posterior_factors`, no factorization.  Batched over leading
    axes: G_star_n (..., t, n), g_star_star (t,) -> mean, var (..., t)."""
    mean = (G_star_n @ factors["alpha"][..., None])[..., 0]
    V = torch.linalg.solve_triangular(factors["L"], G_star_n.mT, upper=False)
    var = g_star_star - torch.sum(V**2, dim=-2)
    return mean, torch.clamp(var, min=1e-12)


def posterior_from_gram(G, G_star_n, g_star_star, y, noise_var):
    """Posterior mean/variance from gram blocks (paper eqs. 2-3, eq. 3's
    sign typo fixed): :func:`posterior_factors` then
    :func:`posterior_apply`.  G (n, n), G_star_n (t, n), g_star_star (t,),
    y (n,); ``noise_var`` a scalar or per point (n,)."""
    return posterior_apply(posterior_factors(G, y, noise_var), G_star_n, g_star_star)


def nlml_from_gram(G, y, noise_var):
    """Negative log marginal likelihood -log N(y | 0, G + sigma^2 I)."""
    n = G.shape[0]
    L = chol_jittered(G, noise_var + DEFAULT_JITTER)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return (
        0.5 * (y @ alpha)
        + torch.sum(torch.log(torch.diagonal(L)))
        + 0.5 * n * math.log(2.0 * math.pi)
    )


@dataclasses.dataclass
class GPModel:
    """A trained GP bound to its (possibly reconstructed) inputs: X (n, d)
    and y (n,) tensors on one device.  :meth:`predict` factorizes the train
    gram once, at its first call (or at :meth:`factors`), and serves every
    later query batch from the cached factors: one gram launch (the
    query-train cross-gram) a request under ``gram_backend="pallas"``."""

    kernel: str
    params: GPParams
    X: torch.Tensor
    y: torch.Tensor
    gram_backend: str = "xla"

    def __post_init__(self):
        self._factors = None

    def factors(self) -> dict:
        """The cached :func:`posterior_factors` of the train gram."""
        if self._factors is None:
            G = gram_fn(self.kernel, self.gram_backend)(self.params, self.X)
            self._factors = posterior_factors(G, self.y, torch.exp(self.params.log_noise))
        return self._factors

    def predict(self, X_star):
        """(mean, var) at ``X_star`` (moved to the model's device and dtype)."""
        X_star = torch.as_tensor(X_star, dtype=self.X.dtype, device=self.X.device)
        G_sn = gram_fn(self.kernel, self.gram_backend)(self.params, X_star, self.X)
        g_ss = prior_diag(self.kernel, self.params, torch.sum(X_star**2, -1))
        return posterior_apply(self.factors(), G_sn, g_ss)

    def nlml(self) -> torch.Tensor:
        G = gram_fn(self.kernel, self.gram_backend)(self.params, self.X)
        return nlml_from_gram(G, self.y, torch.exp(self.params.log_noise))


def make_adam_step(loss: Callable, lr: float) -> Callable:
    """One Adam update ``step(i, params, m, v) -> (params, m, v)`` on the
    scalar ``loss(params)`` — the reference's inline Adam, term for term.
    ``params`` is a named tuple of tensors (``GPParams``, or the sparse
    GP's hyperparameters and inducing inputs); the step returns its type."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(i, p, m, v):
        cls = type(p)
        leaves = [t.detach().requires_grad_(True) for t in p]
        g = torch.autograd.grad(loss(cls(*leaves)), leaves, allow_unused=True)
        g = [torch.zeros_like(a) if gg is None else gg for a, gg in zip(leaves, g)]
        m = [b1 * a + (1 - b1) * gg for a, gg in zip(m, g)]
        v = [b2 * a + (1 - b2) * gg * gg for a, gg in zip(v, g)]
        t = torch.full((), i + 1.0, dtype=torch.float32, device=p[0].device)  # no H2D copy
        p = [
            a.detach() - lr * (mm / (1 - b1**t)) / (torch.sqrt(vv / (1 - b2**t)) + eps)
            for a, mm, vv in zip(p, m, v)
        ]
        return cls(*p), m, v

    return step


def train_gp(
    X,
    y,
    kernel: str = "se",
    params: GPParams | None = None,
    steps: int = 200,
    lr: float = 0.05,
    gram_override: Callable | None = None,
    gram_backend: str = "xla",
) -> GPModel:
    """Maximize the marginal likelihood with ``steps`` Adam steps and return
    the trained :class:`GPModel` on X's device (the callers that train on
    an assembled gram take its ``.params``).  ``gram_override(params) -> G``
    trains on an externally assembled gram (e.g. the center's Nyström
    completion); otherwise the gram is built from ``X`` (through the gram
    kernel for ``gram_backend="pallas"``, differentiable through its
    backward)."""
    params = params if params is not None else init_params(device=X.device)
    k = gram_fn(kernel, gram_backend)

    def loss(p):
        G = gram_override(p) if gram_override is not None else k(p, X)
        return nlml_from_gram(G, y, torch.exp(p.log_noise))

    step = make_adam_step(loss, lr)
    m = [torch.zeros_like(a) for a in params]
    v = [torch.zeros_like(a) for a in params]
    for i in range(steps):
        params, m, v = step(i, params, m, v)
    return GPModel(kernel=kernel, params=GPParams(*(a.detach() for a in params)), X=X, y=y,
                   gram_backend=gram_backend)
