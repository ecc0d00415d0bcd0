"""Operand sets for holding the ``epilogue`` and ``epilogue_fleet`` kernels
against their plain versions (the CPU and card tests, ``chip_smoke.py``).

``serve_cache`` builds a real Nyström serve cache: m random SE experts in
8 dimensions (length-scale^2 8, noise 0.05), factorized by
``nystrom_factors`` + ``nystrom_serve_cache`` in float64 and rounded to
float32, so the variance cancels as it does in serving.  Past K ~ 50 such
a cache is so ill-conditioned (Ainv = L_KK^{-1} of an SE gram) that the
rounding bound of ``epilogue_error_bound`` becomes vacuous; ``generic``
operands (uniform G, scaled random triangular Ainv, a PSD P, gss = 1.5 x
the largest quad + 0.1) keep it meaningful at any K.  ``floored`` test
points get gss = 0, so s2 sits at its 1e-12 floor; ``lost`` experts get
weight 0.
"""
from __future__ import annotations

import torch

from ...core.nystrom import nystrom_factors, nystrom_serve_cache

__all__ = ["epilogue_operands", "epilogue_fleet_operands"]


def _se(a, b):
    d2 = ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)
    return torch.exp(-d2 / 8.0)


def epilogue_operands(m, t, K, *, seed=0, kind="serve_cache", floored=(), lost=(),
                      device=None):
    """(G, Ainv, P, walpha, gss, prior, w), float32, contiguous, on
    ``device``, made from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)
    noise = 0.05
    if kind == "serve_cache":
        Xk, cols, Xq = r(m, K, 8), r(m, 3 * K, 8), r(t, 8)
        f = nystrom_factors(_se(Xk, Xk), _se(Xk, cols), r(m, 3 * K),
                            torch.tensor(noise, dtype=torch.float64))
        f.update(nystrom_serve_cache(f))
        P = (f["U"] - f["U"] @ torch.cholesky_solve(f["U"], f["L_M"])) / (noise + 1e-6)
        G, Ainv, walpha = _se(Xq[None], Xk), f["Ainv"], f["walpha"]
        gss = torch.ones(t, dtype=torch.float64)
    elif kind == "generic":
        G = torch.rand(m, t, K, generator=g, dtype=torch.float64)
        Ainv = torch.tril(r(m, K, K)) / K**0.5
        A = r(m, K, K) / K**0.5
        P = A @ A.mT / K
        walpha = r(m, K)
        Bt = G @ Ainv.mT
        gss = 1.5 * torch.sum(Bt * (Bt @ P.mT), -1).max(0).values + 0.1
    else:
        raise ValueError(f"unknown operand kind {kind!r}")
    prior = gss + noise
    gss = gss.clone()
    gss[list(floored)] = 0.0
    w = torch.ones(m, dtype=torch.float64)
    w[list(lost)] = 0.0
    return tuple(a.to(torch.float32).contiguous().to(device)
                 for a in (G, Ainv, P, walpha, gss, prior, w))


def epilogue_fleet_operands(T, m, t, K, *, seed=0, kind="serve_cache", floored=(),
                            lost=(), device=None):
    """The fleet form: T operand sets of :func:`epilogue_operands` (tenant
    n made from ``seed + n``) stacked on a leading tenant axis — G
    (T, m, t, K), Ainv and P (T, m, K, K), walpha (T, m, K), gss and prior
    (T, t), w (T, m)."""
    per = [epilogue_operands(m, t, K, seed=seed + n, kind=kind, floored=floored, lost=lost)
           for n in range(T)]
    return tuple(torch.stack(a).contiguous().to(device) for a in zip(*per))
