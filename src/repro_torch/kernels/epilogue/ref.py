"""Plain PyTorch version of the fused serve epilogue — counterpart of
``repro/kernels/epilogue/ref.py::epilogue_moments_ref``: the oracle the
``epilogue`` kernel is held against on the card, and what the wrapper runs
for CPU tensors.

One op covers the serve tail of m cached Nyström experts: each expert's
cached apply (mean and variance against the ``nystrom_serve_cache``
operands) and the fusion's moment rows, summed over experts.  The caller
finishes with the fusion's ``finalize``.

Inputs (m experts, t test points, K retained columns), all fp32:
  G      (m, t, K)  masked cross-covariances G_*K per expert
  Ainv   (m, K, K)  L_KK^{-1}
  P      (m, K, K)  woodbury quad-form projector (U - U M^{-1} U) / s2
  walpha (m, K)     W alpha
  gss    (t,)       prior test variance k(x*, x*) (noise-free)
  prior  (t,)       fusion prior variance k(x*, x*) + noise ((r)bcm)
  w      (m,)       availability weights (healthy fleet: all ones)

The fleet form (:func:`epilogue_moments_fleet_plain`) gives every operand a
leading tenant axis T and sums each tenant's OWN m experts into (T, 3, t).

``fuse`` selects the moment rows, which mirror ``FusionSpec.moments``:
  none          [mu_i, s2_i, w]     (one expert; finalize is the identity)
  kl            [w mu, w (s2 + mu^2), w]
  poe/gpoe/bcm  [w/s2, w mu/s2, w]
  rbcm          beta = 0.5 (log prior - log s2) w: [beta/s2, beta mu/s2, beta]
"""
from __future__ import annotations

import torch

__all__ = ["EPILOGUE_FUSES", "epilogue_moments_plain", "epilogue_moments_fleet_plain",
           "epilogue_error_bound", "epilogue_fleet_error_bound"]

EPILOGUE_FUSES = ("none", "kl", "poe", "gpoe", "bcm", "rbcm")
_U = 2.0 ** -24  # fp32 unit roundoff


def _check_fuse(fuse):
    if fuse not in EPILOGUE_FUSES:
        raise ValueError(
            f"unknown epilogue fuse {fuse!r}: known are {', '.join(EPILOGUE_FUSES)}"
        )


def _moment_rows(fuse, mu, s2, prior, w):
    """([T,] m, t) per-expert predictives -> ([T,] m, 3, t) moment rows."""
    _check_fuse(fuse)
    if fuse == "none":
        return torch.stack([mu, s2, w], dim=-2)
    if fuse == "kl":
        return torch.stack([w * mu, w * (s2 + mu * mu), w], dim=-2)
    if fuse == "rbcm":
        beta = 0.5 * (torch.log(prior)[..., None, :] - torch.log(s2)) * w
        return torch.stack([beta / s2, beta * mu / s2, beta], dim=-2)
    return torch.stack([w / s2, w * mu / s2, w], dim=-2)


def _apply(G, Ainv, P, walpha, gss):
    Bt = G @ Ainv.mT  # B^T = G Ainv^T  ([T,] m, t, K)
    mu = (Bt @ walpha[..., None])[..., 0]
    quad = torch.sum(Bt * (Bt @ P.mT), dim=-1)
    return Bt, mu, quad, torch.clamp(gss[..., None, :] - quad, min=1e-12)


def epilogue_moments_plain(G, Ainv, P, walpha, gss, prior, w, *, fuse):
    """Summed moment rows S (3, t) of the fused serve epilogue (with a
    leading tenant axis on every operand: (T, 3, t), see
    :func:`epilogue_moments_fleet_plain`)."""
    _, mu, _, s2 = _apply(G, Ainv, P, walpha, gss)
    wc = torch.as_tensor(w, dtype=mu.dtype, device=mu.device)[..., None] * torch.ones_like(mu)
    return torch.sum(_moment_rows(fuse, mu, s2, prior, wc), dim=-3)


def epilogue_moments_fleet_plain(G, Ainv, P, walpha, gss, prior, w, *, fuse, plan=None):
    """Per-tenant summed moment rows S (T, 3, t): :func:`epilogue_moments_plain`
    batched over a leading tenant axis (G (T, m, t, K), Ainv and P
    (T, m, K, K), walpha (T, m, K), gss and prior (T, t), w (T, m)); each
    tenant sums only its own experts.  ``plan`` is the kernel's and is
    ignored here: the plain version has no tile."""
    if G.dim() != 4:
        raise ValueError(f"fleet epilogue: G must be (T, m, t, K), got {tuple(G.shape)}")
    return epilogue_moments_plain(G, Ainv, P, walpha, gss, prior, w, fuse=fuse)


def epilogue_error_bound(G, Ainv, P, walpha, gss, prior, w, *, fuse,
                         P_mag=None, G_err=None):
    """(3, t) bound on how far two fp32 evaluations of
    :func:`epilogue_moments_plain` that sum in different orders may differ.

    mu, quad and s2 = gss - quad are nested sums of K terms; their rounding
    is at most ``tol = max(1e-5, 3 K u)`` (u = 2^-24) times the sum of the
    ABSOLUTE terms (|G| |Ainv|^T, then |P| against that), not times the
    result: s2 cancels heavily where quad ~ gss.  The bound carries those
    errors to first order through each fusion's rows (divisions by s2 use
    the smallest s2 the error allows; an s2 that sits at its 1e-12 floor in
    both evaluations carries no error), adds two ulps for each ``log`` and
    the rounding of the sum over experts.

    When the two evaluations also got P and G from different computations,
    ``P_mag`` (the sum of P's absolute terms, in place of |P|) and
    ``G_err`` (an absolute error bound of G's entries) widen it to match."""
    _check_fuse(fuse)
    K = G.shape[-1]
    tol = max(1e-5, 3 * K * _U)
    _, mu, quad, s2 = _apply(G, Ainv, P, walpha, gss)
    Pm = P.abs() if P_mag is None else P_mag
    Bm = G.abs() @ Ainv.abs().mT
    PB = Bm @ Pm.mT
    e_mu = tol * (Bm @ walpha.abs()[..., None])[..., 0]
    e_s2 = tol * (torch.sum(Bm * PB, dim=-1) + gss.abs()[None, :])
    if G_err is not None:
        eB = G_err @ Ainv.abs().mT
        e_mu = e_mu + (eB @ walpha.abs()[..., None])[..., 0]
        e_s2 = e_s2 + 2 * torch.sum(eB * PB, dim=-1)
    floored = (gss[None, :] - quad) + e_s2 <= 1e-12
    e_s2 = torch.where(floored, torch.zeros_like(e_s2), e_s2)
    lo = torch.clamp(s2 - e_s2, min=1e-12)
    w = torch.as_tensor(w, dtype=mu.dtype, device=mu.device)[:, None].abs()
    amu = mu.abs()
    if fuse == "none":
        err = [e_mu, e_s2, torch.zeros_like(mu)]
    elif fuse == "kl":
        err = [w * e_mu, w * (e_s2 + 2 * amu * e_mu + e_mu * e_mu), torch.zeros_like(mu)]
    elif fuse == "rbcm":
        beta = (0.5 * (torch.log(prior)[None, :] - torch.log(s2)) * w).abs()
        e_log = 2 * _U * (torch.log(prior).abs()[None, :] + torch.log(s2).abs())
        e_beta = 0.5 * w * (e_s2 / lo + e_log)
        err = [e_beta / lo + beta * e_s2 / lo**2,
               (e_beta * amu + beta * e_mu) / lo + beta * amu * e_s2 / lo**2,
               e_beta]
    else:
        err = [w * e_s2 / lo**2, w * (e_mu / lo + amu * e_s2 / lo**2), torch.zeros_like(mu)]
    rows = _moment_rows(fuse, mu, s2, prior, w * torch.ones_like(mu)).abs()
    m = G.shape[0]
    return torch.stack([e.sum(0) for e in err]) + 2 * (m + 6) * _U * rows.sum(0)


def epilogue_fleet_error_bound(G, Ainv, P, walpha, gss, prior, w, *, fuse,
                               P_mag=None, G_err=None):
    """(T, 3, t): :func:`epilogue_error_bound` applied to each tenant of a
    fleet operand set (``P_mag`` and ``G_err``, when given, carry the
    tenant axis too)."""
    return torch.stack([
        epilogue_error_bound(
            G[n], Ainv[n], P[n], walpha[n], gss[n], prior[n], w[n], fuse=fuse,
            P_mag=None if P_mag is None else P_mag[n],
            G_err=None if G_err is None else G_err[n],
        )
        for n in range(G.shape[0])
    ])
