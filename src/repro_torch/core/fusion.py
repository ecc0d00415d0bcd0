"""KL-barycenter fusion of local predictive Gaussians (paper §5.2, eqs.
62-64) — counterpart of ``repro/core/fusion.py``.

(mu*, Sigma*) = argmin sum_i KL( N(mu_i, Sigma_i) || N(mu, Sigma) )
  =>  mu*    = mean_i mu_i                                   (63)
      Sigma* = mean_i [ Sigma_i + (mu* - mu_i)(mu* - mu_i)^T ] (64)

:func:`kl_fuse_diag_psum` is the mesh form: each machine process holds its
own predictive and the barycenter is two all-reduces over the group.
"""
from __future__ import annotations

import torch

from .registry import FusionSpec, register_fusion

__all__ = ["kl_fuse", "kl_fuse_diag", "kl_fuse_diag_psum", "kl_moments", "kl_finalize"]


def kl_fuse(mus, Sigmas):
    """mus: (m, t); Sigmas: (m, t, t) full covariances over the test batch."""
    mu = torch.mean(mus, dim=0)
    dev = mu[None, :] - mus  # (m, t)
    Sigma = torch.mean(Sigmas + dev[:, :, None] * dev[:, None, :], dim=0)
    return mu, Sigma


def kl_fuse_diag(mus, s2s, w=None):
    """Diagonal/per-point special case: s2s (m, t) marginal variances.

    ``w``: optional (m,) availability weights for degraded serving — the
    barycenter renormalizes over surviving experts and the fused variance
    is inflated by the lost fraction ``m / sum(w)``.  ``w=None`` is the
    healthy fleet."""
    if w is None:
        mu = torch.mean(mus, dim=0)
        s2 = torch.mean(s2s + (mu[None, :] - mus) ** 2, dim=0)
        return mu, s2
    m = mus.shape[0]
    w = torch.as_tensor(w, dtype=mus.dtype, device=mus.device).reshape(m, 1)
    m_eff = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(w * mus, dim=0) / m_eff
    s2 = torch.sum(w * (s2s + (mu[None, :] - mus) ** 2), dim=0) / m_eff
    return mu, s2 * (m / m_eff)


def kl_fuse_diag_psum(mu_i, s2_i, group=None, w_i=None):
    """:func:`kl_fuse_diag` as a collective epilogue: every rank of
    ``group`` holds ITS machine's predictive (mu_i, s2_i) (t,) and the
    barycenter is two all-reduces.  ``w_i`` is the rank's own availability
    weight (the degraded form mirrors the stacked one term for term)."""
    from ..comm.collectives import all_reduce, group_size

    m = group_size(group)
    if w_i is None:
        mu = all_reduce(mu_i, group) / m
        s2 = all_reduce(s2_i + (mu - mu_i) ** 2, group) / m
        return mu, s2
    m_eff = torch.clamp(all_reduce(torch.as_tensor(w_i, dtype=mu_i.dtype,
                                                   device=mu_i.device), group), min=1.0)
    mu = all_reduce(w_i * mu_i, group) / m_eff
    s2 = all_reduce(w_i * (s2_i + (mu - mu_i) ** 2), group) / m_eff
    return mu, s2 * (m / m_eff)


def kl_moments(mu_i, s2_i, prior_var=None, w_i=None):
    """One machine's KL-barycenter moment rows ``[w mu_i, w (s2_i + mu_i^2),
    w]``: their sum over machines is sufficient for eqs. 63-64, since
    mean_i (s2_i + (mu - mu_i)^2) = mean_i (s2_i + mu_i^2) - mu^2."""
    one = torch.ones_like(mu_i)
    if w_i is None:
        return torch.stack([mu_i, s2_i + mu_i * mu_i, one])
    return torch.stack([w_i * mu_i, w_i * (s2_i + mu_i * mu_i), w_i * one])


def kl_finalize(S, m, prior_var=None):
    """Fused KL barycenter from summed moment rows (the degraded form
    mirrors :func:`kl_fuse_diag`: renormalize over survivors, inflate by
    ``m / m_eff``)."""
    m_eff = torch.clamp(S[2], min=1.0)
    mu = S[0] / m_eff
    s2 = (S[1] / m_eff - mu * mu) * (m / m_eff)
    return mu, torch.clamp(s2, min=1e-12)


register_fusion(FusionSpec(
    name="kl",
    fuse=lambda mus, s2s, prior_var=None, w=None: kl_fuse_diag(mus, s2s, w),
    fuse_psum=lambda mu_i, s2_i, prior_var, group, w_i=None: kl_fuse_diag_psum(
        mu_i, s2_i, group, w_i),
    moments=kl_moments,
    finalize=kl_finalize,
))
