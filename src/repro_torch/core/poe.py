"""Zero-rate distributed-GP baselines the paper compares against (§5, §6)
— counterpart of ``repro/core/poe.py``: Product of Experts (PoE),
generalized PoE, Bayesian Committee Machine (BCM) and robust BCM (rBCM,
Deisenroth & Ng 2015).

Each expert i contributes a Gaussian predictive N(mu_i, s2_i) per test
point; the combiners differ in precision weighting.  ``prior_var`` is the
prior k(x*, x*) + sigma_eps^2 that (r)BCM need.  Every combiner takes
optional availability weights ``w`` (m,): a 0 weight removes that expert's
factor and, for the committee machines, its prior correction.  ``w=None``
is the healthy fleet.  :func:`combine_psum` is the mesh form: every sum
over experts is an all-reduce over the machine processes.
"""
from __future__ import annotations

from functools import partial

import torch

from .registry import FusionSpec, register_fusion

__all__ = ["poe", "gpoe", "bcm", "rbcm", "combine", "combine_psum", "combine_moments",
           "combine_finalize"]


def _weights(w, m, like):
    return torch.as_tensor(w, dtype=like.dtype, device=like.device).reshape(m, 1)


def poe(mus, s2s, prior_var=None, w=None):
    """PoE: precision-weighted product.  mus/s2s: (m, t)."""
    if w is None:
        prec = torch.sum(1.0 / s2s, dim=0)
        mu = torch.sum(mus / s2s, dim=0) / prec
        return mu, 1.0 / prec
    w = _weights(w, mus.shape[0], mus)
    prec = torch.clamp(torch.sum(w / s2s, dim=0), min=1e-12)
    mu = torch.sum(w * mus / s2s, dim=0) / prec
    return mu, 1.0 / prec


def gpoe(mus, s2s, prior_var=None, betas=None, w=None):
    """Generalized PoE with weights beta_i (default 1/m; under availability
    weights, beta_i = w_i / sum(w))."""
    m = mus.shape[0]
    if betas is None:
        if w is None:
            betas = torch.full((m, 1), 1.0 / m, dtype=mus.dtype, device=mus.device)
        else:
            w = _weights(w, m, mus)
            betas = w / torch.clamp(torch.sum(w), min=1.0)
    prec = torch.clamp(torch.sum(betas / s2s, dim=0), min=1e-12)
    mu = torch.sum(betas * mus / s2s, dim=0) / prec
    return mu, 1.0 / prec


def bcm(mus, s2s, prior_var, w=None):
    """BCM (Tresp 2000): PoE with the (m-1)-fold prior correction (under
    availability weights, the (sum(w)-1)-fold correction)."""
    m = mus.shape[0]
    if w is None:
        prec = torch.sum(1.0 / s2s, dim=0) - (m - 1.0) / prior_var
        prec = torch.clamp(prec, min=1e-12)
        mu = torch.sum(mus / s2s, dim=0) / prec
        return mu, 1.0 / prec
    w = _weights(w, m, mus)
    m_eff = torch.sum(w)
    prec = torch.sum(w / s2s, dim=0) - (m_eff - 1.0) / prior_var
    prec = torch.clamp(prec, min=1e-12)
    mu = torch.sum(w * mus / s2s, dim=0) / prec
    return mu, 1.0 / prec


def rbcm(mus, s2s, prior_var, w=None):
    """Robust BCM: beta_i = 0.5 (log prior_var - log s2_i); availability
    weights scale the betas, so a lost expert contributes neither evidence
    nor prior correction."""
    betas = 0.5 * (torch.log(prior_var) - torch.log(s2s))  # (m, t)
    if w is not None:
        betas = betas * _weights(w, mus.shape[0], mus)
    prec = torch.sum(betas / s2s, dim=0) + (1.0 - torch.sum(betas, dim=0)) / prior_var
    prec = torch.clamp(prec, min=1e-12)
    mu = torch.sum(betas * mus / s2s, dim=0) / prec
    return mu, 1.0 / prec


_COMBINERS = {"poe": poe, "gpoe": gpoe, "bcm": bcm, "rbcm": rbcm}


def combine(method: str, mus, s2s, prior_var=None, w=None):
    return _COMBINERS[method](torch.as_tensor(mus), torch.as_tensor(s2s),
                              prior_var, w=w)


def combine_psum(method: str, mu_i, s2_i, prior_var, group=None, w_i=None):
    """The combiners as collective epilogues: every rank of ``group`` holds
    ITS expert's (mu_i, s2_i) (t,) and every sum over experts is an
    all-reduce.  Agrees with :func:`combine` on the stacked predictives
    (``w_i`` is the rank's own availability weight; the degraded form
    mirrors the stacked one term for term)."""
    from ..comm.collectives import all_reduce, group_size

    psum = lambda v: all_reduce(torch.as_tensor(v, dtype=mu_i.dtype, device=mu_i.device),
                                group)
    m = group_size(group)
    if method == "poe":
        if w_i is None:
            prec = psum(1.0 / s2_i)
            return psum(mu_i / s2_i) / prec, 1.0 / prec
        prec = torch.clamp(psum(w_i / s2_i), min=1e-12)
        return psum(w_i * mu_i / s2_i) / prec, 1.0 / prec
    if method == "gpoe":
        beta_i = 1.0 / m if w_i is None else w_i / torch.clamp(psum(w_i), min=1.0)
        prec = psum(beta_i / s2_i)
        if w_i is not None:
            prec = torch.clamp(prec, min=1e-12)
        return psum(beta_i * mu_i / s2_i) / prec, 1.0 / prec
    if method == "bcm":
        m_eff = m if w_i is None else psum(w_i)
        w = 1.0 if w_i is None else w_i
        prec = torch.clamp(psum(w / s2_i) - (m_eff - 1.0) / prior_var, min=1e-12)
        return psum(w * mu_i / s2_i) / prec, 1.0 / prec
    if method == "rbcm":
        beta_i = 0.5 * (torch.log(prior_var) - torch.log(s2_i))
        if w_i is not None:
            beta_i = beta_i * w_i
        prec = psum(beta_i / s2_i) + (1.0 - psum(beta_i)) / prior_var
        prec = torch.clamp(prec, min=1e-12)
        return psum(beta_i * mu_i / s2_i) / prec, 1.0 / prec
    raise ValueError(f"unknown combiner {method!r}")


def combine_moments(method: str, mu_i, s2_i, prior_var=None, w_i=None):
    """One expert's moment rows for the fused epilogue: the PoE family sums
    per-expert precision terms, so the rows ``[w/s2_i, w mu_i/s2_i, w]``
    (betas folded in for rbcm), summed over experts, carry everything
    :func:`combine_finalize` needs."""
    w = torch.ones_like(mu_i) if w_i is None else w_i * torch.ones_like(mu_i)
    if method == "rbcm":
        beta = 0.5 * (torch.log(prior_var) - torch.log(s2_i)) * w
        return torch.stack([beta / s2_i, beta * mu_i / s2_i, beta])
    if method not in _COMBINERS:
        raise ValueError(f"unknown combiner {method!r}")
    return torch.stack([w / s2_i, w * mu_i / s2_i, w])


def combine_finalize(method: str, S, m, prior_var=None):
    """Fused combiner from summed moment rows ``S`` (the healthy fleet has
    ``S[2] == m``, so the degraded renormalizations reduce to the original
    arithmetic)."""
    if method == "poe":
        prec = torch.clamp(S[0], min=1e-12)
        return S[1] / prec, 1.0 / prec
    if method == "gpoe":
        # betas = w / m_eff: the normalization folds in at finalize time
        m_eff = torch.clamp(S[2], min=1.0)
        prec = torch.clamp(S[0] / m_eff, min=1e-12)
        return S[1] / torch.clamp(S[0], min=1e-12), 1.0 / prec
    if method == "bcm":
        prec = torch.clamp(S[0] - (S[2] - 1.0) / prior_var, min=1e-12)
        return S[1] / prec, 1.0 / prec
    if method == "rbcm":
        prec = torch.clamp(S[0] + (1.0 - S[2]) / prior_var, min=1e-12)
        return S[1] / prec, 1.0 / prec
    raise ValueError(f"unknown combiner {method!r}")


# the zero-rate combiners double as registered fusion rules, so broadcast
# artifacts can fuse with any of them by name (fuse="rbcm" etc.)
for _name in _COMBINERS:
    register_fusion(FusionSpec(
        name=_name,
        fuse=partial(combine, _name),
        fuse_psum=partial(combine_psum, _name),
        moments=partial(combine_moments, _name),
        finalize=partial(combine_finalize, _name),
    ))
del _name
