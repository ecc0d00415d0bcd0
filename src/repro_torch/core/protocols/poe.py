"""Zero-rate baselines PoE / gPoE / BCM / rBCM as a protocol — counterpart
of ``repro/core/protocols/poe.py``.

Each machine is an expert on its local data only (the block-diagonal-gram
assumption); predictions are combined by a registered fusion rule.
Nothing crosses the wire, so every ledger is 0: this is the zero point of
the paper's rate/distortion axis that the quantized protocols beat.  The
shared hyperparameters are trained on machine 0's local data with the
plain gram, as in the reference; with ``gram_backend="pallas"`` the own
blocks (fit) and every request's query products go through the ``gram``
kernel, one launch each over all experts.
"""
from __future__ import annotations

import torch

from ..gp import GPParams, kernel_from_inner, posterior_apply, posterior_factors, train_gp
from ..registry import FUSIONS, ProtocolSpec, register_protocol
from .base import FittedProtocol, StreamState, _mask_gram, pad_parts, params_on
from .broadcast import _star_exact_products

__all__ = []


def _fit_poe(parts, cfg, params: GPParams | None, device) -> FittedProtocol:
    kernel, backend = cfg.kernel, cfg.gram_backend
    X0 = torch.as_tensor(parts[0][0], dtype=torch.float32, device=device)
    y0 = torch.as_tensor(parts[0][1], dtype=torch.float32, device=device)
    p = train_gp(X0, y0, kernel=kernel, params=params_on(params, device), steps=cfg.steps,
                 lr=cfg.lr)
    noise = torch.exp(p.log_noise)
    shards = pad_parts(parts, device)
    m, n, d = shards.X.shape
    sq_exact = torch.sum(shards.X**2, -1)
    if backend == "pallas":
        from ...kernels.gram.ops import gram as gram_kernel

        flat = shards.X.reshape(m * n, d)
        full = gram_kernel(flat, flat).reshape(m, n, m, n)
        A = torch.diagonal(full, dim1=0, dim2=2).permute(2, 0, 1)
    else:
        A = torch.einsum("ind,imd->inm", shards.X, shards.X)
    G = _mask_gram(kernel_from_inner(kernel, p, A, sq_exact, sq_exact), shards.mask)
    y = shards.y * shards.mask
    factors = posterior_factors(G, y, noise)
    return FittedProtocol(
        params=p, y=y, factors=factors,
        data={"Xs": shards.X, "mask": shards.mask, "sq_exact": sq_exact},
        wire=None, stream=StreamState.make(shards.lengths, n, device=device),
        protocol="poe", kernel=kernel, gram_mode="dense", fuse=cfg.fusion,
        gram_backend=backend, n_center=0, fit_lengths=shards.lengths,
        block_order=None, bits_per_sample=0, max_bits=0, impl=cfg.impl,
        scheme=cfg.scheme, config=cfg,
    )


def _predict_poe_experts(art, X_star, sq_star, g_ss):
    """(m, t) per-expert dense predictives (mus, s2s)."""
    C = _star_exact_products(art.data["Xs"], X_star, art.gram_backend)
    G_sn = kernel_from_inner(art.kernel, art.params, C, sq_star,
                             art.data["sq_exact"]) * art.data["mask"][:, None, :]
    return posterior_apply(art.factors, G_sn, g_ss)


def _predict_poe(art: FittedProtocol, X_star, sq_star, g_ss, noise, avail=None):
    mus, s2s = _predict_poe_experts(art, X_star, sq_star, g_ss)
    spec = FUSIONS.get(art.fuse)
    if avail is None:
        return spec.fuse(mus, s2s, g_ss + noise)
    # degraded serving: the combiner renormalizes over surviving experts
    return spec.fuse(mus, s2s, g_ss + noise, avail)


register_protocol(ProtocolSpec(name="poe", fit=_fit_poe, predict=_predict_poe))
