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

Streaming ``update`` is zero-rate too: the new rows are written into every
expert's buffer at the shared cursor but are valid on their owner's expert
only (the others get decoupled unit rows, as fit-time padding does), and
each expert's dense factor is bordered in one batched call.  The ledgers
do not move.  ``impl="host"`` runs the serial oracle (:class:`HostPoEGP`),
``impl="mesh"`` one process per expert (:mod:`.mesh`).
:func:`poe_baseline` is the reference's one-call entry point.
A fault plan's dropped and NaN-poisoned shards leave their experts short or
empty (an empty expert is served as lost); its bit flips are a no-op.
"""
from __future__ import annotations

import dataclasses

import torch

from ..gp import (
    GPParams, gram_fn, kernel_from_inner, posterior_apply, posterior_factors,
    posterior_from_gram, train_gp,
)
from ..linalg_safe import DEFAULT_JITTER
from ..nystrom import chol_append_at
from ..registry import FUSIONS, ProtocolSpec, register_protocol
from . import base
from .base import (
    FittedProtocol, StreamState, _apply_fit_faults, _grow_stream, _mask_gram, _numpy,
    pad_parts, params_on, parts_on,
)
from .broadcast import _star_exact_products

__all__ = ["HostPoEGP", "fit_poe_host", "poe_baseline"]


@dataclasses.dataclass
class HostPoEGP:
    """The ``impl="host"`` oracle: shared hypers trained on machine 0's
    local data, one dense solve per expert at predict time."""

    kernel: str
    params: GPParams
    parts: list  # [(X_j, y_j)] as tensors on the oracle's device
    method: str

    def predict(self, X_star, available=None):
        k, p = gram_fn(self.kernel), self.params
        X_star = torch.as_tensor(X_star, dtype=torch.float32, device=self.parts[0][0].device)
        noise = torch.exp(p.log_noise)
        g_ss = torch.diagonal(k(p, X_star, X_star))
        mus, s2s = zip(*[posterior_from_gram(k(p, Xj), k(p, X_star, Xj), g_ss, yj, noise)
                         for Xj, yj in self.parts])
        mus, s2s = torch.stack(mus), torch.stack(s2s)
        spec = FUSIONS.get(self.method)
        if available is None:
            return spec.fuse(mus, s2s, g_ss + noise)
        w = (torch.as_tensor(_numpy(available), dtype=torch.float32, device=mus.device)
             > 0).float()
        return spec.fuse(mus, s2s, g_ss + noise, w)


def fit_poe_host(parts, cfg, params: GPParams | None, device) -> HostPoEGP:
    """Shared hypers trained on ``device`` on machine 0's local data (the
    PoE family shares one hyperparameter set across experts).  Zero rate:
    only a fault plan's data faults apply."""
    parts = parts_on(_apply_fit_faults(parts, cfg)[0], device)
    p = train_gp(parts[0][0], parts[0][1], kernel=cfg.kernel,
                 params=params_on(params, device), steps=cfg.steps, lr=cfg.lr).params
    return HostPoEGP(kernel=cfg.kernel, params=p, parts=parts, method=cfg.fusion)


def poe_baseline(parts, X_star, kernel: str = "se", method: str = "rbcm", steps: int = 150,
                 lr: float = 0.05, impl: str = "batched", gram_backend: str = "xla",
                 train_impl: str = "scan", device=None):
    """Zero-rate baselines in one call: each machine an expert on its local
    data only, the experts' predictions at ``X_star`` combined by PoE / BCM
    / rBCM (``method``).  Returns ``(mu, s2, params)`` on ``device`` (the
    card when None).  A thin composition over :func:`~.base.fit` and
    :func:`~.base.predict`; ``impl="host"`` fits the serial oracle."""
    from ..config import DGPConfig

    cfg = DGPConfig(protocol="poe", kernel=kernel, fusion=method, impl=impl,
                    bits_per_sample=0, steps=int(steps), lr=float(lr),
                    gram_backend=gram_backend, train_impl=train_impl)
    model = base.fit(parts, cfg, None, device)
    mu, s2 = model.predict(X_star)
    return mu, s2, model.params


def _fit_poe(parts, cfg, params: GPParams | None, device) -> FittedProtocol:
    if cfg.impl == "mesh":
        from . import mesh

        return mesh.fit_poe(parts, cfg, params, device)
    # zero rate: nothing crosses the wire, so only a plan's data faults apply
    # (its flip_rate has no packed plane to corrupt and is a no-op)
    parts, _ = _apply_fit_faults(parts, cfg)
    kernel, backend = cfg.kernel, cfg.gram_backend
    X0 = torch.as_tensor(parts[0][0], dtype=torch.float32, device=device)
    y0 = torch.as_tensor(parts[0][1], dtype=torch.float32, device=device)
    p = train_gp(X0, y0, kernel=kernel, params=params_on(params, device), steps=cfg.steps,
                 lr=cfg.lr).params
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


def _update_poe(art: FittedProtocol, X_new, y_new, j: int, pre=None):
    """Machine ``j``'s own exact rows (zero rate, ``pre`` is None): written
    into every expert's buffers at the shared cursor, valid (mask 1) on
    expert j only, and every expert's factor bordered by
    ``chol_append_at`` in one batched call, into copies."""
    p = art.params
    s2 = torch.exp(p.log_noise) + DEFAULT_JITTER
    m = len(art.fit_lengths)
    n_new = X_new.shape[0]
    pos, end = int(art.stream.cols), int(art.stream.cols) + n_new
    k = gram_fn(art.kernel)
    valid = (torch.arange(m, device=X_new.device)[:, None] == j).float().expand(m, n_new)
    mask = art.data["mask"]
    data = dict(art.data)
    for key, rows in (("Xs", X_new), ("mask", valid), ("sq_exact", torch.sum(X_new**2, -1))):
        data[key] = data[key].clone()
        data[key][:, pos:end] = rows
    y2 = art.y.clone()
    y2[:, pos:end] = valid * y_new
    # the OLD mask is zero at the cursor and beyond, so G_on keeps
    # chol_append_at's zero-rows-at-padded-slots contract
    G_on = k(p, data["Xs"], X_new) * (mask[:, :, None] * valid[:, None, :])
    G_nn = _mask_gram(k(p, X_new), valid) + s2 * torch.eye(
        n_new, dtype=X_new.dtype, device=X_new.device)
    L2 = chol_append_at(art.factors["L"], G_on, G_nn, pos)
    factors = {"L": L2, "alpha": torch.cholesky_solve(y2[..., None], L2)[..., 0]}
    return dataclasses.replace(art, y=y2, factors=factors, data=data,
                               stream=_grow_stream(art.stream, j, n_new))


register_protocol(ProtocolSpec(name="poe", fit=_fit_poe, predict=_predict_poe,
                               update=_update_poe, fit_host=fit_poe_host))


# --------------------------------------------------------------------------
# the program contract (repro_torch.analysis.check_contracts enforces it)
# --------------------------------------------------------------------------
from ...analysis.contracts import (  # noqa: E402
    CollectiveBudget,
    Contract,
    LedgerAccounting,
    NoHostCallbacks,
    NoShardingLeak,
    forbid_primitives,
    register_contract,
)

# the zero-rate baseline: the experts are a leading batch axis; the wire
# ledger is 0 and the serve must be as silent as the wire.
register_contract("poe", "predict", Contract(
    name="poe-serve",
    rules=(
        forbid_primitives(),
        NoHostCallbacks(),
        CollectiveBudget(max_count=0),
        NoShardingLeak(max_devices=1),
        LedgerAccounting(),
    ),
))
register_contract("poe", "update", Contract(
    name="poe-update",
    rules=(NoShardingLeak(max_devices=1), LedgerAccounting()),
))
