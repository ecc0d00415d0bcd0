"""``DistributedGP`` — the port's front door, counterpart of
``repro/core/api.py``::

    from repro_torch.core import DGPConfig, DistributedGP
    from repro_torch.faults import corrupt_words, drop_machine

    est = DistributedGP(DGPConfig(gram_backend="pallas"))  # on the card
    art = est.fit(X, y, m=40)          # wire + train + factorize ONCE
    mu, var = est.predict(art, X_query)
    # §5.2 broadcast (KL fusion) and the zero-rate rBCM baseline
    bc = DistributedGP(DGPConfig(protocol="broadcast", fusion="kl", gram_backend="pallas"))
    rbcm = DistributedGP(DGPConfig(protocol="poe", fusion="rbcm", gram_backend="pallas"))
    mu, var = bc.predict(bc.fit(X, y, m=40), X_query, available=alive)  # (m,) mask
    art2 = est.update(art, X_new, y_new, machine=3)  # stream in; art unchanged
    # a degraded fleet: machine 3 dropped, 1e-3 bit flips on the wire
    faulty = DistributedGP(DGPConfig(faults=drop_machine(3) | corrupt_words(1e-3, seed=7)))
    est.health(faulty.fit(X, y, m=40))  # status, machines lost, rows demoted
    est.save(art, "ckpt/")             # est.load("ckpt/") serves identically

The estimator runs on ``device`` — the CUDA card unless the caller passes
another (``device="cpu"`` runs the plain PyTorch versions of the kernels);
without CUDA, the default raises.  Artifacts live on the estimator's device.
With ``DGPConfig(impl="mesh")`` every machine is one process of a
``torch.distributed`` group and every rank calls the same methods with the
same arguments (``repro_torch.launch.ranks`` starts such processes); rank i
reads only ``parts[i]``, and results come back on every rank.
"""
from __future__ import annotations

import dataclasses

import torch

from .config import DGPConfig
from .gp import GPParams
from .protocols import base as _base
from .protocols.base import FittedProtocol

__all__ = ["DistributedGP"]


class DistributedGP:
    """Estimator facade over one :class:`~repro_torch.core.config.DGPConfig`
    on one device.  Stateless beyond the two: ``fit`` returns the artifact
    and every other method takes it explicitly."""

    def __init__(self, config: DGPConfig | None = None, device=None, **overrides):
        if config is None:
            config = DGPConfig(**overrides)
        elif not isinstance(config, DGPConfig):
            raise TypeError(
                f"DistributedGP expects a DGPConfig, got {type(config).__name__}"
            )
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = _base.resolve_device(device)

    def __repr__(self):
        return f"DistributedGP({self.config!r}, device={str(self.device)!r})"

    def fit(self, X=None, y=None, m: int | None = None, *, parts=None,
            generator: torch.Generator | None = None,
            params: GPParams | None = None) -> FittedProtocol:
        """Run the configured protocol ONCE and return the serving artifact.

        Pass the pooled dataset ``(X, y, m)`` — split uniformly at random
        across ``m`` machines by ``generator`` (seed 0 when None) — or
        ``parts``, a list of per-machine ``(X_j, y_j)`` shards.
        ``impl="host"`` returns the serial oracle model instead (same
        ``predict`` surface, no artifact, no streaming)."""
        if parts is None:
            if X is None or y is None or m is None:
                raise ValueError("fit() needs either (X, y, m) or parts=[(X_j, y_j), ...]")
            parts = _base.split_machines(X, y, m, generator)
        elif X is not None or y is not None or m is not None or generator is not None:
            raise ValueError(
                "pass either (X, y, m[, generator]) or parts, not both — parts "
                "are already placed, so a split generator would be unused"
            )
        return _base.fit(parts, self.config, params, self.device)

    def predict(self, art: FittedProtocol, X_star, available=None):
        """Serve one query batch: (mean, var) at ``X_star`` from the cached
        factors, on the artifact's device.  ``available``: optional (m,)
        machine-availability mask; the broadcast and poe fusions
        renormalize over the surviving machines.  An ``impl="host"``
        oracle model answers through its own ``predict``."""
        if isinstance(art, FittedProtocol):
            return _base.predict(art, X_star, available)
        return art.predict(X_star, available)

    def update(self, art: FittedProtocol, X_new, y_new, machine: int = 0) -> FittedProtocol:
        """Stream new points arriving at ``machine`` into a fitted artifact
        (frozen codebooks, rank-k factor growth) and return the new
        artifact; ``art`` is unchanged — see
        :func:`~repro_torch.core.protocols.base.update`."""
        if not isinstance(art, FittedProtocol):
            raise TypeError(
                "update() needs a FittedProtocol artifact (impl='host' oracle "
                "models do not support streaming)"
            )
        return _base.update(art, X_new, y_new, machine)

    def health(self, art: FittedProtocol, available=None):
        """Degradation report of a fitted artifact (machines lost, rows
        demoted, variance inflation) under ``available`` — see
        :func:`~repro_torch.core.protocols.base.serve_health`."""
        if not isinstance(art, FittedProtocol):
            raise TypeError(
                "health() needs a FittedProtocol artifact (impl='host' oracle "
                "models carry no shard table to report on)"
            )
        return _base.serve_health(art, available)

    def save(self, art: FittedProtocol, directory: str, step: int = 0) -> str:
        """Checkpoint an artifact in the reference's format v6."""
        if not isinstance(art, FittedProtocol):
            raise TypeError("save() needs a FittedProtocol artifact")
        return _base.save_artifact(art, directory, step)

    def load(self, directory: str, step: int | None = None) -> FittedProtocol:
        """Restore a checkpoint of either package onto this estimator's
        device."""
        return _base.load_artifact(directory, step, self.device)
