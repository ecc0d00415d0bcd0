"""Name registries of the port — counterpart of ``repro/core/registry.py``.

Kernels, wire schemes, fusions and protocols are looked up by name, as in
the reference, so ``DGPConfig`` validation and the ``fit``/``predict``
dispatch share one table each.  ``FUSIONS`` holds :class:`FusionSpec`
entries, registered by ``core/fusion.py`` (``kl``) and ``core/poe.py`` (the
PoE family); ``SCHEMES`` the wire schemes of ``protocols/wire.py``
(``per_symbol`` and ``vq``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = [
    "Registry", "KernelSpec", "FusionSpec", "SchemeSpec", "ProtocolSpec",
    "KERNELS", "SCHEMES", "FUSIONS", "PROTOCOLS",
    "register_kernel", "register_fusion", "register_scheme",
    "register_protocol",
]


class Registry:
    """A named table of components.  ``register`` rejects duplicates;
    ``get`` raises ``ValueError`` listing the known names."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Any] = {}

    def register(self, name: str, entry: Any) -> Any:
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} name must be a non-empty string")
        if name in self._entries:
            raise ValueError(
                f"duplicate {self.kind} {name!r}: already registered "
                f"(known {self.kind}s: {', '.join(self.names())})"
            )
        self._entries[name] = entry
        return entry

    def get(self, name: str) -> Any:
        if name in self._entries:
            return self._entries[name]
        raise ValueError(
            f"unknown {self.kind} {name!r}: known {self.kind}s are "
            f"{', '.join(self.names())}"
        )

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._entries))

    def __contains__(self, name: str) -> bool:
        return name in self._entries


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A GP kernel: dense gram builder plus the inner-product/diagonal forms
    the quantized-wire paths consume (see ``gp.kernel_from_inner``)."""

    name: str
    gram: Callable  # (params, X, X2=None, *, backend="xla") -> (n, n2)
    from_inner: Callable  # (params, ip, sq_x, sq_x2) -> gram block
    prior_diag: Callable  # (params, sq_x) -> k(x, x) vector


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """How per-machine predictive Gaussians meet: ``fuse`` on stacked
    ``(m, t)`` predictives, taking optional availability weights ``w``
    (m,) for degraded serving.  ``moments`` maps one machine's predictive to
    its (3, t) moment rows and ``finalize`` maps the sum of those rows over
    machines, with the fleet size ``m``, back to the fused ``(mu, s2)`` —
    the decomposition the fused serve epilogue computes in one kernel, and
    the mesh serve in one all-reduce.  ``fuse_psum`` is the fusion as a
    collective epilogue over the machine processes, each holding its own
    predictive (``None`` if the fusion has no mesh form); the mesh serve
    uses it only when ``moments``/``finalize`` are missing, which no
    built-in fusion (kl, poe, gpoe, bcm, rbcm) is: their psum forms are the
    reference's API, for a fusion registered without moment rows."""

    name: str
    fuse: Callable  # (mus, s2s, prior_var, w=None) -> (mu, s2)
    fuse_psum: Callable | None = None  # (mu_i, s2_i, prior_var, group, w_i=None) -> (mu, s2)
    moments: Callable | None = None  # (mu_i, s2_i, prior_var, w_i=None) -> (3, t)
    finalize: Callable | None = None  # (S, m, prior_var) -> (mu, s2)


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """A wire scheme: ``run(shards, bits, max_bits, mode, center,
    faults=None)`` executes the fit-time wire protocol for every machine at
    once and returns a :class:`~repro_torch.core.protocols.base.WireRun`
    (a fault plan's bit flips demote the rows whose CRC fails);
    ``reencode(art, machine, X_new)`` sends new symbols under that
    machine's frozen fit-time state for streaming ``update`` and returns a
    :class:`~repro_torch.core.protocols.wire.Reencoded`;
    ``update_corrupt(art, machine, X_new, plan)``, where the scheme has a
    packed plane to corrupt, sends them through a flipping channel and
    returns ``(keep_idx, decoded, wire_add, payload_add, integrity_add,
    demoted)``: the surviving rows, their received decodes, the ledger
    increments of the WHOLE batch, and the demotion count.  (The reference
    keeps a second, jit-traced ``reencode_traced``; the port traces
    nothing, so one function serves every machine.)"""

    name: str
    run: Callable
    reencode: Callable | None = None  # (art, machine, X_new) -> Reencoded
    update_corrupt: Callable | None = None  # (art, machine, X_new, plan) -> 6-tuple


@dataclasses.dataclass(frozen=True)
class ProtocolSpec:
    """A distributed-GP protocol: the fit/predict/update triple the facade
    dispatches on, and ``fit_host``, the serial oracle ``impl="host"``
    runs (a model with the same ``.predict`` surface, no artifact)."""

    name: str
    fit: Callable  # (parts, cfg, params, device) -> FittedProtocol
    predict: Callable  # (art, X_star, sq_star, g_ss, noise, avail) -> (mu, s2)
    update: Callable  # (art, X_new, y_new, machine, pre) -> FittedProtocol
    fit_host: Callable | None = None  # (parts, cfg, params, device) -> oracle model


KERNELS = Registry("kernel")
SCHEMES = Registry("scheme")
FUSIONS = Registry("fusion")
PROTOCOLS = Registry("protocol")


def register_kernel(spec: KernelSpec) -> KernelSpec:
    return KERNELS.register(spec.name, spec)


def register_fusion(spec: FusionSpec) -> FusionSpec:
    return FUSIONS.register(spec.name, spec)


def register_scheme(spec: SchemeSpec) -> SchemeSpec:
    return SCHEMES.register(spec.name, spec)


def register_protocol(spec: ProtocolSpec) -> ProtocolSpec:
    return PROTOCOLS.register(spec.name, spec)
