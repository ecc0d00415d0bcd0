"""DEPRECATED module-level entry points — counterpart of
``repro/core/distributed_gp.py``.  The code lives in
:mod:`repro_torch.core.protocols`, fronted by the estimator::

    from repro_torch.core import DGPConfig, DistributedGP

    est = DistributedGP(DGPConfig(protocol="center", bits_per_sample=24))
    art = est.fit(X, y, m=40)
    mu, var = est.predict(art, X_query)

Everything importable here keeps working: the classes and helpers are
re-exports, and the seven legacy entry points (``quantize_to_center``,
``single_center_gp``, ``broadcast_gp``, ``poe_baseline``, ``fit``,
``predict``, ``update``) are thin wrappers that emit one
``DeprecationWarning`` per process per function and delegate, with the
numerics, signatures and return types of the calls they wrap.

The legacy ``fit`` takes the reference's loose keyword arguments and maps
them onto one validated :class:`~repro_torch.core.config.DGPConfig`, plus
the port's ``device=`` (the card when None).  The mesh names are the
port's: ``broadcast_gp_mesh`` and ``MESH_AXIS`` from
:mod:`repro_torch.core.protocols.mesh`, and ``machine_mesh``, which is
``machine_group`` (the process group of one rank per machine stands where
the reference's device mesh stood).
"""
from __future__ import annotations

import functools
import warnings

from . import quantizers as _Q
from .protocols import base as _base
from .protocols import broadcast as _broadcast
from .protocols import center as _center
from .protocols import poe as _poe

# -- re-exports: every non-entry-point name the port has keeps its path -----
from .protocols.base import (  # noqa: F401
    FittedProtocol,
    PaddedShards,
    StreamState,
    WireState,
    _mask_gram,
    load_artifact,
    pad_parts,
    predict_op_counts,
    save_artifact,
    split_machines,
    update_growth_count,
)
from .protocols.broadcast import (  # noqa: F401
    HostBroadcastGP,
    _decoded_inner_products,
    _star_decoded_products,
    _star_exact_products,
    _train_inner_products,
)
from .protocols.center import CenterGP, _pallas_ip_rows  # noqa: F401
from .protocols.mesh import (  # noqa: F401
    MESH_AXIS,
    _run_wire_protocol_mesh,
    broadcast_gp_mesh,
)
from .protocols.mesh import machine_group as machine_mesh  # noqa: F401
from .protocols.poe import HostPoEGP  # noqa: F401
from .protocols.wire import _run_wire_protocol  # noqa: F401

__all__ = [
    "split_machines",
    "pad_parts",
    "PaddedShards",
    "WireState",
    "FittedProtocol",
    "fit",
    "predict",
    "update",
    "save_artifact",
    "load_artifact",
    "update_growth_count",
    "predict_op_counts",
    "quantize_to_center",
    "single_center_gp",
    "broadcast_gp",
    "poe_baseline",
    "broadcast_gp_mesh",
    "machine_mesh",
    "MESH_AXIS",
]


# warn once per process per entry point, without touching the global
# warning filters
_WARNED: set[str] = set()


def _deprecated(replacement: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if fn.__name__ not in _WARNED:
                _WARNED.add(fn.__name__)
                warnings.warn(
                    f"repro_torch.core.distributed_gp.{fn.__name__} is deprecated: "
                    f"use {replacement}",
                    DeprecationWarning,
                    stacklevel=2,
                )
            return fn(*args, **kwargs)

        return wrapper

    return deco


def _legacy_config(bits_per_sample, protocol, kernel, steps, lr, gram_mode, fuse, method,
                   gram_backend, max_bits, train_impl, impl, scheme):
    """The loose legacy kwargs as one validated DGPConfig (``method`` wins
    over ``fuse`` for the PoE protocol, as in the old signatures).  The
    port trains with one Adam loop, which computes what both of the
    reference's ``train_impl`` values ("scan", "loop") compute; any other
    value is refused by name, as is an ``impl`` other than "batched" or
    "mesh" ("mesh" runs on every rank of a process group of one rank per
    machine, ``base.fit``)."""
    from .config import TRAIN_IMPLS, DGPConfig

    if impl not in ("batched", "mesh"):
        raise ValueError(f'fit() impl must be "batched" or "mesh", got {impl!r}')
    if train_impl not in TRAIN_IMPLS:
        raise ValueError(
            f"fit() train_impl {train_impl!r} is not one the port can honour "
            f"(known: {', '.join(TRAIN_IMPLS)})"
        )
    return DGPConfig(
        protocol=protocol,
        scheme=scheme,
        kernel=kernel,
        fusion=method if protocol == "poe" else fuse,
        impl=impl,
        gram_backend=gram_backend,
        gram_mode=gram_mode,
        bits_per_sample=int(bits_per_sample),
        max_bits=int(_Q.DEFAULT_MAX_BITS if max_bits is None else max_bits),
        steps=int(steps),
        lr=float(lr),
        train_impl=train_impl,
    )


@_deprecated('DistributedGP(DGPConfig(protocol="center", ...)).fit(...)')
@functools.wraps(_center.quantize_to_center)
def quantize_to_center(*args, **kwargs):
    return _center.quantize_to_center(*args, **kwargs)


@_deprecated('DistributedGP(DGPConfig(protocol="center", ...))')
@functools.wraps(_center.single_center_gp)
def single_center_gp(*args, **kwargs):
    return _center.single_center_gp(*args, **kwargs)


@_deprecated('DistributedGP(DGPConfig(protocol="broadcast", ...))')
@functools.wraps(_broadcast.broadcast_gp)
def broadcast_gp(*args, **kwargs):
    return _broadcast.broadcast_gp(*args, **kwargs)


@_deprecated('DistributedGP(DGPConfig(protocol="poe", ...))')
@functools.wraps(_poe.poe_baseline)
def poe_baseline(*args, **kwargs):
    return _poe.poe_baseline(*args, **kwargs)


@_deprecated("DistributedGP(DGPConfig(...)).fit(...)")
def fit(parts, bits_per_sample: int = 0, protocol: str = "center", *,
        kernel: str = "se", steps: int = 150, lr: float = 0.05, params=None,
        gram_mode: str = "nystrom", fuse: str = "kl", method: str = "rbcm",
        gram_backend: str = "xla", max_bits: int | None = None,
        train_impl: str = "scan", impl: str = "batched",
        scheme: str = "per_symbol", device=None) -> FittedProtocol:
    """The reference's kwargs-form ``fit`` (``repro/core/protocols/base.py``):
    run a protocol ONCE on ``device`` (the card when None) and return the
    serving artifact."""
    cfg = _legacy_config(bits_per_sample, protocol, kernel, steps, lr, gram_mode, fuse,
                         method, gram_backend, max_bits, train_impl, impl, scheme)
    return _base.fit(parts, cfg, params, device)


@_deprecated("DistributedGP(...).predict(art, X_star) or art.predict(X_star)")
@functools.wraps(_base.predict)
def predict(*args, **kwargs):
    return _base.predict(*args, **kwargs)


@_deprecated("DistributedGP(...).update(art, ...) or art.update(...)")
@functools.wraps(_base.update)
def update(*args, **kwargs):
    return _base.update(*args, **kwargs)
