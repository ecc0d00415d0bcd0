"""The §5 protocols of the port (counterpart of ``repro.core.protocols``).

Importing the package registers the wire schemes (``per_symbol``, ``vq``),
the protocols (``center``, ``broadcast``, ``poe``) and the mesh contracts
(:mod:`.mesh`); ``repro_torch.core``
registers the fusion rules before it.
"""
from . import base, wire, center, broadcast, poe, mesh  # noqa: F401 (registration)

from .base import (  # noqa: F401
    FittedProtocol, PaddedShards, ServeHealth, StreamState, WireRun, WireState,
    artifact_arrays, artifact_from_arrays, fit, load_artifact, pad_parts,
    predict, resolve_device, save_artifact, serve_health, split_machines,
)
