"""The §5 protocols of the port (counterpart of ``repro.core.protocols``).

Importing the package registers the ported scheme (``per_symbol``) and
protocols (``center``, ``broadcast``, ``poe``); ``repro_torch.core``
registers the fusion rules before it.
"""
from . import base, wire, center, broadcast, poe  # noqa: F401 (registration)

from .base import (  # noqa: F401
    FittedProtocol, PaddedShards, StreamState, WireRun, WireState,
    artifact_arrays, artifact_from_arrays, fit, load_artifact, pad_parts,
    predict, resolve_device, save_artifact, split_machines,
)
