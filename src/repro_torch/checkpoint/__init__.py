"""Artifact checkpoints of the port (counterpart of ``repro.checkpoint``)."""
from .ckpt import (  # noqa: F401
    CorruptCheckpointError, array_checksum, latest_step, load_artifact_arrays,
    load_artifact_meta, save_artifact,
)
