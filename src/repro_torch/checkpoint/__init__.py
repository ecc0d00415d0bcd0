"""Checkpoints of the port (counterpart of ``repro.checkpoint``): LLM
parameter trees and GP artifacts."""
from .ckpt import (  # noqa: F401
    CorruptCheckpointError, array_checksum, latest_step, load_artifact_arrays,
    load_artifact_meta, restore_checkpoint, save_artifact, save_checkpoint,
)
