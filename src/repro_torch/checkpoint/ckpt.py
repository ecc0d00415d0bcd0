"""Checkpoints — counterpart of ``repro/checkpoint/ckpt.py``.

A tree checkpoint (:func:`save_checkpoint` / :func:`restore_checkpoint`,
the LLM trainer's) is one npz, ``ckpt_<step>.npz``, keyed by each leaf's
tree path joined by ``/`` (dict keys, NamedTuple field names, sequence
indices), as the reference keys it: either package restores the other's
file bit for bit.  An artifact is an npz of its arrays (``ckpt_<step>.npz``) beside a json of
its static metadata (``meta_<step>.json``) holding a CRC32 of every array's
bytes, written atomically.  The layout, the key names and the checksum are
the reference's, so checkpoints load across the two packages in both
directions.
"""
from __future__ import annotations

import json
import os
import re
import zlib

import numpy as np

import torch

__all__ = ["CorruptCheckpointError", "array_checksum", "latest_step", "save_checkpoint",
           "restore_checkpoint", "save_artifact", "load_artifact_meta", "load_artifact_arrays"]


class CorruptCheckpointError(ValueError):
    """An artifact array failed its recorded CRC32 on load (the message
    names it)."""


def array_checksum(arr) -> int:
    """CRC32 of an array's raw (C-contiguous) bytes."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def latest_step(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(directory)
        if (m := re.match(r"ckpt_(\d+)\.npz$", f))
    ]
    return max(steps) if steps else None


def _children(tree):
    """(key, child) pairs of a tree node, or None for a leaf."""
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for k, v in kids:
        yield from _flatten(v, prefix + (str(k),))


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        # numpy has no bfloat16: such a leaf is saved as float32, which holds it exactly
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree) -> str:
    """``tree`` (nested dicts / NamedTuples / sequences of tensors or
    arrays) as ``<directory>/ckpt_<step>.npz``, written to a temporary file
    then renamed into place; returns the path."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: _numpy(v) for k, v in _flatten(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"  # np.savez keeps the name when it ends in .npz
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, step: int, like_tree):
    """The checkpoint of ``step`` in the structure of ``like_tree`` (its
    values give only where each leaf goes): a tensor leaf comes back as a
    tensor on that leaf's device (in its dtype where it is bfloat16, saved
    as float32), any other leaf as the saved numpy array."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:

        def build(tree, prefix):
            kids = _children(tree)
            if kids is None:
                arr = data["/".join(prefix)]
                if not isinstance(tree, torch.Tensor):
                    return arr
                out = torch.from_numpy(arr).to(tree.device)
                return out.to(tree.dtype) if tree.dtype == torch.bfloat16 else out
            vals = {k: build(v, prefix + (str(k),)) for k, v in kids}
            if isinstance(tree, dict):
                return {k: vals[k] for k in tree}
            if hasattr(tree, "_fields"):
                return type(tree)(**vals)
            return type(tree)(vals[i] for i in range(len(tree)))

        return build(like_tree, ())


def save_artifact(directory: str, step: int, arrays: dict, meta: dict) -> str:
    """Write ``arrays`` ({key: numpy array}) and ``meta`` (json-ready, plus
    ``array_checksums``) atomically; returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"  # np.savez keeps the name when it ends in .npz
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    meta = dict(meta)
    meta["array_checksums"] = {k: array_checksum(v) for k, v in arrays.items()}
    meta_path = os.path.join(directory, f"meta_{step:08d}.json")
    tmpm = meta_path + ".tmp"
    with open(tmpm, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmpm, meta_path)
    return path


def _resolve_step(directory: str, step: int | None) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return step


def load_artifact_meta(directory: str, step: int | None = None) -> dict:
    """The sidecar metadata of an artifact checkpoint (the latest when
    ``step`` is None) WITHOUT touching the npz — a cheap screen (protocol,
    config, format version) before paying an array load."""
    step = _resolve_step(directory, step)
    with open(os.path.join(directory, f"meta_{step:08d}.json")) as f:
        return json.load(f)


def load_artifact_arrays(directory: str, step: int | None = None):
    """(meta, {key: np.ndarray}) of an artifact checkpoint (the latest when
    ``step`` is None).  Every array recorded in ``array_checksums`` is
    verified; a mismatch or a missing array raises
    :class:`CorruptCheckpointError`."""
    step = _resolve_step(directory, step)
    meta = load_artifact_meta(directory, step)
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    for k, want in (meta.get("array_checksums") or {}).items():
        if k not in arrays:
            raise CorruptCheckpointError(
                f"artifact checkpoint step {step} is missing array {k!r} "
                f"recorded in meta_{step:08d}.json"
            )
        got = array_checksum(arrays[k])
        if got != int(want):
            raise CorruptCheckpointError(
                f"artifact array {k!r} failed its checksum at step {step}: "
                f"crc32 {got:#010x} != recorded {int(want):#010x}"
            )
    return meta, arrays
