"""Weights and decode states carried between the reference and the port.

The reference's trees are nested dicts of arrays: its ``init_model`` as
``jax.tree.map(np.asarray, ...)`` gives it, its decode state likewise.  The
port keeps the reference's tree, leaf names and stacked leading layer
axes, so the carry is a plain conversion, leaf by leaf, and a numpy tree
(an ``.npz`` of it) is one layout for both packages.  Numpy has no
bfloat16: a leaf in the reference's ``bfloat16`` (ml_dtypes) comes in
through float32, which holds it exactly, and :func:`state_to_numpy` gives
bf16 leaves as float32; :func:`state_from_numpy` casts each state leaf to
its dtype by name.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.protocols.base import resolve_device
from . import backbone

__all__ = ["params_from_numpy", "state_from_numpy", "state_to_numpy"]

# the decode state's leaves not in fp32, by name (models/decode.py)
_STATE_COMPUTE = {"k", "v", "cross_k", "cross_v", "conv_state"}
_STATE_INT = {"kpos", "cross_kpos"}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact in float32
        a, dtype = a.astype(np.float32), dtype or torch.bfloat16
    if not a.flags.writeable:  # a read-only view (jax's np.asarray): torch wants its own
        a = a.copy()
    # always a copy: the tree is the caller's to update in place (training)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)
    return t if dtype is None else t.to(dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A snapshot: the state is updated in place, so never a view of it."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy(), copy=True)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(k, v) for k, v in tree.items()}


def params_from_numpy(tree, device=None):
    """The reference's param tree (nested dicts of numpy arrays) as the
    port's, on ``device`` (the card unless the caller names another), leaf
    dtypes kept; each leaf a copy, never a view of the caller's array."""
    device = resolve_device(device)
    return _map(lambda _, a: _tensor(a, device), tree)


def state_from_numpy(tree, device=None, dtype=None):
    """A decode state given as nested dicts of numpy arrays (the
    reference's, or :func:`state_to_numpy`'s) as the port's on ``device``
    (the card unless the caller names another), each leaf in its dtype by
    name (K/V and the conv state in ``dtype``, ``COMPUTE_DTYPE`` by
    default); an encoder-decoder state gets the port's all-zero
    ``cross_kpos`` row when it has none."""
    device = resolve_device(device)
    compute = backbone.COMPUTE_DTYPE if dtype is None else dtype

    def leaf_dtype(name):
        if name in _STATE_INT:
            return torch.int32
        return compute if name in _STATE_COMPUTE else torch.float32

    state = _map(lambda name, a: _tensor(a, device, leaf_dtype(name)), tree)
    if "dec_layers" in state and "cross_kpos" not in state:
        _, B, S_enc = state["dec_layers"]["cross_k"].shape[:3]
        state["cross_kpos"] = torch.zeros((B, S_enc), dtype=torch.int32, device=device)
    return state


def state_to_numpy(state):
    """The port's decode state as the reference's tree of numpy arrays (bf16
    leaves as float32; the port's own ``cross_kpos`` left out)."""
    return _map(lambda _, t: _numpy(t), {k: v for k, v in state.items() if k != "cross_kpos"})
