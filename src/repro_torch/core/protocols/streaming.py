"""Capacity-padded ("bucketed") factor buffers — counterpart of
``repro/core/protocols/streaming.py``.

Every column-growable tensor of a :class:`~.base.FittedProtocol` (targets,
factor columns, reconstruction rows, validity masks) can live at a padded
CAPACITY — a power of two of the occupied columns, which
``StreamState.cols`` tracks — so that artifacts with different histories
share one shape.  Streaming ``update`` writes each batch at the
occupied-column cursor of these buffers and grows them (:func:`
ensure_capacity`) only when a batch crosses the bucket's edge, so a stream
of n rows changes the buffers' shapes O(log n) times.  A fresh fit is
exact-size, so its first update grows.  The fleet
(:func:`repro_torch.core.fleet.pad_to_capacity`) co-buckets artifacts the
same way.

Padding is EXACT, not approximate:

* targets / ``alpha`` / Nyström ``W`` columns pad with zeros (zero columns
  contribute nothing to means or variances);
* dense Cholesky factors pad with the identity pattern (unit diagonal, zeros
  elsewhere), so solves against zero right-hand sides return exact zeros at
  the padded slots;
* kernel cross-columns against padded basis rows are zeroed through the
  artifact's validity masks (``data["valid"]`` for the center layout,
  ``data["mask"]`` for the expert layouts) — SE kernels do NOT vanish at the
  zero point, so masking is load-bearing.

The pads run on the tensors' own device (the reference pads on the host).
A mesh artifact pads the same way on every rank: its factor and data
buffers hold one machine each (a leading axis of 1), so each rank grows its
own machine's.
"""
from __future__ import annotations

import collections
import dataclasses

import torch
import torch.nn.functional as F

__all__ = ["next_pow2", "ensure_capacity", "update_growth_count"]

# capacity growths made by update(), per protocol (see update_growth_count)
_GROWTHS: collections.Counter = collections.Counter()


def update_growth_count(protocol: str = "center") -> int:
    """How many times streaming ``update`` has grown an artifact's buffers
    to a new capacity bucket, for a protocol — the port's counterpart of
    the reference's ``update_trace_count``.  The reference compiles its
    update into one jitted program whose shapes change only when a bucket
    is crossed, so "no retrace in a bucket" is its contract.  The port
    compiles nothing and captures no CUDA graph on this path; what a
    retrace stood for is a change of buffer shape, and that happens only
    here.  So consecutive in-bucket updates leave this count flat and a
    bucket crossing adds exactly one."""
    return _GROWTHS[protocol]


def next_pow2(n: int) -> int:
    """The smallest power of two >= n (the capacity bucket for n columns)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pad_last(a: torch.Tensor, cap: int) -> torch.Tensor:
    return F.pad(a, (0, cap - a.shape[-1]))


def _pad_rows(a: torch.Tensor, cap: int) -> torch.Tensor:
    """Grow axis -2 (row axis of (..., n, d) point buffers) to ``cap``."""
    return F.pad(a, (0, 0, 0, cap - a.shape[-2]))


def _pad_chol(L: torch.Tensor, cap: int) -> torch.Tensor:
    """Grow (..., n, n) Cholesky factors to (..., cap, cap) with the identity
    pattern in the new slots (unit pivots keep the factor SPD and make
    padded solve outputs exact 0)."""
    n = L.shape[-1]
    out = L.new_zeros(L.shape[:-2] + (cap, cap))
    out[..., :n, :n] = L
    idx = torch.arange(n, cap, device=L.device)
    out[..., idx, idx] = 1.0
    return out


# which leaves grow, and how, per protocol.  Everything NOT listed keeps its
# fit-time shape: the Nyström core factors L_KK/L_M are rank-K and never
# grow; broadcast data (the fixed shard bases) never grows.
_GROWTH = {
    "center": {
        "factors": {"W": _pad_last, "alpha": _pad_last, "L": _pad_chol},
        "data": {"X_recon": _pad_rows, "sq_cols": _pad_last,
                 "sq_exact": _pad_last, "valid": _pad_last},
    },
    "broadcast": {
        "factors": {"W": _pad_last, "alpha": _pad_last},
        "data": {},
    },
    "poe": {
        "factors": {"L": _pad_chol, "alpha": _pad_last},
        "data": {"Xs": _pad_rows, "mask": _pad_last, "sq_exact": _pad_last},
    },
}


def ensure_capacity(art, n_new: int):
    """Return ``art`` (unchanged) if ``n_new`` more columns fit the current
    bucket, else a grown copy at the next power-of-two capacity (counted by
    :func:`update_growth_count`)."""
    cols = int(art.stream.cols)
    capacity = int(art.y.shape[-1])
    need = cols + int(n_new)
    if need <= capacity:
        return art
    grown = _grow(art, next_pow2(need))
    _GROWTHS[art.protocol] += 1
    return grown


def _grow(art, cap: int):
    spec = _GROWTH.get(art.protocol)
    if spec is None:
        raise NotImplementedError(
            f"streaming capacity growth is not defined for protocol "
            f"{art.protocol!r}"
        )
    factors = dict(art.factors)
    for key, pad in spec["factors"].items():
        if key in factors:
            factors[key] = pad(factors[key], cap)
    data = dict(art.data)
    for key, pad in spec["data"].items():
        if key in data:
            data[key] = pad(data[key], cap)
    return dataclasses.replace(art, y=_pad_last(art.y, cap), factors=factors, data=data)
