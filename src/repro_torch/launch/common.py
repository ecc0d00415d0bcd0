"""What the port's figure scripts share — counterpart of
``benchmarks/common.py``: timing, row emission, the SMSE and the seeded
split over machines.

Every script prints rows ``name,us_per_call,derived``, where ``derived`` is
the figure's own metric (distortion, SMSE, ...) as key=value pairs joined by
``|``, and returns them as dicts.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["sync", "timed", "emit", "smse", "machine_parts"]


def sync():
    """Wait for the card's queued work, if CUDA is in use (its work is
    asynchronous: a host clock must wait for it)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, repeats: int = 3, **kw):
    """``(fn(*args, **kw), microseconds per call)``: one warm-up call, then
    the mean of ``repeats`` calls on the host clock, the card synchronized
    before each reading."""
    fn(*args, **kw)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
    sync()
    return out, (time.perf_counter() - t0) / repeats * 1e6


def emit(name: str, us_per_call: float, **derived) -> dict:
    """Print one row and return it as ``{"name", "us_per_call", "derived"}``."""
    kv = "|".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in derived.items())
    print(f"{name},{us_per_call:.1f},{kv}", flush=True)
    return {"name": name, "us_per_call": float(us_per_call), "derived": derived}


def smse(y_true, y_pred) -> float:
    """Standardized mean squared error: mean((y - y_pred)^2) / var(y)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean((y_true - y_pred) ** 2) / np.var(y_true))


def machine_parts(X, y, m: int, seed: int = 0):
    """A uniform random split over ``m`` machines from a seeded numpy
    permutation: ``[(X_j, y_j), ...]`` (the reference's ``split_machines``
    draws from the JAX PRNG; both packages can be given these parts)."""
    perm = np.random.default_rng(seed).permutation(X.shape[0])
    return [(X[c], y[c]) for c in np.array_split(perm, m)]
