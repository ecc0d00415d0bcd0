"""Deterministic synthetic data — counterpart of ``repro/data/synthetic.py``:

* ``lm_batch_stream`` — token batches for the LLM training driver (Zipf-ish
  marginal + Markov bigram structure so the loss has signal), the
  reference's numpy draws, so the token ids equal its bit for bit.
* ``regression_dataset`` — GP-regression datasets statistically matched to
  the paper's benchmarks (same n / d / noise regime); a real file
  ``<data_dir>/<name>.npz`` is read instead when the caller names a
  ``data_dir`` that holds one.
* ``mnist_like_two_digits`` — two-cluster 784-d image-like data for the
  Fig. 3c/d PCA comparison, bitwise the reference's.

One deliberate difference: the reference salts its generator with
``hash(name)``, which Python randomizes per process, so its data change
between runs.  Here each name has a fixed integer salt, so a seed gives the
same data in every process.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.protocols.base import resolve_device

__all__ = ["DATASET_SPECS", "lm_batch_stream", "regression_dataset", "mnist_like_two_digits"]

DATASET_SPECS = {
    # name: (n_train, n_test, d) as in the paper §6
    "sarcos": (1000, 4449, 21),
    "kin40k": (1000, 30000, 8),
    "abalone": (1000, 1044, 8),
}
_SALT = {"sarcos": 1, "kin40k": 2, "abalone": 3}


def lm_batch_stream(vocab_size: int, batch: int, seq: int, seed: int = 0, device=None):
    """Infinite deterministic stream of {tokens, labels} int32 (batch, seq)
    batches on ``device`` (the card unless the caller names another; the
    device is checked at the call, before the first batch)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    # fixed random bigram preference: tok -> preferred successor
    succ = rng.integers(0, vocab_size, size=vocab_size)

    def stream():
        step = 0
        while True:
            r = np.random.default_rng((seed, step))
            toks = np.empty((batch, seq + 1), dtype=np.int64)
            toks[:, 0] = r.zipf(1.3, size=batch) % vocab_size
            noise = r.random((batch, seq))
            rand_next = r.integers(0, vocab_size, size=(batch, seq))
            for t in range(seq):
                follow = succ[toks[:, t]]
                toks[:, t + 1] = np.where(noise[:, t] < 0.65, follow, rand_next[:, t])
            toks = torch.from_numpy(toks.astype(np.int32))
            yield {"tokens": toks[:, :-1].contiguous().to(device),
                   "labels": toks[:, 1:].contiguous().to(device)}
            step += 1

    return stream()


def regression_dataset(name: str, seed: int = 0, data_dir: str | None = None):
    """(X_train, y_train, X_test, y_test) float32, normalized like the
    paper: inputs zero-mean unit-variance, targets centered.  With
    ``data_dir``, the arrays of ``<data_dir>/<name>.npz`` (keys
    ``X_train``, ``y_train``, ``X_test``, ``y_test``) where that file
    exists."""
    if data_dir is not None:
        loaded = _try_load_real(name, data_dir)
        if loaded is not None:
            return loaded
    n_train, n_test, d = DATASET_SPECS[name]
    rng = np.random.default_rng((_SALT[name], seed))
    freq, feats = {"kin40k": (4.0, 64), "sarcos": (2.0, 16), "abalone": (1.0, 8)}[name]
    A = rng.normal(size=(d, d)) / np.sqrt(d)
    Xall = rng.normal(size=(n_train + n_test, d)) @ A.T
    W1 = rng.normal(size=(d, feats)) / np.sqrt(d)
    w2 = rng.normal(size=feats)
    f = np.tanh(Xall @ W1) @ w2 + 0.3 * np.sin(freq * Xall @ W1[:, 0])
    y = f + 0.05 * np.std(f) * rng.normal(size=f.shape[0])
    X_tr, X_te = Xall[:n_train], Xall[n_train:]
    y_tr, y_te = y[:n_train], y[n_train:]
    mu, sd = X_tr.mean(0), X_tr.std(0) + 1e-9
    X_tr = (X_tr - mu) / sd
    X_te = (X_te - mu) / sd
    ym = y_tr.mean()
    return (
        X_tr.astype(np.float32), (y_tr - ym).astype(np.float32),
        X_te.astype(np.float32), (y_te - ym).astype(np.float32),
    )


def _try_load_real(name: str, data_dir: str):
    path = os.path.join(data_dir, f"{name}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return (z["X_train"], z["y_train"], z["X_test"], z["y_test"])


def mnist_like_two_digits(n_per_digit: int = 1000, seed: int = 0):
    """Two 784-dim clusters with digit-specific low-rank covariance — the
    Fig. 3c/d setting (digit 6 on machine 1, digit 7 on machine 2)."""
    rng = np.random.default_rng(seed)
    d = 784

    def digit(k):
        basis = rng.normal(size=(d, 30)) / np.sqrt(d)
        scales = np.geomspace(5.0, 0.1, 30)
        z = rng.normal(size=(n_per_digit, 30)) * scales
        return (z @ basis.T + 0.05 * rng.normal(size=(n_per_digit, d))).astype(np.float32)

    return digit(6), digit(7)
