"""Deterministic synthetic data — the GP side of ``repro/data/synthetic.py``,
in numpy:

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

__all__ = ["DATASET_SPECS", "regression_dataset", "mnist_like_two_digits"]

DATASET_SPECS = {
    # name: (n_train, n_test, d) as in the paper §6
    "sarcos": (1000, 4449, 21),
    "kin40k": (1000, 30000, 8),
    "abalone": (1000, 1044, 8),
}
_SALT = {"sarcos": 1, "kin40k": 2, "abalone": 3}


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
