"""GP-regression datasets shaped like the paper's benchmarks — the recipe of
``repro/data/synthetic.py::regression_dataset``, in numpy.

One deliberate difference: the reference salts its generator with
``hash(name)``, which Python randomizes per process, so its data change
between runs.  Here each name has a fixed integer salt, so a seed gives the
same data in every process.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DATASET_SPECS", "regression_dataset"]

DATASET_SPECS = {
    # name: (n_train, n_test, d) as in the paper §6
    "sarcos": (1000, 4449, 21),
    "kin40k": (1000, 30000, 8),
    "abalone": (1000, 1044, 8),
}
_SALT = {"sarcos": 1, "kin40k": 2, "abalone": 3}


def regression_dataset(name: str, seed: int = 0):
    """(X_train, y_train, X_test, y_test) float32, normalized like the
    paper: inputs zero-mean unit-variance, targets centered."""
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
