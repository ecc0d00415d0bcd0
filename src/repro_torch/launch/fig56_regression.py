"""Paper Figs. 5-6 on the port: distributed GP regression SMSE against bits
per sample — counterpart of ``benchmarks/fig56_regression.py``.

  python -m repro_torch.launch.fig56_regression [--full] [--device cpu] \\
      [--gram-mode nystrom|direct]

The same experiment as the reference script: SARCOS / KIN40K /
ABALONE-shaped data (``repro_torch.data.synthetic``, no download), the
linear kernel (Fig. 5: sarcos, abalone) and the SE kernel (Fig. 6: sarcos,
kin40k, abalone); models: the full GP, the zero-rate BCM and rBCM, the
§5.1 center (``nystrom`` and ``direct``) and the §5.2 broadcast (its gram
mode from ``--gram-mode``) at each rate.  Quick by default (500 training
points over 10 machines, 60 Adam steps, 200 test points, R in {4, 16,
48}); ``--full`` is the paper's setting (1000 points over 40 machines, 150
steps, 1000 test points, nine rates from 2 to 100).  Everything goes
through ``DistributedGP`` with ``gram_backend="pallas"``: on the CUDA card,
the hand-written kernels; with ``--device cpu``, their plain versions.

One difference from the reference: its ``split_machines`` draws from the
JAX PRNG, so here the machines' shards come from a seeded numpy
permutation (:func:`machine_parts`), which both packages can be given.
Each row printed is ``fig56_<dataset>_<kernel>,<fit seconds>,model=...|R=...
|smse=...|wire_kbits=...`` (fit seconds on the host clock).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import DGPConfig, DistributedGP
from ..core.gp import GPModel, GPParams, train_gp
from ..core.protocols.base import params_on, resolve_device
from ..data.synthetic import regression_dataset
from .common import machine_parts, smse

__all__ = ["MODELS", "fit_full", "fit_model", "machine_parts", "model_config",
           "run_dataset", "smse", "main"]

# every model this script knows; the reference's figure draws the first five
# and one broadcast mode (``--gram-mode``)
MODELS = ("full", "bcm", "rbcm", "center_nystrom", "center_direct", "center_nystrom_fitc",
          "broadcast_nystrom", "broadcast_direct")
ZERO_RATE = ("full", "bcm", "rbcm")


def model_config(model: str, kernel: str, R: int, steps: int,
                 gram_backend: str = "xla") -> DGPConfig:
    """The ``DGPConfig`` of one model of the figure (not the full GP)."""
    if model in ("bcm", "rbcm"):
        return DGPConfig(protocol="poe", fusion=model, kernel=kernel, steps=steps,
                         gram_backend=gram_backend)
    protocol, mode = model.split("_", 1)
    return DGPConfig(protocol=protocol, gram_mode=mode, kernel=kernel,
                     bits_per_sample=int(R), steps=steps, gram_backend=gram_backend)


def fit_full(X, y, kernel: str, steps: int, gram_backend: str = "xla", device=None,
             params: GPParams | None = None) -> GPModel:
    """Train the full GP on all of ``(X, y)`` and factorize its predictive
    (at fit time, so that a request is one cross-gram)."""
    device = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    full = train_gp(X, y, kernel=kernel, params=params_on(params, device), steps=steps,
                    gram_backend=gram_backend)
    full.factors()
    return full


def fit_model(model: str, parts, kernel: str, R: int, steps: int, gram_backend: str = "xla",
              device=None, params: GPParams | None = None):
    """Fit one model of the figure; returns ``predict(X_star) -> (mu, var)``
    and the fitted object (the full GP's :class:`GPModel`, or the
    protocol's artifact)."""
    if model == "full":
        X = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        full = fit_full(X, y, kernel, steps, gram_backend, device, params)
        return full.predict, full
    est = DistributedGP(model_config(model, kernel, R, steps, gram_backend), device=device)
    art = est.fit(parts=parts, params=params)
    return (lambda X_star: est.predict(art, X_star)), art


def run_dataset(name: str, kernel: str, rates, m_machines: int, steps: int,
                n_test_cap: int, n_train_cap: int | None = None,
                models=MODELS, gram_backend: str = "xla", device=None, seed: int = 0,
                emit=print) -> dict:
    """SMSE of each model on one dataset: ``{(model, R): smse}`` with R = 0
    for the zero-rate models.  The full GP trains on the same shuffled
    points the machines hold."""
    X, y, Xt, yt = regression_dataset(name, seed=seed)
    if n_train_cap:
        X, y = X[:n_train_cap], y[:n_train_cap]
    Xt, yt = Xt[:n_test_cap], yt[:n_test_cap]
    parts = machine_parts(X, y, m_machines, seed)
    results = {}
    for model in models:
        for R in ((0,) if model in ZERO_RATE else rates):
            t0 = time.perf_counter()
            predict, fitted = fit_model(model, parts, kernel, R, steps, gram_backend, device)
            mu, _ = predict(Xt)
            fit_s = time.perf_counter() - t0
            results[model, R] = smse(yt, mu.cpu().numpy())
            wire = getattr(fitted, "wire_bits", 0)
            emit(f"fig56_{name}_{kernel},{fit_s:.3f},model={model}|R={R}|"
                 f"smse={results[model, R]:.6g}|wire_kbits={wire / 1e3:.6g}")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the paper's setting")
    ap.add_argument("--gram-mode", default="nystrom", choices=["nystrom", "direct"],
                    help="the broadcast protocol's gram mode")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    a = ap.parse_args(argv)
    quick = not a.full
    rates = [4, 16, 48] if quick else [2, 5, 8, 12, 16, 25, 40, 64, 100]
    models = ZERO_RATE + ("center_nystrom", "center_direct", f"broadcast_{a.gram_mode}")
    out = {}
    for kernel, datasets in (("linear", ["sarcos", "abalone"]),
                             ("se", ["sarcos", "kin40k", "abalone"])):
        for name in datasets:
            out[name, kernel] = run_dataset(
                name, kernel, rates, 10 if quick else 40, 60 if quick else 150,
                200 if quick else 1000, 500 if quick else None, models,
                "pallas", a.device)
    return out


if __name__ == "__main__":
    main()
