"""Paper Fig. 4 on the port: a 1-d GP (N = 200) trained on per-symbol
quantized inputs at R = 1..8 bits a sample, its posterior mean and standard
deviation against the unquantized GP's on a dense grid — counterpart of
``benchmarks/fig4_gp1d.py``.

  python -m repro_torch.launch.fig4_gp1d [--full] [--device cpu] \\
      [--gram-backend pallas|xla]

The paper's claim: at R = 1 the posterior is badly distorted (possibly with
inverted peaks), from R = 6 on it is close to the true GP's.  Every GP is a
``train_gp`` on ``device`` (the card unless the caller names another) whose
gram goes through the ``gram`` kernel under ``--gram-backend pallas`` (the
default): one launch an Adam step, one for the predictive's factors and one
for the grid's cross-gram.  Quick by default (120 Adam steps); ``--full``
takes 300 (``configs/gp_paper.py`` FIG4: N = 200, R = 1..8).  Each R prints
a ``fig4`` row: the mean and sd MSE against the true GP, and the
correlation of the means (a sign flip reads negative); ``us`` is the fit's
host time (train and factorize, synchronized).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.gp_paper import FIG4
from ..core.gp import train_gp
from ..core.protocols.base import resolve_device
from ..core.schemes import PerSymbolScheme
from .common import emit, sync

__all__ = ["main", "cli"]


def _fit(X, y, steps: int, gram_backend: str):
    """Train and factorize one GP: (model, host microseconds)."""
    sync()
    t0 = time.perf_counter()
    model = train_gp(X, y, kernel=FIG4.kernel, steps=steps, gram_backend=gram_backend)
    model.factors()
    sync()
    return model, (time.perf_counter() - t0) * 1e6


def _posterior(model, grid):
    mu, var = model.predict(grid)
    return mu.cpu().numpy(), np.sqrt(var.cpu().numpy())


def main(quick: bool = True, device=None, seed: int = 0, gram_backend: str = "pallas") -> list:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = FIG4.n_train
    X_np = rng.uniform(-8, 8, size=(n, 1)).astype(np.float32)
    f = lambda x: np.sin(x[:, 0]) + 0.5 * np.cos(2.3 * x[:, 0]) + 0.1 * x[:, 0]
    y_np = (f(X_np) + 0.1 * rng.normal(size=n)).astype(np.float32)
    X, y = torch.from_numpy(X_np).to(dev), torch.from_numpy(y_np).to(dev)
    grid = torch.from_numpy(np.linspace(-8, 8, 200).astype(np.float32)[:, None]).to(dev)

    steps = 120 if quick else 300
    true_gp, _ = _fit(X, y, steps, gram_backend)
    mu_t, sd_t = _posterior(true_gp, grid)

    Qx = np.cov(X_np.T).reshape(1, 1) + 1e-6
    rows = []
    for R in FIG4.rates:
        sch = PerSymbolScheme(R, max_bits_per_dim=R).fit(Qx, Qx)
        gp_q, us = _fit(sch.roundtrip(X), y, steps, gram_backend)
        mu_q, sd_q = _posterior(gp_q, grid)
        row = emit("fig4", us, R=R, mean_mse=float(np.mean((mu_q - mu_t) ** 2)),
                   sd_mse=float(np.mean((sd_q - sd_t) ** 2)),
                   corr_with_true=float(np.corrcoef(mu_q, mu_t)[0, 1]))
        row["ledger"] = {"rates": sch.rates.tolist(), "wire_bits": sch.wire_bits(n),
                         "side_info_bits": sch.side_info_bits(1)}
        rows.append(row)
    return rows


def cli(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the paper's setting")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--gram-backend", default="pallas", choices=["pallas", "xla"],
                    help="pallas: the gram kernel (its plain version on the CPU)")
    a = ap.parse_args(argv)
    return main(quick=not a.full, device=a.device, gram_backend=a.gram_backend)


if __name__ == "__main__":
    cli()
