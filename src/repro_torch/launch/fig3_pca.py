"""Paper Fig. 3 on the port: the Theorem-3 dimension reduction against PCA
in four settings — counterpart of ``benchmarks/fig3_pca.py``:

(a) Gaussian, a different covariance on each machine;
(b) Gaussian, one covariance;
(c) MNIST-like: digit 6 on machine 1, digit 7 on machine 2;
(d) MNIST-like: both digits split uniformly.

  python -m repro_torch.launch.fig3_pca [--full] [--device cpu]

The paper's claim: the proposed reduction beats PCA exactly where the two
machines' covariances differ (a, c) and ties where they match (b, d).  The
bases are built on the host in float64; the second moments, projections and
distortions (eq. 7) run on ``device`` (the card unless the caller names
another), with no kernel of the port, as in the reference.  Quick by
default (m in {2, 4, 8, 12, 16} at d = 20 and {5, 10, 20, 40} on 600
points a digit); ``--full`` is the paper's m = 1..19 and {2, 5, 10, 20,
40, 80} on 1000 points a digit.  No draw here is random beyond the seeded
numpy generator, so the rows follow the reference script's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.distortion import distortion_quadratic, second_moment
from ..core.protocols.base import resolve_device
from ..core.schemes import DimReductionScheme, PCAScheme
from ..data.synthetic import mnist_like_two_digits
from .common import emit, timed

__all__ = ["main", "cli"]


def _gauss(rng, d, n, same_cov):
    A = rng.normal(size=(d, d))
    Qx = A @ A.T / d
    if same_cov:
        Qy = Qx
    else:
        B = rng.normal(size=(d, d))
        Qy = B @ B.T / d
    X = rng.multivariate_normal(np.zeros(d), Qx, size=n).astype(np.float32)
    Y = rng.multivariate_normal(np.zeros(d), Qy, size=n).astype(np.float32)
    return X, Y


def _compare(tag, X, Y, ms, dev) -> list:
    X, Y = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
    Sx = second_moment(X).cpu().double().numpy()
    Sy = second_moment(Y).cpu().double().numpy()
    rows = []
    for m in ms:
        dr = DimReductionScheme(m).fit(Sx, Sy)
        pc = PCAScheme(m).fit(Sx)
        e_dr, us = timed(lambda: float(distortion_quadratic(X, dr.roundtrip(X), Sy)))
        e_pc = float(distortion_quadratic(X, pc.roundtrip(X), Sy))
        row = emit(f"fig3{tag}", us, m=m, proposed=e_dr, pca=e_pc,
                   ratio=e_dr / max(e_pc, 1e-12))
        n, d = X.shape
        row["ledger"] = {"wire_bits": (dr.wire_bits(n), pc.wire_bits(n)),
                         "side_info_bits": (dr.side_info_bits(d), pc.side_info_bits(d))}
        rows.append(row)
    return rows


def main(quick: bool = True, device=None, seed: int = 0) -> list:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, n = 20, 3000
    ms = [2, 4, 8, 12, 16] if quick else list(range(1, d))
    rows = _compare("a_diff_cov", *_gauss(rng, d, n, same_cov=False), ms, dev)
    rows += _compare("b_same_cov", *_gauss(rng, d, n, same_cov=True), ms, dev)

    six, seven = mnist_like_two_digits(n_per_digit=600 if quick else 1000, seed=seed)
    ms_img = [5, 10, 20, 40] if quick else [2, 5, 10, 20, 40, 80]
    rows += _compare("c_mnist_split_by_digit", six, seven, ms_img, dev)
    both = np.concatenate([six, seven])
    rng.shuffle(both)
    half = both.shape[0] // 2
    rows += _compare("d_mnist_uniform", both[:half], both[half:], ms_img, dev)
    return rows


def cli(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the paper's setting")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    a = ap.parse_args(argv)
    return main(quick=not a.full, device=a.device)


if __name__ == "__main__":
    cli()
