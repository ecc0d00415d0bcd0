"""Paper Fig. 2 on the port: distortion (eq. 7) against bits per sample for
the three schemes on a 20-dimensional Gaussian with a random covariance —
counterpart of ``benchmarks/fig2_distortion.py``.

  python -m repro_torch.launch.fig2_distortion [--full] [--device cpu]

The schemes are fitted on the host in float64 (``core/schemes.py``) and the
data's roundtrips and distortions run on ``device`` (the card unless the
caller names another); no kernel of the port runs here, as none of the
reference's does.  Quick by default (R in {5, 10, 20, 40, 70, 100});
``--full`` is the paper's R = 5..120 in steps of 5 (``configs/gp_paper.py``
FIG2).  Each R prints one ``fig2`` row: the Theorem-1 lower bound ``lb``,
the simulated optimal scheme ``opt`` (its test-channel noise keyed by
seed R), ``per_symbol`` and ``dim_red`` (the Theorem-3 projection at the
same wire budget, 16 bits a coefficient), beside the zero-rate distortion
tr(Qx Qy).  The returned rows also carry each scheme's integer ledger
(``row["ledger"]``): the per-symbol rates, wire bits and side-info bits.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs.gp_paper import FIG2
from ..core.distortion import distortion_quadratic
from ..core.protocols.base import resolve_device
from ..core.schemes import DimReductionScheme, OptimalScheme, PerSymbolScheme
from .common import emit, timed

__all__ = ["gaussian_setting", "main", "cli"]


def gaussian_setting(rng, d: int, n: int):
    """Random covariances Qx, Qy (float64) and n float32 samples of N(0, Qx)."""
    A = rng.normal(size=(d, d))
    Qx = A @ A.T / d
    B = rng.normal(size=(d, d))
    Qy = B @ B.T / d
    X = rng.multivariate_normal(np.zeros(d), Qx, size=n).astype(np.float32)
    return Qx, Qy, X


def main(quick: bool = True, device=None, d: int = 20, n: int = FIG2.n_train,
         seed: int = 0) -> list:
    dev = resolve_device(device)
    Qx, Qy, X_np = gaussian_setting(np.random.default_rng(seed), d, n)
    X = torch.from_numpy(X_np).to(dev)
    D0 = float(np.trace(Qx @ Qy))  # zero-rate distortion

    rates = [5, 10, 20, 40, 70, 100] if quick else list(FIG2.rates)
    rows = []
    for R in rates:
        ps = PerSymbolScheme(R).fit(Qx, Qy)
        Xh, us = timed(ps.roundtrip, X)
        e_ps = float(distortion_quadratic(X, Xh, Qy))
        opt = OptimalScheme(R).fit(Qx, Qy)
        e_opt = float(distortion_quadratic(X, opt.roundtrip(X, R), Qy))
        m = max(1, R // 16)  # DR at the same wire budget, 16 bits a coefficient
        dr = DimReductionScheme(m).fit(Qx, Qy)
        e_dr = float(distortion_quadratic(X, dr.roundtrip(X), Qy))
        row = emit("fig2", us, bits=R, bits_per_dim=R / d, lb=opt.expected_distortion,
                   opt=e_opt, per_symbol=e_ps, dim_red=e_dr, zero_rate=D0)
        row["ledger"] = {
            "rates": ps.rates.tolist(),
            "wire_bits": (opt.wire_bits(n), ps.wire_bits(n), dr.wire_bits(n)),
            "side_info_bits": (opt.side_info_bits(d), ps.side_info_bits(d),
                               dr.side_info_bits(d)),
        }
        rows.append(row)
    # the paper's claims, printed (the tests and the smoke hold them)
    by_r = {r["derived"]["bits"]: r["derived"] for r in rows}
    mid, hi = by_r[rates[2]], by_r[rates[-1]]
    emit("fig2_check", 0.0,
         per_symbol_near_opt=mid["per_symbol"] / max(mid["opt"], 1e-12),
         hi_rate_frac_of_zero=hi["per_symbol"] / D0)
    return rows


def cli(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the paper's setting")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    a = ap.parse_args(argv)
    return main(quick=not a.full, device=a.device)


if __name__ == "__main__":
    cli()
