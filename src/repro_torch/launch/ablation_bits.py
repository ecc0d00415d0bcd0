"""Ablation on the port: bit-allocation strategies for the per-symbol scheme
— counterpart of ``benchmarks/ablation_bits.py``.

  python -m repro_torch.launch.ablation_bits [--full] [--device cpu]

The paper proves the greedy Algorithm-1 allocation optimal among integer
allocations.  This quantifies what that is worth against (a) the uniform
allocation (R/d bits everywhere) and (b) rounded reverse water-filling
(the real-valued optimum rounded to integers), at equal total rate, on the
Fig. 2 Gaussian (d = 20, n = 4000, at most 10 bits a dimension).  The
allocations are host numpy; the quantizer's encode and decode and the
distortions (eq. 7) run as plain tensor ops on ``device`` (the card unless
the caller names another), with no kernel of the port, as the reference's
run with no Pallas kernel.  Quick by default (R in {10, 20, 40, 80});
``--full`` takes R in {5, 10, 20, 40, 60, 80, 100, 120}.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import quantizers as Q
from ..core.distortion import distortion_quadratic
from ..core.protocols.base import resolve_device
from ..core.transforms import make_decorrelating_transform
from .common import emit
from .fig2_distortion import gaussian_setting

__all__ = ["codes", "distortion", "main", "cli"]


def _alloc_uniform(lam, R, max_bits):
    d = lam.shape[0]
    base = R // d
    extra = R - base * d
    rates = np.full(d, base, dtype=np.int32)
    rates[:extra] += 1  # spill to the largest-variance dims
    return np.minimum(rates, max_bits)


def _alloc_waterfill_rounded(lam, R, max_bits):
    """Real-valued rates r_i = 0.5 log2(lam_i / q_i), floor + greedy top-off."""
    lam = np.maximum(lam, 1e-12)
    lo, hi = 0.0, float(lam.max())
    for _ in range(100):  # bisect the water level so the total bits ~ R
        mid = 0.5 * (lo + hi)
        q = np.minimum(mid, lam)
        bits = 0.5 * np.log2(lam / q).sum()
        if bits > R:
            lo = mid
        else:
            hi = mid
    q = np.minimum(0.5 * (lo + hi), lam)
    real = 0.5 * np.log2(lam / np.maximum(q, 1e-12))
    rates = np.minimum(np.floor(real).astype(np.int32), max_bits)
    # distribute the leftover greedily by fractional part
    left = int(R - rates.sum())
    order = np.argsort(-(real - np.floor(real)))
    for i in order[:max(left, 0)]:
        if rates[i] < max_bits:
            rates[i] += 1
    return rates


def _tables(tr, rates, device):
    sigma = torch.from_numpy(np.sqrt(np.maximum(tr.variances, 0)).astype(np.float32)).to(device)
    edges, cents = Q.build_codebook_tables(int(max(rates.max(), 1)), device=device)
    return sigma, torch.from_numpy(np.asarray(rates)).to(device), edges, cents


def codes(X, tr, rates) -> torch.Tensor:
    """The per-symbol codes of X (n, d) under the transform ``tr`` and the
    allocation ``rates``, on X's device."""
    sigma, r, edges, _ = _tables(tr, rates, X.device)
    Xp = X @ torch.from_numpy(tr.T.astype(np.float32)).to(X.device).T
    return Q.quantize(Xp, sigma, r, edges)


def distortion(X, tr, rates, Qy) -> float:
    """Eq. (7) of X's per-symbol roundtrip under the allocation ``rates``."""
    sigma, r, _, cents = _tables(tr, rates, X.device)
    T_inv = torch.from_numpy(tr.T_inv.astype(np.float32)).to(X.device)
    Xh = Q.dequantize(codes(X, tr, rates), sigma, r, cents) @ T_inv.T
    return float(distortion_quadratic(X, Xh, Qy))


def main(quick: bool = True, device=None, d: int = 20, n: int = 4000, seed: int = 0,
         max_bits: int = 10) -> list:
    dev = resolve_device(device)
    Qx, Qy, X_np = gaussian_setting(np.random.default_rng(seed), d, n)
    X = torch.from_numpy(X_np).to(dev)
    tr = make_decorrelating_transform(Qx, Qy)
    lam = np.maximum(tr.variances, 0)

    rows = []
    for R in ([10, 20, 40, 80] if quick else [5, 10, 20, 40, 60, 80, 100, 120]):
        alloc = {"greedy": Q.allocate_bits_greedy(lam, R, max_bits),
                 "uniform": _alloc_uniform(lam, R, max_bits),
                 "waterfill_rounded": _alloc_waterfill_rounded(lam, R, max_bits)}
        e = {k: distortion(X, tr, v, Qy) for k, v in alloc.items()}
        row = emit("ablation_bits", 0.0, R=R, **e,
                   uniform_penalty=e["uniform"] / max(e["greedy"], 1e-12),
                   wf_penalty=e["waterfill_rounded"] / max(e["greedy"], 1e-12))
        row["ledger"] = {k: v.tolist() for k, v in alloc.items()}
        rows.append(row)
    return rows


def cli(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the full rate list")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    a = ap.parse_args(argv)
    return main(quick=not a.full, device=a.device)


if __name__ == "__main__":
    cli()
