"""Per-symbol scalar quantization (paper §4.2) — counterpart of
``repro/core/quantizers.py``.

Equiprobable bins for a zero-mean Gaussian symbol: the standard-normal
edges ``alpha_i = Phi^{-1}(i / 2^R)`` and the eq. 39 centroids, both scaled
by the symbol's std.  The tables are built in numpy (float64, then stored
float32 exactly as the reference stores them) and moved to the caller's
device; :func:`quantize` / :func:`dequantize` are tensor ops over padded,
rate-indexed tables, so heterogeneous per-dimension rates need no loop.
"""
from __future__ import annotations

import heapq
from functools import lru_cache

import numpy as np
import torch
from scipy.special import ndtri  # Phi^{-1}

__all__ = [
    "DEFAULT_MAX_BITS",
    "gauss_bin_edges",
    "gauss_centroids",
    "unit_distortion",
    "expected_distortion",
    "allocate_bits_greedy",
    "build_codebook_tables",
    "quantize",
    "dequantize",
]

DEFAULT_MAX_BITS = 12  # codebooks up to 4096 levels


@lru_cache(maxsize=None)
def gauss_bin_edges(rate: int) -> np.ndarray:
    """Interior bin edges (2^R - 1 of them) for the standard normal."""
    if rate < 0:
        raise ValueError("rate must be >= 0")
    n = 1 << rate
    if n == 1:
        return np.zeros((0,), dtype=np.float64)
    return ndtri(np.arange(1, n) / n)


@lru_cache(maxsize=None)
def gauss_centroids(rate: int) -> np.ndarray:
    """Centroids (2^R of them) of the equiprobable bins, standard normal (eq. 39)."""
    n = 1 << rate
    edges = np.concatenate([[-np.inf], gauss_bin_edges(rate), [np.inf]])
    # integral of u*phi(u) over (a_i, a_{i+1}) = phi(a_i) - phi(a_{i+1})
    pdf_vals = np.exp(-0.5 * edges**2) / np.sqrt(2.0 * np.pi)
    pdf_vals[~np.isfinite(edges)] = 0.0
    return n * (pdf_vals[:-1] - pdf_vals[1:])


@lru_cache(maxsize=None)
def unit_distortion(rate: int) -> float:
    """e(1, R) = 1 - 2^{-R} * sum(c_i^2): MSE of quantizing a standard normal."""
    c = gauss_centroids(rate)
    return float(1.0 - np.sum(c**2) / (1 << rate))


def expected_distortion(variance, rate: int):
    """e(sigma^2, R) (eq. 40) — scales linearly with the variance."""
    return variance * unit_distortion(rate)


def allocate_bits_greedy(
    variances: np.ndarray, total_bits: int, max_bits: int = DEFAULT_MAX_BITS
) -> np.ndarray:
    """Paper Algorithm 1 on the host: give each of ``total_bits`` in turn to
    the dimension whose distortion drops the most (a heap; ties go to the
    lower dimension, as the reference's heap does).  Returns int32 rates
    (d,), summing to ``total_bits`` unless every dimension reaches
    ``max_bits`` or no dimension gains anything."""
    variances = np.asarray(variances, dtype=np.float64)
    d = variances.shape[0]
    rates = np.zeros(d, dtype=np.int32)

    def gain(var, r):
        return var * (unit_distortion(r) - unit_distortion(r + 1))

    heap = [(-gain(variances[i], 0), i) for i in range(d)]
    heapq.heapify(heap)
    remaining = int(total_bits)
    while remaining > 0 and heap:
        neg_g, i = heapq.heappop(heap)
        if neg_g >= 0.0:  # no dimension gains anything (all variances 0)
            break
        rates[i] += 1
        remaining -= 1
        if rates[i] < max_bits:
            heapq.heappush(heap, (-gain(variances[i], int(rates[i])), i))
    return rates


def build_codebook_tables(max_bits: int = DEFAULT_MAX_BITS, device=None):
    """Padded tables indexed by rate: ``edges[r, :]`` holds 2^r - 1 real
    edges then +inf; ``cents[r, :]`` holds 2^r centroids then 0.

    Shapes: edges (max_bits+1, 2^max_bits - 1), cents (max_bits+1, 2^max_bits),
    float32 on ``device``."""
    n_max = 1 << max_bits
    edges = np.full((max_bits + 1, n_max - 1), np.inf, dtype=np.float32)
    cents = np.zeros((max_bits + 1, n_max), dtype=np.float32)
    for r in range(max_bits + 1):
        e = gauss_bin_edges(r)
        c = gauss_centroids(r)
        edges[r, : e.shape[0]] = e
        cents[r, : c.shape[0]] = c
    return torch.from_numpy(edges).to(device), torch.from_numpy(cents).to(device)


def quantize(x, sigma, rates, edges_table):
    """Encode symbols to bin indices.

    x: (..., d); sigma: (..., d) per-dim std; rates: (..., d) int per-dim
    bits (leading axes broadcast against ``x``'s, e.g. a machine axis);
    edges_table from :func:`build_codebook_tables`.  Returns int32 codes in
    [0, 2^R_i): the count of scaled edges below x — the padded +inf edges
    never count, so one comparison handles every rate at once."""
    scaled = edges_table[rates.long()] * sigma[..., None]  # (..., d, E)
    if x.dim() > sigma.dim():  # x carries a row axis the tables do not
        scaled = scaled.unsqueeze(-3)
    return (x[..., None] > scaled).sum(-1, dtype=torch.int32)


def dequantize(codes, sigma, rates, centroids_table):
    """Decode bin indices to centroid values (eq. 39 scaled by sigma).
    Shapes as in :func:`quantize`."""
    cents = centroids_table[rates.long()] * sigma[..., None]  # (..., d, C)
    if codes.dim() > sigma.dim():
        cents = cents.unsqueeze(-3).expand(*codes.shape, cents.shape[-1])
    return torch.gather(cents, -1, codes.long()[..., None])[..., 0]
