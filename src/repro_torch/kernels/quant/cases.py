"""Operand sets for holding the ``quant_encode``, ``quant_decode`` and
``qgram`` kernels against their plain versions (the CPU and card tests,
``chip_smoke.py``), made with numpy from a seed so that both packages can
be given the same inputs.

The tables are those of the reference's kernels benchmark: per-dimension
variances uniform in [0.1, 2), rates from Algorithm 1
(:func:`allocate_bits_greedy`) at ``total_bits`` with a cap of
``max_bits``, tables from :func:`build_scaled_tables`, symbols
N(0, sigma^2).  ``zero_dims`` get variance 0, hence rate 0 (a row of +inf
edges); ``dominant`` multiplies dimension 0's variance by 1e4, so that it
takes up to ``max_bits`` bits (a 4096-entry row at max_bits 12).
``specials`` plants NaN, +inf, -inf, 0 and symbols exactly on an
edge in the first rows.

``encode_operands`` makes the tables the encode kernel must count right
whether or not it may search them: rows that ascend (with +inf pads and a
rate-0 row of +inf), and rows that do not (``ENCODE_TABLE_KINDS``).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import quantizers as Q
from .ops import build_scaled_tables

__all__ = ["quant_operands", "qgram_operands", "encode_operands", "ENCODE_TABLE_KINDS"]

# ascending: sorted rows; unsorted: every third row shuffled; nan_edge: a NaN
# edge in every third row; duplicates: runs of equal edges; signed_zeros:
# -0.0 and +0.0 edges side by side in both orders; infinite: -inf edges
# first and +inf edges among the live ones, still ascending
ENCODE_TABLE_KINDS = ("ascending", "unsorted", "nan_edge", "duplicates", "signed_zeros",
                      "infinite")


def quant_operands(n, d, total_bits, *, max_bits=8, seed=0, zero_dims=(),
                   dominant=False, specials=False, device=None):
    """(x (n, d) fp32, scaled_edges (d, E), scaled_cents (d, E), rates (d,)
    int32), torch tensors on ``device``."""
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.1, 2.0, size=d)
    var[list(zero_dims)] = 0.0
    if dominant:
        var[0] *= 1e4
    rates = Q.allocate_bits_greedy(var, total_bits, max_bits)
    sigma = np.sqrt(var).astype(np.float32)
    edges, cents = build_scaled_tables(sigma, rates)
    x = (rng.normal(size=(n, d)) * sigma).astype(np.float32)
    if specials and n >= 5:
        x[0, :] = np.nan
        x[1, :] = np.inf
        x[2, :] = -np.inf
        x[3, :] = 0.0
        for j in range(d):  # exactly on an edge: the strict count leaves it out
            live = edges[j][torch.isfinite(edges[j])]
            if live.numel():
                x[4, j] = float(live[int(rng.integers(live.numel()))])
    to = lambda a: torch.as_tensor(a).to(device)
    return to(x), to(edges), to(cents), to(rates.astype(np.int32))


def qgram_operands(m, n, d, p, total_bits, *, max_bits=8, seed=0, pad_rows=0,
                   shared_y=True, device=None):
    """(codes (m, n + pad_rows, d) int32 with the last ``pad_rows`` rows -1,
    scaled_cents (m, d, C), y (p, d) or (m, p, d)), each machine encoded
    under its own tables (C the largest machine's, smaller tables padded
    with 0 — their codes never reach the pad)."""
    rng = np.random.default_rng(seed)
    ops = [quant_operands(n, d, total_bits, max_bits=max_bits,
                          seed=int(rng.integers(2**31))) for _ in range(m)]
    C = max(o[2].shape[1] for o in ops)
    cents = np.zeros((m, d, C), np.float32)
    codes = np.full((m, n + pad_rows, d), -1, np.int32)
    for b, (x, edges, c, _) in enumerate(ops):
        cents[b, :, : c.shape[1]] = c.numpy()
        codes[b, :n] = (x[:, :, None] > edges[None]).sum(-1).numpy()
    y = rng.normal(size=(p, d) if shared_y else (m, p, d)).astype(np.float32)
    to = lambda a: torch.as_tensor(a).to(device)
    return to(codes), to(cents), to(y)


def encode_operands(n, d, E, kind="ascending", *, seed=0, device=None):
    """(x (n, d), edges (d, E)) fp32 torch tensors on ``device``: a
    ``kind`` of ``ENCODE_TABLE_KINDS``.  Every row holds a live prefix of
    N(0, 1) edges and +inf pads (a seeded quarter to all of the row live),
    row 0 is all +inf (rate 0); symbols are N(0, 1.5^2), with NaN, +inf,
    -inf, +0.0, -0.0 and symbols exactly on an edge in the first rows."""
    if kind not in ENCODE_TABLE_KINDS:
        raise ValueError(f"unknown table kind {kind!r}: known are {ENCODE_TABLE_KINDS}")
    rng = np.random.default_rng(seed)
    edges = np.full((d, E), np.inf, np.float32)
    for j in range(1, d):
        live = int(rng.integers(max(1, E // 4), E + 1))
        row = np.sort(rng.normal(size=live)).astype(np.float32)
        if kind == "duplicates":
            row = np.round(row * 8) / 8  # runs of equal edges, still ascending
        elif kind == "signed_zeros" and live >= 4:
            at = int(np.searchsorted(row, 0.0))
            row = np.concatenate([row[:at], [-0.0, 0.0, 0.0, -0.0], row[at:]])[:live]
        elif kind == "unsorted" and j % 3 == 1:
            row = rng.permutation(row)
        elif kind == "nan_edge" and j % 3 == 1:
            row[live // 2] = np.nan
        elif kind == "infinite" and live >= 4:
            row[: live // 4] = -np.inf
            row[-(live // 4):] = np.inf
        edges[j, :live] = row
    x = (1.5 * rng.normal(size=(n, d))).astype(np.float32)
    specials = [np.nan, np.inf, -np.inf, 0.0, -0.0]
    for r, v in enumerate(specials[:n]):
        x[r] = v
    if n > len(specials):
        for j in range(d):  # exactly on an edge: the strict count leaves it out
            live = edges[j][np.isfinite(edges[j])]
            if live.size:
                x[len(specials), j] = live[int(rng.integers(live.size))]
    to = lambda a: torch.from_numpy(a).to(device)
    return to(x), to(edges)
