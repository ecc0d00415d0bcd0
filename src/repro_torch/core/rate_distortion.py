"""Rate-distortion theory of the inner-product problem (paper §4.1) —
counterpart of ``repro/core/rate_distortion.py``.

* Theorem 1: the lower bound by reverse water-filling over the eigenvalues
  of Qx Qy (:func:`reverse_waterfill`, :func:`rd_lower_bound_curve`,
  :func:`rate_for_distortion`, :func:`distortion_for_rate`).
* Theorem 2: for Gaussian X the bound is achieved by the test channel
  x = x̂ + z (:func:`make_test_channel`); the ``vq`` wire scheme simulates
  it by sampling x̂ | x (:func:`sample_test_channel`), since block coding
  with 2^{nR} codebooks is intractable, as the paper notes.

The channel algebra runs on the host in float64 numpy with
``np.linalg.eigh``, as the reference's does, so both packages build the
same channel from the same second moments.  The reference samples the
channel's noise from ``jax.random``; the port draws it from one function,
:func:`channel_noise`, keyed by the same two integers on a CPU generator
(the parity tests substitute the reference's draws there).  Rates are in
bits per sample (log2).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..faults import stream_generator

__all__ = [
    "product_eigs",
    "reverse_waterfill",
    "rd_lower_bound_curve",
    "rate_for_distortion",
    "distortion_for_rate",
    "OptimalTestChannel",
    "make_test_channel",
    "channel_noise",
    "sample_test_channel",
]


def _sqrt_psd(Q):
    """Symmetric PSD square root (and inverse sqrt) via eigh."""
    w, v = np.linalg.eigh(np.asarray(Q, dtype=np.float64))
    w = np.clip(w, 0.0, None)
    s = np.sqrt(w)
    half = (v * s) @ v.T
    inv_s = np.where(s > 1e-12 * s.max(), 1.0 / np.where(s == 0, 1.0, s), 0.0)
    inv_half = (v * inv_s) @ v.T
    return half, inv_half


def product_eigs(Qx, Qy):
    """Eigendecomposition of Qy^{1/2} Qx Qy^{1/2} = U Lambda U^T (eq. 25/33).

    Returns (Lambda_desc, U, Qy_half, Qy_inv_half).  Lambda equals the
    eigenvalues of Qx @ Qy (real, >= 0, since both are PSD)."""
    Qy_half, Qy_inv_half = _sqrt_psd(Qy)
    B = Qy_half @ np.asarray(Qx, dtype=np.float64) @ Qy_half
    B = 0.5 * (B + B.T)
    lam, U = np.linalg.eigh(B)
    order = np.argsort(lam)[::-1]
    return np.clip(lam[order], 0.0, None), U[:, order], Qy_half, Qy_inv_half


def reverse_waterfill(eigs: np.ndarray, distortion: float) -> np.ndarray:
    """q_i = min(lambda_wl, eig_i) with sum(q) == D (eq. 14/27-29)."""
    eigs = np.asarray(eigs, dtype=np.float64)
    total = eigs.sum()
    if distortion >= total:
        return eigs.copy()
    lo, hi = 0.0, float(eigs.max())
    for _ in range(200):  # bisection on the water level
        mid = 0.5 * (lo + hi)
        if np.minimum(mid, eigs).sum() > distortion:
            hi = mid
        else:
            lo = mid
    return np.minimum(0.5 * (lo + hi), eigs)


def rd_lower_bound_curve(Qx, Qy, n_points: int = 200):
    """The (R, D) lower-bound curve of Theorem 1 for Gaussian X,
    parametrized by the water level: R = 0.5 sum(log2(eig / q)),
    D = sum(q).  Returns (rates_bits, distortions), rate-ascending."""
    eigs, _, _, _ = product_eigs(Qx, Qy)
    eigs = np.maximum(eigs, 1e-300)
    levels = np.geomspace(eigs.max(), eigs.max() * 1e-12, n_points)
    rates, dists = [], []
    for lv in levels:
        q = np.minimum(lv, eigs)
        rates.append(0.5 * np.sum(np.log2(eigs / q)))
        dists.append(q.sum())
    return np.asarray(rates), np.asarray(dists)


def rate_for_distortion(Qx, Qy, distortion: float) -> float:
    """R_lb(D) in bits (Theorem 1, eq. 13 specialized to Gaussian h(x))."""
    eigs, _, _, _ = product_eigs(Qx, Qy)
    q = reverse_waterfill(np.maximum(eigs, 1e-300), distortion)
    return float(0.5 * np.sum(np.log2(np.maximum(eigs, 1e-300) / np.maximum(q, 1e-300))))


def distortion_for_rate(Qx, Qy, rate_bits: float) -> float:
    """Invert the Theorem-1 curve: D such that R_lb(D) == rate_bits."""
    rates, dists = rd_lower_bound_curve(Qx, Qy, n_points=2000)
    return float(np.interp(rate_bits, rates, dists))


class OptimalTestChannel(NamedTuple):
    """x̂ | x  ~  N(A x, W): the Theorem-2 achieving conditional."""

    A: np.ndarray
    W_half: np.ndarray  # W^{1/2} for sampling
    rate_bits: float
    distortion: float


def make_test_channel(Qx, Qy, distortion: float) -> OptimalTestChannel:
    """The Theorem-2 test channel for target distortion D:

    Q    = Qy^{-1/2} U Qtilde U^T Qy^{-1/2},  Qtilde = diag(min(level, Lambda))
    x̂    = A x + w,  A = (Qx - Q) Qx^{-1},  W = (Qx - Q) - (Qx - Q) Qx^{-1} (Qx - Q)

    which gives x̂ ~ N(0, Qx - Q) and x - x̂ of covariance Q, independent of
    x̂ — eq. (30)."""
    eigs, U, Qy_half, Qy_inv_half = product_eigs(Qx, Qy)
    q = reverse_waterfill(np.maximum(eigs, 1e-300), distortion)
    Qtilde = np.diag(q)
    Q = Qy_inv_half @ U @ Qtilde @ U.T @ Qy_inv_half
    Qx = np.asarray(Qx, dtype=np.float64)
    QxmQ = Qx - Q
    Qx_inv = np.linalg.pinv(Qx)
    A = QxmQ @ Qx_inv
    W = QxmQ - QxmQ @ Qx_inv @ QxmQ
    W = 0.5 * (W + W.T)
    W_half, _ = _sqrt_psd(W)
    rate = 0.5 * np.sum(np.log2(np.maximum(eigs, 1e-300) / np.maximum(q, 1e-300)))
    return OptimalTestChannel(A=A, W_half=W_half, rate_bits=float(rate), distortion=float(q.sum()))


def channel_noise(shape, seed: int, stream: int) -> torch.Tensor:
    """The channel's standard Gaussian noise for one transmission: float32
    of ``shape``, drawn on the CPU from ``stream_generator(seed, stream)``
    (the reference keys ``jax.random.normal`` by ``fold_in(PRNGKey(seed),
    stream)``)."""
    shape = tuple(int(s) for s in shape)
    return torch.randn(shape, generator=stream_generator(seed, stream), dtype=torch.float32)


def sample_test_channel(channel: OptimalTestChannel, X: torch.Tensor, seed: int,
                        stream: int) -> torch.Tensor:
    """Simulate the optimal scheme on ``X``'s device: X̂ = X A^T + N W^½^T,
    N = :func:`channel_noise` (float32, as the reference samples)."""
    noise = channel_noise(X.shape, seed, stream).to(X.device)
    A = torch.as_tensor(channel.A, dtype=torch.float32, device=X.device)
    W_half = torch.as_tensor(channel.W_half, dtype=torch.float32, device=X.device)
    return X @ A.T + noise @ W_half.T
