"""The paper's transmission schemes behind one fit / roundtrip API (§4) —
counterpart of ``repro/core/schemes.py``.

Every scheme answers: given dataset X at machine M_x and the receiver-side
covariance Q_y, produce a wire message of bounded size whose decoding X̂
minimizes the inner-product distortion (7).

* ``OptimalScheme``      — §4.1, the Theorem-2 Gaussian test channel at the
                           Theorem-1 rate (simulated: block coding is
                           exponential, as the paper notes).
* ``PerSymbolScheme``    — §4.2, decorrelate + greedy bit loading + scalar
                           equiprobable-bin quantizer.  The practical one.
* ``DimReductionScheme`` — §4.3, the Theorem-3 projection (16 bits a
                           coefficient, as in the paper's Fig. 2).
* ``PCAScheme``          — the PCA projection baseline (Fig. 3).

The fits run on the host in float64 numpy, as the reference's do; encode,
decode and roundtrip are tensor ops on the symbols' device.  The batched
protocols use ``torch_scheme`` instead: one per-symbol fit for every
machine at once, on the device.  Wire costs (bits) follow the paper's §4
cost analysis; side info (covariances, d x d fp32) is reported apart, as
the paper amortizes it.  Where the reference takes a PRNG key, the test
channel takes ``(seed, stream)`` and draws its noise from
:func:`~repro_torch.core.rate_distortion.channel_noise`; the deterministic
schemes accept and ignore them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..comm.accounting import side_info_bits
from . import quantizers as Q
from . import rate_distortion as rd
from .transforms import make_decorrelating_transform, make_dim_reduction, make_pca

__all__ = ["PerSymbolScheme", "OptimalScheme", "DimReductionScheme", "PCAScheme"]


def _f32(a, device) -> torch.Tensor:
    """A host array as a float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@dataclasses.dataclass
class PerSymbolScheme:
    """Paper §4.2.  ``bits_per_sample`` = R (total across the d dimensions)."""

    bits_per_sample: int
    max_bits_per_dim: int = Q.DEFAULT_MAX_BITS

    def fit(self, Qx, Qy):
        tr = make_decorrelating_transform(Qx, Qy)
        rates = Q.allocate_bits_greedy(tr.variances, self.bits_per_sample,
                                       self.max_bits_per_dim)
        self._tr = tr
        self.rates = rates
        self.sigma = np.sqrt(np.maximum(tr.variances, 0.0)).astype(np.float32)
        self._edges, self._cents = Q.build_codebook_tables(int(rates.max(initial=0)))
        # expected distortion sum_i e(Lambda_ii, R_i) (eq. 35 + 40)
        self.expected_distortion = float(
            sum(Q.expected_distortion(v, int(r)) for v, r in zip(tr.variances, rates))
        )
        return self

    def encode(self, X) -> torch.Tensor:
        """(n, d) -> int32 codes (n, d), on X's device."""
        X = torch.as_tensor(X)
        Xp = X @ _f32(self._tr.T, X.device).T
        return Q.quantize(Xp, _f32(self.sigma, X.device),
                          torch.from_numpy(self.rates).to(X.device), self._edges.to(X.device))

    def decode(self, codes) -> torch.Tensor:
        dev = codes.device
        Xp = Q.dequantize(codes, _f32(self.sigma, dev),
                          torch.from_numpy(self.rates).to(dev), self._cents.to(dev))
        return Xp @ _f32(self._tr.T_inv, dev).T

    def roundtrip(self, X, seed=None, stream: int = 0) -> torch.Tensor:
        return self.decode(self.encode(X))

    def wire_bits(self, n: int) -> int:
        return int(self.rates.sum()) * n

    def side_info_bits(self, d: int) -> int:
        return side_info_bits(d)  # Qx and Qy exchanged (paper: O(2 d^2 + R n))


@dataclasses.dataclass
class OptimalScheme:
    """The Theorem-2 test channel at the Theorem-1 rate (simulated block
    coding)."""

    bits_per_sample: float

    def fit(self, Qx, Qy):
        D = rd.distortion_for_rate(Qx, Qy, self.bits_per_sample)
        self.channel = rd.make_test_channel(Qx, Qy, D)
        self.expected_distortion = self.channel.distortion
        return self

    def roundtrip(self, X, seed: int, stream: int = 0) -> torch.Tensor:
        """X̂ = X A^T + N W^½^T on X's device, the noise N keyed by
        ``(seed, stream)``."""
        return rd.sample_test_channel(self.channel, torch.as_tensor(X), seed, stream)

    def wire_bits(self, n: int) -> int:
        return int(np.ceil(self.channel.rate_bits * n))

    def side_info_bits(self, d: int) -> int:
        return side_info_bits(d)


@dataclasses.dataclass
class DimReductionScheme:
    """The Theorem-3 projection; m coefficients x ``coeff_bits`` bits each."""

    m: int
    coeff_bits: int = 16  # the paper's Fig. 2 assumption

    def fit(self, Sx, Sy):
        self.dr = make_dim_reduction(Sx, Sy, self.m)
        self.expected_distortion = self.dr.left_out
        return self

    def encode(self, X) -> torch.Tensor:
        X = torch.as_tensor(X)
        return X @ _f32(self.dr.P, X.device).T

    def decode(self, Z) -> torch.Tensor:
        return Z @ _f32(self.dr.U, Z.device).T

    def roundtrip(self, X, seed=None, stream: int = 0) -> torch.Tensor:
        return self.decode(self.encode(X))

    def wire_bits(self, n: int) -> int:
        d = self.dr.U.shape[0]
        return self.coeff_bits * (self.m * n + self.m * d)  # the z's and U (paper §4.3)

    def side_info_bits(self, d: int) -> int:
        return d * d * 32  # S_y only


@dataclasses.dataclass
class PCAScheme(DimReductionScheme):
    """The PCA baseline (uses S_x only)."""

    def fit(self, Sx, Sy=None):
        self.dr = make_pca(Sx, self.m)
        self.expected_distortion = None  # PCA's objective is not (7)
        return self

    def side_info_bits(self, d: int) -> int:
        return 0
