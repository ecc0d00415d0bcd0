"""The §4.2 per-symbol scheme as the host oracles run it — the
``PerSymbolScheme`` of ``repro/core/schemes.py``.

The fit runs on the host in float64 numpy (the decorrelating transform,
Algorithm-1 greedy allocation), as the reference's does; encode and decode
are tensor ops on the symbols' device.  The batched protocols use
``torch_scheme`` instead: one fit for every machine at once, on the
device.  ``OptimalScheme``, ``DimReductionScheme`` and ``PCAScheme`` come
with queue 1, slice 6 in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..comm.accounting import side_info_bits
from . import quantizers as Q
from .transforms import make_decorrelating_transform

__all__ = ["PerSymbolScheme"]


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

    def wire_bits(self, n: int) -> int:
        return int(self.rates.sum()) * n

    def side_info_bits(self, d: int) -> int:
        return side_info_bits(d)  # Qx and Qy exchanged (paper: O(2 d^2 + R n))
