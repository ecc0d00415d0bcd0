"""§5.1 single-center protocol — counterpart of
``repro/core/protocols/center.py``.

Machine ``center`` ships its second moment S_c to every machine; machine j
fits the wire scheme to (Qx=S_j, Qy=S_c) and transmits packed codes; the
center decodes, forms the first K rows of the gram (its own block exact),
Nyström-completes it (eq. 61), trains the hyperparameters on the
completion and serves predictions from one cached factor set.

With ``gram_backend="pallas"`` the inner products come from the
hand-written Hopper kernels: ``gram`` for the center's exact rows and every
query, ``qgram_packed`` for the reconstructed rows, read straight from the
packed words.  This slice ports ``gram_mode="nystrom"``;
``nystrom_fitc``/``direct`` wait in slice 2b (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...comm.accounting import row_bits
from ..gp import GPParams, gram_fn, kernel_from_inner, train_gp
from ..nystrom import (
    nystrom_apply, nystrom_apply_cached, nystrom_complete, nystrom_factors,
    nystrom_serve_cache,
)
from ..registry import SCHEMES, ProtocolSpec, register_protocol
from .base import FittedProtocol, StreamState, WireState, pad_parts, params_on

__all__ = ["CenterGP"]


def _check_mode(gram_mode: str):
    if gram_mode != "nystrom":
        raise NotImplementedError(
            f"gram_mode={gram_mode!r} is not ported yet (head of queue 1, "
            "slice 2b in ROADMAP.md)"
        )


def _quantize_to_center_batched(parts, bits_per_sample: int, center: int,
                                max_bits: int, scheme: str, device):
    """Run the wire scheme for every machine at once, then assemble the
    center's gram-row layout (exact center block first)."""
    shards = pad_parts(parts, device)
    m = shards.X.shape[0]
    run = SCHEMES.get(scheme).run(shards, bits_per_sample, max_bits, "center", center)
    wire_state, shards = run.state, run.shards
    L = shards.lengths
    order = [center] + [j for j in range(m) if j != center]
    X_recon = torch.cat([shards.X[center, : L[center]]] + [
        wire_state.decoded[j, : L[j]] for j in order[1:]
    ])
    y_all = torch.cat([shards.y[j, : L[j]] for j in order])
    sq_norms = torch.cat([torch.sum(shards.X[j, : L[j]] ** 2, -1) for j in order])
    return X_recon, y_all, sq_norms, shards, run, order


def _pallas_ip_rows(wire: WireState, block_order, lengths, Xc, Y, pack_bits: int):
    """<x_i, y_j> for every x in the center gram-row layout (N, p): the
    center's exact rows through the ``gram`` kernel, the reconstructed rows
    straight from the PACKED words through ONE ``qgram_packed`` launch over
    the machines — X̂ = dequant(unpack(words)) T_inv^T, so
    <x̂, y> = qgram_packed(words, Y T_inv)."""
    from ...kernels.gram.ops import gram as gram_kernel
    from ...kernels.qgram.ops import qgram_packed_batched

    idx_list = list(block_order[1:])
    idx = torch.as_tensor(idx_list, device=Y.device)
    n_pad = wire.codes.shape[1]
    mask = torch.as_tensor(
        np.arange(n_pad)[None, :] < np.asarray([lengths[j] for j in idx_list])[:, None],
        dtype=torch.float32, device=Y.device,
    )
    top = gram_kernel(Xc, Y)  # (n_c, p)
    proj = torch.einsum("pd,mde->mpe", Y, wire.T_inv[idx]).contiguous()
    blocks = qgram_packed_batched(
        wire.codes[idx], wire.rates[idx], wire.scaled_cents[idx], proj,
        total_bits=pack_bits, mask=mask,
    )  # (m-1, n_pad, p)
    rows = [top] + [blocks[i, : lengths[j]] for i, j in enumerate(idx_list)]
    return torch.cat(rows)


@dataclasses.dataclass
class CenterGP:
    """Fit-time builder of the center's training gram.  With the pallas
    backend the parameter-independent inner products are computed ONCE by
    the kernels (``_ip``) and reused by every training step."""

    kernel: str
    X_recon: torch.Tensor  # center block exact, rest reconstructed
    n_center: int
    gram_backend: str = "xla"
    wire: WireState | None = None
    block_order: tuple | None = None
    block_lengths: tuple | None = None
    pack_bits: int = 0
    _ip_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def _ip(self, key: str):
        if key not in self._ip_cache:
            Xc = self.X_recon[: self.n_center]
            if key == "KN":
                self._ip_cache[key] = _pallas_ip_rows(
                    self.wire, self.block_order, self.block_lengths, Xc, Xc,
                    self.pack_bits,
                ).T  # (n_c, N)
            elif key == "sq":
                self._ip_cache[key] = torch.sum(self.X_recon**2, -1)
        return self._ip_cache[key]

    def gram_blocks(self, params: GPParams):
        """(G_KK, G_KN) at ``params``."""
        K = self.n_center
        if self.gram_backend == "pallas":
            sq, ip_KN = self._ip("sq"), self._ip("KN")
            G_KK = kernel_from_inner(self.kernel, params, ip_KN[:, :K], sq[:K], sq[:K])
            G_KN = kernel_from_inner(self.kernel, params, ip_KN, sq[:K], sq)
            return G_KK, G_KN
        k = gram_fn(self.kernel)
        Xc = self.X_recon[:K]
        return k(params, Xc), k(params, Xc, self.X_recon)

    def _gram(self, params: GPParams):
        return nystrom_complete(*self.gram_blocks(params))


def _fit_center(parts, cfg, params: GPParams | None, device) -> FittedProtocol:
    if not cfg.center < len(parts):
        raise ValueError(f"center={cfg.center} out of range for m={len(parts)} machines")
    _check_mode(cfg.gram_mode)
    X_recon, y_all, sq_norms, shards, run, order = _quantize_to_center_batched(
        parts, cfg.bits_per_sample, cfg.center, cfg.max_bits, cfg.scheme, device,
    )
    K = shards.lengths[cfg.center]
    d = X_recon.shape[1]
    builder = CenterGP(
        kernel=cfg.kernel, X_recon=X_recon, n_center=K,
        gram_backend=cfg.gram_backend, wire=run.state, block_order=tuple(order),
        block_lengths=shards.lengths,
        pack_bits=row_bits(cfg.bits_per_sample, d, cfg.max_bits),
    )
    p = train_gp(
        X_recon, y_all, kernel=cfg.kernel, params=params_on(params, device), steps=cfg.steps,
        lr=cfg.lr, gram_override=builder._gram,
    )
    G_KK, G_KN = builder.gram_blocks(p)
    factors = nystrom_factors(G_KK, G_KN, y_all, torch.exp(p.log_noise))
    if cfg.serve_epilogue == "fused":
        factors.update(nystrom_serve_cache(factors))
    sq_cols = builder._ip("sq") if cfg.gram_backend == "pallas" \
        else torch.sum(X_recon**2, -1)
    data = {
        "Xc": X_recon[:K], "X_recon": X_recon, "sq_cols": sq_cols,
        "sq_exact": sq_norms, "valid": torch.ones_like(y_all),
    }
    return FittedProtocol(
        params=p, y=y_all, factors=factors, data=data, wire=run.state,
        stream=StreamState.make(
            shards.lengths, y_all.shape[0], run.wire_bits, run.payload_bits,
            run.integrity_bits, 0, device=device,
        ),
        protocol="center", kernel=cfg.kernel, gram_mode=cfg.gram_mode, fuse="",
        gram_backend=cfg.gram_backend, n_center=K, fit_lengths=shards.lengths,
        block_order=tuple(order), bits_per_sample=cfg.bits_per_sample,
        max_bits=cfg.max_bits, impl=cfg.impl, scheme=cfg.scheme, config=cfg,
    )


def _predict_center(art: FittedProtocol, X_star, sq_star, g_ss, noise, avail=None):
    # the center holds every machine's rows: availability changes nothing
    p = art.params
    Xc = art.data["Xc"]
    if art.gram_backend == "pallas":
        from ...kernels.gram.ops import gram as gram_kernel

        sq_c = art.data["sq_cols"][: art.n_center]
        G_sK = kernel_from_inner(art.kernel, p, gram_kernel(X_star, Xc), sq_star, sq_c)
    else:
        G_sK = gram_fn(art.kernel)(p, X_star, Xc)
    if "Ainv" in art.factors:  # fused serve epilogue: K-sized matmuls only
        return nystrom_apply_cached(art.factors, G_sK, g_ss, noise)
    return nystrom_apply(art.factors, G_sK, g_ss, noise)


register_protocol(ProtocolSpec(name="center", fit=_fit_center, predict=_predict_center))
