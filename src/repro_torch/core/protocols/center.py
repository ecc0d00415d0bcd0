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
packed words.

Three gram modes, as in the reference: ``"nystrom"`` (the paper's eq. 61,
rank capped at the center block), ``"nystrom_fitc"`` (the same completion
with its diagonal pinned to the exact prior variances, from each point's
exact |x|^2, which costs 32 more wire and payload bits per non-center
point) and ``"direct"`` (every block straight from the reconstructed
points, a dense N x N gram).  Under ``"pallas"`` the direct mode's N x N
inner products come from one ``gram`` and one ``qgram_packed`` launch, and
every request's (N, t) products from one of each.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...comm.accounting import row_bits
from ..gp import (
    GPParams, gram_fn, kernel_from_inner, posterior_apply, posterior_factors, prior_diag,
    train_gp,
)
from ..nystrom import (
    nystrom_apply, nystrom_apply_cached, nystrom_complete, nystrom_complete_map,
    nystrom_cross_mapped, nystrom_factors, nystrom_serve_cache,
)
from ..registry import SCHEMES, ProtocolSpec, register_protocol
from .base import FittedProtocol, StreamState, WireState, pad_parts, params_on

__all__ = ["CenterGP"]


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
    the kernels (``_ip``) and reused by every training step, so the
    training loop differentiates only the elementwise kernel map."""

    kernel: str
    X_recon: torch.Tensor  # center block exact, rest reconstructed
    n_center: int
    gram_backend: str = "xla"
    wire: WireState | None = None
    block_order: tuple | None = None
    block_lengths: tuple | None = None
    pack_bits: int = 0
    gram_mode: str = "nystrom"
    sq_norms: torch.Tensor | None = None  # exact |x|^2 for the FITC diagonal
    _ip_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def _exact_diag(self, params: GPParams):
        """k(x_i, x_i) from the exact squared norms the machines shipped."""
        return prior_diag(self.kernel, params, self.sq_norms)

    def _ip_rows(self, Y):
        return _pallas_ip_rows(
            self.wire, self.block_order, self.block_lengths,
            self.X_recon[: self.n_center], Y, self.pack_bits,
        )

    def _ip(self, key: str):
        if key not in self._ip_cache:
            if key == "KN":
                self._ip_cache[key] = self._ip_rows(self.X_recon[: self.n_center]).T  # (n_c, N)
            elif key == "NN":
                self._ip_cache[key] = self._ip_rows(self.X_recon)  # (N, N)
            elif key == "sq":
                self._ip_cache[key] = torch.sum(self.X_recon**2, -1)
        return self._ip_cache[key]

    def gram_blocks(self, params: GPParams):
        """(G_KK, G_KN) at ``params`` (the Nyström modes)."""
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
        if self.gram_mode == "direct":
            # beyond the paper: every block from the reconstructed points;
            # converges to the full GP as R grows (Nyström caps at rank K)
            if self.gram_backend == "pallas":
                sq = self._ip("sq")
                return kernel_from_inner(self.kernel, params, self._ip("NN"), sq, sq)
            return gram_fn(self.kernel)(params, self.X_recon)
        diag = self._exact_diag(params) if self.gram_mode == "nystrom_fitc" else None
        return nystrom_complete(*self.gram_blocks(params), exact_diag=diag)


def _fit_center(parts, cfg, params: GPParams | None, device) -> FittedProtocol:
    if not cfg.center < len(parts):
        raise ValueError(f"center={cfg.center} out of range for m={len(parts)} machines")
    mode = cfg.gram_mode
    if mode not in ("nystrom", "nystrom_fitc", "direct"):
        raise ValueError(f"unknown center gram mode {mode!r}")
    X_recon, y_all, sq_norms, shards, run, order = _quantize_to_center_batched(
        parts, cfg.bits_per_sample, cfg.center, cfg.max_bits, cfg.scheme, device,
    )
    K = shards.lengths[cfg.center]
    d = X_recon.shape[1]
    wire_bits, payload_bits = run.wire_bits, run.payload_bits
    if mode == "nystrom_fitc":  # the exact |x|^2 side channel: 32 bits a point
        wire_bits += 32 * (X_recon.shape[0] - K)
        payload_bits += 32 * (X_recon.shape[0] - K)
    builder = CenterGP(
        kernel=cfg.kernel, X_recon=X_recon, n_center=K,
        gram_backend=cfg.gram_backend, wire=run.state, block_order=tuple(order),
        block_lengths=shards.lengths,
        pack_bits=row_bits(cfg.bits_per_sample, d, cfg.max_bits),
        gram_mode=mode, sq_norms=sq_norms,
    )
    p = train_gp(
        X_recon, y_all, kernel=cfg.kernel, params=params_on(params, device), steps=cfg.steps,
        lr=cfg.lr, gram_override=builder._gram,
    )
    noise = torch.exp(p.log_noise)
    if mode == "nystrom":
        G_KK, G_KN = builder.gram_blocks(p)
        factors = nystrom_factors(G_KK, G_KN, y_all, noise)
        if cfg.serve_epilogue == "fused":
            factors.update(nystrom_serve_cache(factors))
    elif mode == "nystrom_fitc":
        # the completion's (L_KK, W) is also the FITC test map's
        G, L_KK, W = nystrom_complete_map(*builder.gram_blocks(p),
                                          exact_diag=builder._exact_diag(p))
        factors = posterior_factors(G, y_all, noise)
        factors.update(L_KK=L_KK, W=W)
    else:
        factors = posterior_factors(builder._gram(p), y_all, noise)
    sq_cols = builder._ip("sq") if cfg.gram_backend == "pallas" \
        else torch.sum(X_recon**2, -1)
    data = {
        "Xc": X_recon[:K], "X_recon": X_recon, "sq_cols": sq_cols,
        "sq_exact": sq_norms, "valid": torch.ones_like(y_all),
    }
    return FittedProtocol(
        params=p, y=y_all, factors=factors, data=data, wire=run.state,
        stream=StreamState.make(
            shards.lengths, y_all.shape[0], wire_bits, payload_bits,
            run.integrity_bits, 0, device=device,
        ),
        protocol="center", kernel=cfg.kernel, gram_mode=mode, fuse="",
        gram_backend=cfg.gram_backend, n_center=K, fit_lengths=shards.lengths,
        block_order=tuple(order), bits_per_sample=cfg.bits_per_sample,
        max_bits=cfg.max_bits, impl=cfg.impl, scheme=cfg.scheme, config=cfg,
    )


def _predict_center(art: FittedProtocol, X_star, sq_star, g_ss, noise, avail=None):
    # the center holds every machine's rows: availability changes nothing
    p = art.params
    sq_cols = art.data["sq_cols"]
    if art.gram_mode == "direct":
        if art.gram_backend == "pallas":
            pack_bits = row_bits(art.bits_per_sample, art.data["Xc"].shape[1], art.max_bits)
            ip_sN = _pallas_ip_rows(art.wire, art.block_order, art.fit_lengths,
                                    art.data["Xc"], X_star, pack_bits).T  # (t, N)
            G_sn = kernel_from_inner(art.kernel, p, ip_sN, sq_star, sq_cols)
        else:
            # padded capacity slots hold the zero point, where SE kernels do
            # not vanish: the validity mask zeroes those cross-columns
            G_sn = gram_fn(art.kernel)(p, X_star, art.data["X_recon"]) * art.data["valid"]
        return posterior_apply(art.factors, G_sn, g_ss)
    Xc = art.data["Xc"]
    if art.gram_backend == "pallas":
        from ...kernels.gram.ops import gram as gram_kernel

        G_sK = kernel_from_inner(art.kernel, p, gram_kernel(X_star, Xc), sq_star,
                                 sq_cols[: art.n_center])
    else:
        G_sK = gram_fn(art.kernel)(p, X_star, Xc)
    if art.gram_mode == "nystrom_fitc":
        # the FITC test covariance Q_*N = G_*K G_KK^{-1} G_KN from the cached
        # (L_KK, W): raw k(x*, x) against the Nyström-structured train gram
        # would mis-weight y outside the rank-K span
        G_sn = nystrom_cross_mapped(art.factors["L_KK"], art.factors["W"], G_sK)
        return posterior_apply(art.factors, G_sn, g_ss)
    if "Ainv" in art.factors:  # fused serve epilogue: K-sized matmuls only
        return nystrom_apply_cached(art.factors, G_sK, g_ss, noise)
    return nystrom_apply(art.factors, G_sK, g_ss, noise)


register_protocol(ProtocolSpec(name="center", fit=_fit_center, predict=_predict_center))
