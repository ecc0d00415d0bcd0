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

Streaming ``update`` appends new points as columns of the gram (the rank-K
basis stays the center's block): ``nystrom`` grows W and takes L_M through
a rank-n_new Givens update, ``direct`` and ``nystrom_fitc`` border their
dense factor.  Under ``"pallas"`` the new points' cross-gram against the
center block is one ``gram`` launch.

``impl="host"`` runs the serial oracle the batched artifact is held
against: one host-side scheme fit per machine (``schemes.PerSymbolScheme``)
and a :class:`CenterGP` model that refactorizes on every ``predict``.
:func:`single_center_gp` is the reference's one-call entry point.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...comm.accounting import integrity_bits_formula, payload_bits_formula, row_bits
from .. import quantizers as Q
from ..distortion import second_moment
from ..gp import (
    GPParams, gram_fn, kernel_from_inner, posterior_apply, posterior_factors,
    posterior_from_gram, prior_diag, train_gp,
)
from ..linalg_safe import DEFAULT_JITTER
from ..nystrom import (
    _tri_solve, chol_append_at, chol_update_rank, nystrom_apply, nystrom_apply_cached,
    nystrom_complete, nystrom_complete_map, nystrom_cross, nystrom_cross_mapped,
    nystrom_factors, nystrom_kinv, nystrom_posterior, nystrom_serve_cache,
)
from ..registry import SCHEMES, ProtocolSpec, register_protocol
from ..schemes import PerSymbolScheme
from . import base
from .base import (
    FittedProtocol, StreamState, WireState, _apply_fit_faults, _grow_stream, _numpy,
    _refuse_host_flips, pad_parts, params_on, parts_on, resolve_device,
)

__all__ = ["CenterGP", "quantize_to_center", "fit_center_host", "single_center_gp"]


def _quantize_to_center_host(parts, bits_per_sample: int, center: int = 0,
                             max_bits: int = Q.DEFAULT_MAX_BITS, device=None):
    """The serial oracle's wire: a host-side :class:`PerSymbolScheme` fit per
    machine (float64 numpy, as the reference's), its encode and decode on
    ``device``.  Returns (X_recon, y_all, wire_bits, n_center, sq_norms)."""
    parts = parts_on(parts, device)
    S_c = _numpy(second_moment(parts[center][0]))
    Xs, ys, sqs, wire = [], [], [], 0
    for j, (Xj, yj) in enumerate(parts):
        if j == center or Xj.shape[0] == 0:
            Xs.append(Xj)  # empty (dropped) machines transmit nothing
        else:
            sch = PerSymbolScheme(bits_per_sample, max_bits).fit(
                _numpy(second_moment(Xj)), S_c)
            Xs.append(sch.decode(sch.encode(Xj)))
            wire += sch.wire_bits(Xj.shape[0]) + sch.side_info_bits(Xj.shape[1])
        ys.append(yj)
        sqs.append(torch.sum(Xj**2, -1))
    order = [center] + [j for j in range(len(parts)) if j != center]
    return (torch.cat([Xs[j] for j in order]), torch.cat([ys[j] for j in order]), wire,
            parts[center][0].shape[0], torch.cat([sqs[j] for j in order]))


def _quantize_to_center_batched(parts, bits_per_sample: int, center: int,
                                max_bits: int, scheme: str, device, faults=None):
    """Run the wire scheme for every machine at once, then assemble the
    center's gram-row layout (exact center block first) from the shards the
    run returns: under a fault plan's flips, the receiver's compacted
    survivors."""
    shards = pad_parts(parts, device)
    m = shards.X.shape[0]
    run = SCHEMES.get(scheme).run(shards, bits_per_sample, max_bits, "center", center,
                                  faults)
    wire_state, shards = run.state, run.shards
    L = shards.lengths
    order = [center] + [j for j in range(m) if j != center]
    X_recon = torch.cat([shards.X[center, : L[center]]] + [
        wire_state.decoded[j, : L[j]] for j in order[1:]
    ])
    y_all = torch.cat([shards.y[j, : L[j]] for j in order])
    sq_norms = torch.cat([torch.sum(shards.X[j, : L[j]] ** 2, -1) for j in order])
    return X_recon, y_all, sq_norms, shards, run, order


def quantize_to_center(parts, bits_per_sample: int, center: int = 0, impl: str = "batched",
                       max_bits: int = Q.DEFAULT_MAX_BITS, device=None):
    """Run the single-center wire protocol on ``device`` (the card when
    None); returns (X_recon, y_all, wire_bits, n_center, sq_norms).

    X_recon stacks the center's exact block first, then every machine's
    decoded points (the paper's gram-row layout); ``sq_norms`` holds each
    point's exact |x|^2.  impl: ``"host"`` (the serial oracle),
    ``"batched"`` (every machine at once) or ``"mesh"`` (one process per
    machine, the wire through ``comm.q_all_gather``; every rank calls it
    and gets the center's assembly); all three give integer-identical
    ledgers and matching reconstructions."""
    device = resolve_device(device)
    if impl == "host":
        return _quantize_to_center_host(parts, bits_per_sample, center, max_bits, device)
    if impl == "mesh":
        from . import mesh

        mesh.machine_group(len(parts))
        return mesh.quantize_to_center_mesh(parts, bits_per_sample, center, max_bits, device)
    if impl != "batched":
        raise ValueError(f"unknown impl {impl!r}")
    X_recon, y_all, sq_norms, shards, run, _ = _quantize_to_center_batched(
        parts, bits_per_sample, center, max_bits, "per_symbol", device)
    return X_recon, y_all, run.wire_bits, shards.lengths[center], sq_norms


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
    """The center's training gram, and the host oracle's model.

    For the batched fit: with the pallas backend the
    parameter-independent inner products are computed ONCE by the kernels
    (``_ip``) and reused by every training step, so the training loop
    differentiates only the elementwise kernel map.  As the
    ``impl="host"`` oracle (:func:`fit_center_host`): it also holds the
    trained ``params``, the targets and the ledgers, and :meth:`predict`
    refactorizes the gram on every call."""

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
    params: GPParams | None = None  # the oracle's trained hyperparameters
    y: torch.Tensor | None = None
    wire_bits: int = 0
    payload_bits: int = 0
    integrity_bits: int = 0
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

    def predict(self, X_star, available=None):
        """The oracle's (mean, var) at ``X_star``: the gram refactorized, the
        test cross-covariances of the Nyström modes through the same
        Nyström map.  ``available`` is accepted for the fusing models'
        surface and ignored: the center holds every decoded shard."""
        X_star = torch.as_tensor(X_star, dtype=torch.float32, device=self.X_recon.device)
        k, p = gram_fn(self.kernel), self.params
        g_ss = torch.diagonal(k(p, X_star, X_star))
        noise = torch.exp(p.log_noise)
        Xc = self.X_recon[: self.n_center]
        if self.gram_mode == "direct":
            return posterior_from_gram(self._gram(p), k(p, X_star, self.X_recon), g_ss,
                                       self.y, noise)
        G_KK, G_KN = self.gram_blocks(p)
        G_sK = k(p, X_star, Xc)
        if self.gram_mode == "nystrom_fitc":
            G = nystrom_complete(G_KK, G_KN, exact_diag=self._exact_diag(p))
            return posterior_from_gram(G, nystrom_cross(G_KK, G_KN, G_sK), g_ss, self.y,
                                       noise)
        return nystrom_posterior(G_KK, G_KN, self.y, noise, G_sK, g_ss)


def _check_center(cfg, parts):
    if not cfg.center < len(parts):
        raise ValueError(f"center={cfg.center} out of range for m={len(parts)} machines")


def fit_center_host(parts, cfg, params: GPParams | None, device) -> CenterGP:
    """The serial oracle (``impl="host"``): one host-side scheme fit per
    machine, hyperparameters trained on ``device`` on the completed gram,
    and the :class:`CenterGP` model.  Its ledgers are the batched fit's
    formulas.  It has no packed plane, so it refuses a fault plan's bit
    flips; the data faults apply."""
    _check_center(cfg, parts)
    _refuse_host_flips(cfg)
    parts, _ = _apply_fit_faults(parts, cfg)
    X_recon, y_all, wire, K, sq_norms = _quantize_to_center_host(
        parts, cfg.bits_per_sample, cfg.center, cfg.max_bits, device)
    d = X_recon.shape[1]
    lengths = [_numpy(X).shape[0] for X, _ in parts]
    payload = payload_bits_formula(lengths, d, cfg.bits_per_sample, cfg.max_bits,
                                   skip=cfg.center)
    if cfg.gram_mode == "nystrom_fitc":  # the exact |x|^2 side channel: 32 bits a point
        wire += 32 * (X_recon.shape[0] - K)
        payload += 32 * (X_recon.shape[0] - K)
    model = CenterGP(
        kernel=cfg.kernel, X_recon=X_recon, n_center=K, gram_mode=cfg.gram_mode,
        sq_norms=sq_norms, y=y_all, wire_bits=wire, payload_bits=payload,
        integrity_bits=integrity_bits_formula(lengths, skip=cfg.center),
    )
    model.params = train_gp(X_recon, y_all, kernel=cfg.kernel,
                            params=params_on(params, device), steps=cfg.steps, lr=cfg.lr,
                            gram_override=model._gram).params
    return model


def single_center_gp(parts, bits_per_sample: int, kernel: str = "se", steps: int = 150,
                     lr: float = 0.05, params: GPParams | None = None,
                     gram_mode: str = "nystrom", impl: str = "batched",
                     gram_backend: str = "xla", max_bits: int = Q.DEFAULT_MAX_BITS,
                     train_impl: str = "scan", device=None):
    """The full §5.1 protocol in one call: quantize in, Nyström-complete
    (eq. 61), train the hyperparameters on the completion, and return the
    predictor on ``device`` (the card when None) — the serving artifact
    (``.predict(X_star)``), or the :class:`CenterGP` oracle for
    ``impl="host"``.  A thin composition over :func:`~.base.fit`."""
    from ..config import DGPConfig

    cfg = DGPConfig(protocol="center", kernel=kernel, impl=impl, gram_backend=gram_backend,
                    gram_mode=gram_mode, bits_per_sample=int(bits_per_sample),
                    max_bits=int(max_bits), steps=int(steps), lr=float(lr),
                    train_impl=train_impl)
    return base.fit(parts, cfg, params, device)


def _fit_center(parts, cfg, params: GPParams | None, device) -> FittedProtocol:
    if cfg.impl == "mesh":
        from . import mesh

        return mesh.fit_center(parts, cfg, params, device)
    _check_center(cfg, parts)
    parts, _ = _apply_fit_faults(parts, cfg)
    X_recon, y_all, sq_norms, shards, run, order = _quantize_to_center_batched(
        parts, cfg.bits_per_sample, cfg.center, cfg.max_bits, cfg.scheme, device,
        cfg.faults,
    )
    return _center_artifact(X_recon, y_all, sq_norms, shards, run, order, cfg, params, device)


def _center_artifact(X_recon, y_all, sq_norms, shards, run, order, cfg, params,
                     device) -> FittedProtocol:
    """The center's half of the fit, from the assembled gram rows: train
    the hyperparameters on the completion, factorize once, and return the
    artifact (the batched fit's tail; the mesh fit runs it at the center)."""
    mode = cfg.gram_mode
    if mode not in ("nystrom", "nystrom_fitc", "direct"):
        raise ValueError(f"unknown center gram mode {mode!r}")
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
    ).params
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
        "sq_exact": sq_norms, "valid": torch.ones_like(y_all), **run.extras,
    }
    return FittedProtocol(
        params=p, y=y_all, factors=factors, data=data, wire=run.state,
        stream=StreamState.make(
            shards.lengths, y_all.shape[0], wire_bits, payload_bits,
            run.integrity_bits, run.rows_demoted, device=device,
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


def _update_center(art: FittedProtocol, X_new, y_new, j: int, pre, sq_new_exact=None):
    """The streaming append: the receiver's rows ``pre[0]`` become columns
    ``cols .. cols + n_new`` of every column-growable buffer (written into
    copies), the factors grow without refactorizing, the ledgers take
    ``pre``'s increments.  ``sq_new_exact``: the new points' exact |x|^2
    when the center holds only their reconstructions (the mesh), else
    computed from ``X_new``."""
    if art.gram_backend == "pallas" and art.gram_mode != "nystrom":
        raise NotImplementedError(
            "streaming update of pallas-backed center artifacts supports "
            'gram_mode="nystrom" only (direct/fitc query paths read the '
            "fit-time wire codes, which update does not extend)"
        )
    decoded, w_add, p_add, i_add, d_add = pre
    p = art.params
    s2 = torch.exp(p.log_noise) + DEFAULT_JITTER
    n_new = X_new.shape[0]
    pos, end = int(art.stream.cols), int(art.stream.cols) + n_new
    k = gram_fn(art.kernel)
    Xc, K = art.data["Xc"], art.n_center
    sq_new = torch.sum(decoded**2, -1)
    if sq_new_exact is None:
        sq_new_exact = torch.sum(X_new**2, -1)
    y2 = art.y.clone()
    y2[pos:end] = y_new
    f = dict(art.factors)

    def cross_basis():
        """k(Xc, X̂_new) (K, n_new): one ``gram`` launch under pallas."""
        if art.gram_backend == "pallas":
            from ...kernels.gram.ops import gram as gram_kernel

            return kernel_from_inner(art.kernel, p, gram_kernel(Xc, decoded),
                                     art.data["sq_cols"][:K], sq_new)
        return k(p, Xc, decoded)

    if art.gram_mode == "nystrom":
        # W gains L_KK^{-1} G_K,new at the cursor and L_M = chol(s2 I + W W^T)
        # takes the rank-n_new update (zero padded W columns add nothing)
        W_new = _tri_solve(f["L_KK"], cross_basis())
        f["W"] = f["W"].clone()
        f["W"][:, pos:end] = W_new
        f["L_M"] = chol_update_rank(f["L_M"], W_new)
        f["alpha"] = nystrom_kinv(f["W"], f["L_M"], s2, y2)
        if "U" in f:  # the fused serve's cache: Ainv is fixed, U and walpha follow
            f["U"] = f["U"] + W_new @ W_new.T
            f["walpha"] = f["W"] @ f["alpha"]
    else:
        if art.gram_mode == "direct":
            # the validity mask zeroes the cross-covariances against padded
            # slots (k(x, 0) != 0 for SE): chol_append_at's zero-row contract
            G_on = k(p, art.data["X_recon"], decoded) * art.data["valid"][:, None]
            G_nn = k(p, decoded)
        else:  # nystrom_fitc: the bordered factor through the Nyström map
            W_new = _tri_solve(f["L_KK"], cross_basis())
            G_on = f["W"].T @ W_new  # padded W columns are zero: zero rows
            corr = torch.clamp(prior_diag(art.kernel, p, sq_new_exact)
                               - torch.sum(W_new**2, 0), min=0.0)
            G_nn = W_new.T @ W_new + torch.diag(corr)
            f["W"] = f["W"].clone()
            f["W"][:, pos:end] = W_new
        G_nn = G_nn + s2 * torch.eye(n_new, dtype=G_nn.dtype, device=G_nn.device)
        f["L"] = chol_append_at(f["L"], G_on, G_nn, pos)
        f["alpha"] = torch.cholesky_solve(y2[:, None], f["L"])[:, 0]

    data = dict(art.data)
    for key, rows in (("X_recon", decoded), ("sq_cols", sq_new),
                      ("sq_exact", sq_new_exact), ("valid", 1.0)):
        data[key] = data[key].clone()
        data[key][pos:end] = rows
    stream = _grow_stream(art.stream, j, n_new, w_add, p_add, i_add, d_add)
    return dataclasses.replace(art, y=y2, factors=f, data=data, stream=stream)


register_protocol(ProtocolSpec(name="center", fit=_fit_center, predict=_predict_center,
                               update=_update_center, fit_host=fit_center_host))


# --------------------------------------------------------------------------
# the program contract (repro_torch.analysis.check_contracts enforces it)
# --------------------------------------------------------------------------
from ...analysis.contracts import (  # noqa: E402
    CollectiveBudget,
    Contract,
    LedgerAccounting,
    NoHostCallbacks,
    NoShardingLeak,
    forbid_primitives,
    register_contract,
)

# §5.1 serving: the center holds ONE factor set, so a warm predict is
# triangular algebra against it — no factorization, no host round trip, no
# collective (machines were a fit-time construct), and every tensor of the
# artifact on its one device.
register_contract("center", "predict", Contract(
    name="center-serve",
    rules=(
        forbid_primitives(),
        NoHostCallbacks(),
        CollectiveBudget(max_count=0),
        NoShardingLeak(max_devices=1),
        LedgerAccounting(),
    ),
))
register_contract("center", "update", Contract(
    name="center-update",
    rules=(NoShardingLeak(max_devices=1), LedgerAccounting()),
))
