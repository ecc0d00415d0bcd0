"""§5.2 broadcast protocol — counterpart of
``repro/core/protocols/broadcast.py``.

Every machine broadcasts codes fitted against Qy = the sum of the *other*
machines' covariances; each machine builds its own Nyström gram (its own
block exact, the peers' reconstructed), forms a local predictive, and the
per-point predictives are fused with a registered fusion rule (default:
the KL barycenter, eqs. 62-64).  Hyperparameters are trained once, at
machine 0 on its Nyström view, and shared.

The m machines are a leading batch axis (the reference ``vmap``s them).
With ``gram_backend="pallas"`` each batched product is ONE kernel launch:
the own blocks A through ``gram`` on the flattened shards, the cross blocks
B through ``qgram_packed`` straight from the packed words, and on every
request the query products C through ``gram`` and the whole serve tail
through the fused ``epilogue``.

``gram_mode="direct"`` gives each machine a dense N x N view instead: its
own rows exact, every other block decoded-vs-decoded, one batched Cholesky
for the m views.  Under ``"pallas"`` its decoded-vs-decoded products D come
from one more ``qgram_packed`` launch at fit time, and each request's
products against the reconstructions E from one ``qgram_packed`` launch
beside the ``gram`` launch; it serves through ``posterior_apply`` and the
fusion rule, not the fused epilogue.

Streaming ``update`` (``nystrom`` views only, as in the reference): the
machine that receives a batch broadcasts its codes once; every peer's view
gains the reconstructions as columns, the receiver's its exact rows, and
the m views' W, L_M, alpha and fused-serve cache grow in one batched call.

``impl="host"`` runs the serial oracle (:class:`HostBroadcastGP`): one
host-side scheme fit per machine and one dense solve per view per request;
``impl="mesh"`` one process per machine, each holding its own view
(:mod:`.mesh`, ``nystrom`` views only, as in the reference).
:func:`broadcast_gp` is the reference's one-call entry point.

A fault plan (``DGPConfig.faults``) drops and NaN-poisons shards before the
wire; its bit flips demote the broadcast rows whose CRC fails, so every
view is assembled from the compacted survivors (under ``pallas``, B from
one ``qgram_packed`` launch over their words).  A machine left empty is
served as lost: the fusion renormalizes over the others, as it does for
``predict(available=)`` (``base.serve_health`` reports both).
"""
from __future__ import annotations

import dataclasses

import torch

from ...comm.accounting import integrity_bits_formula, payload_bits_formula, row_bits
from .. import quantizers as Q
from ..distortion import second_moment
from ..gp import (
    GPParams, gram_fn, kernel_from_inner, posterior_apply, posterior_factors,
    posterior_from_gram, train_gp,
)
from ..linalg_safe import DEFAULT_JITTER
from ..nystrom import (
    _cho_solve, _tri_solve, chol_update_rank, nystrom_apply, nystrom_apply_cached,
    nystrom_complete, nystrom_factors, nystrom_kinv, nystrom_posterior, nystrom_serve_cache,
)
from ..registry import FUSIONS, SCHEMES, ProtocolSpec, register_protocol
from ..schemes import PerSymbolScheme
from . import base
from .base import (
    FittedProtocol, PaddedShards, StreamState, WireState, _apply_fit_faults, _grow_stream,
    _mask_gram, _numpy, _refuse_host_flips, pad_parts, params_on, parts_on,
)

__all__ = ["HostBroadcastGP", "fit_broadcast_host", "broadcast_gp"]


@dataclasses.dataclass
class HostBroadcastGP:
    """The ``impl="host"`` oracle's fitted state: one host-side scheme fit
    per machine, shared hypers trained at machine 0.  ``predict`` runs one
    dense solve per machine view and fuses — the reference the batched
    artifact is held against."""

    kernel: str
    params: GPParams
    parts: list  # [(X_j, y_j)] as tensors on the oracle's device
    decoded: list
    wire_bits: int
    gram_mode: str
    fuse: str
    payload_bits: int = 0
    integrity_bits: int = 0

    def predict(self, X_star, available=None):
        m = len(self.parts)
        k, p = gram_fn(self.kernel), self.params
        X_star = torch.as_tensor(X_star, dtype=torch.float32, device=self.parts[0][0].device)
        noise = torch.exp(p.log_noise)
        g_ss = torch.diagonal(k(p, X_star, X_star))
        mus, s2s = [], []
        for i in range(m):
            # view i: machine i's block exact and first, the peers' decoded
            order = [i] + [j for j in range(m) if j != i]
            Xv = torch.cat([self.parts[j][0] if j == i else self.decoded[j] for j in order])
            yv = torch.cat([self.parts[j][1] for j in order])
            Xc = Xv[: self.parts[i][0].shape[0]]
            if self.gram_mode == "nystrom":
                mu_i, s2_i = nystrom_posterior(k(p, Xc), k(p, Xc, Xv), yv, noise,
                                               k(p, X_star, Xc), g_ss)
            else:  # direct: every block from the reconstructed points
                mu_i, s2_i = posterior_from_gram(k(p, Xv), k(p, X_star, Xv), g_ss, yv, noise)
            mus.append(mu_i)
            s2s.append(s2_i)
        mus, s2s = torch.stack(mus), torch.stack(s2s)
        spec = FUSIONS.get(self.fuse)
        if available is None:
            return spec.fuse(mus, s2s, g_ss + noise)
        w = (torch.as_tensor(_numpy(available), dtype=torch.float32, device=mus.device)
             > 0).float()
        return spec.fuse(mus, s2s, g_ss + noise, w)


def fit_broadcast_host(parts, cfg, params: GPParams | None, device) -> HostBroadcastGP:
    """The serial §5.2 oracle: every machine encodes once, against the sum
    of the others' second moments, with its own host-side scheme fit;
    shared hypers trained on ``device`` at machine 0 on its Nyström view.
    A fault plan's data faults apply; its bit flips are refused."""
    _refuse_host_flips(cfg)
    parts = parts_on(_apply_fit_faults(parts, cfg)[0], device)
    m, d = len(parts), parts[0][0].shape[1]
    S = [second_moment(X) if X.shape[0] else torch.zeros((d, d), device=device)
         for X, _ in parts]
    S_tot = sum(S)
    wire, decoded = 0, []
    for j, (Xj, _) in enumerate(parts):
        if Xj.shape[0] == 0:
            decoded.append(Xj)  # an empty machine sends nothing
            continue
        sch = PerSymbolScheme(cfg.bits_per_sample, cfg.max_bits).fit(
            _numpy(S[j]), _numpy(S_tot - S[j]))
        decoded.append(sch.decode(sch.encode(Xj)))
        wire += sch.wire_bits(Xj.shape[0]) + sch.side_info_bits(d)
    k = gram_fn(cfg.kernel)
    X0 = torch.cat([parts[0][0]] + decoded[1:])
    y0 = torch.cat([y for _, y in parts])
    Xc = parts[0][0]

    def gram0(p):
        return nystrom_complete(k(p, Xc), k(p, Xc, X0))

    p = train_gp(X0, y0, kernel=cfg.kernel, params=params_on(params, device),
                 steps=cfg.steps, lr=cfg.lr, gram_override=gram0).params
    lengths = [X.shape[0] for X, _ in parts]
    return HostBroadcastGP(
        kernel=cfg.kernel, params=p, parts=parts, decoded=decoded, wire_bits=wire,
        gram_mode=cfg.gram_mode, fuse=cfg.fusion,
        payload_bits=payload_bits_formula(lengths, d, cfg.bits_per_sample, cfg.max_bits),
        integrity_bits=integrity_bits_formula(lengths),
    )


def _train_inner_products(shards: PaddedShards, wire: WireState, backend: str,
                          pack_bits: int = 0):
    """The query-independent inner products every machine's view is
    assembled from, computed once at fit time:

    A (m, n, n): own blocks Xs_i Xs_i^T
    B (m, m, n, n): B[j, i] = X̂_j Xs_i^T (machine j's reconstruction
    against machine i's exact rows; padded rows of j are zero)

    backend="pallas": A is one ``gram`` launch over the flattened shards
    (its diagonal blocks), B one ``qgram_packed`` launch over the machines,
    read straight from the packed words (X̂_j = dequant(words_j) T_inv_j^T,
    so <x̂_j, y> = qgram(words_j, y T_inv_j))."""
    X = shards.X
    m, n, d = X.shape
    if backend == "pallas":
        from ...kernels.gram.ops import gram as gram_kernel
        from ...kernels.qgram.ops import qgram_packed_batched

        flat = X.reshape(m * n, d)
        full = gram_kernel(flat, flat).reshape(m, n, m, n)
        A = torch.diagonal(full, dim1=0, dim2=2).permute(2, 0, 1)
        proj = torch.einsum("Nd,jde->jNe", flat, wire.T_inv).contiguous()
        B = qgram_packed_batched(
            wire.codes, wire.rates, wire.scaled_cents, proj,
            total_bits=pack_bits, mask=shards.mask,
        )  # (m_j, n, m_i * n)
        return A, B.reshape(m, n, m, n).permute(0, 2, 1, 3)
    A = torch.einsum("ind,imd->inm", X, X)
    B = torch.einsum("jnd,imd->jinm", wire.decoded, X)
    return A, B


def _star_exact_products(Xs, X_star, backend: str):
    """C (m, t, n): X_star Xs_i^T — the query-time products against every
    machine's EXACT shard (the Nyström bases); one ``gram`` launch over the
    flattened shards under the pallas backend."""
    m, n, d = Xs.shape
    if backend == "pallas":
        from ...kernels.gram.ops import gram as gram_kernel

        C = gram_kernel(X_star, Xs.reshape(m * n, d))  # (t, m n)
        return C.reshape(-1, m, n).permute(1, 0, 2)
    return torch.einsum("td,ind->itn", X_star, Xs)


def _decoded_inner_products(shards: PaddedShards, wire: WireState, backend: str,
                            pack_bits: int = 0):
    """D (m, n, m n): D[j] = X̂_j [X̂_0 .. X̂_{m-1}]^T, decoded against
    decoded — only the direct views read it.  One ``qgram_packed`` launch
    over the machines under the pallas backend, a projection of the
    flattened reconstructions per machine."""
    m, n, d = shards.X.shape
    dec_flat = wire.decoded.reshape(m * n, d)
    if backend == "pallas":
        from ...kernels.qgram.ops import qgram_packed_batched

        proj = torch.einsum("Nd,jde->jNe", dec_flat, wire.T_inv).contiguous()
        return qgram_packed_batched(
            wire.codes, wire.rates, wire.scaled_cents, proj,
            total_bits=pack_bits, mask=shards.mask,
        )
    return torch.einsum("jnd,Nd->jnN", wire.decoded, dec_flat)


def _star_decoded_products(wire: WireState, X_star, backend: str, pack_bits: int = 0,
                           mask=None):
    """E (m, t, n): E[j] = X_star X̂_j^T, the query's products against the
    reconstructions (direct views only); one ``qgram_packed`` launch
    straight from the packed words under the pallas backend."""
    if backend == "pallas":
        from ...kernels.qgram.ops import qgram_packed_batched

        proj = torch.einsum("td,jde->jte", X_star, wire.T_inv).contiguous()
        return qgram_packed_batched(
            wire.codes, wire.rates, wire.scaled_cents, proj,
            total_bits=pack_bits, mask=mask,
        ).transpose(1, 2)
    return torch.einsum("td,jnd->jtn", X_star, wire.decoded)


def _view_sq_cols(sq_exact, sq_dec):
    """(m, m n): view i's column norms — machine i's block exact, every
    other block decoded."""
    m = sq_exact.shape[0]
    ar = torch.arange(m, device=sq_exact.device)
    sq_cols = sq_dec[None].repeat(m, 1, 1)
    sq_cols[ar, ar] = sq_exact
    return sq_cols.reshape(m, -1)


def broadcast_gp(parts, bits_per_sample: int, X_star, kernel: str = "se", steps: int = 150,
                 lr: float = 0.05, fuse: str = "kl", gram_mode: str = "nystrom",
                 impl: str = "batched", gram_backend: str = "xla",
                 max_bits: int = Q.DEFAULT_MAX_BITS, train_impl: str = "scan", device=None):
    """The full §5.2 protocol in one call: fit on ``device`` (the card when
    None), serve ``X_star`` fused by ``fuse``.  Returns ``(mu, var,
    wire_bits, params)``.  A thin composition over :func:`~.base.fit`;
    ``impl="host"`` fits the serial oracle."""
    from ..config import DGPConfig

    cfg = DGPConfig(protocol="broadcast", kernel=kernel, fusion=fuse, impl=impl,
                    gram_mode=gram_mode, bits_per_sample=int(bits_per_sample),
                    max_bits=int(max_bits), steps=int(steps), lr=float(lr),
                    gram_backend=gram_backend, train_impl=train_impl)
    model = base.fit(parts, cfg, None, device)
    mu, s2 = model.predict(X_star)
    return mu, s2, model.wire_bits, model.params


def _fit_broadcast(parts, cfg, params: GPParams | None, device) -> FittedProtocol:
    if cfg.gram_mode not in ("nystrom", "direct"):
        raise ValueError(f"unknown broadcast gram mode {cfg.gram_mode!r}")
    if cfg.impl == "mesh":
        from . import mesh

        return mesh.fit_broadcast(parts, cfg, params, device)
    parts, _ = _apply_fit_faults(parts, cfg)
    m = len(parts)
    shards = pad_parts(parts, device)
    d = shards.X.shape[-1]
    kernel, backend = cfg.kernel, cfg.gram_backend
    pack_bits = row_bits(cfg.bits_per_sample, d, cfg.max_bits)
    # under a fault plan's flips the run demotes CRC-failing rows and
    # compacts the shards: everything below reads the shards it returns
    run = SCHEMES.get(cfg.scheme).run(shards, cfg.bits_per_sample, cfg.max_bits,
                                      "broadcast", 0, cfg.faults)
    wire, shards = run.state, run.shards
    n_pad = shards.X.shape[1]
    sq_exact = torch.sum(shards.X**2, -1)  # (m, n)
    sq_dec = torch.sum(wire.decoded**2, -1)

    # ---- train the shared hypers at machine 0 on its completed Nyström gram
    # (unpadded slices; the inner products are param-independent constants)
    L = shards.lengths
    n0 = L[0]
    A, B = _train_inner_products(shards, wire, backend, pack_bits)
    ip_KK0 = A[0][:n0, :n0]
    ip_KN0 = torch.cat([ip_KK0] + [B[j, 0][: L[j], :n0].T for j in range(1, m)], dim=1)
    sq0 = sq_exact[0][:n0]
    sq_cols0 = torch.cat([sq0] + [sq_dec[j][: L[j]] for j in range(1, m)])
    y0 = torch.cat([shards.y[j, : L[j]] for j in range(m)])
    X0 = torch.cat([shards.X[0, :n0]] + [wire.decoded[j, : L[j]] for j in range(1, m)])

    def gram0(p):
        G_KK = kernel_from_inner(kernel, p, ip_KK0, sq0, sq0)
        G_KN = kernel_from_inner(kernel, p, ip_KN0, sq0, sq_cols0)
        return nystrom_complete(G_KK, G_KN)

    p = train_gp(X0, y0, kernel=kernel, params=params_on(params, device), steps=cfg.steps,
                 lr=cfg.lr, gram_override=gram0).params
    noise = torch.exp(p.log_noise)

    # ---- factorize every machine's local predictive at once (the
    # reference's vmapped build); column block j of view i is machine j's
    # reconstruction, except block i, which is exact
    mask_flat = shards.mask.reshape(-1)
    y_flat = (shards.y * shards.mask).reshape(-1)
    ar = torch.arange(m, device=device)
    blocks = B.permute(1, 0, 3, 2).clone()  # [i, j]: Xs_i X̂_j^T
    blocks[ar, ar] = A
    ip_KN = blocks.permute(0, 2, 1, 3).reshape(m, n_pad, m * n_pad)
    sq_cols = _view_sq_cols(sq_exact, sq_dec)
    if cfg.gram_mode == "direct":
        # view i: row block i is ip_KN[i]; every other row block r is
        # decoded-vs-decoded (D[r]) except its column block i, decoded-vs-
        # exact (B[r, i])
        D = _decoded_inner_products(shards, wire, backend, pack_bits)
        rows = D.reshape(m, n_pad, m, n_pad)[None].repeat(m, 1, 1, 1, 1)  # [i, r, a, c, b]
        rows[ar, :, :, ar, :] = B.permute(1, 0, 2, 3)
        rows[ar, ar] = ip_KN.reshape(m, n_pad, m, n_pad)
        ip_NN = rows.reshape(m, m * n_pad, m * n_pad)
        G = _mask_gram(kernel_from_inner(kernel, p, ip_NN, sq_cols, sq_cols), mask_flat)
        factors = posterior_factors(G, y_flat.expand(m, -1), noise)
    else:
        G_KK = _mask_gram(kernel_from_inner(kernel, p, A, sq_exact, sq_exact), shards.mask)
        G_KN = kernel_from_inner(kernel, p, ip_KN, sq_exact, sq_cols) * (
            shards.mask[:, :, None] * mask_flat[None, None, :]
        )
        factors = nystrom_factors(G_KK, G_KN, y_flat.expand(m, -1), noise)
        if cfg.serve_epilogue == "fused":
            factors.update(nystrom_serve_cache(factors))
    data = {"Xs": shards.X, "mask": shards.mask, "sq_exact": sq_exact, "sq_dec": sq_dec,
            **run.extras}
    return FittedProtocol(
        params=p, y=y_flat, factors=factors, data=data, wire=wire,
        stream=StreamState.make(
            shards.lengths, y_flat.shape[0], run.wire_bits, run.payload_bits,
            run.integrity_bits, run.rows_demoted, device=device,
        ),
        protocol="broadcast", kernel=kernel, gram_mode=cfg.gram_mode,
        fuse=cfg.fusion, gram_backend=backend, n_center=0,
        fit_lengths=shards.lengths, block_order=None,
        bits_per_sample=cfg.bits_per_sample, max_bits=cfg.max_bits,
        impl=cfg.impl, scheme=cfg.scheme, config=cfg,
    )


def _expert_cross_gram(art, X_star, sq_star):
    """G (m, t, n): each expert's masked cross-covariances to its exact
    shard, from one batched query product."""
    C = _star_exact_products(art.data["Xs"], X_star, art.gram_backend)
    return kernel_from_inner(art.kernel, art.params, C, sq_star,
                             art.data["sq_exact"]) * art.data["mask"][:, None, :]


def _predict_broadcast_experts(art, X_star, sq_star, g_ss, noise):
    """(m, t) per-expert predictives (mus, s2s), unfused."""
    if art.gram_mode == "direct":
        return _predict_direct_experts(art, X_star, sq_star, g_ss)
    G = _expert_cross_gram(art, X_star, sq_star)
    if "Ainv" in art.factors:
        return nystrom_apply_cached(art.factors, G, g_ss, noise)
    return nystrom_apply(art.factors, G, g_ss, noise)


def _predict_direct_experts(art, X_star, sq_star, g_ss):
    """(m, t) dense predictives of the direct views: view i's cross-
    covariances to machine i's exact rows (C[i]) and to every other
    machine's reconstruction (E[j])."""
    Xs, mask = art.data["Xs"], art.data["mask"]
    m, n_pad, d = Xs.shape
    C = _star_exact_products(Xs, X_star, art.gram_backend)
    E = _star_decoded_products(
        art.wire, X_star, art.gram_backend,
        row_bits(art.bits_per_sample, d, art.max_bits), mask,
    )
    ar = torch.arange(m, device=Xs.device)
    cols = E[None].repeat(m, 1, 1, 1)  # [i, j, t, n]
    cols[ar, ar] = C
    ip_sN = cols.permute(0, 2, 1, 3).reshape(m, -1, m * n_pad)
    sq_cols = _view_sq_cols(art.data["sq_exact"], art.data["sq_dec"])
    G_sn = kernel_from_inner(art.kernel, art.params, ip_sN, sq_star, sq_cols) \
        * mask.reshape(-1)
    return posterior_apply(art.factors, G_sn, g_ss)


def _uses_fused_epilogue(art, spec) -> bool:
    """This artifact serves through the one-launch fused epilogue: pallas
    backend, Nyström views with their cached serve operands, a fusion with
    moment rows."""
    return (
        art.gram_backend == "pallas"
        and art.gram_mode == "nystrom"
        and "Ainv" in art.factors
        and spec.moments is not None
        and spec.finalize is not None
    )


def _epilogue_projector(art, noise):
    """The woodbury quad-form projector P = (U - U M^{-1} U) / s2 per
    expert — the query-independent operand of the fused serve.  A
    single-artifact request rebuilds it every time, as the reference does
    (caching it would change the checkpoint's keys); the fleet
    (:mod:`repro_torch.core.fleet`) builds it once per admitted tenant, on
    a stacked artifact with ``noise`` shaped to broadcast (slots, 1, 1, 1)."""
    U = art.factors["U"]
    return (U - U @ _cho_solve(art.factors["L_M"], U)) / (noise + DEFAULT_JITTER)


def _fused_epilogue_operands(art, X_star, sq_star, g_ss, noise, avail):
    """The ``epilogue`` operands of one request, contiguous and in the
    kernel's order: (G, Ainv, P, walpha, gss, prior, w)."""
    f = art.factors
    G = _expert_cross_gram(art, X_star, sq_star)
    w = torch.ones(G.shape[0], dtype=torch.float32, device=G.device) if avail is None else avail
    ops = (G, f["Ainv"], _epilogue_projector(art, noise), f["walpha"], g_ss, g_ss + noise, w)
    return tuple(a.contiguous() for a in ops)


def _predict_broadcast_fused(art, spec, X_star, sq_star, g_ss, noise, avail):
    """One-launch serve tail: every expert's cached apply and the fusion's
    moment rows in one ``epilogue`` call; only ``finalize`` stays outside."""
    from ...kernels.epilogue.ops import epilogue_moments

    ops = _fused_epilogue_operands(art, X_star, sq_star, g_ss, noise, avail)
    S = epilogue_moments(*ops, fuse=art.fuse)
    return spec.finalize(S, ops[0].shape[0], ops[5])


def _predict_broadcast(art: FittedProtocol, X_star, sq_star, g_ss, noise, avail=None):
    spec = FUSIONS.get(art.fuse)
    if _uses_fused_epilogue(art, spec):
        return _predict_broadcast_fused(art, spec, X_star, sq_star, g_ss, noise, avail)
    mus, s2s = _predict_broadcast_experts(art, X_star, sq_star, g_ss, noise)
    if avail is None:
        return spec.fuse(mus, s2s, g_ss + noise)
    # degraded serving: the fusion renormalizes over surviving machines
    return spec.fuse(mus, s2s, g_ss + noise, avail)


def _update_broadcast(art: FittedProtocol, X_new, y_new, j: int, pre):
    """Machine ``j`` broadcast its codes once: every peer's view gains the
    reconstructions ``pre[0]`` as columns at the occupied-column cursor,
    view j its exact rows; the rank-n_pad Nyström bases stay fixed.  The
    m views grow in one batched call each (triangular solve, Givens sweep,
    woodbury solve), into copies."""
    if art.gram_mode != "nystrom":
        raise NotImplementedError(
            'streaming update of broadcast artifacts supports gram_mode='
            '"nystrom" only'
        )
    decoded, w_add, p_add, i_add, d_add = pre
    p = art.params
    s2 = torch.exp(p.log_noise) + DEFAULT_JITTER
    m = len(art.fit_lengths)
    n_new = X_new.shape[0]
    pos, end = int(art.stream.cols), int(art.stream.cols) + n_new
    reps = decoded.expand(m, -1, -1).clone()
    reps[j] = X_new
    sq_new = torch.sum(reps**2, -1)  # (m, n_new)
    ip_new = art.data["Xs"] @ reps.mT  # (m, n_pad, n_new), as the reference's einsum
    G_new = kernel_from_inner(art.kernel, p, ip_new, art.data["sq_exact"], sq_new) \
        * art.data["mask"][:, :, None]
    y2 = art.y.clone()
    y2[pos:end] = y_new
    f = dict(art.factors)
    W_new = _tri_solve(f["L_KK"], G_new)
    f["W"] = f["W"].clone()
    f["W"][..., pos:end] = W_new
    f["L_M"] = chol_update_rank(f["L_M"], W_new)
    f["alpha"] = nystrom_kinv(f["W"], f["L_M"], s2, y2.expand(m, -1))
    if "U" in f:  # the fused serve's cache: Ainv is fixed, U and walpha follow
        f["U"] = f["U"] + W_new @ W_new.mT
        f["walpha"] = (f["W"] @ f["alpha"][..., None])[..., 0]
    stream = _grow_stream(art.stream, j, n_new, w_add, p_add, i_add, d_add)
    return dataclasses.replace(art, y=y2, factors=f, stream=stream)


register_protocol(ProtocolSpec(name="broadcast", fit=_fit_broadcast,
                               predict=_predict_broadcast, update=_update_broadcast,
                               fit_host=fit_broadcast_host))


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

# §5.2 batched serving: the m machines are a leading batch axis of one
# call — nothing may factorize, synchronize with the host or sit on
# another device.
register_contract("broadcast", "predict", Contract(
    name="broadcast-serve",
    rules=(
        forbid_primitives(),
        NoHostCallbacks(),
        CollectiveBudget(max_count=0),
        NoShardingLeak(max_devices=1),
        LedgerAccounting(),
    ),
))
register_contract("broadcast", "update", Contract(
    name="broadcast-update",
    rules=(NoShardingLeak(max_devices=1), LedgerAccounting()),
))
