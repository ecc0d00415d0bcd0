"""impl="mesh": machines are processes, the collectives are the wire —
counterpart of ``repro/core/protocols/mesh.py``.

The reference runs its machines along a device mesh inside ``shard_map``;
the port runs one process per machine, the ranks of a ``torch.distributed``
process group (backend ``gloo``; :func:`machine_group`).  Every rank calls
the same entry point with the same arguments (``DistributedGP(cfg).fit(
parts=parts)``, ``predict``, ``update``, ``save``); rank i reads only
``parts[i]`` (and the shapes of the others), and everything it learns of
its peers arrives through :mod:`repro_torch.comm.collectives`:

* the wire: ``comm.q_all_gather`` — every rank fits and encodes its own
  block, the packed words and O(d^2) side info are gathered, and the
  ledgers are each rank's contribution summed (:func:`_run_wire_protocol_mesh`);
  the targets (and the exact |x|^2 the center stores) follow unquantized
  and uncharged, as the reference's scalars do;
* work the reference runs replicated outside ``shard_map`` runs once, on
  its owner, and reaches the others by broadcast (uncharged, as there):
  the broadcast/poe hyperparameters are trained at machine 0, the center
  protocol after its wire is built at the center;
* the per-machine factors are built on their own rank: a broadcast or poe
  artifact holds on rank i only machine i's factors and data (a leading
  axis of 1, the counterpart of "sharded along the mesh axis"); params,
  y, the wire state and the stream ledgers are whole on every rank;
* serving (broadcast, poe) is each rank's expert applied to the query and
  ONE all-reduce of the fusion's (3, t) moment rows (:func:`predict_mesh`);
  center artifacts are whole on every rank and serve locally;
* streaming (:func:`update_mesh`): machine j re-encodes its batch through
  its frozen codebooks and broadcasts the packed words; the peers decode
  them and every factor grows on its own rank;
* :func:`gather_artifact` collects the machines' factors for a checkpoint
  (rank 0 writes it); a checkpoint loads as a single-process
  ``impl="batched"`` artifact.

No hand-written kernel runs here: the reference refuses
``gram_backend="pallas"`` on the mesh and forms its products with matmuls.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ...comm import collectives as C
from ...comm.accounting import CRC_BITS, row_bits
from ...comm.quantized_collectives import q_all_gather
from .. import torch_scheme
from ..gp import (
    GPParams, gram_fn, kernel_from_inner, posterior_apply, posterior_factors,
    posterior_from_gram, train_gp,
)
from ..linalg_safe import DEFAULT_JITTER
from ..nystrom import (
    _tri_solve, chol_append_at, chol_update_rank, nystrom_apply, nystrom_apply_cached,
    nystrom_complete, nystrom_factors, nystrom_kinv, nystrom_serve_cache,
)
from ..registry import FUSIONS
from ... import faults as fault_plane
from .base import (
    FittedProtocol, PaddedShards, StreamState, WireRun, WireState, _check_fit_lengths,
    _grow_stream, _mask_gram, _numpy, _uses_mesh_predict, params_on,
)

__all__ = ["MESH_AXIS", "machine_group", "broadcast_gp_mesh"]

MESH_AXIS = "machines"  # the reference's axis name, kept for meta.json


def machine_group(m: int):
    """The process group of ``impl="mesh"``: the initialized default group,
    one rank per machine.  Raises unless ``torch.distributed`` is
    initialized with world size ``m`` — there is no fallback to
    ``impl="batched"``."""
    hint = (f"(hint: start {m} processes, e.g. repro_torch.launch.ranks.run_ranks({m}, fn) "
            "or torchrun --nproc-per-node {m}, each calling "
            f'dist.init_process_group("gloo", world_size={m}, rank=...))')
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f'impl="mesh" needs one process per machine and torch.distributed '
                         f"is not initialized {hint}")
    if dist.get_world_size() != m:
        raise ValueError(f'impl="mesh" needs one process per machine: m={m} but the process '
                         f"group has {dist.get_world_size()} ranks {hint}")
    return dist.group.WORLD


def _rank() -> int:
    return dist.get_rank()


def _shape(a) -> tuple:
    return tuple(int(s) for s in a.shape)


def _own_part(parts, cfg, device):
    """This rank's padded block ``(X_i (n_pad, d), y_i (n_pad,), mask_i
    (n_pad,))`` after the fit's data faults, and every machine's row count.
    The peers' parts are read for their shapes only: a fault plan runs on
    this rank's part with the peers' standing in as zero blocks of their
    shapes (the plan draws in machine order by shape, so this rank loses
    the rows a batched fit takes from it), then the surviving counts are
    gathered and the plan's guards run on them, on every rank alike."""
    rank = _rank()
    plan = cfg.faults
    if plan is not None and (plan.drop or plan.nan):
        zeros = lambda a: np.zeros(_shape(a), np.float32)
        stand_in = [(np.asarray(_numpy(X), np.float32), np.asarray(_numpy(y), np.float32))
                    if j == rank else (zeros(X), zeros(y)) for j, (X, y) in enumerate(parts)]
        own = fault_plane.apply_to_parts(stand_in, plan)[0][rank]
        lengths = tuple(int(v) for v in C.all_gather(torch.tensor([own[0].shape[0]])))
        _check_fit_lengths(lengths, cfg)
    else:
        own = parts[rank]
        lengths = tuple(_shape(X)[0] for X, _ in parts)
    n_pad, d = max(lengths), _shape(parts[rank][0])[1]
    X = torch.zeros((n_pad, d), dtype=torch.float32, device=device)
    y = torch.zeros((n_pad,), dtype=torch.float32, device=device)
    mask = torch.zeros((n_pad,), dtype=torch.float32, device=device)
    L = lengths[rank]
    X[:L] = torch.as_tensor(np.asarray(_numpy(own[0]), np.float32), device=device)
    y[:L] = torch.as_tensor(np.asarray(_numpy(own[1]), np.float32), device=device)
    mask[:L] = 1.0
    return X, y, mask, lengths


def _run_wire_protocol_mesh(X_i, mask_i, total_bits: int, max_bits: int, mode: str,
                            center: int, group=None):
    """The per-symbol wire as collectives: this rank's block through
    ``comm.q_all_gather``.  Returns the :class:`~.base.WireState` of every
    machine (the gathered packed words, reconstructions and side info, the
    same on every rank) and the three ledgers as the collective measured
    them: ``(ws, wire_bits, payload_bits, integrity_bits)``."""
    _, st = q_all_gather(X_i, group, total_bits, max_bits, mask=mask_i, mode=mode,
                         center=center, return_state=True)
    tables = torch_scheme.scheme_tables(total_bits, max_bits, X_i.device)
    cents = torch_scheme.scaled_centroids_batched(st["rates"], st["sigma"], tables)
    ws = WireState(st["codes"], st["decoded"], st["T_inv"], st["rates"], st["sigma"],
                   cents, st["T"])
    return ws, st["wire_bits"], st["payload_bits"], st["integrity_bits"]


def _mesh_wire_run(parts, cfg, mode: str, center: int, device, group=None):
    """Fit-time wire of this rank: ``(run, sq_exact)``.  ``run.shards`` is
    what this rank sees of every machine — its own block exact, the others
    reconstructed, every target, the row masks — and, under a fault plan's
    flips, the CRC-surviving rows compacted on every rank alike (the
    channel's masks are keyed by the sender, so every receiver demotes the
    same rows).  ``sq_exact`` (m, n_pad) holds every surviving point's
    exact |x|^2, gathered with the targets after the wire."""
    from .wire import _corrupt_and_demote

    rank = _rank()
    X_i, y_i, mask_i, lengths = _own_part(parts, cfg, device)
    ws, wire, payload, integrity = _run_wire_protocol_mesh(
        X_i, mask_i, cfg.bits_per_sample, cfg.max_bits, mode, center, group)
    X = ws.decoded.clone()
    X[rank] = X_i
    y = torch.zeros_like(ws.decoded[..., 0])
    y[rank] = y_i
    n_pad = X.shape[1]
    mask = (torch.arange(n_pad, device=device)[None, :]
            < torch.as_tensor(lengths, device=device)[:, None]).float()
    shards = PaddedShards(X, y, mask, lengths)
    demoted = 0
    plan = cfg.faults
    if plan is not None and plan.flip_rate > 0.0:
        skip = center if mode == "center" else None
        ws, shards, demoted = _corrupt_and_demote(ws, shards, cfg.bits_per_sample,
                                                  cfg.max_bits, skip, plan)
    # the targets and exact norms of this rank's surviving rows, to everyone
    own = torch.stack([shards.y[rank], torch.sum(shards.X[rank] ** 2, -1)])
    scalars = C.all_gather(own, group)  # (m, 2, n_pad)
    shards = shards._replace(y=scalars[:, 0])
    run = WireRun(ws, wire, payload, integrity, {}, shards, demoted)
    return run, scalars[:, 1]


def _share_params(p, src: int = 0):
    """The hyperparameters trained at ``src``, on every rank."""
    return GPParams(*C.share(tuple(p) if _rank() == src else None, src))


# --------------------------------------------------------------------------
# fit
# --------------------------------------------------------------------------


def fit_center(parts, cfg, params, device) -> FittedProtocol:
    """§5.1 on the mesh: the wire through the collectives, then the center
    assembles its gram rows, trains and factorizes — once, at the center —
    and the artifact reaches every rank whole (the reference unshards at
    this point and continues single-host)."""
    from .center import _center_artifact, _check_center

    _check_center(cfg, parts)
    run, sq_exact = _mesh_wire_run(parts, cfg, "center", cfg.center, device)
    art = None
    if _rank() == cfg.center:
        X_recon, y_all, sq_norms, order = _center_rows(run.shards, run.state, sq_exact,
                                                       cfg.center)
        art = _center_artifact(X_recon, y_all, sq_norms, run.shards, run, order, cfg,
                               params, device)
    return C.share(art, cfg.center)


def _center_rows(shards, ws, sq_exact, center: int):
    """The center's gram-row layout: its exact block first, then every
    machine's reconstruction; targets and exact norms in the same order."""
    m = ws.decoded.shape[0]
    L = shards.lengths
    order = [center] + [j for j in range(m) if j != center]
    X_recon = torch.cat([shards.X[center, : L[center]]]
                        + [ws.decoded[j, : L[j]] for j in order[1:]])
    y_all = torch.cat([shards.y[j, : L[j]] for j in order])
    sq_norms = torch.cat([sq_exact[j, : L[j]] for j in order])
    return X_recon, y_all, sq_norms, order


def quantize_to_center_mesh(parts, bits_per_sample: int, center: int, max_bits: int,
                            device):
    """``quantize_to_center(impl="mesh")``: the §5.1 wire through the
    collectives; the center's assembly ``(X_recon, y_all, wire_bits,
    n_center, sq_norms)`` on every rank."""
    from ..config import DGPConfig

    cfg = DGPConfig(protocol="center", impl="mesh", bits_per_sample=bits_per_sample,
                    max_bits=max_bits, center=center)
    run, sq_exact = _mesh_wire_run(parts, cfg, "center", center, device)
    out = None
    if _rank() == center:
        X_recon, y_all, sq_norms, _ = _center_rows(run.shards, run.state, sq_exact, center)
        out = (X_recon, y_all, sq_norms)
    X_recon, y_all, sq_norms = C.share(out, center)
    return X_recon, y_all, run.wire_bits, run.shards.lengths[center], sq_norms


def fit_broadcast(parts, cfg, params, device) -> FittedProtocol:
    """§5.2 on the mesh: every rank broadcasts its codes once; machine 0
    trains the shared hypers on its Nyström view; every rank factorizes
    ITS view (own block exact, the peers reconstructed) and keeps it."""
    if cfg.gram_mode != "nystrom":
        raise NotImplementedError('impl="mesh" broadcast supports gram_mode="nystrom" only')
    if cfg.gram_backend != "xla":
        raise NotImplementedError(
            'impl="mesh" assembles grams on each machine (gram_backend="xla")')
    rank = _rank()
    run, sq_exact = _mesh_wire_run(parts, cfg, "broadcast", 0, device)
    ws, shards, kernel = run.state, run.shards, cfg.kernel
    m, n_pad, _ = shards.X.shape
    L = shards.lengths
    sq_dec = torch.sum(ws.decoded**2, -1)
    y_flat = (shards.y * shards.mask).reshape(-1)

    p = None
    if rank == 0:
        # machine 0's training inputs, straight from the wire's output
        n0 = L[0]
        X0s = shards.X[0, :n0]
        X_cols0 = torch.cat([X0s] + [ws.decoded[j, : L[j]] for j in range(1, m)])
        ip_KK0, ip_KN0 = X0s @ X0s.T, X0s @ X_cols0.T
        sq0 = sq_exact[0, :n0]
        sq_cols0 = torch.cat([sq0] + [sq_dec[j, : L[j]] for j in range(1, m)])
        y0 = torch.cat([shards.y[j, : L[j]] for j in range(m)])

        def gram0(q):
            return nystrom_complete(kernel_from_inner(kernel, q, ip_KK0, sq0, sq0),
                                    kernel_from_inner(kernel, q, ip_KN0, sq0, sq_cols0))

        p = train_gp(X_cols0, y0, kernel=kernel, params=params_on(params, device),
                     steps=cfg.steps, lr=cfg.lr, gram_override=gram0).params
    p = _share_params(p)
    noise = torch.exp(p.log_noise)

    # this rank's view: its block exact, every other the reconstruction
    x, mi = shards.X[rank], shards.mask[rank]
    sqx = sq_exact[rank]
    cols = ws.decoded.clone()
    cols[rank] = x
    sq_cols = sq_dec.clone()
    sq_cols[rank] = sqx
    ip_KN = torch.einsum("nd,jNd->njN", x, cols).reshape(n_pad, m * n_pad)
    G_KK = _mask_gram(kernel_from_inner(kernel, p, x @ x.T, sqx, sqx), mi)
    G_KN = kernel_from_inner(kernel, p, ip_KN, sqx, sq_cols.reshape(-1)) * (
        mi[:, None] * shards.mask.reshape(-1)[None, :])
    factors = nystrom_factors(G_KK[None], G_KN[None], y_flat[None], noise)
    if cfg.serve_epilogue == "fused":
        factors.update(nystrom_serve_cache(factors))
    data = {"Xs": x[None], "mask": mi[None], "sq_exact": sqx[None],
            "sq_dec": sq_dec[rank][None]}
    return FittedProtocol(
        params=p, y=y_flat, factors=factors, data=data, wire=ws,
        stream=StreamState.make(L, y_flat.shape[0], run.wire_bits, run.payload_bits,
                                run.integrity_bits, run.rows_demoted, device=device),
        protocol="broadcast", kernel=kernel, gram_mode=cfg.gram_mode, fuse=cfg.fusion,
        gram_backend=cfg.gram_backend, n_center=0, fit_lengths=L, block_order=None,
        bits_per_sample=cfg.bits_per_sample, max_bits=cfg.max_bits, impl="mesh",
        scheme=cfg.scheme, config=cfg,
    )


def fit_poe(parts, cfg, params, device) -> FittedProtocol:
    """The zero-rate experts on the mesh: machine 0 trains the shared hypers
    on its own data, every rank factorizes its own expert; only the
    targets cross (so every rank holds ``y`` whole), no wire, every ledger
    0."""
    if cfg.gram_backend != "xla":
        raise NotImplementedError(
            'impl="mesh" assembles grams on each machine (gram_backend="xla")')
    rank = _rank()
    x, y_i, mi, lengths = _own_part(parts, cfg, device)
    p = None
    if rank == 0:
        p = train_gp(x[: lengths[0]], y_i[: lengths[0]], kernel=cfg.kernel,
                     params=params_on(params, device), steps=cfg.steps, lr=cfg.lr).params
    p = _share_params(p)
    noise = torch.exp(p.log_noise)
    sqx = torch.sum(x**2, -1)
    G = _mask_gram(kernel_from_inner(cfg.kernel, p, x @ x.T, sqx, sqx), mi)
    factors = posterior_factors(G[None], (y_i * mi)[None], noise)
    y = C.all_gather(y_i * mi)  # (m, n_pad)
    return FittedProtocol(
        params=p, y=y, factors=factors,
        data={"Xs": x[None], "mask": mi[None], "sq_exact": sqx[None]},
        wire=None, stream=StreamState.make(lengths, y.shape[-1], device=device),
        protocol="poe", kernel=cfg.kernel, gram_mode="dense", fuse=cfg.fusion,
        gram_backend=cfg.gram_backend, n_center=0, fit_lengths=lengths, block_order=None,
        bits_per_sample=0, max_bits=0, impl="mesh", scheme=cfg.scheme, config=cfg,
    )


# --------------------------------------------------------------------------
# serve: each rank's expert, then one all-reduce of the moment rows
# --------------------------------------------------------------------------


def predict_mesh(art, X_star, sq_star, g_ss, noise, avail=None):
    """One request on the mesh: this rank applies ITS machine's cached
    factors to the query (triangular solves or K-sized matmuls, as the
    batched path) and the predictives meet in the fusion's collective
    epilogue — ONE all-reduce of the stacked (3, t) moment rows
    (``FusionSpec.moments`` / ``finalize``), or the fusion's ``fuse_psum``
    where it has no moment rows.  ``avail``: the (m,) availability mask;
    each rank reads its own weight ``w_i = avail[rank]``."""
    rank = _rank()
    m = len(art.fit_lengths)
    fusion = FUSIONS.get(art.fuse)
    fused = fusion.moments is not None and fusion.finalize is not None
    if fusion.fuse_psum is None and not fused:
        raise NotImplementedError(
            f"fusion {art.fuse!r} has no mesh (psum or moments) form — serve the "
            "checkpointed single-process artifact instead")
    p = art.params
    G_sK = kernel_from_inner(art.kernel, p, X_star @ art.data["Xs"][0].T, sq_star,
                             art.data["sq_exact"][0]) * art.data["mask"][0][None, :]
    if art.protocol == "broadcast":
        apply = nystrom_apply_cached if "Ainv" in art.factors else nystrom_apply
        mus, s2s = apply(art.factors, G_sK[None], g_ss, noise)
    else:  # poe: the dense expert
        mus, s2s = posterior_apply(art.factors, G_sK[None], g_ss)
    mu_i, s2_i = mus[0], s2s[0]
    prior = g_ss + noise
    w_i = None if avail is None else avail[rank]
    if fused:
        S = C.all_reduce(fusion.moments(mu_i, s2_i, prior, w_i))
        return fusion.finalize(S, m, prior)
    if w_i is None:
        return fusion.fuse_psum(mu_i, s2_i, prior, None)
    return fusion.fuse_psum(mu_i, s2_i, prior, None, w_i)


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------


def _transmit(art, j: int, X_new, n_new: int, device):
    """Machine ``j``'s new rows through its FROZEN codebooks onto the wire:
    j encodes and packs them, broadcasts the words (and their CRCs under a
    fault plan's flips); every rank unpacks and decodes what arrived.
    Returns ``(keep, decoded, wire_add, payload_add, integrity_add,
    demoted)``: the CRC-surviving rows, their reconstructions and the
    ledger increments of the whole transmission, measured from the
    broadcast word buffer."""
    from .wire import _scheme_state

    rank = _rank()
    d = art.wire.T.shape[-1]
    rbits = row_bits(art.bits_per_sample, d, art.max_bits)
    state = _scheme_state(art.wire, j)
    tables = torch_scheme.scheme_tables(art.bits_per_sample, art.max_bits, device)
    W = torch_scheme.row_words(rbits)
    plan = art.config.faults if art.config is not None else None
    flips = plan is not None and plan.flip_rate > 0.0
    if rank == j:
        words = torch_scheme.pack_codes(torch_scheme.encode(state, X_new, tables),
                                        state["rates"], total_bits=rbits)
        sent = torch.cat([words, torch_scheme.crc_words(words).to(torch.int32)[:, None]], 1)
    else:
        sent = torch.zeros((n_new, W + 1), dtype=torch.int32, device=device)
    if not flips:
        sent = sent[:, :W]  # no flip channel: the words alone
    sent = C.broadcast(sent, j)
    words = sent[:, :W]
    keep = torch.arange(n_new, device=device)
    if flips:  # the streamed batch's channel, keyed as the batched update keys it
        words = fault_plane.flip_words(words, plan.flip_rate, plan.seed, art.wire_bits + j)
        keep = torch.nonzero(torch_scheme.crc_words(words) == sent[:, W].to(torch.int64))[:, 0]
    received = torch_scheme.unpack_codes(words[keep], state["rates"], total_bits=rbits)
    decoded = torch_scheme.decode(state, received, tables)
    wire_add = int(state["rates"].sum()) * n_new
    payload_add = words.shape[-1] * words.element_size() * 8 * n_new
    return keep, decoded, wire_add, payload_add, CRC_BITS * n_new, n_new - keep.numel()


def update_mesh(art, X_new, y_new, j: int):
    """Stream ``(X_new, y_new)`` arriving at machine ``j`` into a mesh
    artifact; every rank calls it with the same arguments and only rank j
    reads the batch.  j drops its non-finite rows and broadcasts the rest's
    targets (and, for the center, their exact |x|^2); a transmitting
    machine sends its codes (:func:`_transmit`).  Broadcast: each rank
    grows ITS view (own rows exact, the peers' decoded).  Poe: expert j
    takes its rows, the others decoupled unit rows.  Center: the center
    grows the factor set and the artifact reaches every rank whole.
    Returns a NEW artifact on every rank."""
    from .streaming import ensure_capacity

    rank, device = _rank(), art.device
    center = art.block_order[0] if art.block_order else 0
    n_new = torch.zeros(1, dtype=torch.int64, device=device)
    if rank == j:
        finite = torch.isfinite(X_new).all(dim=1) & torch.isfinite(y_new)
        if not bool(finite.all()):
            warnings.warn(
                f"update(): dropping {int((~finite).sum())} non-finite point(s) of "
                f"{finite.numel()} (machine {j})", stacklevel=3,
            )
            X_new, y_new = X_new[finite], y_new[finite]
        n_new += X_new.shape[0]
    n_new = int(C.broadcast(n_new, j))
    if n_new == 0:
        return art
    # the targets (and exact |x|^2: the fitc side channel) from machine j
    own = (torch.stack([y_new, torch.sum(X_new**2, -1)]) if rank == j
           else torch.zeros((2, n_new), device=device))
    y_new, sq_new = C.broadcast(own, j)
    transmits = art.protocol == "broadcast" or (art.protocol == "center" and j != center)
    w_add = p_add = i_add = demoted = 0
    decoded = None
    if transmits:
        keep, decoded, w_add, p_add, i_add, demoted = _transmit(art, j, X_new, n_new, device)
        if rank == j:
            X_new = X_new[keep]
        y_new, sq_new = y_new[keep], sq_new[keep]
        side = 32 * n_new if art.protocol == "center" and art.gram_mode == "nystrom_fitc" else 0
        w_add, p_add = w_add + side, p_add + side
        if keep.numel() == 0:  # every row demoted: the bits moved all the same
            s = art.stream
            return dataclasses.replace(art, stream=dataclasses.replace(
                s, wire_bits=s.wire_bits + w_add, payload_bits=s.payload_bits + p_add,
                integrity_bits=s.integrity_bits + i_add, rows_demoted=s.rows_demoted + demoted))
    art = ensure_capacity(art, y_new.shape[0])
    if art.protocol == "center":
        out = None
        if rank == center:
            from .center import _update_center

            rows = X_new if j == center else decoded
            out = _update_center(art, rows, y_new, j, (rows, w_add, p_add, i_add, demoted),
                                 sq_new_exact=sq_new)
        return C.share(out, center)
    if art.protocol == "broadcast":
        return _grow_view(art, X_new if rank == j else decoded, y_new, j,
                          (w_add, p_add, i_add, demoted))
    return _grow_expert(art, X_new if rank == j else None, y_new, j)


def _grow_view(art, X_eff, y_new, j: int, ledger):
    """This rank's broadcast view gains the batch as columns at the cursor
    (its own rows exact, a peer's decoded); the rank-n_pad basis stays."""
    p = art.params
    s2 = torch.exp(p.log_noise) + DEFAULT_JITTER
    n_new = X_eff.shape[0]
    pos, end = int(art.stream.cols), int(art.stream.cols) + n_new
    Xi, mi, sqi = art.data["Xs"][0], art.data["mask"][0], art.data["sq_exact"][0]
    G_new = kernel_from_inner(art.kernel, p, Xi @ X_eff.T, sqi,
                              torch.sum(X_eff**2, -1)) * mi[:, None]
    y2 = art.y.clone()
    y2[pos:end] = y_new
    f = dict(art.factors)
    W_new = _tri_solve(f["L_KK"], G_new[None])
    f["W"] = f["W"].clone()
    f["W"][..., pos:end] = W_new
    f["L_M"] = chol_update_rank(f["L_M"], W_new)
    f["alpha"] = nystrom_kinv(f["W"], f["L_M"], s2, y2[None])
    if "U" in f:  # the fused serve's cache rides along on its rank
        f["U"] = f["U"] + W_new @ W_new.mT
        f["walpha"] = (f["W"] @ f["alpha"][..., None])[..., 0]
    stream = _grow_stream(art.stream, j, n_new, *ledger)
    return dataclasses.replace(art, y=y2, factors=f, stream=stream)


def _grow_expert(art, X_own, y_new, j: int):
    """Poe: expert j borders its factor with its new rows; every other
    expert appends decoupled unit rows (masked out of its predictions),
    as fit-time padding does.  Every rank's ``y`` takes the batch in row j."""
    rank = _rank()
    p = art.params
    s2 = torch.exp(p.log_noise) + DEFAULT_JITTER
    m = len(art.fit_lengths)
    n_new = y_new.shape[0]
    pos, end = int(art.stream.cols), int(art.stream.cols) + n_new
    device = art.device
    owner = rank == j
    rows = X_own if owner else torch.zeros((n_new, art.data["Xs"].shape[-1]), device=device)
    valid = torch.full((1, n_new), 1.0 if owner else 0.0, device=device)
    mask = art.data["mask"]
    data = dict(art.data)
    for key, new in (("Xs", rows), ("mask", valid), ("sq_exact", torch.sum(rows**2, -1))):
        data[key] = data[key].clone()
        data[key][:, pos:end] = new
    y2 = art.y.clone()
    y2[:, pos:end] = (torch.arange(m, device=device)[:, None] == j).float() * y_new
    k = gram_fn(art.kernel)
    # the OLD mask is zero at the cursor and beyond: chol_append_at's
    # zero-rows-at-padded-slots contract
    G_on = k(p, data["Xs"], rows) * (mask[:, :, None] * valid[:, None, :])
    G_nn = _mask_gram(k(p, rows), valid) + s2 * torch.eye(n_new, device=device)
    L2 = chol_append_at(art.factors["L"], G_on, G_nn, pos)
    factors = {"L": L2, "alpha": torch.cholesky_solve(y2[rank][None, :, None], L2)[..., 0]}
    return dataclasses.replace(art, y=y2, factors=factors, data=data,
                               stream=_grow_stream(art.stream, j, n_new))


# --------------------------------------------------------------------------
# persistence: the machines' factors gathered for a checkpoint
# --------------------------------------------------------------------------

# the artifact groups that live one machine per rank
_MESH_SHARDED_LEAVES = ("factors/", "data/")


def gather_artifact(art):
    """The single-process layout of a sharded mesh artifact: every
    ``factors``/``data`` tensor gathered along its machine axis (every rank
    receives it; :func:`~.base.save_artifact` writes it from rank 0)."""
    if not _uses_mesh_predict(art):  # a center artifact is whole on every rank
        return art
    keys = [("factors", k) for k in sorted(art.factors)] + [("data", k) for k in sorted(art.data)]
    stacks = C.all_gather_many([getattr(art, g)[k][0] for g, k in keys])
    out = {"factors": {}, "data": {}}
    for (g, k), v in zip(keys, stacks):
        out[g][k] = v
    return dataclasses.replace(art, **out)


# --------------------------------------------------------------------------
# the legacy one-shot mesh entry point
# --------------------------------------------------------------------------


def broadcast_gp_mesh(group, X, y, X_star, params: GPParams, *, kernel: str = "se",
                      bits_per_sample: int = 32, max_bits: int = 8):
    """One-shot §5.2 broadcast over ``group`` (the default process group
    when None): every rank holds its block ``X`` (n_loc, d), ``y``
    (n_loc,) and the queries ``X_star`` (t, d); the wire is
    ``comm.q_all_gather`` (the codes; the targets are gathered as they
    are), each rank solves its dense view (its block exact and first) and
    the per-point predictives are KL-fused (eqs. 62-64).  Fixed hypers, no
    training, no artifact — the reference's original mesh prototype; the
    first-class path is ``fit`` with ``impl="mesh"``.  Returns the fused
    (mean, var) on every rank."""
    from ..fusion import kl_fuse_diag

    idx = C.group_rank(group)
    k = gram_fn(kernel)
    X = torch.as_tensor(X, dtype=torch.float32)
    X_star = torch.as_tensor(X_star, dtype=torch.float32, device=X.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=X.device)
    params = params_on(params, X.device)
    blocks = q_all_gather(X, group, bits_per_sample, max_bits)  # (m, n_loc, d)
    y_all = C.all_gather(y, group)
    m = blocks.shape[0]
    order = [idx] + [j for j in range(m) if j != idx]
    Xv = blocks[order].reshape(-1, X.shape[1])
    yv = y_all[order].reshape(-1)
    g_ss = torch.diagonal(k(params, X_star, X_star))
    mu_i, s2_i = posterior_from_gram(k(params, Xv), k(params, X_star, Xv), g_ss, yv,
                                     torch.exp(params.log_noise))
    return kl_fuse_diag(C.all_gather(mu_i, group), C.all_gather(s2_i, group))


# --------------------------------------------------------------------------
# the impl="mesh" program contracts: broadcast and poe serve on the mesh;
# center artifacts are whole on every rank and keep the batched contract
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

# the fused serve epilogue is ONE all-reduce of the moment rows, the single
# collective the §4 wire model allows at serve time; more means a multi-
# reduce epilogue or an unaccounted channel
_MESH_SERVE_CONTRACT = Contract(
    name="mesh-serve",
    rules=(
        forbid_primitives(),
        NoHostCallbacks(),
        CollectiveBudget(max_count=1),
        NoShardingLeak(max_devices=1, allow_prefixes=_MESH_SHARDED_LEAVES),
        LedgerAccounting(),
    ),
)
_MESH_UPDATE_CONTRACT = Contract(
    name="mesh-update",
    rules=(
        NoShardingLeak(max_devices=1, allow_prefixes=_MESH_SHARDED_LEAVES),
        LedgerAccounting(),
    ),
)
for _protocol in ("broadcast", "poe"):
    register_contract(_protocol, "predict", _MESH_SERVE_CONTRACT, impl="mesh")
    register_contract(_protocol, "update", _MESH_UPDATE_CONTRACT, impl="mesh")
del _protocol
