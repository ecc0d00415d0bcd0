"""Shared machinery of the §5 protocols — counterpart of
``repro/core/protocols/base.py``.

* the padded-shard layout every batched stage runs on (:class:`PaddedShards`),
* the wire state (:class:`WireState`, :class:`WireRun`),
* the fit-time fault injection (:func:`_apply_fit_faults`) and the
  degraded-serving report (:class:`ServeHealth`, :func:`serve_health`),
* the serving artifact (:class:`FittedProtocol`, :class:`StreamState`) and
  its :func:`fit` / :func:`predict` / :func:`save_artifact` /
  :func:`load_artifact` lifecycle,
* :func:`artifact_from_arrays`, which builds an artifact from the arrays of
  a checkpoint written by either package (keys as in the reference's npz:
  ``params/…``, ``y``, ``factors/…``, ``data/…``, ``wire/…``, ``stream/…``).

Artifacts are dataclasses of tensors on one device (``art.device``);
:func:`predict` serves on that device, optionally with a machine
availability mask (``available=``) that the fusing protocols renormalize
over, :func:`serve_health` reports what such a request degrades to, and
:func:`update` streams new points in and returns a new artifact.
Checkpoints are format v6, and checkpoints of every older format load.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import operator
import warnings

import numpy as np
import torch

from ...faults import apply_to_parts
from ..gp import GPParams, prior_diag
from ..registry import PROTOCOLS, SCHEMES
from ..torch_scheme import words_from_uint32, words_to_uint32
from .streaming import ensure_capacity, update_growth_count

__all__ = [
    "split_machines",
    "pad_parts",
    "PaddedShards",
    "WireState",
    "WireRun",
    "ServeHealth",
    "serve_health",
    "StreamState",
    "FittedProtocol",
    "fit",
    "predict",
    "update",
    "update_growth_count",
    "save_artifact",
    "load_artifact",
    "artifact_arrays",
    "artifact_from_arrays",
    "resolve_device",
    "params_on",
    "predict_op_counts",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Without CUDA, asking for it raises — nothing carries on
    quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default and no CUDA device "
            "is available; pass device=\"cpu\" to run on the CPU"
        )
    return device


def params_on(params, device):
    """Starting hyperparameters as float32 tensors on ``device``; None
    stays None (``train_gp`` then starts from its defaults)."""
    if params is None:
        return None
    return GPParams(*(torch.as_tensor(a, dtype=torch.float32, device=device)
                      for a in params))


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def parts_on(parts, device):
    """Per-machine ``(X_j, y_j)`` shards (numpy or tensors) as float32
    tensors on ``device`` (copies: the caller's arrays stay untouched)."""
    to = lambda a: torch.as_tensor(np.array(_numpy(a), np.float32), device=device)
    return [(to(X), to(y)) for X, y in parts]


def split_machines(X, y, m: int, generator: torch.Generator | None = None):
    """Random uniform split across m machines (paper §6), drawn from
    ``generator`` (seed 0 when None).  The permutation is torch's, so it
    differs from the reference's ``jax.random`` split: parity tests pass
    the same ``parts`` to both packages instead."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    X, y = _numpy(X), _numpy(y)
    perm = torch.randperm(X.shape[0], generator=generator).numpy()
    return [(X[c], y[c]) for c in np.array_split(perm, m)]


class PaddedShards(collections.namedtuple("PaddedShards", "X y mask lengths")):
    """(m, n_pad, d) machine shards; invalid rows are zero with mask 0.
    ``lengths`` holds the per-machine true row counts (python ints)."""

    __slots__ = ()


def pad_parts(parts, device=None) -> PaddedShards:
    """Stack per-machine ``(X_j, y_j)`` shards (numpy or tensors) into
    zero-padded float32 tensors on ``device``."""
    m = len(parts)
    d = _numpy(parts[0][0]).shape[1]
    lengths = tuple(int(_numpy(p[0]).shape[0]) for p in parts)
    n_pad = max(lengths)
    X = np.zeros((m, n_pad, d), np.float32)
    y = np.zeros((m, n_pad), np.float32)
    mask = np.zeros((m, n_pad), np.float32)
    for j, (Xj, yj) in enumerate(parts):
        X[j, : lengths[j]] = _numpy(Xj)
        y[j, : lengths[j]] = _numpy(yj)
        mask[j, : lengths[j]] = 1.0
    to = lambda a: torch.from_numpy(a).to(device)
    return PaddedShards(to(X), to(y), to(mask), lengths)


def _mask_gram(G, mask):
    """Zero padded rows/cols and pin their diagonal to 1 so the Cholesky
    stays SPD.  A point with k(., pad) = 0 and y_pad = 0 contributes
    nothing to the posterior, so the padded program answers as the
    unpadded one.  Batched over leading axes."""
    return G * (mask[..., :, None] * mask[..., None, :]) + torch.diag_embed(1.0 - mask)


@dataclasses.dataclass
class WireState:
    """Everything the wire protocol produced, for every machine at once.

    codes (m, n_pad, W) int32 — the PACKED words (uint32 bit patterns,
    ``torch_scheme.pack_codes``; padded rows are all-zero words); decoded
    (m, n_pad, d) reconstructions (padded rows zero); T_inv (m, d, d);
    rates (m, d) int32; sigma (m, d); scaled_cents (m, d, C) qgram decode
    tables; T (m, d, d).  The field order is the checkpoint's key order."""

    codes: torch.Tensor
    decoded: torch.Tensor
    T_inv: torch.Tensor
    rates: torch.Tensor
    sigma: torch.Tensor
    scaled_cents: torch.Tensor
    T: torch.Tensor


class WireRun(collections.namedtuple(
    "WireRun",
    "state wire_bits payload_bits integrity_bits extras shards rows_demoted",
)):
    """What one ``SchemeSpec.run`` produced: the :class:`WireState`, the
    three integer ledgers (Theorem-1 ``wire_bits``, packed ``payload_bits``,
    CRC ``integrity_bits``: all charged for what was TRANSMITTED, before any
    demotion), the scheme's ``extras`` (arrays that ride in the artifact's
    ``data``: the vq channel state), the :class:`PaddedShards` the protocol
    assembles from (under a fault plan's flips, each machine's
    CRC-surviving rows compacted to the front, lengths and mask shrunk to
    match) and ``rows_demoted``, the transmitted rows the receiver's CRC
    check rejected."""

    __slots__ = ()


@dataclasses.dataclass
class StreamState:
    """The mutable counters of an artifact, as int32 tensors: per-machine
    row counts ``counts`` (m,), occupied columns ``cols`` and the three
    ledgers plus ``rows_demoted`` (scalars).  ``update`` (slice 3) extends
    them; checkpoints carry them as ``stream/*``."""

    counts: torch.Tensor
    cols: torch.Tensor
    wire_bits: torch.Tensor
    payload_bits: torch.Tensor
    integrity_bits: torch.Tensor
    rows_demoted: torch.Tensor

    @classmethod
    def make(cls, counts, cols, wire_bits=0, payload_bits=0,
             integrity_bits=0, rows_demoted=0, device=None) -> "StreamState":
        i32 = lambda v: torch.as_tensor(np.asarray(v, np.int32), device=device)
        return cls(
            counts=i32(counts), cols=i32(cols), wire_bits=i32(wire_bits),
            payload_bits=i32(payload_bits), integrity_bits=i32(integrity_bits),
            rows_demoted=i32(rows_demoted),
        )


@dataclasses.dataclass
class FittedProtocol:
    """The serving artifact, as in the reference: ``params`` (trained
    :class:`~repro_torch.core.gp.GPParams`), ``y`` (targets in the
    center's column layout), ``factors`` (cached solve factors — the
    Nyström ``L_KK``/``W``/``L_M``/``alpha`` and, for the fused serve
    epilogue, ``Ainv``/``U``/``walpha``), ``data`` (``Xc``, ``X_recon``,
    ``sq_cols``, ``sq_exact``, ``valid``), ``wire`` (:class:`WireState`),
    ``stream`` (:class:`StreamState`) and the static metadata that the
    checkpoint's ``meta.json`` records."""

    params: GPParams
    y: torch.Tensor
    factors: dict
    data: dict
    wire: WireState | None
    stream: StreamState
    protocol: str
    kernel: str
    gram_mode: str
    fuse: str
    gram_backend: str
    n_center: int
    fit_lengths: tuple
    block_order: tuple | None
    bits_per_sample: int
    max_bits: int
    impl: str = "batched"
    scheme: str = "per_symbol"
    config: object | None = None

    @property
    def device(self) -> torch.device:
        return self.y.device

    @functools.cached_property
    def fit_availability(self):
        """The mask :func:`predict` derives when given none: (m,) float32
        on the artifact's device, 0 for each machine whose fit-time shard
        was empty, or ``None`` when every machine served rows.
        ``fit_lengths`` never change, so it is built once per artifact,
        on the device from the lost indices (a request copies nothing
        from the host)."""
        if all(n > 0 for n in self.fit_lengths):
            return None
        idx = torch.arange(len(self.fit_lengths), device=self.device)
        alive = torch.ones(len(self.fit_lengths), dtype=torch.bool, device=self.device)
        for j, n in enumerate(self.fit_lengths):
            if n == 0:
                alive &= idx != j
        return alive.to(torch.float32)

    @property
    def lengths(self) -> tuple:
        return tuple(int(v) for v in self.stream.counts.tolist())

    @property
    def wire_bits(self) -> int:
        return int(self.stream.wire_bits)

    @property
    def payload_bits(self) -> int:
        return int(self.stream.payload_bits)

    @property
    def integrity_bits(self) -> int:
        return int(self.stream.integrity_bits)

    @property
    def rows_demoted(self) -> int:
        return int(self.stream.rows_demoted)

    def predict(self, X_star, available=None):
        """Serve one query batch from the cached factors — see :func:`predict`."""
        return predict(self, X_star, available)

    def health(self, available=None) -> "ServeHealth":
        """Degradation status of this artifact — see :func:`serve_health`."""
        return serve_health(self, available)

    def update(self, X_new, y_new, machine: int = 0) -> "FittedProtocol":
        """Stream in new points — see :func:`update`."""
        return update(self, X_new, y_new, machine)


def _apply_fit_faults(parts, cfg):
    """Dataset-level fault injection at fit entry (drop and NaN shards of
    ``cfg.faults``, on numpy copies of ``parts``) and the guards that keep
    the remaining fleet trainable: the §5.1 center and the broadcast/poe
    training machine (machine 0) must survive; predict-time availability
    masks serve arbitrary machine loss.  Returns ``(parts, rows_removed)``
    (``parts`` untouched without a plan)."""
    plan = cfg.faults
    if plan is None:
        return parts, 0
    new_parts, removed = apply_to_parts(
        [(_numpy(X), _numpy(y)) for X, y in parts], plan)
    _check_fit_lengths([int(p[0].shape[0]) for p in new_parts], cfg)
    return new_parts, removed


def _check_fit_lengths(lengths, cfg):
    """The guards of :func:`_apply_fit_faults` on the surviving row counts."""
    if not any(lengths):
        raise ValueError(
            "fault plan removed every row from every machine — nothing to fit"
        )
    if cfg.protocol == "center" and lengths[cfg.center] == 0:
        raise ValueError(
            f"fault plan emptied the center machine ({cfg.center}) — the "
            "§5.1 protocol cannot fit without its exact block; drop a "
            "non-center machine or serve an old artifact degraded instead"
        )
    if cfg.protocol in ("broadcast", "poe") and lengths[0] == 0:
        raise ValueError(
            "fault plan emptied machine 0, where broadcast/poe train their "
            "hyperparameters — drop a different machine (prediction-time "
            "availability masks handle arbitrary loss)"
        )


def _refuse_host_flips(cfg):
    """The ``impl="host"`` oracles have no packed plane to corrupt: a plan
    with bit flips is refused there (its data faults apply)."""
    if cfg.faults is not None and cfg.faults.flip_rate > 0.0:
        raise NotImplementedError(
            "wire corruption (flip_rate) needs the packed code plane — the "
            'host oracle has none; use impl="batched"'
        )


def fit(parts, cfg, params: GPParams | None = None, device=None):
    """Run the configured protocol once on ``device`` (the card when None)
    and return the serving artifact (the engine under
    ``DistributedGP.fit``).  ``impl="host"`` returns the protocol's serial
    oracle model instead (same ``.predict`` surface, no artifact).
    ``impl="mesh"`` runs on every rank of a process group of one rank per
    machine, each calling ``fit`` with the same arguments (:mod:`.mesh`)."""
    spec = PROTOCOLS.get(cfg.protocol)
    if cfg.impl == "mesh":
        from .mesh import machine_group

        machine_group(len(parts))  # one rank per machine, or raise
    if cfg.impl == "host":
        if spec.fit_host is None:
            raise NotImplementedError(f"protocol {cfg.protocol!r} has no host oracle")
        return spec.fit_host(parts, cfg, params, resolve_device(device))
    return spec.fit(parts, cfg, params, resolve_device(device))


def _availability(art: FittedProtocol, available):
    """Normalize a machine-availability mask to an (m,) float32 tensor on
    the artifact's device, or ``None`` for the all-alive path.  ``None`` in
    means "derive from the artifact": machines whose fit-time shards were
    empty are marked down."""
    m = len(art.fit_lengths)
    if available is None:
        return art.fit_availability
    if isinstance(available, torch.Tensor):
        av = available.to(device=art.device, dtype=torch.float32).reshape(-1)
    else:
        av = torch.from_numpy(np.asarray(available, np.float32).reshape(-1)).to(art.device)
    if av.shape[0] != m:
        raise ValueError(
            f"available mask has {av.shape[0]} entries for m={m} machines"
        )
    return (av > 0).to(torch.float32)


def predict(art: FittedProtocol, X_star, available=None):
    """Serve one query batch from a fitted artifact: (mean, var) at X_star,
    on the artifact's device, from the cached factors only.

    ``available``: optional (m,) machine-availability mask (1 = alive) for
    degraded serving — the broadcast/PoE fusions renormalize over the
    surviving experts; the center serves its factor set regardless (it
    holds everything).  ``None`` derives the mask from the artifact.

    Tripwire: non-finite query rows are zeroed before the kernel map (one
    NaN row would otherwise poison the batch) and answered with the prior
    predictive; for finite inputs every select is an identity."""
    X_star = torch.as_tensor(X_star, dtype=torch.float32, device=art.device)
    return _predict_impl(art, X_star, _availability(art, available))


def _uses_mesh_predict(art: FittedProtocol) -> bool:
    """Broadcast and poe mesh artifacts serve on the mesh (each rank its
    expert, one all-reduce); a mesh center artifact is whole on every rank
    and serves locally."""
    return art.impl == "mesh" and art.protocol in ("broadcast", "poe")


def _predict_impl(art: FittedProtocol, X_star, avail=None):
    """:func:`predict` after the availability mask is normalized (``avail``
    an (m,) float32 tensor or None): the fleet serves each gathered tenant
    row through this, a mesh artifact its collective serve."""
    p = art.params
    noise = torch.exp(p.log_noise)
    finite_row = torch.isfinite(X_star).all(dim=-1)
    Xq = torch.where(finite_row[:, None], X_star, torch.zeros_like(X_star))
    sq_star = torch.sum(Xq**2, -1)
    g_ss = prior_diag(art.kernel, p, sq_star)
    if _uses_mesh_predict(art):
        from .mesh import predict_mesh as serve
    else:
        serve = PROTOCOLS.get(art.protocol).predict
    mu, var = serve(art, Xq, sq_star, g_ss, noise, avail)
    ok = finite_row & torch.isfinite(mu) & torch.isfinite(var)
    mu = torch.where(ok, mu, torch.zeros_like(mu))
    var = torch.where(ok, var, g_ss + noise)  # degrade to the prior, not NaN
    return mu, var


@dataclasses.dataclass(frozen=True)
class ServeHealth:
    """Degradation status of a serving artifact — what :func:`predict` is
    working with, instead of NaNs.

    status : ``"ok"`` (full fleet, nothing demoted) or ``"degraded"``.
    machines / machines_lost : fleet size and the indices serving no rows
        (dropped at fit time or masked out by the availability argument).
    rows_demoted : transmitted rows the receiver's CRC check rejected.
    variance_inflation : the factor the KL barycenter's survivor
        renormalization applies to the fused variance (``m / m_alive``);
        1.0 for the precision-weighted PoE-family fusions (their variance
        widens by itself as experts leave) and for the center protocol."""

    status: str
    machines: int
    machines_lost: tuple
    rows_demoted: int
    variance_inflation: float


def serve_health(art: FittedProtocol, available=None) -> ServeHealth:
    """Report what :func:`predict` degrades to under the given availability
    (``None`` = derived from the artifact, as in :func:`predict`)."""
    m = len(art.fit_lengths)
    avail = _availability(art, available)
    alive = [True] * m if avail is None else [a > 0 for a in avail.tolist()]
    lost = tuple(j for j in range(m) if not alive[j] or art.fit_lengths[j] == 0)
    n_alive = m - len(lost)
    demoted = art.rows_demoted
    inflation = 1.0
    if lost and art.protocol in ("broadcast", "poe") and art.fuse == "kl" and n_alive > 0:
        inflation = m / n_alive
    return ServeHealth(
        status="ok" if not lost and demoted == 0 else "degraded", machines=m,
        machines_lost=lost, rows_demoted=demoted, variance_inflation=inflation,
    )


# --------------------------------------------------------------------------
# update: streaming append by rank-k factor growth
# --------------------------------------------------------------------------


def _machine_index(machine, m: int) -> int:
    """The update's machine index as a python int in [0, m): an int or a
    0-d integer tensor (the reference traces it; here both are the same
    thing)."""
    j = operator.index(machine.item() if isinstance(machine, torch.Tensor) else machine)
    if not 0 <= j < m:
        raise ValueError(f"machine {j} out of range (m={m})")
    return j


def update(art: FittedProtocol, X_new, y_new, machine: int = 0) -> FittedProtocol:
    """Stream (X_new, y_new) arriving at ``machine`` into a fitted artifact.

    The fit-once economics: machine ``machine``'s FROZEN scheme state (the
    codebooks and decorrelating transform of the fit) re-encodes only the
    new rows, and the ledgers are charged the frozen rate — no scheme
    refit, no new side info.  The cached factors then grow by rank-k
    updates (``nystrom.chol_update_rank`` for the Nyström woodbury core,
    ``nystrom.chol_append_at`` for dense factors), written at the
    occupied-column cursor of the capacity-padded buffers
    (:mod:`.streaming`), which grow only when a batch crosses a bucket's
    edge.  Returns a NEW artifact; the input's tensors are unchanged.

    Center: points landing on the center are exact and cost 0 bits (the
    rank-K Nyström basis stays fixed either way).  Broadcast: ``nystrom``
    views only.  PoE: the points extend ``machine``'s expert (zero rate).
    A machine that transmitted no rows at fit time has no frozen codebooks
    and is refused.  Rows with a NaN or Inf are dropped with a warning; a
    batch with no rows left returns ``art`` itself.  Under a fault plan
    with bit flips the batch is corrupted on the wire like a fit-time one:
    CRC-failing new rows are demoted, the whole transmission is charged.
    A mesh artifact is updated by every rank with the same arguments; only
    rank ``machine`` reads the batch (:func:`.mesh.update_mesh`)."""
    m = len(art.fit_lengths)
    X_new = torch.as_tensor(X_new, dtype=torch.float32, device=art.device)
    y_new = torch.as_tensor(y_new, dtype=torch.float32, device=art.device)
    if X_new.dim() != 2 or y_new.dim() != 1 or y_new.shape[0] != X_new.shape[0]:
        raise ValueError("update expects X_new (n_new, d), y_new (n_new,)")
    j = _machine_index(machine, m)
    if art.fit_lengths[j] == 0:
        raise ValueError(
            f"machine {j} transmitted no rows at fit time (dropped or fully "
            "demoted) — it has no frozen codebooks to stream under; route the "
            "batch to a surviving machine or refit"
        )
    if art.impl == "mesh":
        from .mesh import update_mesh

        return update_mesh(art, X_new, y_new, j)
    # a NaN/Inf point would poison the factor growth and every later
    # predict: drop hostile rows, loudly
    finite = torch.isfinite(X_new).all(dim=1) & torch.isfinite(y_new)
    if not bool(finite.all()):
        warnings.warn(
            f"update(): dropping {int((~finite).sum())} non-finite point(s) of "
            f"{finite.numel()} (machine {j})", stacklevel=2,
        )
        X_new, y_new = X_new[finite], y_new[finite]
    if X_new.shape[0] == 0:
        return art  # nothing to append, nothing to charge
    prepared = _prepare_update(art, X_new, y_new, j)
    if isinstance(prepared, FittedProtocol):
        return prepared  # every transmitted row was demoted: ledgers only
    X_new, y_new, pre = prepared
    art = ensure_capacity(art, X_new.shape[0])
    return PROTOCOLS.get(art.protocol).update(art, X_new, y_new, j, pre)


def _prepare_update(art: FittedProtocol, X_new, y_new, machine: int):
    """What the receiving side sees of the batch: ``(X_new, y_new, pre)``
    with ``pre`` ``None`` for poe's zero-rate experts (nothing crosses the
    wire), else ``(decoded, wire_add, payload_add, integrity_add,
    demoted_add)`` — the center's own points exact and free, a transmitting
    machine's through its scheme's ``reencode`` (plus ``nystrom_fitc``'s
    32-bit exact-|x|^2 side channel per transmitted row).  Under a fault
    plan with bit flips the batch crosses the scheme's corrupting channel
    (``update_corrupt``): only the CRC-surviving rows go on, the ledgers
    are charged the whole batch, and when no row survives a NEW artifact
    with only the ledgers and the demotion count bumped is returned."""
    n_new = X_new.shape[0]
    center = art.block_order[0] if art.block_order else 0
    if art.protocol == "center" and machine == center:
        return X_new, y_new, (X_new, 0, 0, 0, 0)  # local and exact
    if art.wire is None or art.protocol == "poe":
        return X_new, y_new, None
    spec = SCHEMES.get(art.scheme)
    side = 32 * n_new if (art.protocol == "center"
                          and art.gram_mode == "nystrom_fitc") else 0
    plan = art.config.faults if art.config is not None else None
    if plan is not None and plan.flip_rate > 0.0 and spec.update_corrupt is not None:
        keep, decoded, w_add, p_add, i_add, demoted = spec.update_corrupt(
            art, machine, X_new, plan)
        if keep.numel() == 0:
            # the receiver kept nothing, but the bits moved: charge them
            s = art.stream
            return dataclasses.replace(art, stream=dataclasses.replace(
                s, wire_bits=s.wire_bits + w_add + side,
                payload_bits=s.payload_bits + p_add + side,
                integrity_bits=s.integrity_bits + i_add,
                rows_demoted=s.rows_demoted + demoted,
            ))
        return X_new[keep], y_new[keep], (decoded, w_add + side, p_add + side, i_add,
                                          demoted)
    r = spec.reencode(art, machine, X_new)
    return X_new, y_new, (r.decoded, r.wire_bits + side, r.payload_bits + side,
                          r.integrity_bits, 0)


def _grow_stream(s: StreamState, machine: int, n_new: int, wire=0, payload=0,
                 integrity=0, demoted=0) -> StreamState:
    """The stream state after ``n_new`` rows arrived at ``machine`` (new
    tensors; ``s`` is unchanged)."""
    counts = s.counts.clone()
    counts[machine] += n_new
    return StreamState(counts, s.cols + n_new, s.wire_bits + wire,
                       s.payload_bits + payload, s.integrity_bits + integrity,
                       s.rows_demoted + demoted)


# --------------------------------------------------------------------------
# persistence: the reference's npz + meta.json layout
# --------------------------------------------------------------------------


def artifact_arrays(art: FittedProtocol) -> dict:
    """{key: numpy array} of an artifact, keyed and typed as the
    reference's checkpoint (dict keys sorted, the word plane as uint32)."""
    out = {f"params/{f}": _numpy(getattr(art.params, f)) for f in GPParams._fields}
    out["y"] = _numpy(art.y)
    for group in ("factors", "data"):
        d = getattr(art, group)
        out.update({f"{group}/{k}": _numpy(d[k]) for k in sorted(d)})
    if art.wire is not None:
        for f in dataclasses.fields(WireState):
            v = getattr(art.wire, f.name)
            out[f"wire/{f.name}"] = (
                words_to_uint32(v) if f.name == "codes" else _numpy(v)
            )
    for f in dataclasses.fields(StreamState):
        out[f"stream/{f.name}"] = _numpy(getattr(art.stream, f.name))
    return out


def save_artifact(art: FittedProtocol, directory: str, step: int = 0) -> str:
    """Checkpoint an artifact in the reference's format v6: the npz of
    :func:`artifact_arrays` plus ``meta_*.json`` with the static metadata,
    the config and a CRC32 per array; the reference's ``load_artifact``
    reads it.  A mesh artifact is saved by every rank together: the
    machines' factors are gathered, rank 0 writes, and every rank returns
    once the files are in place."""
    if art.impl == "mesh":
        from ...comm import collectives as C
        from .mesh import gather_artifact

        whole = gather_artifact(art)
        path = _write_artifact(whole, directory, step) if C.group_rank() == 0 else None
        C.barrier()
        return C.share(path, 0)
    return _write_artifact(art, directory, step)


def _write_artifact(art: FittedProtocol, directory: str, step: int) -> str:
    from ...checkpoint import save_artifact as _save
    from ..config import ARTIFACT_FORMAT_VERSION

    cfg = art.config
    meta = {
        "format_version": ARTIFACT_FORMAT_VERSION,
        "protocol": art.protocol, "kernel": art.kernel,
        "gram_mode": art.gram_mode, "fuse": art.fuse,
        "gram_backend": art.gram_backend, "n_center": art.n_center,
        "lengths": list(art.lengths),
        "fit_lengths": list(art.fit_lengths),
        "block_order": list(art.block_order) if art.block_order is not None else None,
        "bits_per_sample": art.bits_per_sample, "max_bits": art.max_bits,
        "wire_bits": art.wire_bits, "has_wire": art.wire is not None,
        "payload_bits": art.payload_bits,
        "integrity_bits": art.integrity_bits,
        "rows_demoted": art.rows_demoted,
        "impl": art.impl,
        "scheme": art.scheme,
        "config": cfg.asdict() if cfg is not None else None,
    }
    return _save(directory, step, artifact_arrays(art), meta)


def _pack_legacy_wire(codes: np.ndarray, rates, meta: dict, device) -> torch.Tensor:
    """A pre-v3 checkpoint's unpacked int32 code plane (m, n_pad, d), -1 on
    padded rows, as the packed word plane of a fresh fit (-1 rows pack to
    zero words); vq never had codes and gets zero words."""
    from ...comm.accounting import row_bits
    from ..torch_scheme import pack_codes

    m, n_pad, d = codes.shape
    if meta.get("scheme", "per_symbol") == "vq":
        return torch.zeros((m, n_pad, 0), dtype=torch.int32, device=device)
    total = row_bits(meta["bits_per_sample"], d, meta["max_bits"])
    return pack_codes(torch.from_numpy(np.array(codes, copy=True)).to(device), rates,
                      total_bits=total)


def artifact_from_arrays(meta: dict, arrays: dict, device=None) -> FittedProtocol:
    """Build the port's artifact on ``device`` from a checkpoint's ``meta``
    and its arrays (numpy, keyed as in the reference's npz) — a checkpoint
    of either package, of any format version the reference loads:

    * v1 (no ``config`` block): the config is rebuilt by
      :meth:`DGPConfig.from_legacy_meta`;
    * before v3 (unpacked int32 codes): the codes are packed as a fit
      packs them;
    * before v5 (no ``stream/*``): the stream state is made from the json's
      counts and ledgers (``payload_bits`` before v3 and ``integrity_bits``
      before v4 were not recorded: 0), center artifacts get their all-live
      ``valid`` mask, and poe's streamed extras (``X_extra``,
      ``extra_mask``, ``y_extra``) are folded into the experts' columns.

    This is the one place where state of the reference crosses into the
    port."""
    from ..config import ARTIFACT_FORMAT_VERSION, DGPConfig

    version = meta.get("format_version", 1)
    if version > ARTIFACT_FORMAT_VERSION:
        raise ValueError(
            f"artifact format version {version} is newer than this code "
            f"supports ({ARTIFACT_FORMAT_VERSION})"
        )
    protocol = meta["protocol"]
    PROTOCOLS.get(protocol)  # raises for a protocol not ported yet
    device = resolve_device(device)

    def put(key):
        return torch.from_numpy(np.array(arrays[key], copy=True)).to(device)

    params = GPParams(*(put(f"params/{f}") for f in GPParams._fields))
    group = lambda g: {
        k.split("/", 1)[1]: put(k) for k in sorted(arrays) if k.startswith(g + "/")
    }
    factors, data = group("factors"), group("data")
    wire = None
    if meta["has_wire"]:
        wire = WireState(*(
            None if f.name == "codes" else put(f"wire/{f.name}")
            for f in dataclasses.fields(WireState)
        ))
        codes = arrays["wire/codes"]
        wire.codes = (words_from_uint32(codes, device) if codes.dtype == np.uint32
                      else _pack_legacy_wire(codes, wire.rates, meta, device))
    cfg = meta.get("config")
    config = DGPConfig.from_dict(cfg) if cfg else DGPConfig.from_legacy_meta(meta)
    config = dataclasses.replace(config, impl="batched")
    y = put("y")
    stream_keys = [f"stream/{f.name}" for f in dataclasses.fields(StreamState)]
    if all(k in arrays for k in stream_keys):
        stream = StreamState(*(put(k) for k in stream_keys))
    else:
        cols = y.shape[-1] if protocol == "poe" else y.shape[0]
        if "X_extra" in data:
            cols += data["X_extra"].shape[0]
        stream = StreamState.make(
            meta["lengths"], cols, meta["wire_bits"], meta.get("payload_bits", 0),
            meta.get("integrity_bits", 0), meta.get("rows_demoted", 0), device=device,
        )
    if protocol == "center" and "valid" not in data:
        data["valid"] = torch.ones_like(y)
    if protocol == "poe" and "X_extra" in data:
        # the dense factors already hold the [n_pad | extras] column order
        Xe, em, ye = data.pop("X_extra"), data.pop("extra_mask"), data.pop("y_extra")
        m = em.shape[0]
        y = torch.cat([y, ye[None, :] * em], dim=1)
        data["Xs"] = torch.cat([data["Xs"], Xe[None].expand(m, -1, -1)], dim=1)
        data["mask"] = torch.cat([data["mask"], em], dim=1)
        sq_e = torch.sum(Xe**2, -1)
        data["sq_exact"] = torch.cat([data["sq_exact"], sq_e[None].expand(m, -1)], dim=1)
    return FittedProtocol(
        params=params, y=y, factors=factors, data=data, wire=wire,
        stream=stream, protocol=protocol, kernel=meta["kernel"],
        gram_mode=meta["gram_mode"], fuse=meta["fuse"],
        gram_backend=meta["gram_backend"], n_center=meta["n_center"],
        fit_lengths=tuple(meta.get("fit_lengths", meta["lengths"])),
        block_order=(tuple(meta["block_order"])
                     if meta["block_order"] is not None else None),
        bits_per_sample=meta["bits_per_sample"], max_bits=meta["max_bits"],
        impl="batched", scheme=meta.get("scheme", "per_symbol"), config=config,
    )


def load_artifact(directory: str, step: int | None = None, device=None) -> FittedProtocol:
    """Restore a checkpoint of either package onto ``device`` (its CRC32s
    verified): :func:`artifact_from_arrays` applied to the files.  Always a
    single-process ``impl="batched"`` artifact, a mesh fit's checkpoint too
    (its factors were gathered at save time)."""
    from ...checkpoint import load_artifact_arrays

    device = resolve_device(device)
    meta, arrays = load_artifact_arrays(directory, step)
    return artifact_from_arrays(meta, arrays, device)


def predict_op_counts(art: FittedProtocol, X_star, ops=("cholesky", "eigh")) -> dict:
    """Count factorizations in one :func:`predict` of this artifact — the
    structural serve-path check: a warm predict performs ZERO ``cholesky``
    (no refactorization) and ZERO ``eigh`` (no scheme refit).  ``ops`` are
    the reference's primitive names; each counts the aten ops that perform
    it (``repro_torch.analysis.op_walk.FACTORIZATION_OPS``).  A thin wrapper
    over :func:`repro_torch.analysis.predict_ops`, side-effect-neutral as
    it is."""
    from ...analysis.contracts import predict_ops
    from ...analysis.op_walk import primitive_counts

    return dict(primitive_counts(predict_ops(art, X_star), names=ops))
