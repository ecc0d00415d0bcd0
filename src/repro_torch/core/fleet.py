"""Multi-tenant fleet serving — counterpart of ``repro/core/fleet.py``.

Artifacts fitted under the same :class:`~.config.DGPConfig` at the same
capacity bucket have the same static metadata and the same tensor shapes.
Stacking T of them tensor by tensor gives one tenant-major artifact, and one
batched predict answers a whole mixed-tenant micro-batch:

* :func:`bucket_key` — the homogeneity class: the static metadata plus the
  (key, shape, dtype) of every tensor (keys as in the checkpoint's npz).
  Same key <=> stackable.  :func:`pad_to_capacity` co-buckets artifacts of
  different capacities with the exact pads of :mod:`.protocols.streaming`.
* :class:`FleetStack` — a resident stack with a FIXED slot count and an LRU
  tenant -> row map.  Admitting a tenant writes one row in place
  (``leaf[row].copy_(new)``), so no stacked tensor is ever reallocated
  (:meth:`FleetStack.data_ptrs` shows it); a batch gathers its rows with an
  index tensor.
* Broadcast artifacts on the fused serve route get a TENANT-BATCHED
  epilogue: the query-independent projector P is built once per admit and
  kept resident per slot, the operands of every gathered tenant are built
  in one batched pass (one ``gram`` launch per tenant for the query
  products), and ONE ``epilogue_fleet`` launch reduces every tenant's
  experts into its own moment rows.  Center and poe stacks serve through a
  loop of the single-tenant predict over the gathered rows (batching it is
  later work, ROADMAP.md).
* :class:`ArtifactCache` — LRU over loaded artifacts, capacity in artifacts
  or bytes, loader-on-miss (checkpoint-backed via :class:`ArtifactStore`).
* :class:`ArtifactStore` — a directory of per-tenant checkpoints
  (``root/tenant_<id>/``, the reference's layout and format v6), so a store
  written by either package loads in the other.

The request plane (micro-batching under a latency budget) is
:mod:`repro_torch.launch.fleet`.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import re

import numpy as np
import torch

from .gp import GPParams, kernel_from_inner, prior_diag
from .registry import FUSIONS
from .protocols import base
from .protocols import broadcast as _broadcast
from .protocols import streaming
from .protocols.base import FittedProtocol, StreamState, WireState

__all__ = [
    "bucket_key",
    "artifact_nbytes",
    "pad_to_capacity",
    "scale_targets",
    "stack_artifacts",
    "FleetStack",
    "ArtifactCache",
    "ArtifactStore",
]

_TENSOR_FIELDS = ("params", "y", "factors", "data", "wire", "stream")
_STATIC_FIELDS = tuple(f.name for f in dataclasses.fields(FittedProtocol)
                       if f.name not in _TENSOR_FIELDS)


# --------------------------------------------------------------------------
# flatten / unflatten: the port's stand-in for the reference's pytrees
# --------------------------------------------------------------------------


def _leaves(art: FittedProtocol) -> dict:
    """{key: tensor} of an artifact, keyed as ``base.artifact_arrays`` keys
    the checkpoint (``params/…``, ``y``, ``factors/…``, ``data/…``,
    ``wire/…``, ``stream/…``), without copying."""
    out = {f"params/{f}": getattr(art.params, f) for f in GPParams._fields}
    out["y"] = art.y
    for group in ("factors", "data"):
        d = getattr(art, group)
        out.update({f"{group}/{k}": d[k] for k in sorted(d)})
    for group, cls in (("wire", WireState), ("stream", StreamState)):
        obj = getattr(art, group)
        if obj is not None:
            out.update({f"{group}/{f.name}": getattr(obj, f.name)
                        for f in dataclasses.fields(cls)})
    return out


def _with_leaves(template: FittedProtocol, leaves: dict) -> FittedProtocol:
    """An artifact with ``template``'s static metadata and the tensors of
    ``leaves`` (keyed as :func:`_leaves`)."""
    group = lambda g: {k.split("/", 1)[1]: v for k, v in leaves.items()
                       if k.startswith(g + "/")}
    return dataclasses.replace(
        template,
        params=GPParams(*(leaves[f"params/{f}"] for f in GPParams._fields)),
        y=leaves["y"], factors=group("factors"), data=group("data"),
        wire=None if template.wire is None else WireState(**group("wire")),
        stream=StreamState(**group("stream")),
    )


def _row(stack: FittedProtocol, row: int) -> FittedProtocol:
    """One tenant of a stacked artifact, as views (nothing is copied)."""
    return _with_leaves(stack, {k: v[row] for k, v in _leaves(stack).items()})


# --------------------------------------------------------------------------
# homogeneity: when do artifacts co-batch?
# --------------------------------------------------------------------------


def bucket_key(art: FittedProtocol):
    """The stacking-compatibility class of an artifact: its static metadata
    (protocol, kernel, fusion, config, fit_lengths ...), its device, and
    every tensor's (key, shape, dtype).  Two artifacts share a bucket iff
    their keys compare equal; then their tensors stack into one
    tenant-major artifact.  Hashable, so it keys the server's stack table."""
    static = tuple((name, getattr(art, name)) for name in _STATIC_FIELDS)
    sig = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in _leaves(art).items())
    return static, str(art.device), sig


def artifact_nbytes(art: FittedProtocol) -> int:
    """Device bytes of an artifact's tensors (the unit of the cache's
    byte-capacity accounting)."""
    return sum(v.numel() * v.element_size() for v in _leaves(art).values())


def pad_to_capacity(art: FittedProtocol, capacity: int | None = None) -> FittedProtocol:
    """Pad an artifact's column-growable buffers up to ``capacity``
    (default: the next power of two of its occupied columns) with the EXACT
    pads of :mod:`.protocols.streaming` — zero columns, identity Cholesky
    slots, masked cross-columns — so the padded artifact predicts as the
    unpadded one.  The co-bucketing primitive: a fresh fit (exact-size
    buffers) and one that streamed updates (grown buffers, slice 3) share a
    bucket once both are padded to the same capacity."""
    cols = int(art.stream.cols)
    cap_now = int(art.y.shape[-1])
    target = streaming.next_pow2(cols) if capacity is None else int(capacity)
    if target < cap_now:
        if cap_now == cols and streaming.next_pow2(cols) == cap_now:
            return art  # already exactly at a power-of-two capacity
        raise ValueError(
            f"pad_to_capacity: target {target} is below the artifact's "
            f"current capacity {cap_now} (buffers never shrink)"
        )
    if target == cap_now:
        return art
    return streaming._grow(art, target)


def scale_targets(art: FittedProtocol, c: float) -> FittedProtocol:
    """An EXACT artifact for the target vector ``c * y``: the posterior
    mean operands (``alpha`` and the cached ``walpha``) are linear in y, so
    scaling them gives the artifact a fit on scaled targets at the same
    hyperparameters would give, without paying the fit.  Per-expert
    variances do not depend on y; a moment-matching fusion's combined
    variance shifts with the scaled expert means, as a refit's would.
    Same bucket by construction: only tensor VALUES change."""
    c = float(c)
    factors = dict(art.factors)
    for k in ("alpha", "walpha"):
        if k in factors:
            factors[k] = c * factors[k]
    return dataclasses.replace(art, y=c * art.y, factors=factors)


def stack_artifacts(arts) -> FittedProtocol:
    """Stack homogeneous artifacts tensor by tensor into one tenant-major
    artifact (every tensor gains a leading tenant axis; static metadata is
    shared).  Raises ``ValueError`` naming the first mismatching artifact
    when they are not bucket-compatible."""
    arts = list(arts)
    if not arts:
        raise ValueError("stack_artifacts: need at least one artifact")
    key0 = bucket_key(arts[0])
    for i, a in enumerate(arts[1:], start=1):
        if bucket_key(a) != key0:
            raise ValueError(
                f"stack_artifacts: artifact {i} is not bucket-compatible "
                f"with artifact 0 (different config/protocol metadata or "
                f"leaf shapes — pad_to_capacity() aligns capacity buckets; "
                f"heterogeneous configs need separate stacks)"
            )
    per = [_leaves(a) for a in arts]
    return _with_leaves(arts[0], {k: torch.stack([p[k] for p in per]) for k in per[0]})


# --------------------------------------------------------------------------
# the fleet predict
# --------------------------------------------------------------------------


def _uses_fused(art: FittedProtocol) -> bool:
    """The artifact (single or stacked) serves through the fused epilogue."""
    return art.protocol == "broadcast" and art.impl != "mesh" and \
        _broadcast._uses_fused_epilogue(art, FUSIONS.get(art.fuse))


def _projector(art: FittedProtocol):
    """The woodbury projector P of a single artifact (m, K, K) or of a
    stacked one (slots, m, K, K): the admit-time build of the fused route
    (the reference's ``_projector_jit`` / ``_stack_projector_jit``)."""
    noise = torch.exp(art.params.log_noise)
    return _broadcast._epilogue_projector(art, noise.reshape(noise.shape + (1, 1, 1)))


def _fleet_fused_operands(stack, idx, Xq, avail, proj):
    """The ``epilogue_fleet`` operands of S gathered tenants (rows ``idx``
    of ``stack``, queries ``Xq`` (S, t, d)), built in one batched pass that
    mirrors the sanitize prologue of ``base._predict_impl`` term for term.
    ``proj`` is the stack's resident projector buffer (slots, m, K, K), so
    the per-query solve against ``L_M`` of the single-tenant serve is skipped.
    Returns (finite, noise, G, Ainv, P, walpha, gss, prior, w), the last
    seven contiguous and in the kernel's order."""
    # the rows go up without a stream sync (a warm flush makes none)
    rows = torch.as_tensor(idx, dtype=torch.long).to(Xq.device, non_blocking=True)
    take = lambda a: a.index_select(0, rows)
    p = GPParams(*(take(a) for a in stack.params))  # each (S,)
    noise = torch.exp(p.log_noise)
    finite = torch.isfinite(Xq).all(dim=-1)  # (S, t)
    Xqc = torch.where(finite[..., None], Xq, torch.zeros_like(Xq))
    sq_star = torch.sum(Xqc**2, -1)
    g_ss = prior_diag(stack.kernel, GPParams(*(a[:, None] for a in p)), sq_star)
    # one query product per tenant (each against its own exact shards)
    C = torch.stack([
        _broadcast._star_exact_products(stack.data["Xs"][r], Xqc[s], stack.gram_backend)
        for s, r in enumerate(idx)
    ])  # (S, m, t, n)
    G = kernel_from_inner(
        stack.kernel, GPParams(*(a[:, None, None, None] for a in p)), C,
        sq_star[:, None, :], take(stack.data["sq_exact"]),
    ) * take(stack.data["mask"])[:, :, None, :]
    m = C.shape[1]
    w = torch.ones((len(idx), m), dtype=torch.float32, device=Xq.device) \
        if avail is None else avail
    prior = g_ss + noise[:, None]
    ops = (G, take(stack.factors["Ainv"]), take(proj), take(stack.factors["walpha"]),
           g_ss, prior, w)
    return (finite, noise) + tuple(a.contiguous() for a in ops)


def _fleet_predict_fused(stack, idx, Xq, avail, proj, plan=None):
    """Tenant-batched fused serve: the batched operand build, ONE
    ``epilogue_moments_fleet`` launch for every tenant's experts, and the
    fusion's ``finalize`` over the tenant axis (elementwise).  The
    non-finite tripwire applies per tenant row: a hostile query row
    degrades ITS answer to the prior and touches nothing else.  ``plan``:
    the stack's epilogue plan (None: the pure plan), its expert groups
    re-derived for this flush's tenant count."""
    from ..kernels.epilogue.ops import epilogue_moments_fleet, plan_fleet

    spec = FUSIONS.get(stack.fuse)
    m = len(stack.fit_lengths)
    finite, noise, G, Ainv, P, walpha, g_ss, prior, w = _fleet_fused_operands(
        stack, idx, Xq, avail, proj)
    if plan is not None:
        sms = torch.cuda.get_device_properties(G.device).multi_processor_count
        plan = plan_fleet(len(idx), m, G.shape[2], G.shape[3], sms, tile=plan[:2])
    S = epilogue_moments_fleet(G, Ainv, P, walpha, g_ss, prior, w, fuse=stack.fuse,
                               plan=plan)
    mu, var = spec.finalize(S.transpose(0, 1), m, prior)
    ok = finite & torch.isfinite(mu) & torch.isfinite(var)
    mu = torch.where(ok, mu, torch.zeros_like(mu))
    var = torch.where(ok, var, g_ss + noise[:, None])
    return mu, var


def _fleet_predict_impl(stack, idx, Xq, avail=None, proj=None, plan=None):
    """The fleet serve: answer tenant rows ``idx`` of the stacked artifact
    ``stack`` for queries ``Xq`` (S, t, d); ``avail`` is None or (S, m);
    ``proj`` is the stack's slot-aligned projector buffer on the fused
    route and None elsewhere; ``plan`` the fused route's epilogue plan."""
    if proj is not None:
        return _fleet_predict_fused(stack, idx, Xq, avail, proj, plan)
    outs = [base._predict_impl(_row(stack, r), Xq[s], None if avail is None else avail[s])
            for s, r in enumerate(idx)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


# --------------------------------------------------------------------------
# FleetStack: fixed resident slots, LRU tenant->row map
# --------------------------------------------------------------------------


class FleetStack:
    """A resident capacity bucket of the fleet: ``slots`` stacked artifact
    rows, an LRU ``tenant -> row`` map, and the batched predict over them.

    The slot count is FIXED at construction (a power of two unless given):
    admitting a tenant writes one row in place, evicting is forgetting a map
    entry, and a query batch gathers its rows by index, so no stacked
    tensor is reallocated in the steady state (:meth:`data_ptrs`).  Admits
    run off the hot path (host work per CACHE miss, not per request)."""

    def __init__(self, tenants, slots: int | None = None):
        items = list(tenants.items()) if isinstance(tenants, dict) else list(tenants)
        if not items:
            raise ValueError("FleetStack: need at least one tenant artifact")
        self.key = bucket_key(items[0][1])
        n_slots = streaming.next_pow2(len(items)) if slots is None else int(slots)
        if n_slots < len(items):
            raise ValueError(f"FleetStack: {len(items)} tenants exceed {n_slots} slots")
        # unoccupied slots hold a copy of the first artifact: every row is a
        # VALID artifact, and unaddressed rows are never returned to a caller
        padded = [a for _, a in items]
        padded += [items[0][1]] * (n_slots - len(items))
        self.tree = stack_artifacts(padded)
        self.slots = n_slots
        self.protocol = items[0][1].protocol
        self._rows: "collections.OrderedDict[object, int]" = collections.OrderedDict()
        self._free = list(range(len(items), n_slots))[::-1]
        self.swaps = 0  # admits that evicted a resident tenant
        for row, (tid, _) in enumerate(items):
            if tid in self._rows:
                raise ValueError(f"FleetStack: duplicate tenant id {tid!r}")
            self._rows[tid] = row
        # fused-route stacks keep the query-independent projector resident
        # per slot: one batched build here, one single-artifact build per
        # admit, none per request
        self.fused = _uses_fused(self.tree)
        self._proj = _projector(self.tree).contiguous() if self.fused else None
        self._plans: dict = {}  # t -> the fused route's epilogue plan on the card

    def __contains__(self, tenant) -> bool:
        return tenant in self._rows

    def __len__(self) -> int:
        return len(self._rows)

    def tenants(self) -> tuple:
        """Resident tenant ids, least-recently-used first."""
        return tuple(self._rows)

    def data_ptrs(self) -> dict:
        """{key: data_ptr()} of every stacked tensor (and of the resident
        projector, ``"proj"``): admits and evictions leave it unchanged."""
        out = {k: v.data_ptr() for k, v in _leaves(self.tree).items()}
        if self._proj is not None:
            out["proj"] = self._proj.data_ptr()
        return out

    def admit(self, tenant, art: FittedProtocol) -> int:
        """Make ``tenant`` resident (write its tensors into one slot row)
        and return the row.  A re-admit refreshes the row in place; a full
        stack evicts the least-recently-used tenant."""
        if bucket_key(art) != self.key:
            raise ValueError(
                f"FleetStack.admit({tenant!r}): artifact is not "
                "bucket-compatible with this stack (different config "
                "metadata or leaf shapes; pad_to_capacity() aligns capacity "
                "buckets, heterogeneous configs need their own stack)"
            )
        if tenant in self._rows:
            row = self._rows[tenant]
            self._rows.move_to_end(tenant)
        elif self._free:
            row = self._free.pop()
            self._rows[tenant] = row
        else:
            _, row = self._rows.popitem(last=False)  # evict the LRU tenant
            self._rows[tenant] = row
            self.swaps += 1
        new = _leaves(art)
        for k, leaf in _leaves(self.tree).items():
            leaf[row].copy_(new[k])
        if self._proj is not None:
            self._proj[row].copy_(_projector(art))
        return row

    def touch(self, tenant) -> None:
        """Refresh a resident tenant's LRU recency without rewriting its row
        (raises ``KeyError`` when not resident).  The server touches every
        batch member during grouping so a same-batch admit can never evict a
        co-batched tenant."""
        self._rows.move_to_end(tenant)

    def rows(self, tenants) -> np.ndarray:
        """Slot rows for a tenant batch (touches their LRU recency).  Raises
        ``KeyError`` naming the non-resident tenants."""
        missing = [t for t in tenants if t not in self._rows]
        if missing:
            raise KeyError(
                f"FleetStack: tenants not resident: {missing!r} (admit() "
                "them first — FleetServer does this through its cache)"
            )
        for t in tenants:
            self._rows.move_to_end(t)
        return np.asarray([self._rows[t] for t in tenants], np.int64)

    def _epilogue_plan(self, t: int):
        """The fused route's epilogue plan for requests of t points on the
        card, resolved once for each t through the autotune cache at the
        stack's launch shape (``slots`` tenants, as the reference's
        ``_epilogue_block``) and remembered; None off the fused route or
        off the card."""
        if self._proj is None or self.tree.device.type != "cuda":
            return None
        if t not in self._plans:
            from ..kernels.epilogue.ops import fleet_epilogue_plan

            m = len(self.tree.fit_lengths)
            K = int(self.tree.factors["Ainv"].shape[-1])
            self._plans[t] = fleet_epilogue_plan(self.slots, m, t, K, fuse=self.tree.fuse,
                                                 device=self.tree.device)
        return self._plans[t]

    def predict(self, tenants, Xq, avail=None):
        """Serve one mixed-tenant micro-batch: on the fused route ONE
        ``epilogue_fleet`` launch for all of it.

        ``tenants``: length-S sequence of resident tenant ids (repeats
        allowed); ``Xq``: (S, t, d) per-tenant query batches; ``avail``:
        optional (S, m) per-tenant availability masks (rows of ones = that
        tenant healthy).  Returns (mu, var), each (S, t), on the stack's
        device."""
        idx = self.rows(tenants)
        dev = self.tree.device
        Xq = torch.as_tensor(Xq, dtype=torch.float32, device=dev)
        if Xq.dim() != 3 or Xq.shape[0] != idx.shape[0]:
            raise ValueError(
                f"FleetStack.predict: Xq must be (S, t, d) with "
                f"S == len(tenants) == {idx.shape[0]}, got {tuple(Xq.shape)}"
            )
        if avail is not None:
            avail = (torch.as_tensor(avail, dtype=torch.float32, device=dev) > 0).float()
            m = len(self.tree.fit_lengths)
            if tuple(avail.shape) != (idx.shape[0], m):
                raise ValueError(
                    f"FleetStack.predict: avail must be (S, m) = "
                    f"({idx.shape[0]}, {m}), got {tuple(avail.shape)}"
                )
        return _fleet_predict_impl(self.tree, idx.tolist(), Xq, avail, self._proj,
                                   self._epilogue_plan(int(Xq.shape[1])))


# --------------------------------------------------------------------------
# ArtifactCache: LRU over loaded artifacts, loader-on-miss
# --------------------------------------------------------------------------


class ArtifactCache:
    """LRU cache of loaded serving artifacts with checkpoint-backed
    load-on-miss.

    ``loader(tenant) -> FittedProtocol`` supplies misses (typically
    :meth:`ArtifactStore.load`); capacity is bounded in ARTIFACTS
    (``capacity``), BYTES (``capacity_bytes``, via :func:`artifact_nbytes`),
    or both — eviction drops least-recently-used entries until both bounds
    hold.  A single artifact larger than the byte budget is kept (capacity
    bounds the cache, it does not refuse service).  Hit/miss/eviction
    counters give the server's hit rate."""

    def __init__(self, loader, capacity: int | None = None,
                 capacity_bytes: int | None = None):
        self._loader = loader
        self.capacity = None if capacity is None else int(capacity)
        self.capacity_bytes = None if capacity_bytes is None else int(capacity_bytes)
        if self.capacity is not None and self.capacity < 1:
            raise ValueError("ArtifactCache: capacity must be >= 1")
        self._items: "collections.OrderedDict[object, FittedProtocol]" = \
            collections.OrderedDict()
        self._nbytes: dict = {}
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __contains__(self, tenant) -> bool:
        return tenant in self._items

    def __len__(self) -> int:
        return len(self._items)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def get(self, tenant) -> FittedProtocol:
        """The cached artifact for ``tenant``; a miss pays one loader call
        (checkpoint restore) and may evict LRU entries."""
        art = self._items.get(tenant)
        if art is not None:
            self.hits += 1
            self._items.move_to_end(tenant)
            return art
        self.misses += 1
        art = self._loader(tenant)
        self.put(tenant, art)
        return art

    def put(self, tenant, art: FittedProtocol) -> None:
        """Insert/refresh an entry, then evict LRU entries until the
        artifact- and byte-capacity bounds both hold."""
        if tenant in self._items:
            self.total_bytes -= self._nbytes.pop(tenant)
            del self._items[tenant]
        nb = artifact_nbytes(art)
        self._items[tenant] = art
        self._nbytes[tenant] = nb
        self.total_bytes += nb
        while len(self._items) > 1 and (
            (self.capacity is not None and len(self._items) > self.capacity)
            or (self.capacity_bytes is not None and self.total_bytes > self.capacity_bytes)
        ):
            old, _ = self._items.popitem(last=False)
            self.total_bytes -= self._nbytes.pop(old)
            self.evictions += 1

    def stats(self) -> dict:
        return {
            "entries": len(self._items),
            "bytes": self.total_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }


# --------------------------------------------------------------------------
# ArtifactStore: per-tenant v6 checkpoints on disk
# --------------------------------------------------------------------------


def _tenant_dirname(tenant) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", str(tenant))
    return f"tenant_{safe}"


class ArtifactStore:
    """A directory of per-tenant artifact checkpoints
    (``root/tenant_<id>/``), each in the format v6 of
    :func:`~.protocols.base.save_artifact` — CRC-checked npz + metadata
    sidecar, the reference's layout, so a store written by either package
    loads in the other.  ``store.load`` is the canonical
    :class:`ArtifactCache` loader and restores onto ``device`` (the card
    when None; without CUDA that raises unless ``device="cpu"``)."""

    def __init__(self, root: str, device=None):
        self.root = str(root)
        self.device = device
        os.makedirs(self.root, exist_ok=True)

    def path(self, tenant) -> str:
        return os.path.join(self.root, _tenant_dirname(tenant))

    def save(self, tenant, art: FittedProtocol, step: int = 0) -> str:
        return base.save_artifact(art, self.path(tenant), step)

    def load(self, tenant, step: int | None = None) -> FittedProtocol:
        return base.load_artifact(self.path(tenant), step, self.device)

    def meta(self, tenant, step: int | None = None) -> dict:
        """The checkpoint's static metadata WITHOUT loading the arrays — a
        cheap bucket-compatibility screen before paying a full restore."""
        from ..checkpoint import load_artifact_meta

        return load_artifact_meta(self.path(tenant), step)

    def tenants(self) -> list:
        pref = "tenant_"
        return sorted(
            d[len(pref):] for d in os.listdir(self.root)
            if d.startswith(pref) and os.path.isdir(os.path.join(self.root, d))
        )
