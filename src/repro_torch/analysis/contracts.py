"""Declarative program contracts for the serve hot path — counterpart of
``repro/analysis/contracts.py``.

The production guarantees are structural facts about what a call does: a
warm predict performs no factorization, makes no host round trip and runs
no collective, and the artifact it serves lives on one device.  This
module states them as rules over the planes the checker inspects:

* the ops a predict dispatches (:mod:`.op_walk`): :class:`PrimitiveBudget`,
  :class:`NoHostCallbacks`, :class:`CollectiveBudget`;
* the devices of the artifact's tensors (:class:`NoShardingLeak`: every
  tensor on the artifact's device and, for a mesh artifact, every tensor
  outside its per-machine groups the same on every rank);
* the §4 ledgers against :mod:`repro_torch.comm.accounting`
  (:class:`LedgerAccounting`).

A :class:`Contract` is a named bundle of rules, registered next to each
protocol (``core/protocols/{center,broadcast,poe}.py`` call
:func:`register_contract` at import) and looked up per (protocol, impl,
phase).  :func:`check_contracts` runs one predict of the artifact under the
op recorder and returns a :class:`ContractReport` or raises
:class:`ContractViolation`.

Where the reference is trace-neutral (building the program to inspect it
never moves a retrace counter), the port is side-effect-neutral: the
inspected predict leaves the artifact, ``update_growth_count`` and the
kernel runtime's launch counts as they were.  :func:`retrace_budget`
budgets the port's form of a retrace, a capacity growth.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from .op_walk import (
    FACTORIZATION_PRIMITIVES,
    HOST_SYNC_OPS,
    collective_stats,
    primitive_counts,
    record_ops,
)

__all__ = [
    "Finding",
    "ContractViolation",
    "ContractReport",
    "Contract",
    "PrimitiveBudget",
    "forbid_primitives",
    "NoHostCallbacks",
    "CollectiveBudget",
    "NoShardingLeak",
    "LedgerAccounting",
    "register_contract",
    "contract_for",
    "check_contracts",
    "predict_ops",
    "find_sharding_leaks",
    "find_rank_leaks",
    "retrace_budget",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation: which contract and rule fired, on what."""

    contract: str
    rule: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.contract}] {self.rule}: {self.detail}"


class ContractViolation(AssertionError):
    """Raised by :func:`check_contracts` and :func:`retrace_budget` with
    every finding attached (an AssertionError, so a test suite treats a
    broken contract as a failed assert)."""

    def __init__(self, findings):
        self.findings = tuple(findings)
        super().__init__(
            "program contract violated:\n  "
            + "\n  ".join(str(f) for f in self.findings)
        )


@dataclasses.dataclass(frozen=True)
class ContractReport:
    """What :func:`check_contracts` measured: the contract that ran, the
    factorization counts and collective stats of the predict, the tensors
    off the artifact's device, and the findings (empty = the contract
    holds)."""

    contract: str
    protocol: str
    impl: str
    phase: str
    op_counts: dict
    collectives: dict
    leaks: tuple
    findings: tuple

    @property
    def ok(self) -> bool:
        return not self.findings


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrimitiveBudget:
    """Per-primitive budgets over the ops of the predict: ``budgets`` is
    ``((name, max_count), ...)`` in the reference's names (a factorization
    name counts every aten op that performs it, :mod:`.op_walk`)."""

    budgets: tuple
    name: str = "primitive-budget"

    def check(self, ctx) -> list:
        if ctx.ops is None:
            return []
        budgets = dict(self.budgets)
        counts = primitive_counts(ctx.ops, names=budgets.keys())
        return [
            f"{prim}: {counts[prim]} ops > budget {cap}"
            for prim, cap in budgets.items()
            if counts[prim] > cap
        ]


def forbid_primitives(*names) -> PrimitiveBudget:
    """A zero budget for each named primitive; with no names, for every
    one-shot factorization (cholesky, eig, eigh, lu, qr, svd)."""
    names = names or tuple(sorted(FACTORIZATION_PRIMITIVES))
    return PrimitiveBudget(budgets=tuple((n, 0) for n in names))


@dataclasses.dataclass(frozen=True)
class NoHostCallbacks:
    """No host round trip inside the predict: a ``.item()`` or a copy to
    the CPU (:data:`~.op_walk.HOST_SYNC_OPS`) stalls the host on the
    device once per request."""

    name: str = "no-host-callbacks"

    def check(self, ctx) -> list:
        if ctx.ops is None:
            return []
        return [
            f"host-sync op {op!r} appears {ctx.ops[op]}x in a hot-path call "
            "(one host round trip per request)"
            for op in sorted(HOST_SYNC_OPS) if ctx.ops.get(op, 0) > 0
        ]


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """The wire is the only collective channel, and it is budgeted:
    ``max_count`` collective ops in the call (:data:`~.op_walk.COLLECTIVE_OPS`;
    the batched serve budgets 0, the fused mesh epilogue exactly one
    all-reduce) and, optionally, ``max_bytes`` of collective payload."""

    max_count: int = 0
    max_bytes: int | None = None
    name: str = "collective-budget"

    def check(self, ctx) -> list:
        if ctx.ops is None:
            return []
        stats = collective_stats(ctx.ops)
        total = sum(v["count"] for v in stats.values())
        out = []
        if total > self.max_count:
            detail = ", ".join(f"{k} x{v['count']}" for k, v in sorted(stats.items()))
            out.append(f"{total} collective ops ({detail}) > budget {self.max_count} "
                       "— an unaccounted channel beside the §4 wire")
        if self.max_bytes is not None:
            nbytes = sum(v["bytes"] for v in stats.values())
            if nbytes > self.max_bytes:
                out.append(f"collective payload {nbytes} B > budgeted {self.max_bytes} B")
        return out


def _tensor_leaves(obj, path=""):
    """(path, tensor) for every tensor of an artifact: its params, y, the
    ``factors``/``data`` dicts, the wire and stream states."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _tensor_leaves(obj[k], f"{path}/{k}" if path else str(k))
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for k in obj._fields:
            yield from _tensor_leaves(getattr(obj, k), f"{path}/{k}" if path else k)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensor_leaves(getattr(obj, f.name),
                                      f"{path}/{f.name}" if path else f.name)


def find_sharding_leaks(art, *, max_devices: int = 1) -> list:
    """Tensors of ``art`` that are not on the artifact's device
    (``art.device``), as ``[(path, device), ...]``, when the artifact spans
    more than ``max_devices`` devices.  The reference looks for arrays
    committed to a multi-device sharding; in one process the same fault is
    a tensor left on another device (a CPU copy, a ``meta`` placeholder),
    which every request would then move or fail on."""
    leaves = list(_tensor_leaves(art))
    if len({t.device for _, t in leaves} | {art.device}) <= max_devices:
        return []
    return [(p, str(t.device)) for p, t in leaves if t.device != art.device]


def find_rank_leaks(art, allow_prefixes=()) -> list:
    """The mesh form of a sharding leak: tensors of ``art`` outside the
    ``allow_prefixes`` groups (which hold one machine per rank by design)
    that differ between the ranks of the default process group, or hold
    one machine's slice (a leading axis of 1 where there are m machines),
    as ``[(path, what), ...]``.  Every rank must call it (one gather of
    each tensor's CRC32)."""
    import zlib

    from ..comm import collectives as C

    m = len(art.fit_lengths)
    leaves = [(p, t) for p, t in _tensor_leaves(art)
              if not any(p.startswith(a) for a in allow_prefixes)]
    crc = torch.tensor([zlib.crc32(t.detach().cpu().contiguous().numpy().tobytes())
                        for _, t in leaves], dtype=torch.int64)
    crcs = C.all_gather(crc)
    out = [(p, "differs between ranks") for i, (p, _) in enumerate(leaves)
           if bool((crcs[:, i] != crcs[0, i]).any())]
    out += [(p, "holds one machine's slice") for p, t in leaves
            if m > 1 and t.dim() > 0 and t.shape[0] == 1]
    return out


@dataclasses.dataclass(frozen=True)
class NoShardingLeak:
    """Every tensor of the artifact on the artifact's one device; for a mesh
    artifact also every tensor outside ``allow_prefixes`` (the groups that
    hold one machine per rank: ``factors/``, ``data/``) whole and the same
    on every rank (:func:`find_rank_leaks`)."""

    max_devices: int = 1
    allow_prefixes: tuple = ()
    name: str = "no-sharding-leak"

    def check(self, ctx) -> list:
        art = ctx.artifact
        if art is None:
            return []
        out = [
            f"tensor {path!r} is on {dev}, not on the artifact's device "
            f"{art.device} — every request would move or fail on it"
            for path, dev in find_sharding_leaks(art, max_devices=self.max_devices)
        ]
        if getattr(art, "impl", None) == "mesh":
            out += [f"tensor {path!r} {what} — only factors and data may hold one "
                    "machine per rank" for path, what in find_rank_leaks(art, self.allow_prefixes)]
        return out


@dataclasses.dataclass(frozen=True)
class LedgerAccounting:
    """The three §4 ledgers consistent with
    :mod:`repro_torch.comm.accounting`: the packed payload never below the
    Theorem-1 ledger, the CRC ledger whole frames, none negative."""

    name: str = "ledger-accounting"

    def check(self, ctx) -> list:
        art = ctx.artifact
        if art is None or getattr(art, "stream", None) is None:
            return []
        from ..comm.accounting import CRC_BITS

        wire, payload, integrity = (int(art.wire_bits), int(art.payload_bits),
                                    int(art.integrity_bits))
        out = []
        if payload < wire:
            out.append(
                f"payload_bits ({payload}) < wire_bits ({wire}): the wire "
                "physically moved fewer bits than the Theorem-1 ledger "
                "charges — an unaccounted side channel"
            )
        if integrity % CRC_BITS:
            out.append(
                f"integrity_bits ({integrity}) is not a whole number of "
                f"{CRC_BITS}-bit CRC frames"
            )
        if min(wire, payload, integrity) < 0:
            out.append(f"negative ledger (wire={wire}, payload={payload}, crc={integrity})")
        return out


# --------------------------------------------------------------------------
# contracts: named rule bundles, declared next to each protocol
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Contract:
    """A named bundle of rules enforced together over one call and artifact."""

    name: str
    rules: tuple

    def check(self, ctx) -> list:
        return [Finding(self.name, rule.name, detail)
                for rule in self.rules for detail in rule.check(ctx)]


@dataclasses.dataclass
class _CheckContext:
    """What one enforcement pass inspects: the ops of the call (None for
    artifact-only phases) and the artifact."""

    ops: object = None
    artifact: object = None


# (protocol, impl, phase) -> Contract; impl "*" matches any.  Protocol
# modules register at import top level (repro_torch.analysis.lint checks).
_CONTRACTS: dict = {}


def register_contract(protocol: str, phase: str, contract: Contract,
                      impl: str = "*") -> Contract:
    """Declare the contract for one (protocol, phase), at module top level
    next to the protocol's ``register_protocol``; ``impl`` narrows it to one
    substrate, ``"*"`` covers the rest."""
    key = (protocol, impl, phase)
    if key in _CONTRACTS:
        raise ValueError(f"contract already registered for {key}")
    _CONTRACTS[key] = contract
    return contract


def contract_for(protocol: str, impl: str, phase: str) -> Contract:
    """The most specific registered contract for (protocol, impl, phase)."""
    for key in ((protocol, impl, phase), (protocol, "*", phase)):
        if key in _CONTRACTS:
            return _CONTRACTS[key]
    known = sorted({f"{p}/{i}/{ph}" for p, i, ph in _CONTRACTS})
    raise KeyError(
        f"no contract registered for {protocol}/{impl}/{phase} "
        f"(known: {', '.join(known)})"
    )


# --------------------------------------------------------------------------
# side-effect-neutral inspection + the check_contracts entry point
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _side_effect_neutral():
    """Snapshot and restore the counters a predict could move: the
    capacity growths of :mod:`..core.protocols.streaming` (a predict never
    grows, and this keeps it so) and the kernel runtime's launch counts, so
    an inspected predict never shows up in a launch or growth budget."""
    from ..core.protocols import streaming
    from ..kernels import runtime

    growths = dict(streaming._GROWTHS)
    launches = {name: runtime.family(name).launches for name in runtime.launches()}
    try:
        yield
    finally:
        streaming._GROWTHS.clear()
        streaming._GROWTHS.update(growths)
        for name, n in launches.items():
            runtime.family(name).launches = n


def _query_dim(art) -> int:
    """The feature dimension of the artifact's query space."""
    for key in ("Xc", "X_recon", "Xs"):
        if key in art.data:
            return int(art.data[key].shape[-1])
    raise ValueError("cannot infer query dimension; pass X_star explicitly")


def predict_ops(art, X_star=None):
    """The ops of one predict of ``art`` at ``X_star`` (an (8, d) batch of
    zeros when None), recorded side-effect-neutrally.  The batch is put on
    the artifact's device before recording, so the upload of a host batch
    is not counted as the predict's.  A broadcast or poe mesh artifact
    serves collectively: every rank must call it together."""
    from ..core.protocols import base

    if X_star is None:
        X_star = torch.zeros((8, _query_dim(art)), dtype=torch.float32, device=art.device)
    X_star = torch.as_tensor(X_star, dtype=torch.float32, device=art.device)
    avail = base._availability(art, None)
    with _side_effect_neutral():
        return record_ops(base._predict_impl, art, X_star, avail)


def check_contracts(art, X_star=None, phase: str = "predict", *,
                    raise_on_violation: bool = True) -> ContractReport:
    """Enforce the registered (protocol, impl, phase) contract on a fitted
    artifact: one predict of ``art`` at ``X_star`` under the op recorder
    (phase ``"predict"``; an (8, d) probe when ``X_star`` is None), the
    devices of its tensors and its §4 ledgers.  Raises
    :class:`ContractViolation` listing every finding, or returns the
    :class:`ContractReport`.  Side-effect-neutral: the artifact,
    ``update_growth_count`` and the launch counts are left as they were."""
    contract = contract_for(art.protocol, art.impl, phase)
    ops = predict_ops(art, X_star) if phase == "predict" else None
    findings = contract.check(_CheckContext(ops=ops, artifact=art))
    report = ContractReport(
        contract=contract.name,
        protocol=art.protocol,
        impl=art.impl,
        phase=phase,
        op_counts=(dict(primitive_counts(ops, names=FACTORIZATION_PRIMITIVES))
                   if ops is not None else {}),
        collectives=collective_stats(ops) if ops is not None else {},
        leaks=tuple(find_sharding_leaks(art)),
        findings=tuple(findings),
    )
    if findings and raise_on_violation:
        raise ContractViolation(findings)
    return report


@contextlib.contextmanager
def retrace_budget(protocol: str, *, serve: int = 0, update: int | None = None):
    """The retrace contract as a context manager, on the port's form of a
    retrace: a capacity growth (``streaming.update_growth_count``), the
    only event that changes an artifact's buffer shapes.  A growth is what
    makes the reference retrace its update and, at the next request, its
    serve; so the block may grow at most ``serve`` times (and, when given,
    at most ``update`` times).  A serve itself never grows anything, by
    construction: a warm serve loop with no update in it meets a budget of
    0 always.  Raises :class:`ContractViolation` on exit otherwise."""
    from ..core.protocols.streaming import update_growth_count

    g0 = update_growth_count(protocol)
    yield
    grown = update_growth_count(protocol) - g0
    findings = []
    if grown > serve:
        findings.append(Finding(
            f"{protocol}-retrace-budget", "serve-retraces",
            f"{grown} capacity growth(s) reshaped the served buffers > budget {serve}",
        ))
    if update is not None and grown > update:
        findings.append(Finding(
            f"{protocol}-retrace-budget", "update-retraces",
            f"{grown} capacity growth(s) > update budget {update}",
        ))
    if findings:
        raise ContractViolation(findings)
