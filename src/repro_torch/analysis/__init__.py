"""Static analysis of the port's calls and of its source tree —
counterpart of ``repro.analysis``.

Two planes:

* :mod:`.op_walk` + :mod:`.contracts` — the program plane: the aten ops a
  predict dispatches (and, on the card, the device kernels it runs), a
  declarative :class:`~.contracts.Contract` rule vocabulary (primitive
  budgets, host round trips, collectives, tensors off the artifact's
  device, ledger cross-checks), per-protocol contracts registered next to
  each protocol, and :func:`~.contracts.check_contracts`
  (side-effect-neutral by construction).
* :mod:`.lint` — the source plane: ``python -m repro_torch.analysis.lint
  src/repro_torch`` checks the conventions that keep the program plane
  checkable.
"""
from .op_walk import (
    COLLECTIVE_OPS,
    FACTORIZATION_OPS,
    FACTORIZATION_PRIMITIVES,
    HOST_SYNC_OPS,
    collective_stats,
    hand_written_kernels,
    kernel_events,
    kernel_trace,
    primitive_counts,
    record_ops,
)
from .contracts import (
    CollectiveBudget,
    Contract,
    ContractReport,
    ContractViolation,
    Finding,
    LedgerAccounting,
    NoHostCallbacks,
    NoShardingLeak,
    PrimitiveBudget,
    check_contracts,
    contract_for,
    find_sharding_leaks,
    forbid_primitives,
    predict_ops,
    register_contract,
    retrace_budget,
)

__all__ = [
    "COLLECTIVE_OPS",
    "FACTORIZATION_OPS",
    "FACTORIZATION_PRIMITIVES",
    "HOST_SYNC_OPS",
    "record_ops",
    "primitive_counts",
    "collective_stats",
    "kernel_events",
    "kernel_trace",
    "hand_written_kernels",
    "Contract",
    "ContractReport",
    "ContractViolation",
    "Finding",
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
    "retrace_budget",
]
