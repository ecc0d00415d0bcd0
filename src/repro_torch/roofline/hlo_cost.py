"""Per-device cost of a PyTorch function, counted at the dispatcher —
counterpart of ``repro/roofline/hlo_cost.py``.

The reference walks XLA's optimised, SPMD-partitioned HLO.  The port has
no HLO: it runs eagerly, so :func:`analyze` runs the function once under a
``TorchDispatchMode`` and counts each ATen op as it executes:

  matmuls and the rest of ``torch.utils.flop_counter``'s formula registry
                -> flops, from the op's (local) shapes
  every other non-view op
                -> operand + result bytes                  [HBM traffic]
  the ``_c10d_functional`` / ``c10d`` collectives and DTensor's all-to-all
                -> result bytes, by the reference's kind   [wire bytes]

Only ops on local tensors are counted.  An op whose arguments are DTensors
is handed on (the mode returns ``NotImplemented``), and the local ops
DTensor runs for it — the shard's matmul, the collectives of a
redistribute — come back through the mode and are counted; so are the
fake tensors of a dry run (``FakeTensorMode``), whose shapes are the
shards'.  DTensor's sharding propagation runs each op once more on
global-shape stand-ins to learn the output's shape; those ops run with
the dispatch modes set aside, so neither this counter nor a memory
tracker sees them.

Bytes are counted at op granularity — a no-cache-reuse HBM-traffic proxy,
as the reference's top-level-instruction bytes.  The reference multiplies
a ``while`` body by its trip count because XLA's cost analysis visits it
once; eager execution runs every iteration of every loop (layers,
microbatches, remat's recompute), so there is no trip count to apply.
An op can declare its own bytes (:func:`register_bytes`, e.g. a custom
kernel op that reads its cache once) and FLOPs
(``torch.utils.flop_counter.register_flop_formula``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["COLLECTIVES", "HloCost", "Cost", "CostCounter", "analyze", "register_bytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# "namespace::op" -> the reference's collective kind
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "collective-permute",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "collective-permute",
}

# ops that move no bytes: waits on a collective, allocation without a
# write, metadata queries
_NO_BYTES = {
    "_c10d_functional::wait_tensor", "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::lift_fresh", "aten::_local_scalar_dense",
}

_BYTES: dict = {}


def register_bytes(op, fn):
    """``fn(*args, out=..., **kwargs) -> bytes`` for ``op`` (an
    ``OpOverloadPacket``): the bytes it moves, in place of operand + result
    bytes."""
    _BYTES[op] = fn


@dataclasses.dataclass
class HloCost:
    """The reference's fields: flops, HBM-traffic bytes, collective wire
    bytes and the collective bytes by kind — per device."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=lambda: {c: 0.0 for c in COLLECTIVES})

    def __iadd__(self, o):
        self.flops += o.flops
        self.bytes += o.bytes
        self.collective_bytes += o.collective_bytes
        for k in self.collectives:
            self.collectives[k] += o.collectives[k]
        return self

    def scaled(self, k: float) -> "HloCost":
        return HloCost(self.flops * k, self.bytes * k, self.collective_bytes * k,
                       {c: v * k for c, v in self.collectives.items()})

    def as_dict(self):
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes, "collectives": dict(self.collectives)}


Cost = HloCost


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _qualname(func) -> str:
    return f"{func.namespace}::{func._opname}"


class CostCounter(TorchDispatchMode):
    """Counts the local ops run under it into ``self.cost`` (an
    :class:`HloCost`) and, per op name, into ``self.calls``."""

    def __init__(self):
        super().__init__()
        self.cost = HloCost()
        self.calls: dict = {}

    @contextlib.contextmanager
    def _uncounted_propagation(self):
        """Leave DTensor's shape propagation uncounted (it runs the op on
        global-shape stand-ins): it runs with the dispatch modes — this
        counter, a memory tracker beside it — set aside."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name, None)
        if orig is None:
            raise RuntimeError(f"this torch's ShardingPropagator has no {name}: the counter "
                               "cannot tell DTensor's shape propagation from the local ops")

        def wrapped(prop, *a, **kw):
            with _disable_current_modes():  # this counter and any other mode
                return orig(prop, *a, **kw)

        setattr(ShardingPropagator, name, wrapped)
        try:
            yield
        finally:
            setattr(ShardingPropagator, name, orig)

    def __enter__(self):
        self._prop = self._uncounted_propagation()
        self._prop.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._prop.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        name = _qualname(func)
        self.calls[name] = self.calls.get(name, 0) + 1
        c = self.cost
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            b = _nbytes(out)
            c.collective_bytes += b
            c.collectives[kind] += b
            c.bytes += b
        elif packet in _BYTES:
            c.bytes += _BYTES[packet](*args, out=out, **kwargs)
        elif not func.is_view and name not in _NO_BYTES:
            c.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def analyze(fn, *args, **kwargs) -> HloCost:
    """The per-device cost of running ``fn(*args, **kwargs)`` once (under a
    :class:`CostCounter`; a caller that needs the result too runs the
    counter itself)."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.cost
