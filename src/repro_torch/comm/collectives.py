"""The exact collectives between machines: the one place the port calls
``torch.distributed``.

Under ``impl="mesh"`` every machine is one process (a rank of the default
process group, backend ``gloo``: NCCL refuses two ranks on one GPU, and
the machines share one card).  The quantized wire
(:mod:`.quantized_collectives`) and the mesh substrate
(:mod:`repro_torch.core.protocols.mesh`) move tensors through the functions
here and nothing else:

* :func:`all_gather` — every rank's tensor, stacked along a new leading
  machine axis (``c10d.allgather_``);
* :func:`all_reduce` — the elementwise sum over ranks (``c10d.allreduce_``);
* :func:`broadcast` — rank ``src``'s tensor on every rank
  (``c10d.broadcast_``);
* :func:`all_gather_many` — several tensors in one gather;
* :func:`share` — any picklable object (an artifact, a path) from ``src``
  to every rank, by ``broadcast_object_list``;
* :func:`barrier`.

gloo takes card tensors for all three ops (an H100 with torch 2.11,
cu128) and moves them through host memory itself, so nothing is staged
here: the tensors go to the ops as they are.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "group_size",
    "group_rank",
    "all_gather",
    "all_reduce",
    "all_gather_many",
    "broadcast",
    "share",
    "barrier",
]

def group_size(group=None) -> int:
    """Ranks (machines) in ``group`` (the default process group when None)."""
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank (its machine index) in ``group``."""
    return dist.get_rank(group)


def _global(src: int, group) -> int:
    return src if group is None else dist.get_global_rank(group, src)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(m, *t.shape): rank j's ``t`` at index j, on ``t``'s device."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(outs, t, group=group)
    return torch.stack(outs)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor; ``t`` is untouched).
    Every rank receives the same bits."""
    work = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(work, group=group)
    return work


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (a new tensor); the other ranks'
    ``t`` gives only the shape, dtype and device to receive into."""
    work = t.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(work, _global(src, group), group=group)
    return work


def _as_bytes(tensors) -> torch.Tensor:
    """One flat uint8 buffer of the tensors' bytes, in order."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _from_bytes(buf: torch.Tensor, like) -> list:
    """The tensors of :func:`_as_bytes` back, shaped and typed as ``like``
    (a list of ``(shape, dtype)``)."""
    out, o = [], 0
    for shape, dtype in like:
        n = int(torch.Size(shape).numel()) * torch.empty((), dtype=dtype).element_size()
        out.append(buf[o: o + n].view(dtype).reshape(shape))
        o += n
    return out


def all_gather_many(tensors, group=None) -> list:
    """:func:`all_gather` of several tensors (one device) in ONE collective:
    their bytes travel as one buffer.  Returns the (m, ...) stacks."""
    like = [(tuple(t.shape), t.dtype) for t in tensors]
    rows = all_gather(_as_bytes(tensors), group)
    per_rank = [_from_bytes(r, like) for r in rows]
    return [torch.stack([pr[i] for pr in per_rank]) for i in range(len(tensors))]


def share(obj, src: int, group=None):
    """Rank ``src``'s ``obj`` — any picklable structure, e.g. a fitted
    artifact or a path — on every rank (``broadcast_object_list``: the
    pickle's length, then its bytes).  A tensor comes back on the device it
    was sent from (the one card under ``impl="mesh"``), with the sender's
    bits; rank ``src`` gets ``obj`` itself."""
    box = [obj if group_rank(group) == src else None]
    dist.broadcast_object_list(box, _global(src, group), group=group)
    return box[0]


def barrier(group=None) -> None:
    dist.barrier(group=group)
