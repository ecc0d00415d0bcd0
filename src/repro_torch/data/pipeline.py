"""Sharded batch delivery — counterpart of ``repro/data/pipeline.py``.

The reference lays a host batch out over a device mesh (the batch axis
along the mesh's data axes), each host materializing only its own shards.
Under ``impl="mesh"`` the port's machines are the ranks of a
``torch.distributed`` process group, so :class:`ShardedBatcher` hands each
rank its own contiguous slice of the batch's leading axis, on the rank's
device (the card unless the caller names another); 0-d entries are whole
on every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.protocols.base import resolve_device

__all__ = ["ShardedBatcher"]


class ShardedBatcher:
    """Cut host batches (dicts of arrays) along their leading axis into this
    rank's slice.  ``group``: the process group whose ranks share the batch
    (the default group when None); ``device``: where the slices go (the card
    when None, as every entry point of the port; without CUDA that raises)."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        self.device = resolve_device(device)
        self.ranks = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def slice_for(self, n: int) -> slice:
        """This rank's rows of an n-row batch: an equal share each, so n
        must divide by the ranks (as the reference's sharding requires)."""
        if n % self.ranks:
            raise ValueError(f"a batch of {n} rows does not split over {self.ranks} ranks")
        per = n // self.ranks
        return slice(self.rank * per, (self.rank + 1) * per)

    def __call__(self, host_batch: dict) -> dict:
        out = {}
        for k, v in host_batch.items():
            v = np.asarray(v)
            part = v if v.ndim == 0 else np.ascontiguousarray(v[self.slice_for(v.shape[0])])
            out[k] = torch.as_tensor(part, device=self.device)
        return out
