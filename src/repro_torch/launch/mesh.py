"""Production mesh construction — counterpart of ``repro/launch/mesh.py``.

A FUNCTION, not a module-level constant: importing this module touches no
process group.  :func:`make_production_mesh` builds a ``DeviceMesh`` of the
reference's shapes and axis names over the process group the caller has
set up; the dry run (``launch/dryrun.py``) sets up a ``fake`` group of 256
or 512 ranks in one process (:func:`fake_world`), so both meshes are
built with no card and no peer.

The roofline constants are an NVIDIA H100 80GB HBM3 at 700 W (the SXM
data sheet): 989e12 FLOP/s dense bf16, 3.35e12 B/s HBM3, 450e9 B/s NVLink
each way.  NVLink joins the eight cards of one host all to all; a 16-wide
mesh axis spans two hosts, whose link is slower, so the collective term
is a lower bound.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist

__all__ = ["make_production_mesh", "fake_world", "PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda",
                         shape=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, on ``device_type`` over the default process group,
    which must hold as many ranks.  ``shape`` replaces the size of each
    axis (a small mesh of the same names, for tests)."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = tuple(shape) if shape is not None else ((2, 16, 16) if multi_pod else (16, 16))
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name the axes {axes}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks (this
    process is rank 0; collectives move nothing), destroyed on exit.
    Raises if the process already has a default group: a real group (the
    gloo ranks of ``launch/ranks.py``) must never meet a fake one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process; the dry "
                           "run needs a process of its own")
    dist.init_process_group("fake", world_size=world_size, rank=0, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


# NVIDIA H100 80GB HBM3 (SXM, 700 W) constants used by the roofline analysis
PEAK_FLOPS_BF16 = 989e12  # dense, per card
HBM_BW = 3.35e12          # bytes/s per card
ICI_BW = 450e9            # bytes/s NVLink, each way per card
