"""repro_torch — the PyTorch/CUDA port of ``repro``, the distributed
communication-limited GP of arXiv:1705.02627, for one NVIDIA H100.

The JAX package ``repro`` stays as the reference; this package mirrors its
layout (``repro/core/nystrom.py`` <-> ``repro_torch/core/nystrom.py``, …,
``core/jax_scheme.py`` -> ``core/torch_scheme.py``), imports ``torch``,
numpy and scipy and never ``jax`` or ``repro``.  Its kernels are written by
hand for Hopper (``kernels/csrc/*.cu``) and built at first use.  See
ROADMAP.md for what is ported and what comes in which slice.
"""
from .core import DGPConfig, DistributedGP  # noqa: F401

__all__ = ["DGPConfig", "DistributedGP"]
