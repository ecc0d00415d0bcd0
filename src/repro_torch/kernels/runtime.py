"""Kernel runtime of the port — counterpart of ``repro/kernels/runtime.py``.

One registry of kernel families, each a pair ``{kernel, plain}`` over the
same signature, and one dispatch rule, :func:`choose`:

* a CUDA tensor goes to the hand-written Hopper kernel — which launches or
  raises; nothing falls back;
* a CPU tensor goes to the family's plain PyTorch version;
* any other device raises.

Each family counts the launches of its kernel: the kernel wrapper adds one
where it launches and nowhere else, so a run can show that a path really
went through the kernel (``chip_smoke.py`` resets the counts before the
main path and reads them after).  The autotune cache and shape sweeps of
the reference wait for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Family", "register", "family", "choose", "launches", "reset_launches"]


@dataclasses.dataclass
class Family:
    """One kernel family: the CUDA kernel wrapper, its plain version, and
    the number of kernel launches so far."""

    name: str
    kernel: Callable
    plain: Callable
    launches: int = 0


_FAMILIES: dict[str, Family] = {}


def register(name: str, kernel: Callable, plain: Callable) -> Family:
    if name in _FAMILIES:
        raise ValueError(f"duplicate kernel family {name!r}")
    fam = _FAMILIES[name] = Family(name, kernel, plain)
    return fam


def family(name: str) -> Family:
    try:
        return _FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel family {name!r}: known families are "
            f"{', '.join(sorted(_FAMILIES))}"
        ) from None


def choose(name: str, tensor: torch.Tensor) -> Callable:
    """The one dispatch rule: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    fam = family(name)
    if tensor.device.type == "cuda":
        return fam.kernel
    if tensor.device.type == "cpu":
        return fam.plain
    raise ValueError(
        f"{name}: no implementation for tensors on {tensor.device}"
    )


def launches() -> dict[str, int]:
    """Kernel launches per family since the last :func:`reset_launches`."""
    return {name: fam.launches for name, fam in sorted(_FAMILIES.items())}


def reset_launches() -> None:
    for fam in _FAMILIES.values():
        fam.launches = 0
