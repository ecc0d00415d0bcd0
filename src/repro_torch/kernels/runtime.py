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
main path and reads them after).  :func:`shape_sweep` times every backend
of one family over a table of cases, as the reference's does.  The
reference's persistent autotune cache waits for a later slice: none of the
port's kernels takes a tunable tile yet.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import Callable, Sequence

import torch

__all__ = ["Family", "register", "family", "families", "choose", "launches",
           "reset_launches", "shape_sweep"]

# the modules that register the families (imported by :func:`families`)
_OPS_MODULES = ("gram.ops", "qgram.ops", "epilogue.ops", "quant.ops", "decode_attn.ops")


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


def families() -> tuple[str, ...]:
    """The names of every kernel family of the port, after importing the
    modules that register them (importing builds nothing)."""
    for mod in _OPS_MODULES:
        importlib.import_module(f"{__package__}.{mod}")
    return tuple(sorted(_FAMILIES))


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


def _device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("a sweep case needs at least one tensor argument")


def _time_us(fn, args, kw, reps: int, device: torch.device) -> float:
    """Microseconds per call after one warm call: CUDA events around
    ``reps`` calls (after a synchronize) on the card, the host clock on the
    CPU."""
    fn(*args, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args, **kw)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kw)
    return (time.perf_counter() - t0) * 1e6 / reps


def shape_sweep(
    name: str,
    cases: Sequence[tuple[str, Callable[[], tuple], dict | None]],
    reps: int = 2,
) -> list[tuple[str, str, float]]:
    """Time the backends of family ``name`` that run on each case's device
    — ``"cuda"`` (the kernel) and ``"plain"`` for a case on the card,
    ``"plain"`` alone for a case on the CPU — over a table of cases.

    ``cases`` rows are ``(label, make_args, kwargs)``; ``make_args()``
    builds the positional arguments of the family's signature, and the
    first tensor among them names the device.  Returns ``(label, backend,
    us_per_call)`` rows.  A backend that cannot run a case gives ``nan``
    and the sweep goes on (the reference's contract); a caller that needs
    every row finite checks for ``nan`` itself."""
    fam = family(name)
    rows: list[tuple[str, str, float]] = []
    for label, make_args, kw in cases:
        args = tuple(make_args())
        kw = dict(kw or {})
        device = _device(args)
        backends = {"plain": fam.plain}
        if device.type == "cuda":
            backends = {"cuda": fam.kernel, **backends}
        for backend, fn in backends.items():
            try:
                us = _time_us(fn, args, kw, reps, device)
            except Exception:  # the reference's contract: nan, not an abort
                us = math.nan
            rows.append((label, backend, us))
    return rows
