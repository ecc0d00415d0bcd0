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
of one family over a table of cases, as the reference's does.

The persistent autotune cache is the reference's: each family that tunes
registers its menu (:func:`register_tune_candidates`; ``qgram_packed``'s
tile, the fleet epilogue's (variant, tile)), and :func:`autotune` returns
the winner cached for a key or sweeps the menu once, timing each
candidate on the card (:func:`time_candidate`), and stores the winner in
one JSON file that later processes read (:func:`cache_path`).  A key's
backend field names the card and the hash of the family's kernel library
(:func:`cache_key`), so another card or an edited source sweeps again.  A
sweep synchronizes with the card, so none runs while a stream is being
captured or under ``torch.cuda.set_sync_debug_mode``: there a cached
winner is used if one exists, else the caller's default, and nothing is
written (:func:`may_sweep`).  The reference's ``REPRO_AUTOTUNE_INTERPRET``
has no counterpart: the port has no interpret mode, and its CPU path, the
plain version, has no tile to tune.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import tempfile
import threading
import time
from typing import Any, Callable, Iterable, Sequence

import torch

__all__ = ["Family", "register", "family", "families", "choose", "launches",
           "reset_launches", "shape_sweep", "register_tune_candidates", "tune_candidates",
           "CACHE_VERSION", "cache_path", "cache_key", "clear_cache_memory",
           "may_sweep", "autotune", "sweep_count", "time_candidate"]

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


# --------------------------------------------------------------------------
# autotune candidate registry (one menu per kernel family)
# --------------------------------------------------------------------------

_TUNE_CANDIDATES: dict[str, tuple] = {}


def register_tune_candidates(op: str, candidates: Iterable[tuple]) -> tuple:
    """Declare the autotune menu of one kernel family (module top level,
    like :func:`register`).  A candidate is a tuple of ints and strings.
    Re-registration replaces the menu; a cached winner that fell off it is
    swept again (:func:`autotune`'s membership check)."""
    cands = tuple(tuple(c) for c in candidates)
    _TUNE_CANDIDATES[op] = cands
    return cands


def tune_candidates(op: str) -> tuple:
    """The registered menu of ``op``; a KeyError names the known menus."""
    try:
        return _TUNE_CANDIDATES[op]
    except KeyError:
        raise KeyError(
            f"no autotune candidates registered for {op!r}: known are "
            f"{sorted(_TUNE_CANDIDATES)}"
        ) from None


# --------------------------------------------------------------------------
# persistent autotune cache
# --------------------------------------------------------------------------
#
# File format (JSON, written by atomic rename), the reference's:
#   {"version": 1, "entries": {"<key>": [candidate fields...], ...}}
# Key: <op>|<backend>|<shape>x<shape>...|<dtype>|bits=<b>|<extra...>
# A corrupt, stale or unreadable file is ignored (the defaults, and a later
# sweep rewrites it); the cache speeds a call up and is never required.

CACHE_VERSION = 1

_SWEEPS = 0  # sweeps this process has run
_CACHE_MEM: dict[str, tuple] | None = None
_CACHE_LOCK = threading.Lock()
_BACKENDS: dict[tuple, str] = {}


def cache_path() -> str:
    """``REPRO_TUNE_CACHE``, else ``~/.cache/repro/autotune.json``."""
    return os.environ.get(
        "REPRO_TUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro", "autotune.json"),
    )


def _backend(op: str, device=None) -> str:
    """A key's backend field: ``cuda:<card name>:<source hash of op's
    kernel library>`` for a CUDA device (the digest in the library's file
    name, :func:`.build.digest`); ``cpu:torch`` for none or any other
    device (the plain versions: nothing is swept there).  The reference's
    field (``jax.default_backend()``) holds no colon, so no key of one
    package is a key of the other."""
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        return "cpu:torch"
    k = (op, dev.index)
    if k not in _BACKENDS:
        from . import build

        _BACKENDS[k] = f"cuda:{torch.cuda.get_device_name(dev)}:{build.digest(op)}"
    return _BACKENDS[k]


def cache_key(
    op: str,
    shapes: Sequence[Sequence[int]],
    dtype: Any,
    bits: int | None = None,
    extra: Sequence[Any] = (),
    device=None,
) -> str:
    """The (op, backend, shapes, dtype, bits, extra) key of one call."""
    shape_sig = "x".join("-".join(str(int(s)) for s in shp) for shp in shapes)
    parts = [op, _backend(op, device), shape_sig, str(dtype).removeprefix("torch.")]
    if bits is not None:
        parts.append(f"bits={int(bits)}")
    parts.extend(str(e) for e in extra)
    return "|".join(parts)


def _load_cache() -> dict[str, tuple]:
    global _CACHE_MEM
    if _CACHE_MEM is not None:
        return _CACHE_MEM
    entries: dict[str, tuple] = {}
    try:
        with open(cache_path()) as f:
            blob = json.load(f)
        if (
            isinstance(blob, dict)
            and blob.get("version") == CACHE_VERSION
            and isinstance(blob.get("entries"), dict)
        ):
            for k, v in blob["entries"].items():
                if isinstance(k, str) and isinstance(v, (list, tuple)):
                    entries[k] = tuple(v)
    except (OSError, ValueError, TypeError):
        pass  # corrupt, stale or missing: the defaults; a later sweep rewrites it
    _CACHE_MEM = entries
    return entries


def _store_cache(key: str, value: tuple) -> None:
    entries = _load_cache()
    entries[key] = tuple(value)
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", prefix=".autotune-")
        with os.fdopen(fd, "w") as f:
            json.dump({"version": CACHE_VERSION,
                       "entries": {k: list(v) for k, v in entries.items()}},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only filesystem: the cache stays in this process


def clear_cache_memory() -> None:
    """Drop this process's image of the cache file (the next lookup reads
    the file again)."""
    global _CACHE_MEM
    with _CACHE_LOCK:
        _CACHE_MEM = None


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _sync_checked() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() != 0


def may_sweep() -> bool:
    """Whether a sweep may run now: not while the current stream is being
    captured into a CUDA graph, and not under a sync debug mode (a sweep
    waits for the card)."""
    return not (_capturing() or _sync_checked())


def autotune(
    key: str,
    candidates: Iterable[tuple],
    measure: Callable[[tuple], float | None],
    default: tuple,
) -> tuple:
    """The cached winner for ``key`` when the cache has one on the menu,
    else a sweep: ``measure(candidate)`` in seconds over the candidates
    (``None``: infeasible for this shape; one that raises is skipped), the
    fastest stored and returned (``default`` when none ran).  Where
    :func:`may_sweep` says no, a miss returns ``default`` and writes
    nothing."""
    global _SWEEPS
    cands = [tuple(c) for c in candidates]
    with _CACHE_LOCK:
        hit = _load_cache().get(key)
    if hit is not None and tuple(hit) in cands:
        return tuple(hit)
    if not may_sweep():
        return tuple(default)
    _SWEEPS += 1
    best, best_t = tuple(default), float("inf")
    for cand in cands:
        try:
            dt = measure(cand)
        except Exception:
            continue
        if dt is not None and dt < best_t:
            best, best_t = cand, dt
    with _CACHE_LOCK:
        _store_cache(key, best)
    return best


def sweep_count() -> int:
    """The sweeps this process has run."""
    return _SWEEPS


_SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock: the host enqueues the timed calls meanwhile


def time_candidate(run: Callable[[], Any], device, reps: int = 10) -> float:
    """Seconds a call of ``run`` takes on the card: one warm call, then
    ``reps`` calls between two CUDA events, queued behind a spin kernel so
    that the interval holds the card's time and not the host's launches.
    ``run`` launches through a family's raw C entry, so the family's launch
    count does not move."""
    with torch.cuda.device(device):
        run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / reps
