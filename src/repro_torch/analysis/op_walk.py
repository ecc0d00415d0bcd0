"""The ops a call dispatches — the op-level plane of the contract checker,
counterpart of ``repro/analysis/jaxpr_walk.py``.

The reference inspects the jaxpr of a compiled program.  The port compiles
nothing, so the program of a call is what it dispatches: :func:`record_ops`
runs the call once under a ``TorchDispatchMode`` and counts the ``aten``
ops that reach the dispatcher (composite ops arrive decomposed, so
``torch.linalg.cholesky`` is counted as ``linalg_cholesky_ex``) and the
collectives between machine processes, under their namespace
(``c10d.allreduce_``) and with the bytes each delivers.  The
tables below map those names onto the reference's primitive names, so
reports read the same in both packages.

The hand-written kernels are launched through ctypes and never pass the
dispatcher; on the card :func:`kernel_trace` reads them (and every other
device kernel) from ``torch.profiler``'s CUDA activities.  On the CPU a
kernel family runs its plain version, whose ops do show up here.

Nothing here imports the rest of the package:
:mod:`repro_torch.analysis.contracts` builds the rule layer on top.
"""
from __future__ import annotations

import collections
import re

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "FACTORIZATION_OPS",
    "FACTORIZATION_PRIMITIVES",
    "HOST_SYNC_OPS",
    "COLLECTIVE_OPS",
    "BYTES",
    "KERNEL_SYMBOLS",
    "record_ops",
    "primitive_counts",
    "collective_stats",
    "kernel_trace",
    "kernel_events",
    "hand_written_kernels",
]

# the reference's one-shot O(n^3) decompositions (jaxpr_walk.py), each with
# the aten ops that perform it.  A solve or an inverse of a general matrix
# factorizes it (LU) every call, so those count as ``lu``; triangular
# solves and ``cholesky_solve`` against a cached factor do not factorize.
FACTORIZATION_OPS = {
    "cholesky": frozenset({"linalg_cholesky_ex", "cholesky", "linalg_cholesky"}),
    "eigh": frozenset({"linalg_eigh", "_linalg_eigh", "linalg_eigvalsh"}),
    "eig": frozenset({"linalg_eig", "linalg_eigvals"}),
    "svd": frozenset({"linalg_svd", "_linalg_svd", "svd", "linalg_svdvals"}),
    "qr": frozenset({"linalg_qr", "qr", "geqrf"}),
    "lu": frozenset({
        "linalg_lu_factor_ex", "linalg_lu_factor", "linalg_lu", "lu_factor",
        "linalg_solve_ex", "_linalg_solve_ex", "linalg_solve",
        "linalg_inv_ex", "linalg_inv", "inverse",
        "linalg_det", "_linalg_det", "linalg_slogdet", "_linalg_slogdet", "logdet",
    }),
}
FACTORIZATION_PRIMITIVES = frozenset(FACTORIZATION_OPS)

# host round trips a call can make: ``.item()`` (and int()/float()/bool()
# of a tensor) dispatches ``_local_scalar_dense``; a copy from a device to
# the CPU (``.cpu()``, ``.tolist()``, ``.numpy()`` of a card tensor) is
# recorded under the pseudo-op ``copy_to_host`` beside its own aten name.
# Off the card the only copies are CPU to CPU, so only the first shows.
HOST_SYNC_OPS = frozenset({"_local_scalar_dense", "copy_to_host"})

# the collectives between machine processes: the c10d ops that
# repro_torch.comm.collectives dispatches (recorded under their namespace;
# none in one process)
COLLECTIVE_OPS = frozenset({"c10d.allreduce_", "c10d.allgather_", "c10d.broadcast_"})
# a collective's payload is recorded beside its count, under this suffix
BYTES = "/bytes"

# the __global__ functions of kernels/csrc, by the family that launches
# them (the two epilogue families share one body, as do the two qgrams)
KERNEL_SYMBOLS = {
    "gram": ("gram_kernel", "gram_split_sum"),
    "qgram": ("qgram_kernel",),
    "qgram_packed": ("qgram_kernel",),
    "epilogue": ("small_kernel", "mma_kernel"),
    "epilogue_fleet": ("small_kernel", "mma_kernel"),
    "quant_encode": ("quant_encode_kernel",),
    "quant_decode": ("decode_flat", "decode_tile"),
    "decode_attn": ("decode_attn_partial", "decode_attn_warp", "decode_attn_combine"),
}
# a symbol as a whole word of a demangled name, or as the length-prefixed
# identifier of a mangled one ("11gram_kernelI...")
_SYMBOLS = sorted({s for v in KERNEL_SYMBOLS.values() for s in v})
_SYMBOL_RE = re.compile("|".join(
    rf"(?<![A-Za-z0-9_])({s})(?![A-Za-z0-9_])|{len(s)}({s})(?=[IEv])" for s in _SYMBOLS))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class _Recorder(TorchDispatchMode):
    def __init__(self, counts: collections.Counter):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            name = f"c10d.{name}"
            # the bytes the collective delivers: its output tensors (in place
            # for allreduce_ / broadcast_, the gathered lists for allgather_)
            self.counts[name + BYTES] += sum(t.numel() * t.element_size()
                                             for t in _tensors(args[0]))
        self.counts[name] += 1
        if name in ("_to_copy", "copy_"):
            srcs = list(_tensors(args[1:] if name == "copy_" else args[:1]))
            dst = args[0] if name == "copy_" else out
            if (isinstance(dst, torch.Tensor) and dst.device.type == "cpu"
                    and any(t.device.type not in ("cpu", "meta") for t in srcs)):
                self.counts["copy_to_host"] += 1
        return out


def record_ops(fn, *args, **kwargs) -> collections.Counter:
    """Run ``fn(*args, **kwargs)`` once and return the aten ops it
    dispatched, by name."""
    counts = collections.Counter()
    with _Recorder(counts):
        fn(*args, **kwargs)
    return counts


def primitive_counts(ops, names=None) -> collections.Counter:
    """The counts of ``ops`` (from :func:`record_ops`) under the
    reference's primitive names: each factorization name sums its aten ops
    (:data:`FACTORIZATION_OPS`), any other name is its aten op's count.
    ``names``: restrict to these (each requested name gets an entry,
    possibly 0, so budget checks never KeyError)."""
    if names is None:
        names = set(ops) | FACTORIZATION_PRIMITIVES
    out = collections.Counter({n: 0 for n in names})
    for n in names:
        aten = FACTORIZATION_OPS.get(n, (n,))
        out[n] = sum(ops.get(a, 0) for a in aten)
    return out


def collective_stats(ops) -> dict:
    """``{name: {"count": int, "bytes": int}}`` for each collective op of
    ``ops`` (:data:`COLLECTIVE_OPS`) — the payload is what the op's output
    tensors hold; empty in one process."""
    return {name: {"count": int(n), "bytes": int(ops.get(name + BYTES, 0))}
            for name, n in sorted(ops.items()) if name in COLLECTIVE_OPS and n}


# sentinel kernels (``torch.cuda._sleep``, a ``spin_kernel``) that lead
# every trace of :func:`kernel_trace`: the profiler drops the first few
# kernel records of a trace, more of them the longer the process has run
# (none in a fresh process, a handful after a few minutes of work, once
# more than 64 late in a 40-minute smoke), so the sentinels take that loss
# and the call's own kernels all come after
_SENTINELS = 256
# traces taken before giving up, when one loses every sentinel
_TRACE_ATTEMPTS = 3


def kernel_trace(fn, *args, **kwargs) -> tuple:
    """``(names, lost)``: the names of the device kernels one call of
    ``fn`` runs, in the order they started, from ``torch.profiler``'s CUDA
    activities, and how many of the trace's leading sentinel records the
    profiler dropped; ``([], 0)`` without CUDA.  This sees the
    hand-written kernels too, which :func:`record_ops` cannot.  A trace
    that lost every sentinel may have lost the call's own records too: the
    call is traced again, and after ``_TRACE_ATTEMPTS`` such traces this
    raises.  So ``fn`` must be free of effects that anyone reads later
    (launch counters, a growth count, a changed artifact): it may run up to
    ``_TRACE_ATTEMPTS`` times."""
    if not torch.cuda.is_available():
        fn(*args, **kwargs)
        return [], 0
    for _ in range(_TRACE_ATTEMPTS):
        torch.cuda.synchronize()  # earlier work still in flight stays out of the trace
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(_SENTINELS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        lead = [i for i, n in enumerate(names) if "spin_kernel" in n]
        if lead:
            return names[lead[-1] + 1:], _SENTINELS - len(lead)
    raise RuntimeError(f"kernel_trace: the profiler dropped all {_SENTINELS} sentinel "
                       f"records that lead the trace, {_TRACE_ATTEMPTS} times; the call's "
                       "own may be short too")


def kernel_events(fn, *args, **kwargs) -> list:
    """The names of the device kernels one call of ``fn`` runs, in order
    (:func:`kernel_trace` without the count of dropped sentinels)."""
    return kernel_trace(fn, *args, **kwargs)[0]


def hand_written_kernels(names) -> collections.Counter:
    """How many of the kernel ``names`` (from :func:`kernel_events`) are
    the port's hand-written kernels, by their ``__global__`` name (see
    :data:`KERNEL_SYMBOLS`)."""
    out = collections.Counter()
    for n in names:
        hit = _SYMBOL_RE.search(n)
        if hit:
            out[next(g for g in hit.groups() if g)] += 1
    return out
