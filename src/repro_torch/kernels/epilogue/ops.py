"""Public wrappers of the fused serve epilogue — counterpart of
``repro/kernels/epilogue/ops.py`` (``epilogue_moments``,
``epilogue_moments_fleet``, ``fleet_epilogue_block``).

:func:`epilogue_moments` computes the summed fusion moment rows S (3, t) of
m cached Nyström experts (operands in :mod:`.ref`) through the hand-written
Hopper kernel (``csrc/epilogue.cu``) for CUDA tensors and through
:func:`.ref.epilogue_moments_plain` for CPU tensors
(:func:`repro_torch.kernels.runtime.choose`).  :func:`epilogue_moments_fleet`
is the same with a leading tenant axis — per-tenant rows (T, 3, t) in one
launch of ``csrc/epilogue_fleet.cu`` (family ``"epilogue_fleet"``, its own
launch count).  The kernels mask ragged t and K themselves, so nothing is
padded here.  :func:`plan` / :func:`plan_fleet` pick the test-point tile and
expert split for a shape.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build, runtime
from .ref import EPILOGUE_FUSES, epilogue_moments_fleet_plain, epilogue_moments_plain

__all__ = ["epilogue_moments", "epilogue_cuda", "epilogue_moments_plain",
           "epilogue_moments_fleet", "epilogue_fleet_cuda", "epilogue_moments_fleet_plain",
           "plan", "plan_fleet", "fleet_epilogue_block", "FAMILY", "FLEET_FAMILY"]

_SLOTS = 512  # outputs per chunk of a 256-thread block (TT x KC)
_JC = 32  # reduction chunk
_SMEM = 232_448  # dynamic shared memory one block may use on Hopper
_BLOCKS_PER_SM = 8  # 256-thread blocks: a full SM's 2048 threads

_FNS: dict = {}


def _fn(lib: str, symbol: str, n_ints: int):
    """The C entry ``symbol`` of kernel library ``lib`` (built on first
    use): ``n_ints`` int arguments, then ten pointers (seven operands, out,
    scratch, stream)."""
    if symbol not in _FNS:
        fn = getattr(build.library(lib), symbol)
        fn.argtypes = [ctypes.c_int] * n_ints + [ctypes.c_void_p] * 10
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return _FNS[symbol]


def smem_bytes(tt: int, K: int) -> int:
    """Shared memory of one block at tile ``tt`` (as
    ``csrc/epilogue_body.cuh`` lays it out: Bt, the staged chunk, the G
    chunk, the quad terms)."""
    kc = _SLOTS // tt
    return 4 * (tt * (K | 1) + kc * (_JC + 1) + tt * (_JC + 1) + tt * (kc + 1))


def plan_fleet(T: int, m: int, t: int, K: int, sms: int = 132) -> tuple[int, int]:
    """(tt, groups) for a launch over T tenants: the largest test-point
    tile (16 down to 1) whose shared memory fits, then enough expert groups
    that the grid's T * ceil(t / tt) test tiles reach ~8 blocks on each of
    the card's ``sms`` multiprocessors (each group ceil(m / groups)
    consecutive experts of every tenant).  Raises for a K no tile fits
    (K > ~40,000)."""
    for tt in (16, 8, 4, 2, 1):
        if smem_bytes(tt, K) <= _SMEM:
            break
    else:
        raise ValueError(
            f"epilogue kernel: K={K} does not fit in shared memory even one "
            "test point at a time"
        )
    tiles = T * math.ceil(t / tt)
    groups = min(m, max(1, math.ceil(_BLOCKS_PER_SM * sms / tiles)))
    per = math.ceil(m / groups)
    return tt, math.ceil(m / per)


def plan(m: int, t: int, K: int, sms: int = 132) -> tuple[int, int]:
    """(tt, groups) of a single-tenant launch: :func:`plan_fleet` at T = 1."""
    return plan_fleet(1, m, t, K, sms)


def fleet_epilogue_block(T: int, m: int, t: int, K: int, sms: int = 132) -> int:
    """The t-tile the fleet kernel plans for this launch shape (the
    reference's autotuned tile; the port's persistent autotune cache is
    slice 8)."""
    return plan_fleet(T, m, t, K, sms)[0]


def _need(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"epilogue kernel: {msg}")


# operand shapes of one tenant; the fleet form prefixes each with T
_SHAPES = {"Ainv": ("m", "K", "K"), "P": ("m", "K", "K"), "walpha": ("m", "K"),
           "gss": ("t",), "prior": ("t",), "w": ("m",)}


def _check(fuse, ops: dict, lead: tuple) -> None:
    """Validate a launch's operands: a known fuse; G on a CUDA device with
    dims ``lead`` + (m, t, K); every operand of its shape, float32,
    contiguous and on G's device."""
    _need(fuse in EPILOGUE_FUSES, f"unknown fuse {fuse!r}: known are {', '.join(EPILOGUE_FUSES)}")
    G = ops["G"]
    dev = G.device
    _need(dev.type == "cuda", f"G on {dev}, not a CUDA device")
    names = lead + ("m", "t", "K")
    _need(G.dim() == len(names), f"G must be ({', '.join(names)}), got {tuple(G.shape)}")
    dims = dict(zip(names, G.shape))
    for name, a in ops.items():
        if name != "G":
            want = tuple(dims[d] for d in lead + _SHAPES[name])
            _need(tuple(a.shape) == want, f"{name} must be {want}, got {tuple(a.shape)}")
        _need(a.dtype == torch.float32, f"{name} must be float32, got {a.dtype}")
        _need(a.device == dev, f"{name} on {a.device}, G on {dev}")
        _need(a.is_contiguous(), f"{name} must be contiguous")


def _launch(fn, fuse, ints, ops, out, scratch, name):
    dev = out.device
    with torch.cuda.device(dev):
        err = fn(
            EPILOGUE_FUSES.index(fuse), *ints, *(a.data_ptr() for a in ops),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def epilogue_cuda(G, Ainv, P, walpha, gss, prior, w, *, fuse):
    """Launch the Hopper epilogue kernel: G (m, t, K), Ainv and P (m, K, K),
    walpha (m, K), gss and prior (t,), w (m,), all fp32, contiguous, on one
    CUDA device -> (3, t).  Raises on a bad operand or a refused launch;
    never falls back."""
    ops = {"G": G, "Ainv": Ainv, "P": P, "walpha": walpha, "gss": gss,
           "prior": prior, "w": w}
    _check(fuse, ops, ())
    m, t, K = G.shape
    out = torch.empty((3, t), dtype=torch.float32, device=G.device)
    if t == 0:
        return out
    if m == 0 or K == 0:
        raise ValueError(f"epilogue kernel: needs m > 0 experts and K > 0, got m={m}, K={K}")
    tt, groups = plan(m, t, K, _sms(G.device))
    scratch = (torch.empty((groups, 3, t), dtype=torch.float32, device=G.device)
               if groups > 1 else None)
    _launch(_fn("epilogue", "repro_epilogue_f32", 6), fuse, (m, t, K, tt, groups),
            ops.values(), out, scratch, "epilogue")
    FAMILY.launches += 1
    return out


FAMILY = runtime.register("epilogue", epilogue_cuda, epilogue_moments_plain)


def epilogue_moments(G, Ainv, P, walpha, gss, prior, w, *, fuse):
    """Summed fusion moment rows S (3, t) for m cached Nyström experts —
    the fused serve epilogue.  Callers finish with the fusion's
    ``finalize(S, m, prior)``."""
    return runtime.choose("epilogue", G)(G, Ainv, P, walpha, gss, prior, w, fuse=fuse)


def epilogue_fleet_cuda(G, Ainv, P, walpha, gss, prior, w, *, fuse):
    """Launch the Hopper fleet epilogue kernel: G (T, m, t, K), Ainv and P
    (T, m, K, K), walpha (T, m, K), gss and prior (T, t), w (T, m), all
    fp32, contiguous, on one CUDA device -> (T, 3, t), each tenant summing
    only its own experts.  Raises on a bad operand or a refused launch;
    never falls back."""
    ops = {"G": G, "Ainv": Ainv, "P": P, "walpha": walpha, "gss": gss,
           "prior": prior, "w": w}
    _check(fuse, ops, ("T",))
    T, m, t, K = G.shape
    out = torch.empty((T, 3, t), dtype=torch.float32, device=G.device)
    if T == 0 or t == 0:
        return out
    if m == 0 or K == 0:
        raise ValueError(f"epilogue kernel: needs m > 0 experts and K > 0, got m={m}, K={K}")
    _need(T <= 65535, f"at most 65535 tenants a launch, got T={T}")
    tt, groups = plan_fleet(T, m, t, K, _sms(G.device))
    scratch = (torch.empty((groups, T, 3, t), dtype=torch.float32, device=G.device)
               if groups > 1 else None)
    _launch(_fn("epilogue_fleet", "repro_epilogue_fleet_f32", 7), fuse,
            (T, m, t, K, tt, groups), ops.values(), out, scratch, "epilogue_fleet")
    FLEET_FAMILY.launches += 1
    return out


FLEET_FAMILY = runtime.register("epilogue_fleet", epilogue_fleet_cuda,
                                epilogue_moments_fleet_plain)


def epilogue_moments_fleet(G, Ainv, P, walpha, gss, prior, w, *, fuse):
    """Per-tenant summed fusion moment rows S (T, 3, t) — the fused serve
    epilogue batched over a leading tenant axis, one kernel launch for the
    whole mixed-tenant micro-batch.  Callers finish with the fusion's
    ``finalize`` per tenant."""
    return runtime.choose("epilogue_fleet", G)(G, Ainv, P, walpha, gss, prior, w, fuse=fuse)
