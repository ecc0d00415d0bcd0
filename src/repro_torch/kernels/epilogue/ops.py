"""Public wrapper of the fused serve epilogue — counterpart of
``repro/kernels/epilogue/ops.py::epilogue_moments``.

:func:`epilogue_moments` computes the summed fusion moment rows S (3, t) of
m cached Nyström experts (operands in :mod:`.ref`) through the hand-written
Hopper kernel (``csrc/epilogue.cu``) for CUDA tensors and through
:func:`.ref.epilogue_moments_plain` for CPU tensors
(:func:`repro_torch.kernels.runtime.choose`).  The kernel masks ragged t
and K itself, so nothing is padded here.  :func:`plan` picks the kernel's
test-point tile and expert split for a shape.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build, runtime
from .ref import EPILOGUE_FUSES, epilogue_moments_plain

__all__ = ["epilogue_moments", "epilogue_cuda", "epilogue_moments_plain",
           "plan", "FAMILY"]

_SLOTS = 512  # outputs per chunk of a 256-thread block (TT x KC)
_JC = 32  # reduction chunk
_SMEM = 232_448  # dynamic shared memory one block may use on Hopper
_BLOCKS_PER_SM = 8  # 256-thread blocks: a full SM's 2048 threads

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.library("epilogue").repro_epilogue_f32
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] * 6 + [ptr] * 10
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def smem_bytes(tt: int, K: int) -> int:
    """Shared memory of one block at tile ``tt`` (as ``csrc/epilogue.cu``
    lays it out: Bt, the staged chunk, the G chunk, the quad terms)."""
    kc = _SLOTS // tt
    return 4 * (tt * (K | 1) + kc * (_JC + 1) + tt * (_JC + 1) + tt * (kc + 1))


def plan(m: int, t: int, K: int, sms: int = 132) -> tuple[int, int]:
    """(tt, groups) for a launch: the largest test-point tile (16 down to
    1) whose shared memory fits, then enough expert groups that the grid
    reaches ~8 blocks on each of the card's ``sms`` multiprocessors (each
    group ceil(m / groups) consecutive experts).  Raises for a K no tile
    fits (K > ~40,000)."""
    for tt in (16, 8, 4, 2, 1):
        if smem_bytes(tt, K) <= _SMEM:
            break
    else:
        raise ValueError(
            f"epilogue kernel: K={K} does not fit in shared memory even one "
            "test point at a time"
        )
    tiles = math.ceil(t / tt)
    groups = min(m, max(1, math.ceil(_BLOCKS_PER_SM * sms / tiles)))
    per = math.ceil(m / groups)
    return tt, math.ceil(m / per)


def _need(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"epilogue kernel: {msg}")


def epilogue_cuda(G, Ainv, P, walpha, gss, prior, w, *, fuse):
    """Launch the Hopper epilogue kernel: G (m, t, K), Ainv and P (m, K, K),
    walpha (m, K), gss and prior (t,), w (m,), all fp32, contiguous, on one
    CUDA device -> (3, t).  Raises on a bad operand or a refused launch;
    never falls back."""
    _need(fuse in EPILOGUE_FUSES, f"unknown fuse {fuse!r}: known are {', '.join(EPILOGUE_FUSES)}")
    dev = G.device
    _need(dev.type == "cuda", f"G on {dev}, not a CUDA device")
    _need(G.dim() == 3, f"G must be (m, t, K), got {tuple(G.shape)}")
    m, t, K = G.shape
    shapes = {"Ainv": (m, K, K), "P": (m, K, K), "walpha": (m, K),
              "gss": (t,), "prior": (t,), "w": (m,)}
    ops = {"G": G, "Ainv": Ainv, "P": P, "walpha": walpha, "gss": gss,
           "prior": prior, "w": w}
    for name, a in ops.items():
        if name in shapes:
            _need(tuple(a.shape) == shapes[name],
                  f"{name} must be {shapes[name]}, got {tuple(a.shape)}")
        _need(a.dtype == torch.float32, f"{name} must be float32, got {a.dtype}")
        _need(a.device == dev, f"{name} on {a.device}, G on {dev}")
        _need(a.is_contiguous(), f"{name} must be contiguous")
    out = torch.empty((3, t), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    if m == 0 or K == 0:
        raise ValueError(f"epilogue kernel: needs m > 0 experts and K > 0, got m={m}, K={K}")
    tt, groups = plan(m, t, K, torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = (torch.empty((groups, 3, t), dtype=torch.float32, device=dev)
               if groups > 1 else None)
    with torch.cuda.device(dev):
        err = _fn()(
            EPILOGUE_FUSES.index(fuse), m, t, K, tt, groups,
            G.data_ptr(), Ainv.data_ptr(), P.data_ptr(), walpha.data_ptr(),
            gss.data_ptr(), prior.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {err}")
    FAMILY.launches += 1
    return out


FAMILY = runtime.register("epilogue", epilogue_cuda, epilogue_moments_plain)


def epilogue_moments(G, Ainv, P, walpha, gss, prior, w, *, fuse):
    """Summed fusion moment rows S (3, t) for m cached Nyström experts —
    the fused serve epilogue.  Callers finish with the fusion's
    ``finalize(S, m, prior)``."""
    return runtime.choose("epilogue", G)(G, Ainv, P, walpha, gss, prior, w, fuse=fuse)
