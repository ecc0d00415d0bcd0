"""Public wrappers of the per-symbol quantizer kernels — counterpart of
``repro/kernels/quant/ops.py``.

:func:`build_scaled_tables` makes a machine's (d, E) edge and (d, C)
centroid tables from its (sigma, rates), exactly as the reference does.
:func:`encode` counts, for every symbol, the scaled edges below it (the
kernel stages each row in chunks of :data:`ENCODE_CHUNK` edges and counts a
chunk whose edges do not decrease by a binary search, any other chunk in
full: the same count either way), and
:func:`decode` looks each code's centroid up (the kernel's variant and tile
from :func:`decode_plan`): through the hand-written Hopper kernels
(``csrc/quant_encode.cu``, ``csrc/quant_decode.cu``; families
``"quant_encode"`` and ``"quant_decode"``) for CUDA tensors, and through
:mod:`.ref`'s plain versions for CPU tensors
(:func:`repro_torch.kernels.runtime.choose`).  The kernels mask their
ragged edges themselves, so nothing is padded here.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ...core import quantizers as Q
from .. import build, runtime
from .ref import decode_plain, encode_plain

__all__ = ["build_scaled_tables", "encode", "decode", "encode_cuda", "decode_cuda",
           "encode_plain", "decode_plain", "ENCODE_FAMILY", "DECODE_FAMILY",
           "DEFAULT_ECHUNK", "ENCODE_CHUNK", "DecodePlan", "decode_plan",
           "decode_smem_bytes", "DECODE_BD", "DECODE_ROWS"]

DEFAULT_ECHUNK = 128  # the reference's table padding unit
ENCODE_CHUNK = 8192  # edges the encode kernel stages at a time (csrc/quant_encode.cu CHUNK)

_FNS: dict = {}


def _fn(lib: str, symbol: str, ints: int):
    """``symbol`` of library ``lib`` (built on first use): ``ints`` ints,
    three pointers and the stream; returns the CUDA error code."""
    if symbol not in _FNS:
        fn = getattr(build.library(lib), symbol)
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] * ints + [ptr] * 4
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return _FNS[symbol]


# csrc/quant_decode.cu: a tile is BN rows x DECODE_BD dimensions (256 threads)
DECODE_BD = 32
DECODE_ROWS = (32, 64)  # the tile rows the kernel is built for
_DECODE_VARIANT_ID = {"flat": 0, "tile": 1}
_DECODE_FLAT_MAX = 8192  # symbols up to which a call takes the flat variant
_DECODE_DEEP = 16  # blocks an SM of 32-row tiles from which a tile takes 64 rows


class DecodePlan(NamedTuple):
    """How ``csrc/quant_decode.cu`` decodes one call: the variant ("flat"
    or "tile"), the rows ``bn`` and dimensions ``bd`` of a tile (0 for
    "flat") and a block's dynamic shared memory in bytes."""

    variant: str
    bn: int
    bd: int
    smem: int


def decode_smem_bytes(variant: str, bn: int) -> int:
    """A block's shared memory: the (bn, DECODE_BD + 1)-word tile of codes,
    then values, of "tile"; none for "flat"."""
    return 4 * bn * (DECODE_BD + 1) if variant == "tile" else 0


def decode_plan(n: int, d: int, C: int, sms: int = 132) -> DecodePlan:
    """The decode kernel's plan for (n, d) codes against a (d, C) table on a
    card with ``sms`` SMs — a function of its arguments alone.

    - "flat" (one thread a symbol): at most ``_DECODE_FLAT_MAX`` symbols
      (the wire's 25 x 21), or d < DECODE_BD where the tile would take its
      4-byte path (d % 4 != 0) or leave over half its columns idle
      (d < 16): there its barriers and idle lanes cost more than its
      coalescing saves;
    - "tile" (lookups gathered from L2 through a shared tile of 32 rows, 64
      from ``_DECODE_DEEP`` blocks an SM): the rest, at every C.
    Timed on the card (``quant/stages.py``, 29 shapes), the pick is within
    1.5 % of the fastest of flat and the 32- and 64-row tiles at 22 and
    within 6 % at the rest; no table size made staging the rows in shared
    memory pay (PERF.md section 6).  Raises ValueError where the grid
    would exceed the card's limits."""
    small_d = d < DECODE_BD and (d % 4 != 0 or d < DECODE_BD // 2)
    if (n * d <= _DECODE_FLAT_MAX or small_d) and n * d < 2**31:
        return DecodePlan("flat", 0, 0, 0)
    tiles_d = math.ceil(d / DECODE_BD)
    if tiles_d > 65535:
        raise ValueError(f"quant_decode: d = {d} exceeds the grid's {65535 * DECODE_BD}")
    bn = DECODE_ROWS[math.ceil(n / DECODE_ROWS[0]) * tiles_d >= _DECODE_DEEP * sms]
    return DecodePlan("tile", bn, DECODE_BD, decode_smem_bytes("tile", bn))


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_scaled_tables(sigma, rates, echunk: int = DEFAULT_ECHUNK, device=None):
    """(d,) sigma, (d,) integer rates -> scaled_edges (d, E), scaled_cents
    (d, E) fp32 on ``device``, E = max(2^max_rate, echunk) rounded up to a
    multiple of ``echunk``; unused edges +inf, unused centroids 0.  Each
    entry is the float64 product of the standard-normal table and the
    dimension's sigma, cast to fp32 — the reference's bits."""
    rates = _numpy(rates).astype(np.int64)
    sigma = _numpy(sigma).astype(np.float32)
    d = rates.shape[0]
    max_r = int(rates.max(initial=0))
    E = max(1 << max_r, echunk) if max_r > 0 else echunk
    E = int(np.ceil(E / echunk) * echunk)
    edges = np.full((d, E), np.inf, dtype=np.float32)
    cents = np.zeros((d, E), dtype=np.float32)
    for i in range(d):
        r = int(rates[i])
        e = Q.gauss_bin_edges(r)
        c = Q.gauss_centroids(r)
        edges[i, : e.shape[0]] = e * sigma[i]
        cents[i, : c.shape[0]] = c * sigma[i]
    return torch.from_numpy(edges).to(device), torch.from_numpy(cents).to(device)


def _need(name: str, cond: bool, msg: str):
    if not cond:
        raise ValueError(f"{name} kernel: {msg}")


def _check(name, a, a_name, a_dtype, b, b_name):
    _need(name, a.device.type == "cuda", f"{a_name} on {a.device}, not a CUDA device")
    _need(name, b.device == a.device, f"{b_name} on {b.device}, {a_name} on {a.device}")
    _need(name, a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
          f"expects {a_name} (n, d) and {b_name} (d, E), got {tuple(a.shape)} and "
          f"{tuple(b.shape)}")
    if a.dtype != a_dtype or b.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes {a_name} {a_dtype} and {b_name} float32, "
                        f"got {a.dtype} and {b.dtype}")
    _need(name, a.is_contiguous() and b.is_contiguous(),
          f"{a_name} and {b_name} must be contiguous")


def _launch(name, symbol, a, b, out, fam, lead=()):
    """Launch ``symbol`` on (``lead``..., n, d, b's width, a, b, out, the
    current stream); nothing for an empty output."""
    n, d = a.shape
    if n == 0 or d == 0:
        return out
    with torch.cuda.device(a.device):
        err = _fn(name, symbol, 3 + len(lead))(
            *lead, n, d, b.shape[1], a.data_ptr(), b.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    fam.launches += 1
    return out


def encode_cuda(x: torch.Tensor, scaled_edges: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper encode kernel: x (n, d) fp32, scaled_edges (d, E)
    fp32, contiguous on one CUDA device -> int32 codes (n, d).  Raises on a
    bad operand or a refused launch; never falls back."""
    _check("quant_encode", x, "x", torch.float32, scaled_edges, "scaled_edges")
    _need("quant_encode", x.shape[1] <= 65535, f"d = {x.shape[1]} exceeds the grid's y axis")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    return _launch("quant_encode", "repro_quant_encode_f32", x, scaled_edges, out,
                   ENCODE_FAMILY)


def decode_cuda(codes: torch.Tensor, scaled_cents: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper decode kernel as :func:`decode_plan` says: codes
    (n, d) int32, scaled_cents (d, C) fp32, contiguous on one CUDA device
    (a view with a storage offset included) -> (n, d) fp32.  Raises on a
    bad operand or a refused launch; never falls back."""
    _check("quant_decode", codes, "codes", torch.int32, scaled_cents, "scaled_cents")
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    pl = decode_plan(*codes.shape, scaled_cents.shape[1], _sms(codes.device))
    return _launch("quant_decode", "repro_quant_decode_f32", codes, scaled_cents, out,
                   DECODE_FAMILY, lead=(_DECODE_VARIANT_ID[pl.variant], pl.bn, pl.smem))


ENCODE_FAMILY = runtime.register("quant_encode", encode_cuda, encode_plain)
DECODE_FAMILY = runtime.register("quant_decode", decode_cuda, decode_plain)


def encode(x: torch.Tensor, scaled_edges: torch.Tensor) -> torch.Tensor:
    """int32 codes (n, d): the number of ``scaled_edges[j, :]`` strictly
    below ``x[i, j]`` (tables from :func:`build_scaled_tables`)."""
    return runtime.choose("quant_encode", x)(x, scaled_edges)


def decode(codes: torch.Tensor, scaled_cents: torch.Tensor) -> torch.Tensor:
    """x̂ (n, d) = ``scaled_cents[j, codes[i, j]]``; a code outside [0, C)
    decodes to 0."""
    return runtime.choose("quant_decode", codes)(codes, scaled_cents)
