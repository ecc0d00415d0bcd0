"""Public wrappers of the fused dequantize+gram kernels — counterpart of
``repro/kernels/qgram/ops.py``.

* :func:`qgram_packed_batched` computes, for every machine at once,
  G[b] = decode(unpack(words[b])) proj[b]^T straight from the packed code
  plane: through the hand-written Hopper kernel (``csrc/qgram_packed.cu``,
  ONE launch over the machine axis) for CUDA tensors, and through
  :func:`.ref.qgram_packed_plain` for CPU tensors.  Words are the port's
  int32 tensors carrying the uint32 bit pattern (see
  :mod:`repro_torch.core.torch_scheme`).
* :func:`qgram_batched` / :func:`qgram` — the reference's unpacked-code
  API: G[b] = decode(codes[b]) y[b]^T from int32 codes (-1 rows, and any
  code outside the table, decode to 0), through ``csrc/qgram.cu`` (family
  ``"qgram"``, again one launch over the machines) or
  :func:`.ref.qgram_plain`.

Both kernels are entry points of one body (``csrc/qgram_body.cuh``);
:func:`plan` picks its tile configuration and the column tiles a block
walks from the shape alone.  ``qgram_packed``'s tile is swept on the card
and cached by shape (:func:`tuned_plan`, the reference's block autotune
through :func:`repro_torch.kernels.runtime.autotune`); ``qgram`` keeps the
pure plan, as the reference does not tune it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...core.torch_scheme import WORD_BITS, row_words
from .. import build, runtime
from .ref import qgram_packed_plain, qgram_plain

__all__ = ["qgram_packed", "qgram_packed_batched", "qgram_packed_cuda",
           "qgram_packed_plain", "pack_meta", "FAMILY", "qgram", "qgram_batched",
           "qgram_cuda", "qgram_plain", "QGRAM_FAMILY", "Plan", "plan", "tuned_plan",
           "smem_bytes", "TILES", "DK"]

# csrc/qgram_body.cuh's tile configurations: name -> (rows BR, columns BC)
# of a block's output tile (256 threads each), and the blocks an SM the
# plan's column groups aim for
TILES = {"small": (32, 32), "flat": (32, 64), "wide": (64, 128), "long": (64, 128)}
_AIM = {"small": 4, "flat": 2, "wide": 16, "long": 16}
_VARIANT_ID = {"small": 0, "flat": 1, "wide": 2, "long": 3}
DK = 32  # the body's d-chunk: at d <= DK a block decodes its rows once
_PITCH = DK + 4  # floats a shared row
_SMEM = 232_448  # shared memory one block may use on Hopper
_FEW = 4  # small tiles an SM up to which a call stays on the small tile

# qgram_packed's autotune menu: the body's four tiles (the walk follows
# from the tile by plan's own rule)
runtime.register_tune_candidates("qgram_packed", (("small",), ("flat",), ("wide",), ("long",)))


class Plan(NamedTuple):
    """How ``csrc/qgram_body.cuh`` computes one call: the tile
    configuration (a key of :data:`TILES`), the column tiles a block walks
    and the column groups of the grid (``ceil(column tiles / walk)``, every
    group non-empty)."""

    variant: str
    walk: int
    groups: int


def smem_bytes(variant: str, d: int, W: int | None = None, C: int = 0) -> int:
    """Shared memory of one block: two x̂ buffers and two y slabs of
    ``DK + 4``-float rows; for "long" two ``DK``-row chunks of a C-entry
    centroid table; for the packed kernel (``W`` words a row) the staged
    mask, meta rows and words of its rows."""
    br, bc = TILES[variant]
    staged = 0 if W is None else 4 * (br + 3 * d + br * W)
    table = 4 * 2 * DK * C if variant == "long" else 0
    return 4 * 2 * _PITCH * (br + bc) + table + staged


def _tiles(variant: str, n: int, p: int) -> tuple[int, int]:
    br, bc = TILES[variant]
    return max(1, math.ceil(n / br)), max(1, math.ceil(p / bc))


def plan(m: int, n: int, p: int, d: int, W: int | None = None, C: int = 0,
         sms: int = 132, variant: str | None = None) -> Plan:
    """The body's plan for m machines' (n, p) outputs over d, with ``W``
    packed words a row (None: int32 codes) and C-entry centroid tables, on
    a card with ``sms`` SMs — a function of its arguments alone.  With
    ``variant`` given, that tile with its walk (ValueError where it does not
    fit: "long" at d <= DK, shared memory, the grid); else the tile:

    - "long" (64 x 128, each d-chunk's table staged in shared memory): d
      longer than one chunk, an output of at least half a wave of its
      tiles, and two chunks of the table within the block's shared memory
      (the kernels bench shape);
    - "small" (32 x 32): an output of at most four small tiles an SM (the
      GP fit's and the wire's calls): latency-bound, spread over the SMs;
    - "flat" (32 x 64): the rest at most 32 rows a machine (broadcast's
      fit call, 25 rows x 1000 columns);
    - "wide" (64 x 128): the rest (40 x 1000 x 4449).
    A block walks ``walk`` column tiles, so the grid holds about
    ``_AIM[variant]`` blocks an SM, balanced over the groups.  Raises
    ValueError where a block's staged bytes exceed the card's or the grid
    its limits."""
    if variant is not None:
        if variant not in TILES or (variant == "long" and d <= DK):
            raise ValueError(f"qgram: no {variant!r} tile at d = {d}")
    else:
        tr, tc = _tiles("long", n, p)
        if d > DK and 2 * m * tr * tc >= sms and smem_bytes("long", d, W, C) <= _SMEM:
            variant = "long"
        elif m * math.prod(_tiles("small", n, p)) <= _FEW * sms:
            variant = "small"
        else:
            variant = "flat" if n <= 32 else "wide"
        if smem_bytes(variant, d, W, C) > _SMEM:
            variant = "small"
    if smem_bytes(variant, d, W, C) > _SMEM:
        raise ValueError(f"qgram: d = {d}, W = {W} need {smem_bytes(variant, d, W, C)} bytes "
                         f"of shared memory a block, more than {_SMEM}")
    tiles_r, tiles_c = _tiles(variant, n, p)
    if tiles_r > 65535 or m > 65535:
        raise ValueError(f"qgram: {m} machines x {tiles_r} row tiles exceed the grid's limits")
    walk = min(tiles_c, max(1, math.ceil(m * tiles_r * tiles_c / (_AIM[variant] * sms))))
    walk = math.ceil(tiles_c / math.ceil(tiles_c / walk))  # balanced over the groups
    return Plan(variant, walk, math.ceil(tiles_c / walk))


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_FN = None
_QGRAM_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.library("qgram_packed").repro_qgram_packed_f32
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] * 8 + [ptr, ptr, ptr, ptr, ctypes.c_int64,
                                            ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def pack_meta(rates: torch.Tensor) -> torch.Tensor:
    """(..., 3, d) int32 [word index, bit offset, width] rows of each
    dimension's code in the packed row — ``_pack_meta`` of the reference."""
    w = rates.to(torch.int32)
    offs = torch.cumsum(w, -1, dtype=torch.int32) - w
    return torch.stack([offs // WORD_BITS, offs % WORD_BITS, w], dim=-2)


def _need(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"qgram_packed kernel: {msg}")


def _launch(pl: Plan, words, rates, scaled_cents, y, mask, out):
    """One launch of plan ``pl`` into ``out`` (checked operands; rates
    int32).  Counts nothing: the caller does."""
    m, n, W = words.shape
    d, C = scaled_cents.shape[1:]
    p = y.shape[-2]
    dev = words.device
    proj_bs = p * d if y.dim() == 3 else 0
    with torch.cuda.device(dev):
        err = _fn()(
            _VARIANT_ID[pl.variant], pl.walk, m, n, p, d, W, C, words.data_ptr(),
            rates.data_ptr(), scaled_cents.data_ptr(), y.data_ptr(), proj_bs,
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qgram_packed kernel launch failed: CUDA error {err}")


def tuned_plan(words, rates, scaled_cents, y, *, total_bits, mask=None) -> Plan:
    """The plan of a ``qgram_packed`` call on the card: the tile cached for
    its key ((m, n, W), (m, d, C), y's shape, int32, the bits, whether a
    mask is given), else a sweep of the menu on the call's own operands
    into a scratch output, the winner stored (:func:`runtime.autotune`);
    :func:`plan`'s tile where no sweep may run.  Operands as
    :func:`qgram_packed_cuda` takes them."""
    m, n, W = words.shape
    d, C = scaled_cents.shape[1:]
    p = y.shape[-2]
    dev = words.device
    sms = _sms(dev)
    key = runtime.cache_key(
        "qgram_packed", ((m, n, W), (m, d, C), tuple(y.shape)), torch.int32,
        bits=total_bits, extra=("mask" if mask is not None else "nomask",), device=dev,
    )
    rates = rates.to(torch.int32)
    scratch = None  # made on a miss only

    def measure(cand):
        nonlocal scratch
        try:
            pl = plan(m, n, p, d, W, C, sms, variant=cand[0])
        except ValueError:
            return None
        if scratch is None:
            scratch = torch.empty((m, n, p), dtype=torch.float32, device=dev)
        return runtime.time_candidate(
            lambda: _launch(pl, words, rates, scaled_cents, y, mask, scratch), dev)

    default = (plan(m, n, p, d, W, C, sms).variant,)
    win = runtime.autotune(key, runtime.tune_candidates("qgram_packed"), measure, default)
    return plan(m, n, p, d, W, C, sms, variant=win[0])


def qgram_packed_cuda(words, rates, scaled_cents, y, *, total_bits, mask=None, plan=None):
    """Launch the Hopper kernel once over all machines.  words (m, n, W)
    int32, rates (m, d) integer, scaled_cents (m, d, C) fp32, y (p, d) or
    (m, p, d) fp32, mask (m, n) fp32 or None; all contiguous on one CUDA
    device; tiled as ``plan`` says, or where it is None as the autotune
    cache says (:func:`tuned_plan`).  Raises on a bad operand or a refused
    launch; never falls back."""
    dev = words.device
    _need(dev.type == "cuda", f"words on {dev}, not a CUDA device")
    _need(words.dim() == 3 and scaled_cents.dim() == 3 and rates.dim() == 2,
          "expects words (m, n, W), rates (m, d), scaled_cents (m, d, C)")
    m, n, W = words.shape
    d, C = scaled_cents.shape[1:]
    p = y.shape[-2]
    _need(W == row_words(total_bits), f"{W} words per row, total_bits={total_bits}")
    _need(tuple(rates.shape) == (m, d) and scaled_cents.shape[0] == m,
          "machine axes of words, rates and scaled_cents differ")
    _need(y.shape[-1] == d and y.dim() in (2, 3) and (y.dim() == 2 or y.shape[0] == m),
          f"y must be (p, {d}) or ({m}, p, {d}), got {tuple(y.shape)}")
    _need(mask is None or tuple(mask.shape) == (m, n), f"mask must be ({m}, {n})")
    _need(words.dtype == torch.int32, f"words must be int32, got {words.dtype}")
    given = [("words", words), ("rates", rates), ("scaled_cents", scaled_cents), ("y", y)]
    given += [] if mask is None else [("mask", mask)]
    for name, t in given[2:]:
        _need(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    for name, t in given:
        _need(t.device == dev, f"{name} on {t.device}, words on {dev}")
        _need(t.is_contiguous(), f"{name} must be contiguous")
    rates = rates.to(torch.int32)  # the kernel builds pack_meta's rows from them
    out = torch.empty((m, n, p), dtype=torch.float32, device=dev)
    if m == 0 or n == 0 or p == 0:
        return out
    if plan is None:
        plan = tuned_plan(words, rates, scaled_cents, y, total_bits=total_bits, mask=mask)
    _launch(plan, words, rates, scaled_cents, y, mask, out)
    FAMILY.launches += 1
    return out


FAMILY = runtime.register("qgram_packed", qgram_packed_cuda, qgram_packed_plain)


def qgram_packed_batched(words, rates, scaled_cents, y, *, total_bits, mask=None):
    """G = decode(unpack(words)) y^T for every machine: words (m, n, W),
    rates (m, d), scaled_cents (m, d, C), y (p, d) shared or (m, p, d),
    mask (m, n) row validity (masked rows give zero rows) -> (m, n, p)."""
    return runtime.choose("qgram_packed", words)(
        words, rates, scaled_cents, y, total_bits=total_bits, mask=mask
    )


def qgram_packed(words, rates, scaled_cents, y, *, total_bits, mask=None):
    """One machine: words (n, W), rates (d,), scaled_cents (d, C), y (p, d),
    mask (n,) -> (n, p)."""
    return qgram_packed_batched(
        words[None], rates[None], scaled_cents[None], y, total_bits=total_bits,
        mask=None if mask is None else mask[None],
    )[0]


# --------------------------------------------------------------------------
# the unpacked int32-code API
# --------------------------------------------------------------------------


def _qgram_fn():
    global _QGRAM_FN
    if _QGRAM_FN is None:
        fn = build.library("qgram").repro_qgram_f32
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] * 7 + [ptr, ptr, ptr, ctypes.c_int64, ptr, ptr]
        fn.restype = ctypes.c_int
        _QGRAM_FN = fn
    return _QGRAM_FN


def _need_q(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"qgram kernel: {msg}")


def qgram_cuda(codes, scaled_cents, y):
    """Launch the Hopper kernel once over all machines: codes (m, n, d)
    int32, scaled_cents (m, d, C) fp32, y (p, d) or (m, p, d) fp32, all
    contiguous on one CUDA device -> (m, n, p), tiled as :func:`plan` says.
    Raises on a bad operand or a refused launch; never falls back."""
    dev = codes.device
    _need_q(dev.type == "cuda", f"codes on {dev}, not a CUDA device")
    _need_q(codes.dim() == 3 and scaled_cents.dim() == 3,
            f"expects codes (m, n, d) and scaled_cents (m, d, C), got "
            f"{tuple(codes.shape)} and {tuple(scaled_cents.shape)}")
    m, n, d = codes.shape
    C = scaled_cents.shape[-1]
    _need_q(tuple(scaled_cents.shape[:2]) == (m, d),
            f"scaled_cents must be ({m}, {d}, C), got {tuple(scaled_cents.shape)}")
    _need_q(y.dim() in (2, 3) and y.shape[-1] == d and (y.dim() == 2 or y.shape[0] == m),
            f"y must be (p, {d}) or ({m}, p, {d}), got {tuple(y.shape)}")
    if codes.dtype != torch.int32:
        raise TypeError(f"qgram kernel takes int32 codes, got {codes.dtype}")
    for name, t in (("scaled_cents", scaled_cents), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"qgram kernel takes float32 {name}, got {t.dtype}")
    for name, t in (("codes", codes), ("scaled_cents", scaled_cents), ("y", y)):
        _need_q(t.device == dev, f"{name} on {t.device}, codes on {dev}")
        _need_q(t.is_contiguous(), f"{name} must be contiguous")
    p = y.shape[-2]
    out = torch.empty((m, n, p), dtype=torch.float32, device=dev)
    if m == 0 or n == 0 or p == 0:
        return out
    y_bs = p * d if y.dim() == 3 else 0  # a shared y: stride 0 over machines
    pl = plan(m, n, p, d, None, C, _sms(dev))
    with torch.cuda.device(dev):
        err = _qgram_fn()(
            _VARIANT_ID[pl.variant], pl.walk, m, n, p, d, C, codes.data_ptr(), scaled_cents.data_ptr(), y.data_ptr(),
            y_bs, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qgram kernel launch failed: CUDA error {err}")
    QGRAM_FAMILY.launches += 1
    return out


QGRAM_FAMILY = runtime.register("qgram", qgram_cuda, qgram_plain)


def qgram_batched(codes, scaled_cents, y):
    """G = decode(codes) y^T for every machine: codes (m, n, d) int32 (pad
    rows with -1 so they decode to 0), scaled_cents (m, d, C), y (p, d)
    shared or (m, p, d) -> (m, n, p)."""
    return runtime.choose("qgram", codes)(codes, scaled_cents, y)


def qgram(codes, scaled_cents, y):
    """One machine: codes (n, d), scaled_cents (d, C), y (p, d) -> (n, p)."""
    return qgram_batched(codes[None], scaled_cents[None], y)[0]
