"""Public wrapper of the ``gram`` kernel — counterpart of
``repro/kernels/gram/ops.py``.

:func:`gram` computes G = X Y^T through the hand-written Hopper kernel
(``csrc/gram.cu``) for CUDA tensors and through :func:`.ref.gram_plain` for
CPU tensors (:func:`repro_torch.kernels.runtime.choose`).  It is a
``torch.autograd.Function`` whose backward is the same kernel twice —
dX = g Y and dY = g^T X are gram products too (``_gram_bwd`` in the
reference) — so training through it stays differentiable.  The kernel reads
its operands through their strides, so the backward passes transposed
views without copies, and ragged shapes need no padding.  :func:`plan`
picks the kernel's tile configuration and its split of K from the shape
alone.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from .. import build, runtime
from .ref import gram_plain

__all__ = ["gram", "gram_cuda", "gram_plain", "plan", "Plan", "residency", "TILES",
           "FAMILY"]

# csrc/gram.cu's tile configurations: name -> (rows BM, columns BN, k-slab
# BK, blocks an SM holds — its registers and shared memory, as the card's
# occupancy API reports them: chip_smoke.py checks these against
# residency())
TILES = {"small": (64, 64, 32, 2), "wide": (128, 128, 16, 2), "narrow24": (128, 24, 32, 5)}
_TILE_ID = {"small": 0, "wide": 1, "narrow24": 2}
_FEW = 8  # small-tile blocks of an output that one small launch serves whole
_K_MIN = 256  # the shortest range of K a split takes


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``csrc/gram.cu`` computes one product: the tile configuration
    (a key of :data:`TILES`) and K cut into ``splits`` ranges of
    ``k_per_split`` (a multiple of the tile's BK; the last may be shorter,
    none is empty)."""

    tile: str
    splits: int
    k_per_split: int


def plan(n: int, p: int, d: int, sms: int = 132) -> Plan:
    """The kernel's plan for an (n, p) output over K = d on a card with
    ``sms`` SMs — a function of its arguments alone.

    A short product whose output is a few small tiles (the GP request and
    fit products, 128 x 25 and 25 x 25 at d = 21) takes the small tile
    whole: one launch, bound by its latency.  Otherwise an output of at
    most 24 columns (the backward's n x d and p x d at d <= 24) takes the
    narrow tile, one of at most 32 the small tile, one whose wide tiles
    fill every SM the wide tile, the rest the small one.  K is split where the tiles do not fill the blocks the card holds
    at once (one wave) and K holds two ranges of 256 or more: into as many
    ranges as fill about two waves, each 256 or more (measured faster than
    one wave on the H100 for both backward products)."""
    small = math.ceil(n / 64) * math.ceil(p / 64)
    if small <= _FEW and d < 2 * _K_MIN:
        tile = "small"
    elif p <= 24:
        tile = "narrow24"
    elif p <= 32:  # at most half a small tile's width: the wide tile would be 3/4 padding
        tile = "small"
    elif math.ceil(n / 128) * math.ceil(p / 128) >= sms:
        tile = "wide"
    else:
        tile = "small"
    bm, bn, bk, per_sm = TILES[tile]
    blocks = max(1, math.ceil(n / bm) * math.ceil(p / bn))
    wave = per_sm * sms
    splits = 1
    if blocks < wave and d >= 2 * _K_MIN:
        splits = min(2 * wave // blocks, d // _K_MIN)
    kps = math.ceil(math.ceil(d / bk) / splits) * bk
    return Plan(tile, math.ceil(d / kps) if d else 1, kps)


def residency(tile: str) -> int:
    """Blocks of ``tile``'s kernel an SM of the current card holds, from
    the CUDA occupancy API (builds the kernel library)."""
    fn = build.library("gram").repro_gram_residency
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(_TILE_ID[tile])


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.library("gram").repro_gram_f32
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [i32] * 6 + [ptr, i64, i64, ptr, i64, i64, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def gram_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper gram kernel: x (n, d), y (p, d) fp32 CUDA tensors
    on one device, any strides -> (n, p) fp32, computed as :func:`plan`
    says.  A split plan launches two CUDA kernels (the partial products
    into a workspace, then their sum in split order); either way it is one
    call of the family, so ``FAMILY.launches`` counts one.  Raises on a bad
    operand or a refused launch; never falls back."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(
            f"gram expects x (n, d) and y (p, d), got {tuple(x.shape)} and "
            f"{tuple(y.shape)}"
        )
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"gram kernel takes float32, got {x.dtype} and {y.dtype}")
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(
            f"gram kernel needs both operands on one CUDA device, got "
            f"{x.device} and {y.device}"
        )
    n, d = x.shape
    p = y.shape[0]
    out = torch.empty((n, p), dtype=torch.float32, device=x.device)
    if n == 0 or p == 0:
        return out
    pl = plan(n, p, d, torch.cuda.get_device_properties(x.device).multi_processor_count)
    ws = (torch.empty((pl.splits, n, p), dtype=torch.float32, device=x.device)
          if pl.splits > 1 else None)
    with torch.cuda.device(x.device):
        err = _fn()(
            _TILE_ID[pl.tile], n, p, d, pl.splits, pl.k_per_split,
            x.data_ptr(), x.stride(0), x.stride(1),
            y.data_ptr(), y.stride(0), y.stride(1),
            None if ws is None else ws.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    FAMILY.launches += 1
    return out


FAMILY = runtime.register("gram", gram_cuda, gram_plain)


class _Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return runtime.choose("gram", x)(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        impl = runtime.choose("gram", g)
        # d(X Y^T)/dX . g = g Y;  d/dY . g = g^T X — both gram products
        dx = impl(g, y.T) if ctx.needs_input_grad[0] else None
        dy = impl(g.T, x.T) if ctx.needs_input_grad[1] else None
        return dx, dy


def gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """G = X Y^T for any (n, d) / (p, d) shapes, differentiable."""
    return _Gram.apply(x.to(torch.float32), y.to(torch.float32))
