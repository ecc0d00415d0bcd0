"""Public wrapper of the ``gram`` kernel — counterpart of
``repro/kernels/gram/ops.py``.

:func:`gram` computes G = X Y^T through the hand-written Hopper kernel
(``csrc/gram.cu``) for CUDA tensors and through :func:`.ref.gram_plain` for
CPU tensors (:func:`repro_torch.kernels.runtime.choose`).  It is a
``torch.autograd.Function`` whose backward is the same kernel twice —
dX = g Y and dY = g^T X are gram products too (``_gram_bwd`` in the
reference) — so training through it stays differentiable.  The kernel reads
its operands through their strides, so the backward passes transposed
views without copies, and ragged shapes need no padding.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, runtime
from .ref import gram_plain

__all__ = ["gram", "gram_cuda", "gram_plain", "FAMILY"]

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.library("gram").repro_gram_f32
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ptr, i64, i64, ptr, i64, i64, ptr, ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def gram_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper gram kernel: x (n, d), y (p, d) fp32 CUDA tensors
    on one device, any strides -> (n, p) fp32.  Raises on a bad operand or
    a refused launch; never falls back."""
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
    with torch.cuda.device(x.device):
        err = _fn()(
            n, p, d, x.data_ptr(), x.stride(0), x.stride(1),
            y.data_ptr(), y.stride(0), y.stride(1), out.data_ptr(),
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
