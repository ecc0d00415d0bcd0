"""Public wrapper of the decode-attention kernel — counterpart of
``repro/kernels/decode_attn/ops.py``.

:func:`decode_attn` attends one query token per (batch, query head) to a
(ring) KV cache: through the hand-written Hopper kernel
(``csrc/decode_attn.cu``, family ``"decode_attn"``) for CUDA tensors and
through :func:`.ref.decode_attn_plain` for CPU tensors
(:func:`repro_torch.kernels.runtime.choose`).  Both return the normalized
output, as the reference's public function does.  The kernel masks the
ragged end of S itself, so nothing is padded here (the reference pads S to
a chunk multiple with empty slots).  It reads kpos before any K or V row
and reads only the valid slots' rows; it splits S across blocks when
B x KV is small against the card's SMs.  :func:`plan` picks the kernel
(the tensor-core warp kernel for bf16 K/V, the block kernel otherwise)
and the split.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import build, runtime
from ...roofline.hlo_cost import register_bytes
from .ref import NEG, decode_attn_plain

__all__ = ["decode_attn", "decode_attn_cuda", "decode_attn_plain", "plan", "Plan", "FAMILY",
           "NEG", "warp_smem"]

GROUP = 8  # query heads per block
HD_MAX = 512  # largest head dim the kernel takes
HD_MMA = 256  # largest head dim of the tensor-core path
_BLOCKS_PER_SM = 4  # block kernel: split S until the grid holds about this many blocks an SM
_TILE = 128  # block kernel: most valid slots a tile takes (one a thread)
_WARP_SLOTS = 512  # warp kernel: most slots in a warp's range (its kpos list)
_WARPS = 4  # warp kernel: warps of a block, each its own range, merged at the end
_WARP_STAGES = 2  # warp kernel: stages in a warp's copy ring (WNST in the source)
_SM_SMEM = 227 * 1024  # shared memory an SM gives its blocks (H100)

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.library("decode_attn").repro_decode_attn
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([i32] * 11 + [ptr] * 5 + [i64, i32, i64, i32, ctypes.c_float]
                       + [ptr] * 5)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``csrc/decode_attn.cu`` walks the cache.  ``path`` "mma": the
    warp kernel (bf16 K/V, scores and weighted sum on the tensor cores),
    "simt": the block kernel (CUDA cores).  S is cut into ``splits`` ranges
    of ``slots_per_split`` (a multiple of 128; the last may be shorter,
    none is empty)."""

    path: str
    splits: int
    slots_per_split: int


def warp_smem(hd: int, q_terms: int) -> int:
    """Shared memory of one warp-kernel block (``WarpLayout`` in the
    source): Q^T's B fragments, then for each of its four warps a slot list
    and a ring of 16-slot K and V stages at a row pitch of hd rounded up to
    16, plus 8."""
    hdp = -(-hd // 16) * 16
    per_warp = _WARP_SLOTS * 4 + 2 * _WARP_STAGES * 16 * (hdp + 8) * 2
    return q_terms * (hdp // 16) * 32 * 8 + _WARPS * per_warp


def plan(B: int, S: int, KV: int, G: int, hd: int, kv_bytes: int, sms: int = 132,
         aligned: bool = True) -> Plan:
    """The kernel's plan for B x KV x G heads over S slots of head dim
    ``hd`` in ``kv_bytes``-byte K/V elements, on a card with ``sms`` SMs
    (``aligned``: K and V start on 16 bytes) — a function of its arguments
    alone.  bf16 K/V with 16-byte rows and hd <= 256 take the warp kernel:
    blocks of four warps, a warp a quarter of the block's range (at most
    512 slots), as many ranges over B x KV x ceil(G / 8) as the SMs hold
    blocks at once (by shared memory, :func:`warp_smem`, as for fp32 q),
    stages of 16 slots in a ring of two.  The rest take the block kernel:
    about four blocks an SM, tiles of up to 128 valid slots."""
    base = B * KV * math.ceil(G / GROUP)
    if kv_bytes == 2 and aligned and hd % 8 == 0 and hd <= HD_MMA:
        per_sm = _SM_SMEM // (warp_smem(hd, q_terms=3) + 1024)  # blocks an SM holds at once
        want = max(1, per_sm * sms // base)  # ranges a row, the grid within one wave
        unit = 32 * _WARPS  # a block's range: four warp ranges of whole 32-slot windows
        sps = min(_WARPS * _WARP_SLOTS, max(unit, -(-math.ceil(S / want) // unit) * unit))
        return Plan("mma", math.ceil(S / sps), sps)
    tiles = math.ceil(S / _TILE)
    want = max(1, min(tiles, math.ceil(_BLOCKS_PER_SM * sms / max(base, 1))))
    sps = math.ceil(tiles / want) * _TILE
    return Plan("simt", math.ceil(S / sps), sps)


def _need(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"decode_attn kernel: {msg}")


_TYPES = (torch.float32, torch.bfloat16)


def decode_attn_cuda(q, K, V, kpos, pos, *, window=None, softcap=None):
    """Launch the Hopper kernel: q (B, KV, G, hd) and K, V (B, S, KV, hd)
    float32 or bfloat16 (K and V of one type), kpos (B, S) int32, all
    contiguous on one CUDA device; pos a Python int or a 0-d int32 tensor
    on that device (read by the kernel, never synchronized on); window None
    or an int; softcap None or a positive float (each valid slot's score
    s becomes softcap tanh(s / softcap) before the softmax).  -> (B, KV,
    G, hd) fp32.  Raises on a bad operand or a refused launch; never falls
    back.  The launch is the custom op ``torch.ops.repro_torch.decode_attn``
    (CUDA only), whose fake implementation lets a dry run on fake ``cuda``
    tensors trace this path without launching; the op carries its FLOP and
    byte counts for the cost counter (``repro_torch.roofline``)."""
    dev = q.device
    _need(dev.type == "cuda", f"q on {dev}, not a CUDA device")
    _need(q.dim() == 4 and K.dim() == 4 and V.dim() == 4 and kpos.dim() == 2,
          f"expects q (B, KV, G, hd), K/V (B, S, KV, hd), kpos (B, S); got "
          f"{tuple(q.shape)}, {tuple(K.shape)}, {tuple(V.shape)}, {tuple(kpos.shape)}")
    B, KV, G, hd = q.shape
    S = K.shape[1]
    _need(tuple(K.shape) == (B, S, KV, hd) and tuple(V.shape) == (B, S, KV, hd),
          f"K and V must be ({B}, S, {KV}, {hd}), got {tuple(K.shape)} and {tuple(V.shape)}")
    _need(tuple(kpos.shape) == (B, S), f"kpos must be ({B}, {S}), got {tuple(kpos.shape)}")
    _need(S > 0, "the cache has no slots (S = 0)")
    _need(hd <= HD_MAX, f"head dim {hd} above {HD_MAX}")
    if q.dtype not in _TYPES or K.dtype not in _TYPES or V.dtype != K.dtype:
        raise TypeError(f"decode_attn kernel takes q and K = V in float32 or bfloat16, got "
                        f"{q.dtype}, {K.dtype}, {V.dtype}")
    if kpos.dtype != torch.int32:
        raise TypeError(f"decode_attn kernel takes int32 kpos, got {kpos.dtype}")
    for name, t in (("q", q), ("K", K), ("V", V), ("kpos", kpos)):
        _need(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _need(t.is_contiguous(), f"{name} must be contiguous")
    if isinstance(pos, torch.Tensor):
        _need(pos.dim() == 0 and pos.dtype == torch.int32 and pos.device == dev,
              f"pos must be a 0-d int32 tensor on {dev}, got {pos.dtype} "
              f"{tuple(pos.shape)} on {pos.device}")
        pos_t, pos_val = pos, 0
    else:
        pos_t, pos_val = None, int(pos)
    _need(softcap is None or float(softcap) > 0, f"softcap must be positive, got {softcap}")
    window = None if window is None else int(window)
    softcap = None if softcap is None else float(softcap)
    return torch.ops.repro_torch.decode_attn(q, K, V, kpos, pos_t, pos_val, window, softcap)


@torch.library.custom_op("repro_torch::decode_attn", mutates_args=(), device_types="cuda")
def _decode_attn_op(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor, kpos: torch.Tensor,
                    pos: Optional[torch.Tensor], pos_val: int, window: Optional[int],
                    softcap: Optional[float]) -> torch.Tensor:
    """The launch, as a custom op (operands checked by
    :func:`decode_attn_cuda`; ``pos`` the 0-d tensor or None and then
    ``pos_val``): a fake tensor takes :func:`_decode_attn_fake` instead, so
    a dry run traces the card's path and launches nothing."""
    dev = q.device
    B, KV, G, hd = q.shape
    S = K.shape[1]
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    has_window, win = (0, 0) if window is None else (1, int(window))
    has_cap, cap = (0, 0.0) if softcap is None else (1, float(softcap))
    vec = hd % 8 == 0 and K.data_ptr() % 16 == 0 and V.data_ptr() % 16 == 0
    pl = plan(B, S, KV, G, hd, K.element_size(),
              torch.cuda.get_device_properties(dev).multi_processor_count, aligned=vec)
    nsplit = pl.splits
    part_acc = torch.empty((B, KV, nsplit, G, hd), dtype=torch.float32, device=dev)
    part_md = torch.empty((2, B, KV, nsplit, G), dtype=torch.float32, device=dev)
    bf = torch.bfloat16
    with torch.cuda.device(dev):
        err = _fn()(
            int(q.dtype == bf), int(K.dtype == bf), int(vec), int(pl.path == "mma"), B, S, KV,
            G, hd, nsplit, pl.slots_per_split,
            q.data_ptr(), K.data_ptr(), V.data_ptr(), kpos.data_ptr(),
            None if pos is None else pos.data_ptr(), pos_val,
            has_window, win, has_cap, cap, part_acc.data_ptr(), part_md[0].data_ptr(),
            part_md[1].data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error {err}")
    FAMILY.launches += 1
    return out


@_decode_attn_op.register_fake
def _decode_attn_fake(q, K, V, kpos, pos, pos_val, window, softcap):
    return q.new_empty(q.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.decode_attn)
def _decode_attn_flops(q_shape, K_shape, *args, out_shape=None, **kwargs) -> int:
    """Scores and the weighted sum over every slot: 4 B KV G S hd."""
    B, KV, G, hd = q_shape
    return 4 * B * KV * G * K_shape[1] * hd


def _decode_attn_bytes(q, K, V, kpos, *args, out=None, **kwargs) -> int:
    """q, K, V and kpos read once, the output written once."""
    return sum(t.numel() * t.element_size() for t in (q, K, V, kpos, out))


register_bytes(torch.ops.repro_torch.decode_attn, _decode_attn_bytes)


FAMILY = runtime.register("decode_attn", decode_attn_cuda, decode_attn_plain)


def decode_attn(q, K, V, kpos, pos, *, window=None, softcap=None):
    """Single-token GQA attention over a ring KV cache: q (B, KV, G, hd),
    K/V (B, S, KV, hd), kpos (B, S) (-1 = empty slot), pos the current
    position; optional sliding ``window`` and attention logit ``softcap``
    (gemma2's).  Returns (B, KV, G, hd) fp32."""
    return runtime.choose("decode_attn", q)(q, K, V, kpos, pos, window=window, softcap=softcap)
