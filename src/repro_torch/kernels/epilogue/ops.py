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
padded here.  :func:`plan` / :func:`plan_fleet` pick, from the shape, the
kernel variant (CUDA-core fp32 at small K, 3xTF32 tensor-core products at
large K), the test-point tile and the expert groups, which the launch sums
in group order itself.  The fleet kernel's (variant, tile) is swept on the
card and cached by launch shape (:func:`fleet_epilogue_plan`, the
reference's tuned t-tile through :func:`repro_torch.kernels.runtime.
autotune`); the single-tenant kernel keeps the pure plan, as the reference
does not tune it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import build, runtime
from .ref import EPILOGUE_FUSES, epilogue_moments_fleet_plain, epilogue_moments_plain

__all__ = ["epilogue_moments", "epilogue_cuda", "epilogue_moments_plain",
           "epilogue_moments_fleet", "epilogue_fleet_cuda", "epilogue_moments_fleet_plain",
           "Plan", "plan", "plan_fleet", "smem_bytes", "fleet_epilogue_plan",
           "fleet_epilogue_block", "SMALL_K", "MMA_POINTS", "VARIANTS", "FAMILY", "FLEET_FAMILY"]

SMALL_K = 32  # the largest K of the small (CUDA-core) variant
MMA_POINTS = 2048  # points (T * t) from which K <= SMALL_K takes the mma variant
_JS, _NST = 36, 3  # the mma variant's padded chunk row and chunk buffers (epilogue_body.cuh)
_SMEM = 232_448  # shared memory one block may use on Hopper
_STATIC = 16  # the kernels' static shared memory (the last-block flag)
_BLOCKS_PER_SM = 8  # blocks the expert groups aim for on each SM
VARIANTS = ("small", "mma")

# the fleet kernel's autotune menu: (variant, test points a block), each
# feasible where csrc/epilogue_body.cuh's launch_epilogue takes it
runtime.register_tune_candidates(
    "epilogue_fleet", (("small", 16), ("small", 32), ("mma", 128), ("mma", 32), ("mma", 16))
)


class Plan(NamedTuple):
    """How ``csrc/epilogue_body.cuh`` runs a shape: ``variant`` "small"
    (four threads a point, CUDA-core fp32, K <= :data:`SMALL_K`; tt 16 or
    32) or "mma" (3xTF32 tensor-core products; tt 128 at K <= SMALL_K, else
    32 or 16), ``tt`` test points a block, ``groups``
    expert groups of ceil(m / groups) consecutive experts (summed in group
    order inside the launch)."""

    variant: str
    tt: int
    groups: int


_FNS: dict = {}
_COUNTERS: dict = {}


def _fn(lib: str, symbol: str, n_ints: int):
    """The C entry ``symbol`` of kernel library ``lib`` (built on first
    use): ``n_ints`` int arguments, then eleven pointers (seven operands,
    out, scratch, counters, stream)."""
    if symbol not in _FNS:
        fn = getattr(build.library(lib), symbol)
        fn.argtypes = [ctypes.c_int] * n_ints + [ctypes.c_void_p] * 11
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return _FNS[symbol]


def smem_bytes(variant: str, tt: int, K: int) -> int:
    """Shared memory of one block (``csrc/epilogue_body.cuh``'s layout plus
    its static flag).  small: two stage buffers of Ainv and P (KP rows of
    KS floats, KP = K rounded up to 4, KS / 4 odd), walpha + w and the
    tile's G rows; mma: Bt (tt x (kb + 4), kb = K rounded up to 64), two
    chunk buffers (64 + tt rows of 36), walpha + w and the column groups'
    quad and mu partials."""
    if variant == "small":
        kp = -(-K // 4) * 4
        ks = kp if (kp // 4) % 2 else kp + 4
        floats = 2 * (2 * kp * ks + kp + 4 + -(-tt * K // 4) * 4)
    elif variant == "mma":
        nbc = 32 if K <= SMALL_K else 64  # the n-block
        kb = -(-K // nbc) * nbc
        floats = (tt * (kb + 4) + _NST * (nbc + tt) * _JS + 2 * (kb + 4)
                  + 2 * (128 // tt) * tt)
    else:
        raise ValueError(f"epilogue kernel: unknown variant {variant!r}")
    return 4 * floats + _STATIC


def plan_fleet(T: int, m: int, t: int, K: int, sms: int = 132,
               tile: tuple | None = None) -> Plan:
    """The plan of a launch over T tenants.  ``tile`` = (variant, tt)
    forces the tile where the kernel takes it (small: K <= :data:`SMALL_K`,
    tt 16 or 32; mma: tt 128 at K <= SMALL_K, else 32 or 16; shared memory
    within the block's) and raises ValueError elsewhere.  Otherwise, K <=
    SMALL_K: the small variant, a tile of 32 points (16 when t <= 16),
    unless the launch holds :data:`MMA_POINTS` points or more (T * t),
    where the mma variant's tile of 128 points is faster (measured;
    PERF.md section 6).  Larger K:
    the mma variant, a tile of 32 points, 16 once 32 no longer fit shared
    memory (K > 1344), so the tile shrinks as K grows.  Then enough expert
    groups that the grid's T * ceil(t / tt) tiles reach ~8 blocks on each
    of the card's ``sms`` multiprocessors.  Raises for a K no tile fits
    (K > 2688)."""
    if tile is not None:
        variant, tt = tile
        ok = {"small": (16, 32) if K <= SMALL_K else (),
              "mma": (128,) if K <= SMALL_K else (32, 16)}.get(variant, ())
        if tt not in ok or smem_bytes(variant, tt, K) > _SMEM:
            raise ValueError(f"epilogue kernel: no {variant}/{tt} tile at K={K}")
    elif K <= SMALL_K:
        variant, tt = ("mma", 128) if T * t >= MMA_POINTS else ("small", 16 if t <= 16 else 32)
    else:
        variant = "mma"
        for tt in (32, 16):
            if smem_bytes(variant, tt, K) <= _SMEM:
                break
        else:
            raise ValueError(
                f"epilogue kernel: K={K} does not fit in shared memory even 16 test "
                "points at a time"
            )
    tiles = T * math.ceil(t / tt)
    groups = min(m, max(1, math.ceil(_BLOCKS_PER_SM * sms / tiles)))
    per = math.ceil(m / groups)
    return Plan(variant, tt, math.ceil(m / per))


def plan(m: int, t: int, K: int, sms: int = 132) -> Plan:
    """The plan of a single-tenant launch: :func:`plan_fleet` at T = 1."""
    return plan_fleet(1, m, t, K, sms)


def fleet_epilogue_plan(T: int, m: int, t: int, K: int, *, fuse: str = "kl",
                        device=None) -> Plan:
    """The fleet kernel's plan for a launch shape on ``device``: the
    (variant, tile) cached for its key ((T, m, t, K), float32, the fuse),
    else a sweep of the menu on zero operands of the launch shape, the
    winner stored (:func:`runtime.autotune`); :func:`plan_fleet`'s where
    no sweep may run.  Off the card (``device`` None or not CUDA) the pure
    :func:`plan_fleet`."""
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        return plan_fleet(T, m, t, K)
    sms = _sms(dev)
    key = runtime.cache_key("epilogue_fleet", ((T, m, t, K),), torch.float32,
                            extra=(f"fuse={fuse}",), device=dev)
    ops = out = None  # made on a miss only

    def measure(cand):
        nonlocal ops, out
        try:
            pl = plan_fleet(T, m, t, K, sms, tile=cand)
        except ValueError:
            return None
        if ops is None:
            z = lambda *shape, v=0.0: torch.full(shape, v, dtype=torch.float32, device=dev)
            ops = (z(T, m, t, K), z(T, m, K, K), z(T, m, K, K), z(T, m, K),
                   z(T, t, v=1.0), z(T, t, v=1.0), z(T, m, v=1.0))
            out = torch.empty((T, 3, t), dtype=torch.float32, device=dev)
        fn = _fn("epilogue_fleet", "repro_epilogue_fleet_f32", 8)
        return runtime.time_candidate(
            lambda: _launch(fn, fuse, (T, m, t, K), pl, ops, out, "epilogue_fleet"), dev)

    pure = plan_fleet(T, m, t, K, sms)
    win = runtime.autotune(key, runtime.tune_candidates("epilogue_fleet"), measure,
                           (pure.variant, pure.tt))
    return plan_fleet(T, m, t, K, sms, tile=win)


def fleet_epilogue_block(T: int, m: int, t: int, K: int, *, fuse: str = "kl",
                         device=None) -> int:
    """The t-tile of :func:`fleet_epilogue_plan` (the reference's tuned
    block)."""
    return fleet_epilogue_plan(T, m, t, K, fuse=fuse, device=device).tt


def _counters(dev, n: int) -> torch.Tensor:
    """At least ``n`` tile counters on ``dev``: zeros that every launch
    leaves zero (the last block of a tile resets its own), kept for the
    process so that a launch allocates none.  Launches on one device are
    ordered by its stream, as the port's callers issue them."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return buf


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


def _launch(fn, fuse, shape, pl: Plan, ops, out, name):
    """Launch plan ``pl`` over ``shape`` ((m, t, K) or (T, m, t, K)): the
    group partials' scratch and the tile counters when it splits the
    experts."""
    dev = out.device
    T, t = (1, shape[1]) if len(shape) == 3 else (shape[0], shape[2])
    scratch = counters = None
    if pl.groups > 1:
        scratch = torch.empty((pl.groups,) + out.shape, dtype=torch.float32, device=dev)
        counters = _counters(dev, T * math.ceil(t / pl.tt))
    ints = (*shape, VARIANTS.index(pl.variant), pl.tt, pl.groups)
    with torch.cuda.device(dev):
        err = fn(
            EPILOGUE_FUSES.index(fuse), *ints, *(a.data_ptr() for a in ops),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(),
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
    _launch(_fn("epilogue", "repro_epilogue_f32", 7), fuse, (m, t, K),
            plan(m, t, K, _sms(G.device)), ops.values(), out, "epilogue")
    FAMILY.launches += 1
    return out


FAMILY = runtime.register("epilogue", epilogue_cuda, epilogue_moments_plain)


def epilogue_moments(G, Ainv, P, walpha, gss, prior, w, *, fuse):
    """Summed fusion moment rows S (3, t) for m cached Nyström experts —
    the fused serve epilogue.  Callers finish with the fusion's
    ``finalize(S, m, prior)``."""
    return runtime.choose("epilogue", G)(G, Ainv, P, walpha, gss, prior, w, fuse=fuse)


def epilogue_fleet_cuda(G, Ainv, P, walpha, gss, prior, w, *, fuse, plan=None):
    """Launch the Hopper fleet epilogue kernel: G (T, m, t, K), Ainv and P
    (T, m, K, K), walpha (T, m, K), gss and prior (T, t), w (T, m), all
    fp32, contiguous, on one CUDA device -> (T, 3, t), each tenant summing
    only its own experts; tiled as ``plan`` says (None: :func:`plan_fleet`).
    Raises on a bad operand or a refused launch; never falls back."""
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
    if plan is None:
        plan = plan_fleet(T, m, t, K, _sms(G.device))
    _launch(_fn("epilogue_fleet", "repro_epilogue_fleet_f32", 8), fuse, (T, m, t, K),
            plan, ops.values(), out, "epilogue_fleet")
    FLEET_FAMILY.launches += 1
    return out


FLEET_FAMILY = runtime.register("epilogue_fleet", epilogue_fleet_cuda,
                                epilogue_moments_fleet_plain)


def epilogue_moments_fleet(G, Ainv, P, walpha, gss, prior, w, *, fuse, plan=None):
    """Per-tenant summed fusion moment rows S (T, 3, t) — the fused serve
    epilogue batched over a leading tenant axis, one kernel launch for the
    whole mixed-tenant micro-batch.  ``plan``: the kernel's (None:
    :func:`plan_fleet`; the plain version has none).  Callers finish with
    the fusion's ``finalize`` per tenant."""
    return runtime.choose("epilogue_fleet", G)(G, Ainv, P, walpha, gss, prior, w, fuse=fuse,
                                               plan=plan)
