"""Device times of the fused serve epilogue and its tenant-batched form at
the shapes of the paths and the larger ones, against their rounding bound,
on one card.

    python src/repro_torch/kernels/epilogue/timing.py [--reps 20]

Run as a file, it times the ``repro_torch`` package that Python imports
(``PYTHONPATH``), so the same script holds two checkouts' kernels against
each other on the same inputs: run it once with ``PYTHONPATH=src`` and once
with ``PYTHONPATH=<other checkout>/src``, one after the other on one card.
The operands are the seeded ``epilogue_operands`` / ``epilogue_fleet_
operands`` of the package (the same bits in both checkouts).  It prints one
JSON object: the card's name and power limit (``nvidia-smi``), the
package's path and, for each case, the plan, the kernel's ms, the bound's
ms and what bounds it, the largest error and the largest error over
``epilogue_error_bound``.  No single PyTorch call computes the epilogue, so
there is no library time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

if __name__ == "__main__":  # run as a file: import the package from PYTHONPATH, not from here
    sys.path.pop(0)

import torch

HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores (data sheet)

# (label, T (None: the single-tenant kernel), m, t, K, operand kind)
CASES = [
    ("request", None, 40, 128, 25, "serve_cache"),
    ("test set t=4449", None, 40, 4449, 25, "serve_cache"),
    ("large K=300", None, 40, 130, 300, "generic"),
    ("fleet flush", 16, 40, 16, 25, "serve_cache"),
    ("fleet serve-sized", 8, 40, 128, 25, "serve_cache"),
]


def device_ms(fn, reps: int) -> float:
    """Device time per call: ``reps`` calls captured in a CUDA graph,
    replayed five times and timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def bound_ms(T, m, t, K, tensor_cores: bool) -> tuple[float, str]:
    """Each operand read once and the rows written once, over the card's
    memory rate; the products' 4 K^2 flops a point and expert (3xTF32 on
    the tensor cores: three TF32 products each) and the rest's 4 K + 6 in
    fp32, over their peak rates."""
    nbytes = 4 * T * (m * t * K + 2 * m * K * K + m * K + 2 * t + m + 3 * t)
    prod = T * m * t * 4 * K * K
    rest = T * m * t * (4 * K + 6)
    ops_s = (3 * prod / TF32_FLOPS if tensor_cores else prod / FP32_FLOPS) + rest / FP32_FLOPS
    return max((nbytes / HBM_BYTES * 1e3, "bytes"), (ops_s * 1e3, "operations"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("epilogue timing needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch
    from repro_torch.kernels.epilogue import ops
    from repro_torch.kernels.epilogue.cases import epilogue_fleet_operands, epilogue_operands
    from repro_torch.kernels.epilogue.ref import (
        epilogue_error_bound, epilogue_fleet_error_bound, epilogue_moments_fleet_plain,
        epilogue_moments_plain,
    )

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rows = []
    for label, T, m, t, K, kind in CASES:
        if T is None:
            opnds = epilogue_operands(m, t, K, seed=m + t + K, kind=kind, device=dev)
            kernel, plain, err_bound = ops.epilogue_cuda, epilogue_moments_plain, epilogue_error_bound
            pl = ops.plan(m, t, K)
        else:
            opnds = epilogue_fleet_operands(T, m, t, K, seed=T + m + t + K, kind=kind, device=dev)
            kernel, plain = ops.epilogue_fleet_cuda, epilogue_moments_fleet_plain
            err_bound = epilogue_fleet_error_bound
            pl = ops.plan_fleet(T, m, t, K)
        got = kernel(*opnds, fuse="kl")
        diff = (got - plain(*opnds, fuse="kl")).abs()
        worst = float((diff / err_bound(*opnds, fuse="kl")).max())
        b, by = bound_ms(T or 1, m, t, K, getattr(pl, "variant", None) == "mma")
        rows.append({
            "case": label, "T": T, "m": m, "t": t, "K": K, "plan": str(pl),
            "ms": device_ms(lambda: kernel(*opnds, fuse="kl"), args.reps),
            "bound_ms": b, "bound_by": by,
            "max_abs_err": float(diff.max()), "worst_err_over_bound": worst,
        })
        del opnds, got, diff
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "package": repro_torch.__file__, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
