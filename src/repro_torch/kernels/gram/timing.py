"""Device times of the gram kernel at the GP paths' short products, with
each tile of ``csrc/gram.cu`` forced in turn beside the one ``plan`` picks,
against the plain version and ``torch.matmul``, the bound and the launch
floor, on one card.

    python src/repro_torch/kernels/gram/timing.py [--reps N]

Run as a file, it times the ``repro_torch`` package that Python imports
(``PYTHONPATH``).  The operands are made here from a seed with numpy.  It
prints one JSON object: the card's name and power limit (``nvidia-smi``),
the launch floor (a one-element in-place add timed the same way) and, for
each case, the plan, the kernel's ms under every tile (one K range), the
plain version's and ``torch.matmul``'s ms, the bound's ms and what bounds
it, and the largest error of any tile against the plain version.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys

if __name__ == "__main__":  # run as a file: import the package from PYTHONPATH, not from here
    sys.path.pop(0)

import numpy as np
import torch

HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)

# (label, n, p, d): the center's fit and request products at Fig. 6
# (K = 25 center rows, d = 21) and center direct's fit call (N = 1000)
CASES = [
    ("fit: Xc (25) . Xc (25)", 25, 25, 21),
    ("request: X* (128) . Xc (25)", 128, 25, 21),
    ("direct request: Xc (25) . X* (128)", 25, 128, 21),
    ("direct fit: Xc (25) . X_recon (1000)", 25, 1000, 21),
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


def forced(x, y, tile: str):
    """The kernel with ``tile`` and K in one range (what ``plan`` gives
    these shapes but for the tile)."""
    from repro_torch.kernels.gram import ops

    n, d = x.shape
    p = y.shape[0]
    bk = ops.TILES[tile][2]
    out = torch.empty((n, p), dtype=torch.float32, device=x.device)
    err = ops._fn()(ops._TILE_ID[tile], n, p, d, 1, math.ceil(d / bk) * bk,
                    x.data_ptr(), x.stride(0), x.stride(1),
                    y.data_ptr(), y.stride(0), y.stride(1), None, out.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200, help="calls per graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gram timing needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch
    from repro_torch.kernels.gram import ops

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda: one.add_(1.0), args.reps)
    rows = []
    for label, n, p, d in CASES:
        rng = np.random.default_rng(n + p + d)
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.normal(size=(p, d)).astype(np.float32)).to(dev)
        want = ops.gram_plain(x, y)
        t_b = 4 * (n * d + p * d + n * p) / HBM_BYTES * 1e3
        t_f = 2 * n * p * d / FP32_FLOPS * 1e3
        rows.append({
            "case": label, "n": n, "p": p, "d": d,
            "plan": dataclasses.asdict(ops.plan(n, p, d, sms)),
            "ms": device_ms(lambda: ops.gram_cuda(x, y), args.reps),
            "tile_ms": {t: device_ms(lambda t=t: forced(x, y, t), args.reps) for t in ops.TILES},
            "max_abs_err": max(float((forced(x, y, t) - want).abs().max()) for t in ops.TILES),
            "plain_ms": device_ms(lambda: ops.gram_plain(x, y), args.reps),
            "matmul_ms": device_ms(lambda: torch.matmul(x, y.T), args.reps),
            "bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations",
        })
    print(json.dumps({"card": card, "package": repro_torch.__file__, "launch_floor_ms": floor,
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
