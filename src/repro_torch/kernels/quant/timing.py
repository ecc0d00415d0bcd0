"""Device times of the ``quant_encode`` kernel at the wire's rows and the
kernels bench shape against ``torch.searchsorted`` and the bound, on one
card.

    python src/repro_torch/kernels/quant/timing.py [--reps 200]

Run as a file, it times the ``repro_torch`` package that Python imports
(``PYTHONPATH``), so the same script holds two checkouts' kernels against
each other on the same inputs: run it once with ``PYTHONPATH=src`` and once
with ``PYTHONPATH=<other checkout>/src``, one after the other on one card.
The operands are the package's seeded ``quant_operands`` (the same bits in
both checkouts).  It prints one JSON object: the card's name and power
limit (``nvidia-smi``), the package's path and, for each case, the edges a
row, the kernel's and ``torch.searchsorted``'s ms (on x transposed to
(d, n) beforehand, as it takes it), the bound's ms and what bounds it, and
whether the kernel's codes equal the plain version's.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

if __name__ == "__main__":  # run as a file: import the package from PYTHONPATH, not from here
    sys.path.pop(0)

import torch

HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet): fp32 compares

# (label, n, d, total bits, max bits, one dominant dimension)
CASES = [
    ("wire: 25 x 21, a 4096-edge row", 25, 21, 48, 12, True),
    ("wire: 25 x 21, 128 edges", 25, 21, 24, 12, False),
    ("bench: 1024 x 128, 4d bits, max 8", 1024, 128, 512, 8, False),
    ("bench: 1024 x 128, a 4096-edge row", 1024, 128, 512, 12, True),
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


def bound_ms(x, edges) -> tuple[float, str]:
    """x, the codes and the finite edges read or written once; a binary
    search's ceil(log2(E + 1)) comparisons a symbol over its row's finite
    edges."""
    n, d = x.shape
    live = torch.isfinite(edges).sum(1).double()
    nbytes = 4 * (2 * n * d + int(live.sum()))
    ops = n * float(torch.ceil(torch.log2(live + 1)).sum())
    return max((nbytes / HBM_BYTES * 1e3, "bytes"), (ops / FP32_FLOPS * 1e3, "operations"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_encode timing needs a CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels.quant.cases import quant_operands
    from repro_torch.kernels.quant.ops import encode_cuda, encode_plain

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rows = []
    for label, n, d, bits, max_bits, dominant in CASES:
        x, edges, _, _ = quant_operands(n, d, bits, max_bits=max_bits, seed=n + d,
                                        dominant=dominant, device=dev)
        xt = x.T.contiguous()
        b, by = bound_ms(x, edges)
        rows.append({
            "case": label, "n": n, "d": d, "E": edges.shape[1],
            "bitwise": bool(torch.equal(encode_cuda(x, edges), encode_plain(x, edges))),
            "ms": device_ms(lambda: encode_cuda(x, edges), args.reps),
            "library_ms": device_ms(lambda: torch.searchsorted(edges, xt), args.reps),
            "bound_ms": b, "bound_by": by,
            "search_steps": math.ceil(math.log2(edges.shape[1] + 1)),
        })
    print(json.dumps({"card": card, "package": repro_torch.__file__, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
