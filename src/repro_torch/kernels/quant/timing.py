"""Device times of the ``quant_encode`` and ``quant_decode`` kernels at the
wire's rows and the kernels bench shape against ``torch.searchsorted`` /
``torch.gather`` and the bound, on one card.

    python src/repro_torch/kernels/quant/timing.py [--reps 200]

Run as a file, it times the ``repro_torch`` package that Python imports
(``PYTHONPATH``), so the same script holds two checkouts' kernels against
each other on the same inputs: run it once with ``PYTHONPATH=src`` and once
with ``PYTHONPATH=<other checkout>/src``, one after the other on one card.
The operands are the package's seeded ``quant_operands`` (the same bits in
both checkouts).  It prints one JSON object: the card's name and power
limit (``nvidia-smi``), the package's path and, for each encode case, the
edges a row, the kernel's and ``torch.searchsorted``'s ms (on x transposed
to (d, n) beforehand, as it takes it), the bound's ms and what bounds it,
and whether the kernel's codes equal the plain version's; for each decode
case, the plan (``decode_plan``, where the package has one), the kernel's
and ``torch.gather``'s ms (on int64 codes transposed to (d, n)
beforehand), the bound's ms and what bounds it, and whether the kernel's
values equal the plain version's bit for bit (the -1 sentinel and codes
>= C planted).
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
ENCODE_CASES = [
    ("wire: 25 x 21, a 4096-edge row", 25, 21, 48, 12, True),
    ("wire: 25 x 21, 128 edges", 25, 21, 24, 12, False),
    ("bench: 1024 x 128, 4d bits, max 8", 1024, 128, 512, 8, False),
    ("bench: 1024 x 128, a 4096-edge row", 1024, 128, 512, 12, True),
]
DECODE_CASES = [
    ("wire: 25 x 21, a 4096-entry row", 25, 21, 48, 12, True),
    ("bench: 1024 x 128, 4d bits, max 8", 1024, 128, 512, 8, False),
    ("bench: 1024 x 128, a 256-entry row", 1024, 128, 512, 8, True),
    ("bench: 1024 x 128, a 4096-entry row", 1024, 128, 512, 12, True),
    ("large: 65536 x 128, 4d bits, max 8", 65536, 128, 512, 8, False),
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


def decode_bound_ms(codes, cents) -> tuple[float, str]:
    """The codes read and the values written once, and each distinct
    in-range table entry the codes look up once; no arithmetic."""
    n, d = codes.shape
    C = cents.shape[1]
    inside = (codes >= 0) & (codes < C)
    j = torch.arange(d, device=codes.device)
    looked = int(torch.unique((j * C + codes.long())[inside]).numel())
    return 4 * (2 * n * d + looked) / HBM_BYTES * 1e3, "bytes"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_encode / quant_decode timing needs a CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels.quant import ops
    from repro_torch.kernels.quant.cases import quant_operands
    from repro_torch.kernels.quant.ops import decode_cuda, decode_plain, encode_cuda, encode_plain

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rows, dec_rows = [], []
    for label, n, d, bits, max_bits, dominant in ENCODE_CASES:
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, n, d, bits, max_bits, dominant in DECODE_CASES:
        x, edges, cents, _ = quant_operands(n, d, bits, max_bits=max_bits, seed=n + d,
                                            dominant=dominant, device=dev)
        codes = encode_cuda(x, edges)
        C = cents.shape[1]
        probe = codes.clone()  # the -1 sentinel and codes past the table
        probe[0, 0], probe[-1, -1], probe[n // 2, d // 2] = -1, C, 2**31 - 1
        codes64 = codes.long().T.contiguous()
        b, by = decode_bound_ms(codes, cents)
        plan = getattr(ops, "decode_plan", None)  # an older checkout has none
        rows_plan = plan(n, d, C, sms)._asdict() if plan else None
        dec_rows.append({
            "case": label, "n": n, "d": d, "C": C, "plan": rows_plan,
            "bitwise": bool(torch.equal(decode_cuda(probe, cents), decode_plain(probe, cents))),
            "ms": device_ms(lambda: decode_cuda(codes, cents), args.reps),
            "library_ms": device_ms(lambda: torch.gather(cents, 1, codes64), args.reps),
            "bound_ms": b, "bound_by": by,
        })
    print(json.dumps({"card": card, "package": repro_torch.__file__, "cases": rows,
                      "decode_cases": dec_rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
