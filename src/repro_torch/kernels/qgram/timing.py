"""Device times of the fused quantized-gram kernels (``qgram_packed`` and
``qgram``) at the paths' shapes and the kernels bench shape, against
``torch.matmul`` of the already-decoded x̂, the bound and the launch floor,
on one card.

    python src/repro_torch/kernels/qgram/timing.py [--reps N]

Run as a file, it times the ``repro_torch`` package that Python imports
(``PYTHONPATH``), so the same script holds two checkouts' kernels against
each other on the same inputs: run it once with ``PYTHONPATH=src`` and once
with ``PYTHONPATH=<other checkout>/src``, in turns on one card.  The
operands are made here from a seed with numpy (the same bits in both
checkouts).  It prints one JSON object: the card's name and power limit
(``nvidia-smi``), the package's path, the launch floor (a one-element
in-place add timed the same way) and, for each case, the package's plan
where it has one, the kernel's, the plain version's and ``torch.matmul``'s
ms, the bound's ms and what bounds it, the error against the plain version
with its tolerance, and whether two launches gave the same bits.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

if __name__ == "__main__":  # run as a file: import the package from PYTHONPATH, not from here
    sys.path.pop(0)

import numpy as np
import torch

HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
TOL = 1e-5  # of max(|x̂| |y|^T): fp32 sums in different orders, no TF32

# (label, kernel, m, n, p, d, total bits, max bits, -1 pad rows, reps)
CASES = [
    ("fit: 39 x 25 x 25, R = 24", "qgram_packed", 39, 25, 25, 21, 24, 12, 0, 200),
    ("broadcast fit: 40 x 25 x 1000, R = 24", "qgram_packed", 40, 25, 1000, 21, 24, 12, 0, 50),
    ("40 x 1000 x 4449, R = 24", "qgram_packed", 40, 1000, 4449, 21, 24, 12, 0, 3),
    ("wire: 39 x (25 + 7) x 25, C = 4096", "qgram", 39, 25, 25, 21, 24, 12, 7, 200),
    ("bench: 1024 x 128 x 1024, 4 bits a dim", "qgram", 1, 1024, 1024, 128, 512, 8, 0, 50),
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
    ms = start.elapsed_time(end) / (5 * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def packed_operands(m, n, p, d, R, cap, seed, dev):
    """words (m, n, W) int32, rates (m, d) int32, cents (m, d, 2^cap),
    proj (m, p, d), mask (m, n) of ones, and the codes (m, n, d): R bits a
    row dealt one at a time to seeded dimensions, at most ``cap`` each."""
    from repro_torch.core import torch_scheme as TS

    rng = np.random.default_rng(seed)
    rates = np.zeros((m, d), np.int64)
    for i in range(m):
        for _ in range(R):
            j = int(rng.integers(d))
            rates[i, j] = min(rates[i, j] + 1, cap)
    codes = rng.integers(0, 2 ** rates[:, None, :], size=(m, n, d))
    words = TS.pack_codes(torch.from_numpy(codes), torch.from_numpy(rates), total_bits=R)
    cents = rng.normal(size=(m, d, 2**cap)).astype(np.float32)
    proj = rng.normal(size=(m, p, d)).astype(np.float32)
    to = lambda a: torch.as_tensor(a).to(dev)
    return (to(words), to(rates).int(), to(cents), to(proj),
            torch.ones((m, n), device=dev), to(codes).int())


def bound_ms(m, n, p, d, nbytes) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES * 1e3, 2 * m * n * p * d / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def looked_up(codes, C) -> int:
    """Distinct (machine, dimension, code) entries inside the tables."""
    m, n, d = codes.shape
    inside = (codes >= 0) & (codes < C)
    b = torch.arange(m, device=codes.device)[:, None, None].expand_as(codes)
    j = torch.arange(d, device=codes.device)[None, None, :].expand_as(codes)
    return int(torch.unique(((b * d + j) * C + codes.long())[inside]).numel())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=0,
                    help="calls per graph (default: each case's own)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qgram timing needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch
    from repro_torch.kernels.qgram import ops
    from repro_torch.kernels.qgram.ref import decode_gathered
    from repro_torch.kernels.quant.cases import qgram_operands

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda: one.add_(1.0), 200)
    rows = []
    for label, kernel, m, n, p, d, R, cap, pad, reps in CASES:
        reps = args.reps or reps
        if kernel == "qgram_packed":
            words, rates, cents, proj, mask, codes = packed_operands(m, n, p, d, R, cap,
                                                                     m + n + p, dev)
            run = lambda: ops.qgram_packed_cuda(words, rates, cents, proj, total_bits=R,
                                                mask=mask)
            plain = lambda: ops.qgram_packed_plain(words, rates, cents, proj, total_bits=R,
                                                   mask=mask)
            y, W = proj, words.shape[-1]
            nbytes = 4 * (words.numel() + rates.numel() + looked_up(codes, cents.shape[-1])
                          + proj.numel() + mask.numel() + m * n * p)
        else:
            codes, cents, y = qgram_operands(m, n, d, p, R, max_bits=cap, seed=m + n + p,
                                             pad_rows=pad, shared_y=m == 1, device=dev)
            run = lambda: ops.qgram_cuda(codes, cents, y)
            plain = lambda: ops.qgram_plain(codes, cents, y)
            W = None
            nbytes = 4 * (codes.numel() + looked_up(codes, cents.shape[-1]) + y.numel()
                          + codes.shape[0] * codes.shape[1] * p)
        xhat = decode_gathered(codes, cents)
        got, again, want = run(), run(), plain()
        scale = float((xhat.abs() @ y.abs().transpose(-1, -2)).max())
        b, by = bound_ms(m, codes.shape[1], p, d, nbytes)
        row = {
            "case": label, "kernel": kernel, "m": m, "n": codes.shape[1], "p": p, "d": d,
            "plan": (ops.plan(m, codes.shape[1], p, d, W, cents.shape[-1], sms)._asdict()
                     if hasattr(ops, "plan") else None),
            "max_abs_err": float((got - want).abs().max()), "tol": TOL * max(1.0, scale),
            "same_bits": bool(torch.equal(got, again)),
            "ms": device_ms(run, reps), "plain_ms": device_ms(plain, reps),
            "matmul_ms": device_ms(lambda: torch.matmul(xhat, y.transpose(-1, -2)), reps),
            "bound_ms": b, "bound_by": by,
        }
        del got, again, want
        rows.append(row)
    print(json.dumps({"card": card, "package": repro_torch.__file__, "launch_floor_ms": floor,
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
