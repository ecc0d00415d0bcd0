"""Device times of the ``decode_attn`` kernel on the cases its CUDA-core
block kernel serves (fp32 K/V, hd > 256, K/V rows that are not a whole
number of 16 bytes), with the bench shape at bf16 K/V beside them, against
``F.scaled_dot_product_attention`` and the byte bound, on one card.

    python src/repro_torch/kernels/decode_attn/timing.py [--reps 20]

Run as a file, it times the ``repro_torch`` package that Python imports
(``PYTHONPATH``), so the same script holds two checkouts' kernels against
each other on the same inputs: run it once with ``PYTHONPATH=src`` and once
with ``PYTHONPATH=<other checkout>/src``, one after the other on one card.  The
inputs are drawn on the card from fixed seeds.  It prints one JSON object:
the card's name and power limit (``nvidia-smi``), the package's path and,
for each case, the plan's kernel where the package has :class:`Plan`, the
kernel's, SDPA's and the bound's ms and the kernel's largest error against
the plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

if __name__ == "__main__":  # run as a file: import the package from PYTHONPATH, not from here
    sys.path.pop(0)

import torch
import torch.nn.functional as F

HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)

# (label, B, S, KV, G, hd, pos, K/V dtype): full caches, slot s holding position s
CASES = [
    ("bench, K/V fp32", 8, 8192, 4, 8, 128, 8191, torch.float32),
    ("hd=512, K/V bf16", 8, 4096, 4, 8, 512, 4095, torch.bfloat16),
    ("hd=100 (200-byte rows), K/V bf16", 8, 8192, 4, 8, 100, 8191, torch.bfloat16),
    ("bench, K/V bf16", 8, 8192, 4, 8, 128, 8191, torch.bfloat16),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_attn timing needs a CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels.decode_attn import ops

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for seed, (label, B, S, KV, G, hd, pos, kv_dtype) in enumerate(CASES):
        g = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn(B, KV, G, hd, generator=g, device=dev)
        K = torch.randn(B, S, KV, hd, generator=g, device=dev).to(kv_dtype)
        V = torch.randn(B, S, KV, hd, generator=g, device=dev).to(kv_dtype)
        kpos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
        got = ops.decode_attn_cuda(q, K, V, kpos, pos)
        err = float((got - ops.decode_attn_plain(q, K, V, kpos, pos)).abs().max())
        qh = q.reshape(B, KV * G, 1, hd).to(kv_dtype)
        kh, vh = K.permute(0, 2, 1, 3), V.permute(0, 2, 1, 3)
        mask = (kpos <= pos)[:, None, None, :]
        esz = K.element_size()
        nbytes = 4 * q.numel() + 2 * B * S * KV * hd * esz + 4 * B * S + 4 * got.numel()
        flops = 4 * B * S * KV * G * hd
        row = {
            "case": label,
            "path": ops.plan(B, S, KV, G, hd, esz, sms).path if hasattr(ops, "Plan") else None,
            "ms": device_ms(lambda: ops.decode_attn_cuda(q, K, V, kpos, pos), args.reps),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=1.0, enable_gqa=True), args.reps),
            "bound_ms": max(nbytes / HBM_BYTES, flops / FP32_FLOPS) * 1e3,
            "max_abs_err": err,
            "tol": 1e-5 * float(V.float().abs().max()),
        }
        rows.append(row)
        del q, K, V, kpos, got, qh, kh, vh
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "package": repro_torch.__file__, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
