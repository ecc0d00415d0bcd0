"""Stage copies of the ``quant_decode`` kernel, and the designs it was chosen
over, timed on one card.

    python src/repro_torch/kernels/quant/stages.py [--parent FILE] [--set stages,sweep]

Run as a file from the root of a checkout (``PYTHONPATH=src``).  It builds,
under ``build/quant_decode_stages/``, copies of ``csrc/quant_decode.cu``
each with one stage removed — the code load (codes made from the index),
the lookup (the value is the code's bits), the store (stored only when the
value has a bit pattern no table here holds) — and two designs kept only
for this comparison: the tile with the block's 32 table rows first copied
into shared memory by cp.async ("staged"), and 16-byte vectors along d
with no shared tile ("vec4", d % 4 == 0 only).  With ``--parent FILE``
(the one-thread-a-symbol kernel's source, e.g. from a ``git archive`` of
an earlier commit) it builds that kernel and the same copies of it, plus
one without its 64-bit ``%``.  Every copy is timed as ``chip_smoke.py``
times the kernels (a CUDA graph of ``--reps`` calls replayed, CUDA events),
twice, in opposite orders, on the seeded ``quant_operands`` of each shape:

- ``stages``: the wire's 25 x 21 (a 4096-entry row), the kernels bench
  1024 x 128 (4 d bits, max 8: a 128-entry table), with a 256-, a 1024-
  and a 4096-entry row, and 65536 x 128;
- ``sweep``: the flat and tile variants over n and d (the shapes
  ``decode_plan`` was fitted to).

Each full kernel is also held bitwise against ``decode_plain`` with -1,
C and INT32_MAX planted.  It prints progress to stderr and one JSON
object to stdout: the card's name and power limit, the launch floor (a
one-element add, timed alike) and, per shape, the bound, ``torch.gather``'s
and the plain version's ms, ``decode_plan``'s pick and each copy's two
times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # run as a file: import the package from PYTHONPATH, not from here
    sys.path.pop(0)

import torch

HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
NVCC = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

STAGES = [  # (label, n, d, total bits, max bits, one dominant dimension)
    ("wire: 25 x 21, a 4096-entry row", 25, 21, 48, 12, True),
    ("bench: 1024 x 128, 4d bits, max 8", 1024, 128, 512, 8, False),
    ("bench: 1024 x 128, a 256-entry row", 1024, 128, 512, 8, True),
    ("bench: 1024 x 128, a 1024-entry row", 1024, 128, 512, 10, True),
    ("bench: 1024 x 128, a 4096-entry row", 1024, 128, 512, 12, True),
    ("large: 65536 x 128, 4d bits, max 8", 65536, 128, 512, 8, False),
]
SWEEP = [(f"{n} x {d}", n, d, 4 * d, 8, False) for n, d in (
    (128, 21), (1000, 21), (4449, 21), (40000, 21), (65536, 21), (64, 128), (256, 128),
    (4096, 128), (16384, 128), (4096, 8), (65536, 3), (65536, 8), (65536, 12), (65536, 16),
    (65536, 20), (65536, 24), (65536, 28), (65536, 31), (4000, 31), (8192, 16), (8192, 24),
    (65536, 32), (1024, 129), (8192, 256))]

VEC4 = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void __launch_bounds__(256) vec4_kernel(int total4, int d, int C,
    const int32_t* __restrict__ codes, const float* __restrict__ cents, float* __restrict__ out) {
  const int q = blockIdx.x * 256 + threadIdx.x;
  if (q >= total4) return;
  const int4 c = __ldg(reinterpret_cast<const int4*>(codes) + q);
  const float* row = cents + static_cast<size_t>((4 * q) % d) * C;
  float4 o;
  o.x = static_cast<unsigned>(c.x) < static_cast<unsigned>(C) ? __ldg(row + c.x) : 0.f;
  o.y = static_cast<unsigned>(c.y) < static_cast<unsigned>(C) ? __ldg(row + C + c.y) : 0.f;
  o.z = static_cast<unsigned>(c.z) < static_cast<unsigned>(C) ? __ldg(row + 2 * C + c.z) : 0.f;
  o.w = static_cast<unsigned>(c.w) < static_cast<unsigned>(C) ? __ldg(row + 3 * C + c.w) : 0.f;
  reinterpret_cast<float4*>(out)[q] = o;
}
extern "C" int launch(int n, int d, int C, const int32_t* codes, const float* cents, float* out,
                      void* stream) {
  const int total4 = n * d / 4;
  vec4_kernel<<<(total4 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      total4, d, C, codes, cents, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def _sub(src: str, pairs, what: str) -> str:
    for a, b in pairs:
        if a not in src:
            raise ValueError(f"{what}: the source has no {a!r}; update stages.py to it")
        src = src.replace(a, b, 1)
    return src


def kernel_copies(src: str) -> dict:
    """The shipped kernel, its stage copies and the staged-rows design."""
    out = {"tile": src}
    out["tile -code load"] = _sub(src, [
        ("__ldg(reinterpret_cast<const int4*>(cb + r * d + 4 * q))",
         "make_int4((r + q) & 15, (r + q + 1) & 15, (r + q + 2) & 15, (r + q + 3) & 15)"),
        ("(r < rows && c < dims) ? __ldg(cb + r * d + c) : -1",
         "(r < rows && c < dims) ? ((r + c) & 15) : -1")], "no code load")
    out["tile -lookup"] = _sub(src, [("v[ci][k] = __ldg(row + cd);",
                                      "v[ci][k] = __int_as_float(cd + c);")], "no lookup")
    out["tile -store"] = _sub(src, [
        ("if (r < rows && 4 * q < dims) {\n",
         "if (r < rows && 4 * q < dims && tile[r * PITCH + 4 * q] == 0xFFFFFFFFu) {\n"),
        ("if (r < rows && c < dims) ob[r * d + c]",
         "if (r < rows && c < dims && tile[r * PITCH + c] == 0xFFFFFFFFu) ob[r * d + c]")],
        "no store")
    out["staged"] = _sub(src, [
        ("template <int BN>\n__global__",
         "__device__ __forceinline__ void cp_async16(void* dst, const void* src) {\n"
         "  asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\" ::\"r\"(\n"
         "      static_cast<unsigned>(__cvta_generic_to_shared(dst))), \"l\"(src));\n}\n\n"
         "template <int BN>\n__global__"),
        ("uint32_t* tile = reinterpret_cast<uint32_t*>(smem4);  // BN x PITCH words",
         "float* tab = reinterpret_cast<float*>(smem4);\n"
         "  uint32_t* tile = reinterpret_cast<uint32_t*>(tab + BD * C);"),
        ("  // 1. the codes: -1 past the tile's edge\n",
         "  {\n    const float* src = cents + static_cast<size_t>(j0) * C;\n"
         "    const int total = dims * C;\n"
         "    if (C % 4 == 0 && reinterpret_cast<uintptr_t>(cents) % 16 == 0)\n"
         "      for (int v = t; v < total / 4; v += NT) cp_async16(tab + 4 * v, src + 4 * v);\n"
         "    else\n      for (int v = t; v < total; v += NT) tab[v] = __ldg(src + v);\n  }\n"),
        ("  __syncthreads();\n", "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
                              "  __syncthreads();\n"),
        ("v[ci][k] = __ldg(row + cd);", "v[ci][k] = tab[c * C + cd];"),
        ("  const dim3 grid(", "  cudaFuncSetAttribute(decode_tile<BN>,\n"
         "      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));\n"
         "  const dim3 grid(")], "staged rows")
    return out


def parent_copies(src: str) -> dict:
    """The one-thread-a-symbol kernel (C entry (n, d, C, codes, cents, out,
    stream)) and its stage copies; each takes two more leading arguments."""
    base = _sub(src, [
        ("extern \"C\" int repro_quant_decode_f32(int n, int d, int C,",
         "extern \"C\" int launch(int dmask, float sentinel, int n, int d, int C,"),
        ("quant_decode_kernel(int64_t total, int d, int C,",
         "quant_decode_kernel(int dmask, float sentinel, int64_t total, int d, int C,"),
        ("      total, d, C, codes, cents, out);",
         "      dmask, sentinel, total, d, C, codes, cents, out);")], "parent")
    return {
        "parent": base,
        "parent -code load": _sub(base, [("const int32_t code = codes[k];",
                                          "const int32_t code = (int32_t)(k & 15);")], "code"),
        "parent -64-bit %": _sub(base, [("const int64_t j = k % d;",
                                         "const int64_t j = (int)k & dmask;")], "%"),
        "parent -lookup": _sub(base, [("? cents[j * C + code] : 0.f;",
                                       "? __int_as_float(code + (int)j) : 0.f;")], "lookup"),
        "parent -store": _sub(base, [(
            "out[k] = (code >= 0 && code < C) ? cents[j * C + code] : 0.f;",
            "{ const float v = (code >= 0 && code < C) ? cents[j * C + code] : 0.f; "
            "if (v == sentinel) out[k] = v; }")], "store"),
    }


def build(sources: dict, where: Path) -> dict:
    """nvcc every source at once; {name: (library, ptxas lines)}."""
    from repro_torch.kernels.build import _nvcc

    where.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu = where / f"copy{i}.cu"
        cu.write_text(src)
        procs[name] = (where / f"libcopy{i}.so", subprocess.Popen(
            [_nvcc(), *NVCC, "-o", str(where / f"libcopy{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = (ctypes.CDLL(str(so)),
                      [ln.strip() for ln in log.splitlines() if "registers" in ln])
    return libs


def device_ms(fn, reps: int) -> float:
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
    ap.add_argument("--parent", default=None, help="the one-thread-a-symbol kernel's .cu")
    ap.add_argument("--set", default="stages,sweep")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_decode stage copies need a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.build import CSRC, build_dir
    from repro_torch.kernels.quant.cases import quant_operands
    from repro_torch.kernels.quant.ops import (
        DECODE_ROWS, _DECODE_VARIANT_ID, decode_plain, decode_plan, decode_smem_bytes,
        encode_cuda,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sources = kernel_copies((CSRC / "quant_decode.cu").read_text())
    sources["vec4"] = VEC4
    if args.parent:
        sources.update(parent_copies(Path(args.parent).read_text()))
    t0 = time.perf_counter()
    libs = build(sources, build_dir().parent / "quant_decode_stages")
    print(f"[build] {len(libs)} copies in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (lib, _) in libs.items():
        if name.startswith("parent"):
            lib.launch.argtypes, lib.launch.restype = [i32, ctypes.c_float] + [i32] * 3 + [ptr] * 4, i32
        elif name == "vec4":
            lib.launch.argtypes, lib.launch.restype = [i32] * 3 + [ptr] * 4, i32
        else:
            fn = lib.repro_quant_decode_f32
            fn.argtypes, fn.restype = [i32] * 6 + [ptr] * 4, i32

    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda: one.add_(1.0), args.reps)
    shapes = (STAGES if "stages" in args.set else []) + (SWEEP if "sweep" in args.set else [])
    rows = []
    for label, n, d, bits, max_bits, dominant in shapes:
        stage_set = (label, n, d, bits, max_bits, dominant) in STAGES
        x, edges, cents, _ = quant_operands(n, d, bits, max_bits=max_bits, seed=n + d,
                                            dominant=dominant, device=dev)
        codes = encode_cuda(x, edges)
        C = cents.shape[1]
        out = torch.empty(n, d, device=dev)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        runs = {}

        def entry(lib, variant, bn, smem):
            fn = libs[lib][0].repro_quant_decode_f32
            return lambda c=codes: fn(variant, bn, smem, n, d, C, c.data_ptr(), cents.data_ptr(),
                                      out.data_ptr(), stream())

        if n * d < 2**31:
            runs["flat"] = entry("tile", _DECODE_VARIANT_ID["flat"], 0, 0)
        for bn in DECODE_ROWS:
            tile = _DECODE_VARIANT_ID["tile"]
            for copy in ("tile", "tile -code load", "tile -lookup", "tile -store", "staged"):
                if copy != "tile" and not stage_set:
                    continue
                smem = decode_smem_bytes("tile", bn) + (4 * 32 * C if copy == "staged" else 0)
                if smem <= 232_448:
                    runs[f"{copy} {bn} rows"] = entry(copy, tile, bn, smem)
        if stage_set and d % 4 == 0:
            runs["vec4"] = lambda c=codes: libs["vec4"][0].launch(
                n, d, C, c.data_ptr(), cents.data_ptr(), out.data_ptr(), stream())
        if args.parent:
            dmask = (1 << (d.bit_length() - 1)) - 1
            for copy in [k for k in libs if k.startswith("parent")]:
                if copy == "parent" or stage_set:
                    runs[copy] = (lambda L: lambda c=codes: L.launch(
                        dmask, 1e30, n, d, C, c.data_ptr(), cents.data_ptr(), out.data_ptr(),
                        stream()))(libs[copy][0])
        probe = codes.clone()
        probe[0, 0], probe[-1, -1], probe[n // 2, d // 2] = -1, C, 2**31 - 1
        want = decode_plain(probe, cents)
        bitwise = {}
        for name, fn in runs.items():
            if " -" in name:
                continue
            out.zero_()
            err = fn(probe)
            torch.cuda.synchronize()
            bitwise[name] = err == 0 and bool(torch.equal(out, want))
        times = {name: [] for name in runs}
        for order in (list(runs), list(reversed(runs))):
            for name in order:
                times[name].append(device_ms(runs[name], args.reps))
        inside = (codes >= 0) & (codes < C)
        looked = int(torch.unique((torch.arange(d, device=dev) * C + codes.long())[inside])
                     .numel())
        codes64 = codes.long().T.contiguous()
        pl = decode_plan(n, d, C, torch.cuda.get_device_properties(dev).multi_processor_count)
        row = {"case": label, "n": n, "d": d, "C": C, "plan": pl._asdict(),
               "bound_ms": 4 * (2 * n * d + looked) / HBM_BYTES * 1e3, "bound_by": "bytes",
               "gather_ms": device_ms(lambda: torch.gather(cents, 1, codes64), args.reps),
               "plain_ms": device_ms(lambda: decode_plain(codes, cents), args.reps),
               "bitwise": bitwise, "ms": times}
        rows.append(row)
        print(f"[{label}] C {C} plan {pl.variant} {pl.bn}  " + "  ".join(
            f"{k} {v[0]:.5f}/{v[1]:.5f}" for k, v in times.items()), file=sys.stderr, flush=True)
    print(json.dumps({"card": card, "floor_ms": floor, "ptxas": {
        k: v[1] for k, v in libs.items()}, "cases": rows}))
    return 0 if all(all(r["bitwise"].values()) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
