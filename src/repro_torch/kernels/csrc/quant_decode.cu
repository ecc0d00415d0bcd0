// Per-symbol decode for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/quant/quant.py::decode_pallas
// (_decode_kernel): x̂[i, j] = cents[j, code[i, j]].  The TPU kernel
// expresses the lookup as a one-hot contraction over the table, so a code
// outside [0, C) — the -1 pad sentinel among them — matches no column and
// decodes to 0; this kernel keeps that: it reads the table only for a code
// in range and writes 0 otherwise.
//
// What bounds it on the H100: bytes — the codes read and the values
// written (4 bytes each a symbol) and the looked-up table entries; no
// arithmetic.  At the wire path's 25 x 21 symbols the call is bound by
// launch latency.
//
// Design: a gather, one thread per symbol in row-major order, so the code
// loads and the stores coalesce; the lookups gather from the (d, C) table
// through L1/L2 (a dimension's 4096-entry row is 16 KB; the looked-up
// entries are what is read).  A grid-stride loop covers any n d with 64-bit
// offsets.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
quant_decode_kernel(int64_t total, int d, int C, const int32_t* __restrict__ codes,
                    const float* __restrict__ cents, float* __restrict__ out) {
  for (int64_t k = (int64_t)blockIdx.x * THREADS + threadIdx.x; k < total;
       k += (int64_t)gridDim.x * THREADS) {
    const int32_t code = codes[k];
    const int64_t j = k % d;
    out[k] = (code >= 0 && code < C) ? cents[j * C + code] : 0.f;
  }
}

}  // namespace

extern "C" int repro_quant_decode_f32(int n, int d, int C, const int32_t* codes,
                                      const float* cents, float* out, void* stream) {
  if (n <= 0 || d <= 0) return 0;  // an empty output: nothing to launch
  const int64_t total = (int64_t)n * d;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  const int grid = static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
  quant_decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      total, d, C, codes, cents, out);
  return static_cast<int>(cudaGetLastError());
}
