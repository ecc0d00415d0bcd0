// Fused dequantize + gram from UNPACKED int32 codes, for Hopper (sm_90a),
// plain C interface.  One launch covers every machine.
//
// Replaces the TPU kernel repro/kernels/qgram/qgram.py::qgram_pallas
// (_qgram_kernel), and its vmap over machines in qgram_batched: for
// machine b, G[b] = x̂[b] y[b]^T with x̂[b][i, j] = cents[b, j, code[b, i, j]];
// a code outside [0, C) — the -1 pad sentinel of a padded row among them —
// decodes to 0, as the TPU kernel's one-hot contraction does.
//
// What bounds it on the H100: at the wire path's shape (39 machines x 25
// rows, d = 21, 25 output columns, 4096-entry tables) the codes, the
// looked-up centroids and the output are tens of KB, so a call is bound by
// launch latency and the latency of the gathers; at the kernels bench shape
// (n = p = 1024, d = 128) by the 2 n p d fp32 operations (268 MFLOP, 4 us
// at 67 TFLOP/s) against 5.2 MB of codes, y and output (1.6 us).
//
// Design: the tiling of qgram_packed.cu without the unpack.  Grid (column
// tile, row tile, machine); a 256-thread block owns a 32 x 128 output tile
// of one machine.  Per d-chunk of 32 it decodes the chunk of its 32 rows
// straight into shared memory, each code GATHERING its one centroid from
// global memory/L2 (a machine's (d, C) table, 344 KB at d = 21 and
// C = 4096, exceeds the 227 KB of shared memory a block may have; the TPU
// kernel's one-hot contraction over C suits its matrix unit, not this
// card), stages the machine's y tile beside it, and accumulates a 4 x 4
// micro-tile per thread with fmaf in d order, so each decoded row serves
// 128 output columns and x̂ never reaches device memory.  A shared y has
// batch stride 0.  Ragged n, p and d are masked at the loads (zeros) and
// at the store.  fp32 FMA, no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BR = 32;   // rows per block
constexpr int BP = 128;  // output columns per block
constexpr int DK = 32;   // d-chunk
constexpr int TX = 32;   // threads along columns (one warp)
constexpr int TY = 8;    // threads along rows
constexpr int RM = BR / TY;  // 4 rows per thread
constexpr int CN = BP / TX;  // 4 columns per thread

__global__ void __launch_bounds__(TX * TY)
qgram_kernel(int n, int p, int d, int C,
             const int32_t* __restrict__ codes,  // (B, n, d)
             const float* __restrict__ cents,    // (B, d, C)
             const float* __restrict__ y,        // (B, p, d) or (p, d)
             int64_t y_bs,                       // batch stride of y
             float* __restrict__ out) {          // (B, n, p)
  __shared__ float xs[BR][DK + 1];
  __shared__ float ys[BP][DK + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BR;
  const int col0 = blockIdx.x * BP;

  const int32_t* codes_b = codes + (int64_t)b * n * d;
  const float* cents_b = cents + (int64_t)b * d * C;
  const float* y_b = y + (int64_t)b * y_bs;

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    // decode this chunk of the block's rows into shared memory
    for (int e = tid; e < BR * DK; e += TX * TY) {
      const int r = e / DK, j = e % DK;
      const int gr = row0 + r, gj = k0 + j;
      float v = 0.f;
      if (gr < n && gj < d) {
        const int32_t code = codes_b[(int64_t)gr * d + gj];
        if (code >= 0 && code < C) v = cents_b[(int64_t)gj * C + code];
      }
      xs[r][j] = v;
    }
    for (int e = tid; e < BP * DK; e += TX * TY) {
      const int c = e / DK, j = e % DK;
      const int gc = col0 + c, gj = k0 + j;
      ys[c][j] = (gc < p && gj < d) ? y_b[(int64_t)gc * d + gj] : 0.f;
    }
    __syncthreads();

    const int kmax = min(DK, d - k0);
    for (int k = 0; k < kmax; ++k) {
      float xv[RM], yv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) xv[i] = xs[ty + i * TY][k];
#pragma unroll
      for (int j = 0; j < CN; ++j) yv[j] = ys[tx + j * TX][k];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < p) out[((int64_t)b * n + r) * p + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int repro_qgram_f32(int batch, int n, int p, int d, int C,
                               const int32_t* codes, const float* cents,
                               const float* y, int64_t y_bs, float* out,
                               void* stream) {
  if (batch <= 0 || n <= 0 || p <= 0) return 0;  // an empty output
  const dim3 grid((p + BP - 1) / BP, (n + BR - 1) / BR, batch);
  qgram_kernel<<<grid, TX * TY, 0, static_cast<cudaStream_t>(stream)>>>(
      n, p, d, C, codes, cents, y, y_bs, out);
  return static_cast<int>(cudaGetLastError());
}
