// Tiled fp32 gram block G = X Y^T for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/gram/gram.py::gram_pallas
// (_gram_kernel): G[i, j] = <x_i, y_j>, fp32 accumulation.
//
// What bounds it on the H100: on the GP main path the operands are tiny
// (a 128-query batch against the center's 25 exact points, d = 21), so a
// call is bound by launch latency, not by bytes (a few KB) or FLOPs (~0.1
// MFLOP).  At large n and p the output (n * p * 4 bytes) dominates the
// bytes and 2 n p d FLOPs of fp32 FMA on the CUDA cores the work; with
// d ~ 20 the intensity is ~d/2 FLOP per output byte, so it is bound by
// writing G.
//
// Design: one 256-thread block per 64 x 64 output tile.  The block stages
// a (64 x 32) slab of X and of Y (d-chunk of 32) in shared memory, each
// thread accumulates a 4 x 4 micro-tile in registers with fmaf in d order,
// and the ragged n, p and d edges are masked at the load (zeros) and at
// the store — no padding in the caller.  Neighbouring threads write
// neighbouring columns, so the stores of G, which dominate the bytes, are
// coalesced.  Operands are addressed through their strides, so the
// backward products (g Y, g^T X) run the same kernel on transposed views
// without copies.  No tensor cores: fp32 in, fp32 FMA, no TF32, so the
// result matches a plain fp32 product to rounding.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;   // rows of X per block
constexpr int BN = 64;   // rows of Y per block
constexpr int BK = 32;   // d-chunk staged per step
constexpr int TX = 16;   // threads along the output's columns
constexpr int TY = 16;   // threads along the output's rows
constexpr int TM = BM / TY;  // 4 outputs per thread along rows
constexpr int TN = BN / TX;  // 4 outputs per thread along columns

__global__ void __launch_bounds__(TX * TY)
gram_kernel(int n, int p, int d,
            const float* __restrict__ x, int64_t sxn, int64_t sxd,
            const float* __restrict__ y, int64_t syp, int64_t syd,
            float* __restrict__ out) {
  // k-major slabs, padded by one column against bank conflicts
  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const bool x_kfast = sxd <= sxn;
  const bool y_kfast = syd <= syp;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // consecutive threads walk an operand's unit-stride axis, so the loads
    // coalesce for row-major operands and for transposed views alike
    for (int e = tid; e < BM * BK; e += TX * TY) {
      const int r = x_kfast ? e / BK : e % BM;
      const int k = x_kfast ? e % BK : e / BM;
      const int gr = row0 + r, gk = k0 + k;
      xs[k][r] = (gr < n && gk < d) ? x[gr * sxn + gk * sxd] : 0.f;
    }
    for (int e = tid; e < BN * BK; e += TX * TY) {
      const int c = y_kfast ? e / BK : e % BN;
      const int k = y_kfast ? e % BK : e / BN;
      const int gc = col0 + c, gk = k0 + k;
      ys[k][c] = (gc < p && gk < d) ? y[gc * syp + gk * syd] : 0.f;
    }
    __syncthreads();
    const int kmax = min(BK, d - k0);
    for (int k = 0; k < kmax; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < p) out[(int64_t)r * p + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int repro_gram_f32(int n, int p, int d,
                              const float* x, int64_t sxn, int64_t sxd,
                              const float* y, int64_t syp, int64_t syd,
                              float* out, void* stream) {
  if (n <= 0 || p <= 0) return 0;  // an empty output: nothing to launch
  const dim3 grid((p + BN - 1) / BN, (n + BM - 1) / BM);
  gram_kernel<<<grid, TX * TY, 0, static_cast<cudaStream_t>(stream)>>>(
      n, p, d, x, sxn, sxd, y, syp, syd, out);
  return static_cast<int>(cudaGetLastError());
}
