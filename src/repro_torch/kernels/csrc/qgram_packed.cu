// Fused unpack + dequantize + gram from PACKED wire words, for Hopper
// (sm_90a), plain C interface.  One launch covers every machine.
//
// Replaces the TPU kernel repro/kernels/qgram/packed.py::qgram_packed_pallas
// (_qgram_packed_kernel): for machine b and row i, unpack the d codes of
// the row's uint32 words by the per-dimension [word, bit, width] meta rows
// (a code may straddle two words; width 0 gives code 0), decode
// x̂[i, j] = cents[b, j, code], zero masked rows, and return x̂ proj[b]^T.
//
// What bounds it on the H100: on the GP main path (39 machines x 25 rows,
// d = 21, W = 1 word per row, 25 output columns) the words, meta and
// output are a few tens of KB; the centroid tables (39 x 21 x 4096 fp32 =
// 13 MB) are the big operand, but only the looked-up entries are read
// (39 x 25 x 21 gathers), so a call is bound by launch latency and the
// latency of those gathers.  At large n and p the output write dominates,
// as for the gram kernel.
//
// Design: grid (column tile, row tile, machine); a 256-thread block owns a
// 32 x 128 output tile of one machine.  Per d-chunk of 32 it reads the
// chunk's meta, unpacks and decodes its 32 rows straight into a shared
// tile (the unpack guards of the reference: no shift by 32, width >= 32
// takes the full mask, the high part of a straddling code comes from word
// + 1, a word past the row's end reads as 0), stages the machine's proj
// tile beside it, and accumulates a 4 x 4 micro-tile per thread with fmaf
// in d order, so each decoded row serves 128 output columns.  The TPU
// kernel decodes by a chunked one-hot contraction over the C = 4096 table
// entries, which suits its matrix unit; here each code
// GATHERS its one centroid from global memory instead — the (d, C) table of
// one machine (344 KB) exceeds the 227 KB of shared memory a block can
// have, and all 39 tables (13 MB) stay resident in the 50 MB L2.  Neither
// the codes nor x̂ ever reach device memory.  A row with no words (rate 0)
// needs no separate route: every width is 0, so no word is read.  A code
// outside the table (only possible for malformed meta) decodes to 0, like
// the one-hot.  fp32 FMA, no tensor cores, no TF32.

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
qgram_packed_kernel(int n, int p, int d, int W, int C,
                    const uint32_t* __restrict__ words,  // (B, n, W)
                    const int32_t* __restrict__ meta,    // (B, 3, d)
                    const float* __restrict__ cents,     // (B, d, C)
                    const float* __restrict__ proj,      // (B, p, d) or (p, d)
                    int64_t proj_bs,                     // batch stride of proj
                    const float* __restrict__ mask,      // (B, n)
                    float* __restrict__ out) {           // (B, n, p)
  __shared__ float xs[BR][DK + 1];
  __shared__ float ps[BP][DK + 1];
  __shared__ int32_t m_word[DK];
  __shared__ uint32_t m_bit[DK];
  __shared__ uint32_t m_width[DK];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BR;
  const int col0 = blockIdx.x * BP;

  const uint32_t* words_b = words + (int64_t)b * n * W;
  const int32_t* meta_b = meta + (int64_t)b * 3 * d;
  const float* cents_b = cents + (int64_t)b * d * C;
  const float* proj_b = proj + (int64_t)b * proj_bs;
  const float* mask_b = mask + (int64_t)b * n;

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    if (tid < DK && k0 + tid < d) {
      m_word[tid] = meta_b[k0 + tid];
      m_bit[tid] = static_cast<uint32_t>(meta_b[d + k0 + tid]);
      m_width[tid] = static_cast<uint32_t>(meta_b[2 * d + k0 + tid]);
    }
    __syncthreads();

    // unpack + decode this chunk of the block's rows into shared memory
    for (int e = tid; e < BR * DK; e += TX * TY) {
      const int r = e / DK, j = e % DK;
      const int gr = row0 + r, gj = k0 + j;
      float v = 0.f;
      if (gr < n && gj < d) {
        const uint32_t width = m_width[j];
        uint32_t code = 0u;
        if (width > 0u) {
          const int wi = m_word[j];
          const uint32_t bit = m_bit[j];
          const uint32_t* rowp = words_b + (int64_t)gr * W;
          const uint32_t lo = wi < W ? (rowp[wi] >> bit) : 0u;
          const uint32_t hi =
              (bit > 0u && wi + 1 < W) ? (rowp[wi + 1] << (32u - bit)) : 0u;
          const uint32_t wmask =
              width >= 32u ? 0xFFFFFFFFu : ((1u << width) - 1u);
          code = (lo | hi) & wmask;
        }
        v = code < static_cast<uint32_t>(C) ? cents_b[(int64_t)gj * C + code] : 0.f;
        v *= mask_b[gr];
      }
      xs[r][j] = v;
    }
    for (int e = tid; e < BP * DK; e += TX * TY) {
      const int c = e / DK, j = e % DK;
      const int gc = col0 + c, gj = k0 + j;
      ps[c][j] = (gc < p && gj < d) ? proj_b[(int64_t)gc * d + gj] : 0.f;
    }
    __syncthreads();

    const int kmax = min(DK, d - k0);
    for (int k = 0; k < kmax; ++k) {
      float xv[RM], pv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) xv[i] = xs[ty + i * TY][k];
#pragma unroll
      for (int j = 0; j < CN; ++j) pv[j] = ps[tx + j * TX][k];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(xv[i], pv[j], acc[i][j]);
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

extern "C" int repro_qgram_packed_f32(int batch, int n, int p, int d, int W, int C,
                                      const uint32_t* words, const int32_t* meta,
                                      const float* cents, const float* proj,
                                      int64_t proj_bs, const float* mask,
                                      float* out, void* stream) {
  if (batch <= 0 || n <= 0 || p <= 0) return 0;  // an empty output
  const dim3 grid((p + BP - 1) / BP, (n + BR - 1) / BR, batch);
  qgram_packed_kernel<<<grid, TX * TY, 0, static_cast<cudaStream_t>(stream)>>>(
      n, p, d, W, C, words, meta, cents, proj, proj_bs, mask, out);
  return static_cast<int>(cudaGetLastError());
}
