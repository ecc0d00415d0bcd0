// Per-symbol encode for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/quant/quant.py::encode_pallas
// (_encode_kernel): code[i, j] = #{e in edges[j, :] : e < x[i, j]}, the
// number of dimension j's scaled bin edges strictly below the symbol.  The
// +inf pads of a row never count, a NaN symbol counts nothing (every
// comparison is false), +inf counts every finite edge, a rate-0 dimension
// (a row of +inf) encodes to 0.
//
// What bounds it on the H100: the bytes are x, the codes and the live
// part of the table — on the wire path (25 rows x 21 dims against a table
// of E = 128 to 4096 edges a row, as the largest rate asks; 344 KB at 4096)
// a few KB to a few hundred, so a call is bound by launch latency and by
// the length of the per-symbol count loop; at the kernels bench shape
// (1024 x 128 symbols, 256 edges a row) by the n d E comparisons of a
// full-row count.
//
// Design: a 256-thread block owns 32 rows of one dimension j.  Lane l of
// each warp takes row i = 32 * blockIdx.x + l; warp w counts the edges of
// slice w of the row (E split into 8 slices), so every lane of a warp reads
// the same edge at the same time — one broadcast load from L1/L2 serves 32
// symbols, and the (d, E) table (344 KB at 4096 edges, more than the 227 KB
// of shared memory a block may have) is streamed from L2, never staged.
// The eight partial counts of a symbol are summed in shared memory in
// slice order.  The count runs over the whole row, so it is right for any
// table, sorted or not (a binary search would need ascending rows); the
// counts are integers, so the result is exact whatever the order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int ROWS = 32;    // rows per block: one per lane
constexpr int SLICES = 8;   // warps per block: one edge slice each

__global__ void __launch_bounds__(ROWS * SLICES)
quant_encode_kernel(int n, int d, int E, const float* __restrict__ x,
                    const float* __restrict__ edges, int32_t* __restrict__ out) {
  __shared__ int part[SLICES][ROWS];
  const int lane = threadIdx.x % ROWS;
  const int w = threadIdx.x / ROWS;
  const int j = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * ROWS + lane;
  const float xv = i < n ? x[i * d + j] : 0.f;

  const int chunk = (E + SLICES - 1) / SLICES;
  const int e0 = w * chunk;
  const int e1 = min(E, e0 + chunk);
  const float* row = edges + (int64_t)j * E;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  int e = e0;
  for (; e + 4 <= e1; e += 4) {  // four independent loads in flight
    c0 += row[e] < xv;
    c1 += row[e + 1] < xv;
    c2 += row[e + 2] < xv;
    c3 += row[e + 3] < xv;
  }
  for (; e < e1; ++e) c0 += row[e] < xv;
  part[w][lane] = (c0 + c1) + (c2 + c3);
  __syncthreads();
  if (w == 0 && i < n) {
    int total = 0;
#pragma unroll
    for (int s = 0; s < SLICES; ++s) total += part[s][lane];
    out[i * d + j] = total;
  }
}

}  // namespace

extern "C" int repro_quant_encode_f32(int n, int d, int E, const float* x,
                                      const float* edges, int32_t* out,
                                      void* stream) {
  if (n <= 0 || d <= 0) return 0;  // an empty output: nothing to launch
  const dim3 grid((n + ROWS - 1) / ROWS, d);
  quant_encode_kernel<<<grid, ROWS * SLICES, 0, static_cast<cudaStream_t>(stream)>>>(
      n, d, E, x, edges, out);
  return static_cast<int>(cudaGetLastError());
}
