// Fused unpack + dequantize + gram from PACKED wire words, for Hopper
// (sm_90a), plain C interface.  One launch covers every machine.
//
// Replaces the TPU kernel repro/kernels/qgram/packed.py::qgram_packed_pallas
// (_qgram_packed_kernel): for machine b and row i, unpack the d codes of
// the row's uint32 words by the per-dimension [word, bit, width] meta rows
// (a code may straddle two words; width 0 gives code 0), decode
// x̂[i, j] = cents[b, j, code], zero masked rows, and return x̂ proj[b]^T.
//
// What bounds it on the H100, by shape (device ms measured by chip_smoke.py
// and kernels/qgram/timing.py on an NVIDIA H100 80GB HBM3 at 700 W, in
// PERF.md; the launch floor, a one-element add timed the same way, is
// ~0.001):
// - The GP fit's call at the centre (39 machines x 25 rows, d = 21, W = 1
//   word a row, 25 columns): the words, meta, looked-up centroids and
//   output are ~20 KB (bound 0.00006), so launch latency and the block's
//   chain of dependent round trips bound it.  The earlier 32 x 128 tile
//   read the meta, then the words, then the centroids in strided loops of
//   dependent loads, and its wrapper launched pack_meta's six small
//   kernels before it (0.0152 in all, 0.0093 of it pack_meta); now 0.0035.
// - Broadcast's fit call (40 machines x 25 rows x 1000 columns, a
//   projection per machine) writes 4 MB (bound 0.0022): 0.0089 on the
//   flat tile, against 0.0178 before.
// - 40 x 1000 x 4449 writes 712 MB (0.21 ms at 3.35 TB/s; a zero_ of it
//   takes 0.218) and reads 15 MB of projections.  The earlier design
//   re-unpacked and re-decoded a block's rows for each of the 35 column
//   tiles of a row (0.727, behind the plain version's 0.597); now 0.484,
//   still behind a torch.matmul of the decoded x̂ (0.447): the multiply
//   and the registers of the 8 x 4 tile at two blocks an SM hold it back.
//
// Design: qgram_body.cuh with the PackedRows loader.  A block copies its
// rows' words and mask into shared memory with cp.async beside its first
// projection slab, builds the machine's meta rows from its rates there
// (so the wrapper launches nothing but this kernel), unpacks from shared
// memory and issues all its centroid gathers at once (two round trips in
// all), decodes its rows once and walks its column tiles with the
// projection double-buffered; the plan (qgram.ops.plan) picks the tile and
// the walk from the shape.  A row with no words (rate 0) needs no separate
// route: every width is 0, so no word is read.  A code outside the table
// (only possible for malformed meta) decodes to 0, like the one-hot.

#include "qgram_body.cuh"

// variant: 0 small, 1 flat, 2 wide, 3 long (qgram.ops.TILES); walk:
// column tiles a block walks (>= 1).  words (B, n, W), rates (B, d)
// int32, cents (B, d, C), proj (B, p, d) with batch stride proj_bs (0: one
// (p, d) shared), mask (B, n) or null (every row kept), out (B, n, p).
// Returns the launch's CUDA error (0 on success).
extern "C" int repro_qgram_packed_f32(int variant, int walk, int batch, int n, int p, int d,
                                      int W, int C, const uint32_t* words, const int32_t* rates,
                                      const float* cents, const float* proj, int64_t proj_bs,
                                      const float* mask, float* out, void* stream) {
  if (batch <= 0 || n <= 0 || p <= 0) return 0;  // an empty output
  qgram::Args a{};
  a.n = n; a.p = p; a.d = d; a.C = C; a.W = W; a.walk = walk;
  a.cents = cents; a.y = proj; a.y_bs = proj_bs; a.out = out;
  a.words = words; a.rates = rates; a.mask = mask;
  return qgram::launch_variant<qgram::PackedRows>(variant, a, batch,
                                                  static_cast<cudaStream_t>(stream));
}
