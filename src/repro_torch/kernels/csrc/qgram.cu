// Fused dequantize + gram from UNPACKED int32 codes, for Hopper (sm_90a),
// plain C interface.  One launch covers every machine.
//
// Replaces the TPU kernel repro/kernels/qgram/qgram.py::qgram_pallas
// (_qgram_kernel), and its vmap over machines in qgram_batched: for
// machine b, G[b] = x̂[b] y[b]^T with x̂[b][i, j] = cents[b, j, code[b, i, j]];
// a code outside [0, C) — the -1 pad sentinel of a padded row among them —
// decodes to 0, as the TPU kernel's one-hot contraction does.
//
// What bounds it on the H100, by shape (device ms measured by chip_smoke.py
// and kernels/qgram/timing.py on an NVIDIA H100 80GB HBM3 at 700 W, in
// PERF.md):
// - The wire's shape (39 machines x 32 rows, d = 21, 25 columns,
//   4096-entry tables): codes, looked-up centroids and output are ~300 KB
//   (bound 0.0001), so launch latency and two dependent round trips (the
//   codes, then their centroids) bound it: 0.0026 on the small tile,
//   against 0.0046 for the earlier 32 x 128 tile.
// - The kernels bench shape (n = p = 1024, d = 128, C = 256): the
//   2 n p d fp32 operations (268 MFLOP, 0.004 at 67 TFLOP/s) against
//   5.2 MB of codes, y and output (0.0016).  The earlier 32 x 128 tile
//   with a 4 x 4 thread tile staged each d-chunk synchronously (0.0243);
//   the long tile takes 0.0154, still behind a torch.matmul of the decoded
//   x̂ (0.0105): one block an SM (128 blocks for 132 SMs) runs its
//   multiply at about a third of the fp32 rate, and the copies, the
//   decode from the staged table and the barriers add ~8 us around it.
//
// Design: qgram_body.cuh with the CodeRows loader — the tiling of
// qgram_packed.cu without the unpack.  At d <= 32 a block decodes its rows
// once and walks its column tiles; at the bench shape the long tile
// (64 x 128, 8 x 4 outputs a thread, 128 blocks for 132 SMs) takes d in
// chunks of 32, copies each chunk's rows of the 256-entry table to shared
// memory with its y slab a step ahead and gathers x̂ from there.  A shared
// y has batch stride 0.

#include "qgram_body.cuh"

// variant: 0 small, 1 flat, 2 wide, 3 long (qgram.ops.TILES); walk:
// column tiles a block walks (>= 1).  codes (B, n, d), cents (B, d, C),
// y (B, p, d) with batch stride y_bs (0: one (p, d) shared), out
// (B, n, p).  Returns the launch's CUDA error (0 on success).
extern "C" int repro_qgram_f32(int variant, int walk, int batch, int n, int p, int d, int C,
                               const int32_t* codes, const float* cents, const float* y,
                               int64_t y_bs, float* out, void* stream) {
  if (batch <= 0 || n <= 0 || p <= 0) return 0;  // an empty output
  qgram::Args a{};
  a.n = n; a.p = p; a.d = d; a.C = C; a.W = 0; a.walk = walk;
  a.cents = cents; a.y = y; a.y_bs = y_bs; a.out = out;
  a.codes = codes;
  return qgram::launch_variant<qgram::CodeRows>(variant, a, batch,
                                                static_cast<cudaStream_t>(stream));
}
