// Fused Nyström serve epilogue over m experts for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel repro/kernels/epilogue/epilogue.py::epilogue_pallas
// (_epilogue_kernel).  Per expert e and test point p:
//   Bt[p, :] = G[e, p, :] Ainv[e]^T            (the cached triangular solve)
//   mu       = Bt[p, :] . walpha[e]
//   quad     = sum_k Bt[p, k] (Bt[p, :] . P[e, k, :])
//   s2       = max(gss[p] - quad, 1e-12)
// then the fusion's three moment rows, summed over the experts into out
// (3, t).
//
// What bounds it on the H100: at the broadcast main path's shape (m = 40
// experts, t = 128 queries, K = 25) the operands are ~0.72 MB (G 512 KB,
// Ainv and P 200 KB) and the work 13 MFLOP of fp32 FMA, so the bound is
// ~0.0002 ms either way and the time is set by launch latency and by the
// dependent steps of a block (stage an expert, two products, the moment
// rows, the group sum: its fence, counter and reload are about 0.003 ms of
// the request's time).  At t = 4449 (the tensor-core path) G's 17.8 MB
// bound it, ~0.0054 ms; at K = 300 the two products' 1.9 GFLOP, run as
// 3xTF32 (three TF32 products each) at 495 TFLOP/s, ~0.011 ms.
//
// Design: the kernels and their launch live in epilogue_body.cuh, shared
// with the tenant-batched epilogue_fleet.cu; this entry is that launch at
// one tenant.  A small-K variant keeps each point's rows in registers
// (four threads a point) and stages each expert's operands whole, double-
// buffered with cp.async; a large-K variant runs both K x K products on
// the tensor cores (mma.sync TF32, 3xTF32 split), streaming Ainv and P in
// chunks past a tile of 16 to 64 points.  Expert groups are summed in
// group order by the last block of a tile to arrive: one launch, no float
// atomics, the same bits on every run.

#include "epilogue_body.cuh"

// fuse: 0 none, 1 kl, 2 poe, 3 gpoe, 4 bcm, 5 rbcm.  variant: 0 small
// (K <= 32; tt 16 or 32), 1 mma (tt 16, 32 or 64).  groups: expert groups,
// each ceil(m / groups) consecutive experts; when > 1, scratch holds
// groups x 3 x t floats and counters ceil(t / tt) ints, zero on entry and
// left zero on exit.
extern "C" int repro_epilogue_f32(int fuse, int m, int t, int K, int variant, int tt,
                                  int groups, const float* G, const float* Ainv,
                                  const float* P, const float* walpha, const float* gss,
                                  const float* prior, const float* w, float* out,
                                  float* scratch, int* counters, void* stream) {
  const Args a{fuse, 1, m, t, K, tt, 0, groups, 0, G, Ainv, P, walpha, gss, prior, w,
               out, scratch, counters};
  return launch_epilogue(a, variant, static_cast<cudaStream_t>(stream));
}
