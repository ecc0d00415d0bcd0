// Fused Nyström serve epilogue over m experts for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel repro/kernels/epilogue/epilogue.py::epilogue_pallas
// (_epilogue_kernel).  Per expert e and test point p:
//   Bt[p, :] = G[e, p, :] Ainv[e]^T            (the cached triangular solve)
//   mu       = Bt[p, :] . walpha[e]
//   quad     = sum_k Bt[p, k] (Bt[p, :] . P[e, k, :])
//   s2       = max(gss[p] - quad, 1e-12)
// then the fusion's three moment rows (FUSE, a template parameter that
// mirrors FusionSpec.moments term for term), summed over the experts into
// out (3, t).
//
// What bounds it on the H100: at the broadcast main path's shape (m = 40
// experts, t = 128 queries, K = 25) the operands are ~0.72 MB (G 512 KB,
// Ainv and P 200 KB) and the work 12.8 MFLOP of fp32 FMA, so the bound is
// ~0.0002 ms either way and the time is set by launch latency and by the
// latency of the dependent steps inside a block (stage, product, product,
// reduce per expert).  At large t the G read dominates the bytes.
//
// Design:
// * No padding.  Ragged t and K are masked in the kernel: rows of G past t
//   and columns past K load as 0, and no output past t or K is computed or
//   stored.
// * The TPU's sequential grid over experts (an accumulator carried across
//   grid steps) becomes a loop inside the block: a block owns a tile of TT
//   test points and a group of consecutive experts, walks them in a fixed
//   order and keeps its three moment rows in the registers of the thread
//   that owns each test point.  When the test tiles alone are too few to
//   fill the card, the experts are split into groups across blocks; each
//   group writes its partial rows and a second pass sums the groups in a
//   fixed order.  No float atomics: the result is the same bits on every
//   run for the same shapes.
// * Both K x K products stream their operand through shared memory in
//   (KC x JC) chunks (KC = 512 / TT rows, JC = 32 columns), so any K works:
//   only Bt (TT x K) stays whole in shared memory, and TT shrinks (16 down
//   to 1) as K grows; that caps K near 40,000 (at TT = 1), where one
//   expert's Ainv and P alone are 12.8 GB.  256 threads own TT x KC
//   outputs, two each; a warp's 32 outputs share one test point, so the
//   left operand is a broadcast read and the chunk rows, padded to JC + 1,
//   are conflict-free.
// * The quad-form reduction writes its TT x KC terms to shared memory and
//   the owning thread sums them in k order, so the sum's order is fixed.
// * fp32 FMA on the CUDA cores: no tensor cores, no TF32.
// * The per-expert body (staging, both products, the moment rows) lives in
//   epilogue_body.cuh, shared with the tenant-batched epilogue_fleet.cu.

#include "epilogue_body.cuh"

namespace {

template <int FUSE>
__global__ void __launch_bounds__(NT)
epilogue_kernel(int m, int t, int K, int TT, int EG,
                const float* __restrict__ G,       // (m, t, K)
                const float* __restrict__ Ainv,    // (m, K, K)
                const float* __restrict__ P,       // (m, K, K)
                const float* __restrict__ walpha,  // (m, K)
                const float* __restrict__ gss,     // (t,)
                const float* __restrict__ prior,   // (t,)
                const float* __restrict__ w,       // (m,)
                float* __restrict__ part) {        // (groups, 3, t)
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const int g = blockIdx.y;
  const int e0 = g * EG;
  const int e1 = min(m, e0 + EG);
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  expert_moments<FUSE>(e0, e1, t, K, TT, t0, G, Ainv, P, walpha, gss, prior,
                       w, smem, acc0, acc1, acc2);
  if (tid < TT && t0 + tid < t) {
    float* out = part + (int64_t)g * 3 * t + t0 + tid;
    out[0] = acc0;
    out[t] = acc1;
    out[2 * t] = acc2;
  }
}

template <int FUSE>
int launch(int m, int t, int K, int tt, int groups, const float* G,
           const float* Ainv, const float* P, const float* walpha,
           const float* gss, const float* prior, const float* w, float* out,
           float* scratch, cudaStream_t stream) {
  const size_t smem = smem_bytes(tt, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        epilogue_kernel<FUSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int eg = (m + groups - 1) / groups;
  float* part = groups == 1 ? out : scratch;
  const dim3 grid((t + tt - 1) / tt, groups);
  epilogue_kernel<FUSE><<<grid, NT, smem, stream>>>(
      m, t, K, tt, eg, G, Ainv, P, walpha, gss, prior, w, part);
  if (groups > 1) {
    const int n = 3 * t;
    sum_groups_kernel<<<(n + 255) / 256, 256, 0, stream>>>(groups, n, part, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fuse: 0 none, 1 kl, 2 poe, 3 gpoe, 4 bcm, 5 rbcm.  tt: test points per
// block, a divisor of 512; groups: expert groups, each ceil(m / groups)
// consecutive experts (scratch holds groups x 3 x t floats when > 1).
extern "C" int repro_epilogue_f32(int fuse, int m, int t, int K, int tt,
                                  int groups, const float* G, const float* Ainv,
                                  const float* P, const float* walpha,
                                  const float* gss, const float* prior,
                                  const float* w, float* out, float* scratch,
                                  void* stream) {
  if (m <= 0 || t <= 0 || K <= 0 || tt <= 0 || SLOTS % tt != 0 ||
      groups <= 0 || groups > m || (groups > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fuse) {
    case NONE: return launch<NONE>(m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case KL: return launch<KL>(m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case POE: return launch<POE>(m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case GPOE: return launch<GPOE>(m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case BCM: return launch<BCM>(m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case RBCM: return launch<RBCM>(m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
