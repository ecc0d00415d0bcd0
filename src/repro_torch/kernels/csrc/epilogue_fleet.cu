// Tenant-batched fused Nyström serve epilogue for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel
// repro/kernels/epilogue/epilogue.py::epilogue_fleet_pallas
// (_epilogue_fleet_kernel): the single-tenant epilogue (epilogue.cu) with a
// leading tenant axis.  For every tenant n of T, over its OWN m experts:
// the cached apply (Bt = G Ainv^T, mu, quad = Bt P Bt^T, s2) and the
// fusion's three moment rows, summed over the experts into out[n] (3, t).
// Operands: G (T, m, t, K), Ainv and P (T, m, K, K), walpha (T, m, K), gss
// and prior (T, t), w (T, m), all fp32 and contiguous; out (T, 3, t).
//
// What bounds it on the H100: at a fleet flush (T = 16 tenants, m = 40,
// t = 16, K = 25) the operands are ~4.3 MB (G 1.0 MB, Ainv and P 3.2 MB)
// and the work ~26 MFLOP of fp32 FMA, so the bound is ~0.0013 ms, set by
// bytes; as for the single-tenant kernel the time is set by launch latency
// and by the dependent steps inside a block (stage, product, product,
// reduce per expert).
//
// Design:
// * The tenant is the grid's z axis (blockIdx.z); each tenant's operands
//   are addressed from their own base pointers, and a block reads and
//   writes only its tenant's slices, so tenants never share an accumulator
//   and one tenant's operands (a NaN, a weight of 0) cannot reach another's
//   rows.
// * Within a tenant, the single-tenant design unchanged: a block owns TT
//   test points and one group of consecutive experts, walks them in order
//   with the three rows in registers (epilogue_body.cuh, the body shared
//   with epilogue.cu), and when the T * ceil(t / TT) test tiles cannot fill
//   the card the experts are split into groups across blocks.  The group
//   partials go to scratch laid out (groups, T, 3, t), so the second pass
//   is the single-tenant sum_groups_kernel over n = T * 3 * t, summing the
//   groups in order: no float atomics, the same bits on every run.
// * No padding: ragged t and K are masked inside the body.

#include "epilogue_body.cuh"

namespace {

template <int FUSE>
__global__ void __launch_bounds__(NT)
epilogue_fleet_kernel(int T, int m, int t, int K, int TT, int EG,
                      const float* __restrict__ G,       // (T, m, t, K)
                      const float* __restrict__ Ainv,    // (T, m, K, K)
                      const float* __restrict__ P,       // (T, m, K, K)
                      const float* __restrict__ walpha,  // (T, m, K)
                      const float* __restrict__ gss,     // (T, t)
                      const float* __restrict__ prior,   // (T, t)
                      const float* __restrict__ w,       // (T, m)
                      float* __restrict__ part) {        // (groups, T, 3, t)
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const int g = blockIdx.y;
  const int n = blockIdx.z;  // tenant
  const int e0 = g * EG;
  const int e1 = min(m, e0 + EG);
  const int64_t mK = (int64_t)m * K;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  expert_moments<FUSE>(e0, e1, t, K, TT, t0, G + n * mK * t, Ainv + n * mK * K,
                       P + n * mK * K, walpha + n * mK, gss + (int64_t)n * t,
                       prior + (int64_t)n * t, w + (int64_t)n * m, smem, acc0,
                       acc1, acc2);
  if (tid < TT && t0 + tid < t) {
    float* out = part + ((int64_t)g * T + n) * 3 * t + t0 + tid;
    out[0] = acc0;
    out[t] = acc1;
    out[2 * t] = acc2;
  }
}

template <int FUSE>
int launch(int T, int m, int t, int K, int tt, int groups, const float* G,
           const float* Ainv, const float* P, const float* walpha,
           const float* gss, const float* prior, const float* w, float* out,
           float* scratch, cudaStream_t stream) {
  const size_t smem = smem_bytes(tt, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        epilogue_fleet_kernel<FUSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int eg = (m + groups - 1) / groups;
  float* part = groups == 1 ? out : scratch;
  const dim3 grid((t + tt - 1) / tt, groups, T);
  epilogue_fleet_kernel<FUSE><<<grid, NT, smem, stream>>>(
      T, m, t, K, tt, eg, G, Ainv, P, walpha, gss, prior, w, part);
  if (groups > 1) {
    const int n = 3 * T * t;
    sum_groups_kernel<<<(n + 255) / 256, 256, 0, stream>>>(groups, n, part, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fuse: 0 none, 1 kl, 2 poe, 3 gpoe, 4 bcm, 5 rbcm.  T: tenants (at most
// 65535, the grid's z limit).  tt: test points per block, a divisor of 512;
// groups: expert groups per tenant, each ceil(m / groups) consecutive
// experts (scratch holds groups x T x 3 x t floats when > 1).
extern "C" int repro_epilogue_fleet_f32(int fuse, int T, int m, int t, int K,
                                        int tt, int groups, const float* G,
                                        const float* Ainv, const float* P,
                                        const float* walpha, const float* gss,
                                        const float* prior, const float* w,
                                        float* out, float* scratch,
                                        void* stream) {
  if (T <= 0 || T > 65535 || m <= 0 || t <= 0 || K <= 0 || tt <= 0 ||
      SLOTS % tt != 0 || groups <= 0 || groups > m ||
      (groups > 1 && scratch == nullptr) || (int64_t)3 * T * t > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fuse) {
    case NONE: return launch<NONE>(T, m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case KL: return launch<KL>(T, m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case POE: return launch<POE>(T, m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case GPOE: return launch<GPOE>(T, m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case BCM: return launch<BCM>(T, m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    case RBCM: return launch<RBCM>(T, m, t, K, tt, groups, G, Ainv, P, walpha, gss, prior, w, out, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
