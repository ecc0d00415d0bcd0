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

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int OPT = 2;           // outputs per thread per chunk
constexpr int SLOTS = NT * OPT;  // TT * KC
constexpr int JC = 32;           // reduction chunk (columns staged per step)
constexpr int LD = JC + 1;       // padded row of a staged chunk

enum Fuse { NONE = 0, KL = 1, POE = 2, GPOE = 3, BCM = 4, RBCM = 5 };

template <int FUSE>
__device__ __forceinline__ void moment_rows(float mu, float s2, float prior,
                                            float w, float& r0, float& r1,
                                            float& r2) {
  if (FUSE == NONE) {
    r0 = mu;
    r1 = s2;
    r2 = w;
  } else if (FUSE == KL) {
    r0 = w * mu;
    r1 = w * (s2 + mu * mu);
    r2 = w;
  } else if (FUSE == RBCM) {
    const float beta = 0.5f * (logf(prior) - logf(s2)) * w;
    r0 = beta / s2;
    r1 = beta * mu / s2;
    r2 = beta;
  } else {  // poe / gpoe / bcm share the precision rows
    r0 = w / s2;
    r1 = w * mu / s2;
    r2 = w;
  }
}

// Stage rows k0 .. k0+KC and columns j0 .. j0+jn of the (K, K) matrix M
// into as[KC][LD]; everything outside reads as 0.
__device__ __forceinline__ void stage_square(float* as, const float* M, int K,
                                             int KC, int k0, int j0, int jn) {
  for (int idx = threadIdx.x; idx < KC * JC; idx += NT) {
    const int r = idx / JC, c = idx % JC;
    as[r * LD + c] =
        (k0 + r < K && c < jn) ? M[(int64_t)(k0 + r) * K + j0 + c] : 0.f;
  }
}

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
  const int KC = SLOTS / TT;
  const int KB = K | 1;         // odd row strides: the owners' row reads
  const int TS = KC + 1;        // hit distinct banks
  float* bt = smem;             // [TT][KB]  Bt of the current expert
  float* as = bt + TT * KB;     // [KC][LD]  chunk of Ainv or P
  float* ls = as + KC * LD;     // [TT][LD]  chunk of G
  float* ts = ls + TT * LD;     // [TT][TS]  quad-form terms of one chunk

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const int g = blockIdx.y;
  const int e0 = g * EG;
  const int e1 = min(m, e0 + EG);
  const bool owner = tid < TT && t0 + tid < t;  // owns test point t0 + tid
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;

  for (int e = e0; e < e1; ++e) {
    const float* Ge = G + ((int64_t)e * t + t0) * K;
    const float* Ae = Ainv + (int64_t)e * K * K;
    const float* Pe = P + (int64_t)e * K * K;

    // phase 1: Bt[p][k] = sum_j G[p][j] Ainv[k][j]
    for (int k0 = 0; k0 < K; k0 += KC) {
      float acc[OPT];
#pragma unroll
      for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
      for (int j0 = 0; j0 < K; j0 += JC) {
        const int jn = min(JC, K - j0);
        __syncthreads();  // the previous chunk's readers are done
        stage_square(as, Ae, K, KC, k0, j0, jn);
        for (int idx = tid; idx < TT * JC; idx += NT) {
          const int r = idx / JC, c = idx % JC;
          ls[r * LD + c] =
              (t0 + r < t && c < jn) ? Ge[(int64_t)r * K + j0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < OPT; ++i) {
          const int o = tid + i * NT;
          const int p = o / KC, kk = o % KC;
          if (k0 + kk < K && t0 + p < t) {
            const float* lrow = ls + p * LD;
            const float* arow = as + kk * LD;
            for (int jj = 0; jj < jn; ++jj)
              acc[i] = fmaf(lrow[jj], arow[jj], acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < OPT; ++i) {
        const int o = tid + i * NT;
        const int p = o / KC, kk = o % KC;
        if (k0 + kk < K && t0 + p < t) bt[p * KB + k0 + kk] = acc[i];
      }
    }
    __syncthreads();  // Bt complete

    float mu = 0.f;
    if (owner) {
      const float* wa = walpha + (int64_t)e * K;
      const float* brow = bt + tid * KB;
      for (int k = 0; k < K; ++k) mu = fmaf(brow[k], wa[k], mu);
    }

    // phase 2: Q[p][k] = sum_j Bt[p][j] P[k][j]; quad[p] = sum_k Bt[p][k] Q[p][k]
    float quad = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      float acc[OPT];
#pragma unroll
      for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
      for (int j0 = 0; j0 < K; j0 += JC) {
        const int jn = min(JC, K - j0);
        __syncthreads();
        stage_square(as, Pe, K, KC, k0, j0, jn);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < OPT; ++i) {
          const int o = tid + i * NT;
          const int p = o / KC, kk = o % KC;
          if (k0 + kk < K && t0 + p < t) {
            const float* brow = bt + p * KB + j0;
            const float* prow = as + kk * LD;
            for (int jj = 0; jj < jn; ++jj)
              acc[i] = fmaf(brow[jj], prow[jj], acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < OPT; ++i) {
        const int o = tid + i * NT;
        const int p = o / KC, kk = o % KC;
        if (k0 + kk < K && t0 + p < t)
          ts[p * TS + kk] = bt[p * KB + k0 + kk] * acc[i];
      }
      __syncthreads();
      if (owner) {
        const int kn = min(KC, K - k0);
        const float* trow = ts + tid * TS;
        for (int kk = 0; kk < kn; ++kk) quad += trow[kk];
      }
    }

    if (owner) {
      const float s2 = fmaxf(gss[t0 + tid] - quad, 1e-12f);
      float r0, r1, r2;
      moment_rows<FUSE>(mu, s2, prior[t0 + tid], w[e], r0, r1, r2);
      acc0 += r0;
      acc1 += r1;
      acc2 += r2;
    }
  }

  if (owner) {
    float* out = part + (int64_t)g * 3 * t + t0 + tid;
    out[0] = acc0;
    out[t] = acc1;
    out[2 * t] = acc2;
  }
}

// out[i] = sum over groups of part[g][i], in group order.
__global__ void sum_groups_kernel(int groups, int n,
                                  const float* __restrict__ part,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int g = 1; g < groups; ++g) s += part[(int64_t)g * n + i];
  out[i] = s;
}

template <int FUSE>
int launch(int m, int t, int K, int tt, int groups, const float* G,
           const float* Ainv, const float* P, const float* walpha,
           const float* gss, const float* prior, const float* w, float* out,
           float* scratch, cudaStream_t stream) {
  const int kc = SLOTS / tt;
  const size_t smem =
      sizeof(float) * ((size_t)tt * (K | 1) + (size_t)kc * LD +
                       (size_t)tt * LD + (size_t)tt * (kc + 1));
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
