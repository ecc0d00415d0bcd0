// The per-expert body of the fused Nyström serve epilogue, shared by the
// single-tenant kernel (epilogue.cu) and the tenant-batched one
// (epilogue_fleet.cu).  Each .cu includes it into its own library.
//
// For one operand set (one tenant): G (m, t, K), Ainv and P (m, K, K),
// walpha (m, K), gss and prior (t,), w (m,), the block that owns test
// points t0 .. t0 + TT walks experts e0 .. e1 in order; per expert e and
// test point p:
//   Bt[p, :] = G[e, p, :] Ainv[e]^T            (the cached triangular solve)
//   mu       = Bt[p, :] . walpha[e]
//   quad     = sum_k Bt[p, k] (Bt[p, :] . P[e, k, :])
//   s2       = max(gss[p] - quad, 1e-12)
// then the fusion's three moment rows (FUSE, a template parameter that
// mirrors FusionSpec.moments term for term), added in expert order to the
// registers of the thread that owns the point.
//
// Layout of the work inside a block: both K x K products stream their
// operand through shared memory in (KC x JC) chunks (KC = 512 / TT rows,
// JC = 32 columns), so any K works; only Bt (TT x K) stays whole in shared
// memory.  256 threads own TT x KC outputs, two each; a warp's 32 outputs
// share one test point, so the left operand is a broadcast read and the
// chunk rows, padded to JC + 1, are conflict-free.  The quad-form terms of
// a chunk go to shared memory and the owning thread sums them in k order,
// so no sum's order depends on scheduling.  Ragged t and K are masked: rows
// of G past t and columns past K load as 0 and nothing past them is
// computed.  fp32 FMA on the CUDA cores: no tensor cores, no TF32.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {  // each including library gets its own copy

constexpr int NT = 256;          // threads per block
constexpr int OPT = 2;           // outputs per thread per chunk
constexpr int SLOTS = NT * OPT;  // TT * KC
constexpr int JC = 32;           // reduction chunk (columns staged per step)
constexpr int LD = JC + 1;       // padded row of a staged chunk

enum Fuse { NONE = 0, KL = 1, POE = 2, GPOE = 3, BCM = 4, RBCM = 5 };

// Dynamic shared memory of one block at tile tt: Bt, the staged chunk, the
// G chunk, the quad-form terms (ops.py::smem_bytes mirrors it).
inline size_t smem_bytes(int tt, int K) {
  const int kc = SLOTS / tt;
  return sizeof(float) * ((size_t)tt * (K | 1) + (size_t)kc * LD +
                          (size_t)tt * LD + (size_t)tt * (kc + 1));
}

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

// Moment rows of experts [e0, e1) at test points t0 .. t0 + TT of one
// operand set, added in expert order to acc0..acc2 of the thread that owns
// point t0 + threadIdx.x (threadIdx.x < TT and t0 + threadIdx.x < t).
// Every thread of the block must call it (it synchronizes).
template <int FUSE>
__device__ __forceinline__ void expert_moments(
    int e0, int e1, int t, int K, int TT, int t0, const float* __restrict__ G,
    const float* __restrict__ Ainv, const float* __restrict__ P,
    const float* __restrict__ walpha, const float* __restrict__ gss,
    const float* __restrict__ prior, const float* __restrict__ w, float* smem,
    float& acc0, float& acc1, float& acc2) {
  const int KC = SLOTS / TT;
  const int KB = K | 1;         // odd row strides: the owners' row reads
  const int TS = KC + 1;        // hit distinct banks
  float* bt = smem;             // [TT][KB]  Bt of the current expert
  float* as = bt + TT * KB;     // [KC][LD]  chunk of Ainv or P
  float* ls = as + KC * LD;     // [TT][LD]  chunk of G
  float* ts = ls + TT * LD;     // [TT][TS]  quad-form terms of one chunk

  const int tid = threadIdx.x;
  const bool owner = tid < TT && t0 + tid < t;  // owns test point t0 + tid

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

}  // namespace
