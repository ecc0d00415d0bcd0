// The fused Nyström serve epilogue for Hopper (sm_90a): the kernels and
// their launch, shared by the single-tenant entry (epilogue.cu) and the
// tenant-batched one (epilogue_fleet.cu).  Each .cu includes it into its
// own library; the single-tenant launch is the fleet launch at T = 1, so a
// tenant of a fleet launch and a single-tenant launch of the same plan run
// the same code on the same operands and give the same bits.
//
// For each tenant n (blockIdx.z): G (m, t, K), Ainv and P (m, K, K),
// walpha (m, K), gss and prior (t,), w (m,); per expert e and test point p:
//   Bt[p, :] = G[e, p, :] Ainv[e]^T            (the cached triangular solve)
//   mu       = Bt[p, :] . walpha[e]
//   quad     = sum_k Bt[p, k] (Bt[p, :] . P[e, k, :])
//   s2       = max(gss[p] - quad, 1e-12)
// then the fusion's three moment rows (fuse mirrors FusionSpec.moments
// term for term), summed over the experts into out[n] (3, t).
//
// A block owns a tile of TT test points (blockIdx.x) and a group of
// consecutive experts (blockIdx.y), walks its experts in order and keeps
// the three rows in registers.  Two variants, chosen by kernels/epilogue/
// ops.py::plan from K and the number of points:
//
// * small K (K <= SMALL_K = 32: the paths' K = 19 and 25).  Four threads
//   own a test point; its G row and the thread's quarter of its Bt row
//   (rows k = 4 r + q of Ainv, P) stay in registers (ptxas: 96 to 128 a
//   thread at K = 4 to 32, the group sum's batched loads included).  Each expert's Ainv, P, walpha, w and the
//   tile's G rows are staged whole into shared memory with cp.async,
//   double-buffered across the block's experts (expert e + 1's copy runs
//   under expert e's arithmetic) behind one barrier an expert.  Ainv and P
//   rows are padded to KS floats so that the four quarters' float4 reads
//   fall in distinct banks; every read of them is a broadcast.  The Bt row
//   is gathered across the four threads by shuffles; mu and quad are summed
//   over the quarters by two xor-shuffles (the same bits in all four).
// * the mma variant (K > 32, and K <= 32 at many points, where its
//   throughput wins: the small variant is bound by shared memory's 32
//   floats a clock to the registers, one float for each FMA).  The two
//   K x K products run on the tensor cores, mma.sync m16n8k8 TF32 with the
//   3xTF32 split (a = a_hi + a_lo, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi,
//   fp32 accumulate), which keeps about the fp32 product's accuracy (each
//   product to ~2^-20 of |a b|).  Eight warps: at K > 32 a tile of TT = 32
//   points (16 past its shared memory) as MT = TT / 16 m-tiles x 8 / MT
//   column groups of a 64-column n-block; at K <= 32 a tile of 128 points,
//   eight m-tiles over one 32-column n-block.  Ainv (then P) and G stream
//   through shared memory in n-block x 32 chunks, NST = 3 buffers deep
//   with cp.async (16-byte copies when K is a multiple of 4), one barrier
//   a chunk; Bt (TT x K) stays whole in shared memory as the second
//   product's left operand.  mu is fused into the first product's epilogue
//   and the quad form into the second's (Bt o Q summed over k in
//   registers), then over the four lanes of a row and over the column
//   groups in a fixed order.
//
// One launch.  When the test tiles alone cannot fill the card the experts
// are split into groups; each group's block writes its partial rows, and
// the last block of a point tile to arrive (a counter per tile and
// __threadfence) sums the partials in group order and resets the counter.
// No float atomics: the same bits on every run, under CUDA-graph replay
// too.  Every sum runs in a fixed order.  Ragged t and K are masked by the
// copies' zero fill: rows of G past t and rows and columns past K stage as
// 0, and nothing past t is stored.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {  // each including library gets its own copy

enum Fuse { NONE = 0, KL = 1, POE = 2, GPOE = 3, BCM = 4, RBCM = 5 };
enum Variant { SMALL = 0, MMA = 1 };

constexpr int SMALL_K = 32;  // the largest K of the small variant
constexpr int TPP = 4;       // threads a test point (small variant)
constexpr int MMA_NT = 256;  // threads of an mma block: eight warps
constexpr int NB = 64;       // output columns of an n-block (mma)
constexpr int JC = 32;       // reduction columns of a staged chunk (mma)
constexpr int JS = JC + 4;   // padded chunk row: conflict-free fragments
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use on Hopper
constexpr size_t SMEM_STATIC = 16;   // finish()'s flag, as the compiler lays it out

struct Args {
  int fuse, T, m, t, K, tt, eg, groups, vec;
  const float* G;       // (T, m, t, K)
  const float* Ainv;    // (T, m, K, K)
  const float* P;       // (T, m, K, K)
  const float* walpha;  // (T, m, K)
  const float* gss;     // (T, t)
  const float* prior;   // (T, t)
  const float* w;       // (T, m)
  float* out;           // (T, 3, t)
  float* part;          // (groups, T, 3, t) when groups > 1
  int* counters;        // (T, ceil(t / tt)) zeros when groups > 1
};

// ---- helpers ---------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4- and 16-byte cp.async; ``bytes`` < the size zero-fills the rest
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// x = hi + lo for the 3xTF32 split: hi is x cut to TF32 (its low 13 bits
// cleared), lo = x - hi exactly in fp32; the tensor cores read lo's top 19
// bits (they ignore a TF32 operand's low 13), so a product keeps ~21 bits
// of each factor.  Two full-rate instructions, not two conversions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// D += A B: m16n8k8, A row-major and B column-major TF32, fp32 accumulate
// (not volatile: a pure function of its operands, free to be scheduled)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Rows {
  float r0 = 0.f, r1 = 0.f, r2 = 0.f;
};

// one expert's moment rows at one point, added to acc
__device__ __forceinline__ void add_moments(int fuse, float mu, float quad, float gss,
                                            float prior, float w, Rows& acc) {
  const float s2 = fmaxf(gss - quad, 1e-12f);
  float r0, r1, r2;
  if (fuse == NONE) {
    r0 = mu;
    r1 = s2;
    r2 = w;
  } else if (fuse == KL) {
    r0 = w * mu;
    r1 = w * (s2 + mu * mu);
    r2 = w;
  } else if (fuse == RBCM) {
    const float beta = 0.5f * (logf(prior) - logf(s2)) * w;
    r0 = beta / s2;
    r1 = beta * mu / s2;
    r2 = beta;
  } else {  // poe / gpoe / bcm share the precision rows
    r0 = w / s2;
    r1 = w * mu / s2;
    r2 = w;
  }
  acc.r0 += r0;
  acc.r1 += r1;
  acc.r2 += r2;
}

// The block's rows to out, or, with expert groups, its partial to part and
// the group-ordered sum by the last block of the tile to arrive.  ``owner``
// threads hold point p's rows.  Every thread of the block calls it.
__device__ __forceinline__ void finish(const Args& a, bool owner, int p, const Rows& acc) {
  const int n = blockIdx.z, t = a.t, t0 = blockIdx.x * a.tt;
  const int64_t slab = (int64_t)3 * t;  // one tenant's (3, t)
  float* out = a.out + n * slab;
  const bool store = owner && t0 + p < t;
  if (a.groups == 1) {
    if (store) {
      out[t0 + p] = acc.r0;
      out[t + t0 + p] = acc.r1;
      out[2 * t + t0 + p] = acc.r2;
    }
    return;
  }
  const int64_t gstride = a.T * slab;  // one group's (T, 3, t)
  float* part = a.part + n * slab;
  if (store) {
    float* mine = part + blockIdx.y * gstride;
    mine[t0 + p] = acc.r0;
    mine[t + t0 + p] = acc.r1;
    mine[2 * t + t0 + p] = acc.r2;
  }
  __threadfence();  // the partial is visible before the arrival is counted
  __syncthreads();
  __shared__ int last;
  int* counter = a.counters + (int64_t)n * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == a.groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int tn = min(a.tt, t - t0);
  constexpr int BATCH = 16;  // partials loaded at once, then added in group order
  for (int i = threadIdx.x; i < 3 * tn; i += blockDim.x) {
    const int64_t at = (int64_t)(i / tn) * t + t0 + i % tn;
    float s = 0.f;
    for (int g0 = 0; g0 < a.groups; g0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        v[k] = g0 + k < a.groups ? __ldcg(part + (g0 + k) * gstride + at) : 0.f;
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        if (g0 + k < a.groups) s = g0 + k == 0 ? v[k] : s + v[k];
    }
    out[at] = s;
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

// ---- small K: four threads a point, operands staged whole ----------------------

template <int KP>
struct Small {
  static constexpr int R = KP / 4;                // Ainv / P rows a thread: k = 4 r + q
  static constexpr int KS = R % 2 ? KP : KP + 4;  // row stride: KS / 4 odd
  // floats of one stage buffer: Ainv, P (KP x KS), walpha + w (KP + 4), G (tt x K)
  static __host__ __device__ int buffer(int tt, int K) {
    return 2 * KP * KS + KP + 4 + ((tt * K + 3) & ~3);
  }
};

template <int KP>
__device__ __forceinline__ void small_stage(const Args& a, int n, int e, int t0, float* buf) {
  using S = Small<KP>;
  const int K = a.K, t = a.t, nt = blockDim.x;
  const int64_t mK = (int64_t)a.m * K;
  const float* Ae = a.Ainv + (n * mK + (int64_t)e * K) * K;
  const float* Pe = a.P + (n * mK + (int64_t)e * K) * K;
  float* As = buf;
  float* Ps = As + KP * S::KS;
  float* ws = Ps + KP * S::KS;
  float* Gs = ws + KP + 4;
  for (int i = threadIdx.x; i < KP * KP; i += nt) {
    const int k = i / KP, j = i % KP;
    const bool v = k < K && j < K;
    const int64_t off = v ? (int64_t)k * K + j : 0;
    cp4(As + k * S::KS + j, Ae + off, v);
    cp4(Ps + k * S::KS + j, Pe + off, v);
  }
  const float* wa = a.walpha + n * mK + (int64_t)e * K;
  for (int i = threadIdx.x; i <= KP; i += nt) {
    if (i < KP)
      cp4(ws + i, wa + (i < K ? i : 0), i < K);
    else
      cp4(ws + KP, a.w + (int64_t)n * a.m + e, true);
  }
  const int nvalid = min(a.tt, t - t0) * K;
  const float* Ge = a.G + ((n * (int64_t)a.m + e) * t + t0) * K;
  for (int i = threadIdx.x; i < a.tt * K; i += nt) cp4(Gs + i, Ge + (i < nvalid ? i : 0), i < nvalid);
  cp_commit();
}

template <int KP>
__device__ __forceinline__ void small_expert(const Args& a, const float* buf, float gss,
                                             float prior, Rows& acc) {
  using S = Small<KP>;
  const int K = a.K;
  const int lane = threadIdx.x % 32, q = threadIdx.x % TPP, p = threadIdx.x / TPP;
  const float* As = buf;
  const float* Ps = As + KP * S::KS;
  const float* ws = Ps + KP * S::KS;
  const float* Gr = ws + KP + 4 + p * K;

  float g[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) g[j] = j < K ? Gr[j] : 0.f;
  // Bt[p][k] = sum_j G[p][j] Ainv[k][j] for this thread's rows k = 4 r + q
  float bm[S::R];
#pragma unroll
  for (int r = 0; r < S::R; ++r) {
    const float4* ar = reinterpret_cast<const float4*>(As + (4 * r + q) * S::KS);
    float s = 0.f;
#pragma unroll
    for (int j4 = 0; j4 < KP / 4; ++j4) {
      const float4 v = ar[j4];
      s = fmaf(g[4 * j4], v.x, s);
      s = fmaf(g[4 * j4 + 1], v.y, s);
      s = fmaf(g[4 * j4 + 2], v.z, s);
      s = fmaf(g[4 * j4 + 3], v.w, s);
    }
    bm[r] = s;
  }
  float mu = 0.f;
#pragma unroll
  for (int r = 0; r < S::R; ++r) mu = fmaf(bm[r], ws[4 * r + q], mu);
  mu += __shfl_xor_sync(FULL, mu, 1);
  mu += __shfl_xor_sync(FULL, mu, 2);
  // the point's whole Bt row, from its four threads
  float bt[KP];
#pragma unroll
  for (int r = 0; r < S::R; ++r)
#pragma unroll
    for (int qq = 0; qq < TPP; ++qq)
      bt[4 * r + qq] = __shfl_sync(FULL, bm[r], (lane & ~(TPP - 1)) | qq);
  // quad = sum_k Bt[p][k] (Bt[p][:] . P[k][:]) over this thread's k, then all
  float quad = 0.f;
#pragma unroll
  for (int r = 0; r < S::R; ++r) {
    const float4* pr = reinterpret_cast<const float4*>(Ps + (4 * r + q) * S::KS);
    float s = 0.f;
#pragma unroll
    for (int j4 = 0; j4 < KP / 4; ++j4) {
      const float4 v = pr[j4];
      s = fmaf(bt[4 * j4], v.x, s);
      s = fmaf(bt[4 * j4 + 1], v.y, s);
      s = fmaf(bt[4 * j4 + 2], v.z, s);
      s = fmaf(bt[4 * j4 + 3], v.w, s);
    }
    quad = fmaf(bm[r], s, quad);
  }
  quad += __shfl_xor_sync(FULL, quad, 1);
  quad += __shfl_xor_sync(FULL, quad, 2);
  add_moments(a.fuse, mu, quad, gss, prior, ws[KP], acc);
}

template <int KP>
__global__ void __launch_bounds__(32 * TPP) small_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.z, t0 = blockIdx.x * a.tt, p = threadIdx.x / TPP;
  const int e0 = blockIdx.y * a.eg, e1 = min(a.m, e0 + a.eg);
  const int buf = Small<KP>::buffer(a.tt, a.K);
  const bool live = t0 + p < a.t;
  const float gss = live ? a.gss[(int64_t)n * a.t + t0 + p] : 1.f;
  const float prior = live ? a.prior[(int64_t)n * a.t + t0 + p] : 1.f;
  Rows acc;
  small_stage<KP>(a, n, e0, t0, smem);
  for (int e = e0; e < e1; ++e) {
    cp_wait_all();
    __syncthreads();  // expert e staged; everyone is done with expert e - 1's buffer
    if (e + 1 < e1) small_stage<KP>(a, n, e + 1, t0, smem + ((e + 1 - e0) & 1) * buf);
    small_expert<KP>(a, smem + ((e - e0) & 1) * buf, gss, prior, acc);
  }
  finish(a, threadIdx.x % TPP == 0, p, acc);
}

// ---- the mma variant: 3xTF32 mma.sync, operands streamed in chunks ------------

// A tile configuration: MT m-tiles of 16 points x NG column groups of NTW
// n-tiles (8 columns) each; MT * NG = 8 warps.  Ainv, P and G stream in
// chunks of NBC rows (the n-block) x 32 columns through NST buffers.
template <int MT, int NG, int NTW>
struct Tile {
  static_assert(MT * NG == 8, "eight warps");
  static constexpr int TT = 16 * MT;          // test points of a block
  static constexpr int NBC = NG * NTW * 8;    // columns of an n-block
  static constexpr int SB = (NBC + TT) * JS;  // floats of a chunk buffer
};
constexpr int NST = 3;  // chunk buffers: two chunks in flight past the one in use

// floats of the mma variant's shared memory: Bt (tt x (kb + 4), kb = K
// rounded up to the n-block), the chunk buffers, walpha + w for two
// experts, the quad and mu partials of the column groups
__host__ __device__ inline int mma_floats(int tt, int nbc, int K) {
  const int kb = (K + nbc - 1) / nbc * nbc;
  const int ng = 128 / tt;  // NG = 8 / MT
  return tt * (kb + 4) + NST * (nbc + tt) * JS + 2 * (kb + 4) + 2 * ng * tt;
}

// copy a (rows x 32) chunk at column j0 of M (row stride K) into dst (row
// stride JS); rows past ``rows_valid`` and columns past K are 0
__device__ __forceinline__ void stage_chunk(float* dst, const float* M, int rows,
                                            int rows_valid, int j0, int K, bool vec) {
  if (vec) {  // K % 4 == 0 and M 16-byte aligned: whole float4s
    for (int i = threadIdx.x; i < rows * (JC / 4); i += MMA_NT) {
      const int r = i / (JC / 4), c = 4 * (i % (JC / 4));
      const int live = r < rows_valid ? max(0, min(4, K - j0 - c)) : 0;
      cp16(dst + r * JS + c, M + (live ? (int64_t)r * K + j0 + c : 0), 4 * live);
    }
  } else {
    for (int i = threadIdx.x; i < rows * JC; i += MMA_NT) {
      const int r = i / JC, c = i % JC;
      const bool v = r < rows_valid && j0 + c < K;
      cp4(dst + r * JS + c, M + (v ? (int64_t)r * K + j0 + c : 0), v);
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The chunk's products into d: KS k-steps of 8 (KS = 0: ``ksteps`` of them,
// the chunk's last columns past K skipped), every n-tile (FULLN) or those
// below K8.  as: the left operand's rows (stride lda), ms: the right
// operand's chunk (NBC rows of JS).
template <int NTW, int KS, bool FULLN>
__device__ __forceinline__ void mma_chunk(const float* as, int lda, const float* ms, int r0,
                                          int r1, int ng, int gq, int c, int n0, int K8,
                                          float (&d)[NTW][4], int ksteps = KS) {
#pragma unroll
  for (int ks = 0; ks < JC / 8; ++ks) {
    if (KS == 0 && ks >= ksteps) break;
    const int kk = ks * 8 + c;
    uint32_t ah[4], al[4];
    split_tf32(as[r0 * lda + kk], ah[0], al[0]);
    split_tf32(as[r1 * lda + kk], ah[1], al[1]);
    split_tf32(as[r0 * lda + kk + 4], ah[2], al[2]);
    split_tf32(as[r1 * lda + kk + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = (ng * NTW + nt) * 8;  // the n-tile's first column in the n-block
      if (FULLN || n0 + col < K8) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(ms[(col + gq) * JS + kk], bh0, bl0);
        split_tf32(ms[(col + gq) * JS + kk + 4], bh1, bl1);
        mma_tf32(d[nt], al, bh0, bh1);  // the small terms first
        mma_tf32(d[nt], ah, bl0, bl1);
        mma_tf32(d[nt], ah, bh0, bh1);
      }
    }
  }
}

template <int MT, int NG, int NTW>
__global__ void __launch_bounds__(MMA_NT) mma_kernel(const Args a) {
  using C = Tile<MT, NG, NTW>;
  constexpr int TT = C::TT, NBC = C::NBC;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = a.K, t = a.t, n = blockIdx.z, t0 = blockIdx.x * TT;
  const int e0 = blockIdx.y * a.eg, e1 = min(a.m, e0 + a.eg);
  const int kb = (K + NBC - 1) / NBC * NBC, BS = kb + 4, K8 = (K + 7) / 8 * 8;
  const int nblk = kb / NBC, jcn = (K + JC - 1) / JC;
  float* bt = smem;                  // [TT][BS]
  float* stg = bt + TT * BS;         // NST x ([NBC][JS] + [TT][JS])
  float* wa = stg + NST * C::SB;     // 2 x [kb + 4]: walpha, then w at [kb], by expert parity
  float* red = wa + 2 * (kb + 4);    // [2][NG][TT]: quad, mu partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = warp % MT, ng = warp / MT, gq = lane / 4, c = lane % 4;
  const int64_t mK = (int64_t)a.m * K;
  const int tv = min(TT, t - t0);  // valid points of the tile

  // a position in the block's sequence of chunks: expert, phase (0: Ainv
  // and G, 1: P), n-block, chunk of the reduction; advanced in that order
  struct Pos {
    int e, ph, nb, jc, buf;
  };
  auto advance = [&](Pos& p) {
    p.buf = p.buf + 1 == NST ? 0 : p.buf + 1;
    if (++p.jc < jcn) return;
    p.jc = 0;
    if (++p.nb < nblk) return;
    p.nb = 0;
    if (++p.ph < 2) return;
    p.ph = 0;
    ++p.e;
  };
  auto issue = [&](const Pos& p) {
    if (p.e < e1) {
      float* ms = stg + p.buf * C::SB;
      const int64_t off = (n * mK + (int64_t)p.e * K) * K;
      const float* M = (p.ph == 0 ? a.Ainv : a.P) + off;
      stage_chunk(ms, M + (int64_t)p.nb * NBC * K, NBC, K - p.nb * NBC, p.jc * JC, K, a.vec);
      if (p.ph == 0)
        stage_chunk(ms + NBC * JS, a.G + ((n * (int64_t)a.m + p.e) * t + t0) * K, TT, tv,
                    p.jc * JC, K, a.vec);
      if (p.ph == 0 && p.nb == 0 && p.jc == 0) {  // walpha and w, read by the first product's epilogues
        float* wd = wa + ((p.e - e0) & 1) * (kb + 4);
        const float* wsrc = a.walpha + n * mK + (int64_t)p.e * K;
        for (int i = threadIdx.x; i <= kb; i += MMA_NT) {
          if (i < kb)
            cp4(wd + i, wsrc + (i < K ? i : 0), i < K);
          else
            cp4(wd + kb, a.w + (int64_t)n * a.m + p.e, true);
        }
      }
    }
    cp_commit();  // an empty group past the end keeps the count
  };

  const bool owner = threadIdx.x < TT;
  const bool live = t0 + threadIdx.x < t;
  const float gss = owner && live ? a.gss[(int64_t)n * t + t0 + threadIdx.x] : 1.f;
  const float prior = owner && live ? a.prior[(int64_t)n * t + t0 + threadIdx.x] : 1.f;
  Rows acc;
  float d[NTW][4];
  float q0 = 0.f, q1 = 0.f, mu0 = 0.f, mu1 = 0.f, we = 0.f;
  const int r0 = mi * 16 + gq, r1 = r0 + 8;  // this thread's rows of the tile

  Pos cur{e0, 0, 0, 0, 0}, next = cur;  // the chunk computed; the next one copied
  for (int i = 0; i < NST - 1; ++i) {
    issue(next);
    advance(next);
  }
  while (cur.e < e1) {
    cp_wait<NST - 2>();
    __syncthreads();  // chunk cur visible; everyone is done with the previous chunk's buffer
    issue(next);
    advance(next);
    const int e = cur.e, ph = cur.ph, nb = cur.nb, jc = cur.jc;
    const int n0 = nb * NBC, j0 = jc * JC;
    const float* ms = stg + cur.buf * C::SB;
    const float* as = ph == 0 ? ms + NBC * JS : bt + j0;  // the left operand's chunk
    const int lda = ph == 0 ? JS : BS;
    if (jc == 0) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
    }
    const int ksteps = min(JC / 8, (K - j0 + 7) / 8);
    if (ksteps == JC / 8 && n0 + NBC <= K8)  // a whole chunk of a whole n-block
      mma_chunk<NTW, JC / 8, true>(as, lda, ms, r0, r1, ng, gq, c, n0, K8, d);
    else
      mma_chunk<NTW, 0, false>(as, lda, ms, r0, r1, ng, gq, c, n0, K8, d, ksteps);
    if (jc == jcn - 1) {  // the n-block's epilogue
      const float* wd = wa + ((e - e0) & 1) * (kb + 4);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int col = n0 + (ng * NTW + nt) * 8 + 2 * c;
        if (ph == 0) {  // Bt to shared memory, mu's terms
          bt[r0 * BS + col] = d[nt][0];
          bt[r0 * BS + col + 1] = d[nt][1];
          bt[r1 * BS + col] = d[nt][2];
          bt[r1 * BS + col + 1] = d[nt][3];
          mu0 = fmaf(d[nt][0], wd[col], mu0);
          mu0 = fmaf(d[nt][1], wd[col + 1], mu0);
          mu1 = fmaf(d[nt][2], wd[col], mu1);
          mu1 = fmaf(d[nt][3], wd[col + 1], mu1);
        } else {  // the quad form's terms: Bt o Q
          q0 = fmaf(bt[r0 * BS + col], d[nt][0], q0);
          q0 = fmaf(bt[r0 * BS + col + 1], d[nt][1], q0);
          q1 = fmaf(bt[r1 * BS + col], d[nt][2], q1);
          q1 = fmaf(bt[r1 * BS + col + 1], d[nt][3], q1);
        }
      }
      if (ph == 0 && nb == 0) we = wd[kb];
    }
    advance(cur);
    if (cur.e != e) {  // the expert's last chunk: sum its rows' terms
      q0 += __shfl_xor_sync(FULL, q0, 1);
      q0 += __shfl_xor_sync(FULL, q0, 2);
      q1 += __shfl_xor_sync(FULL, q1, 1);
      q1 += __shfl_xor_sync(FULL, q1, 2);
      mu0 += __shfl_xor_sync(FULL, mu0, 1);
      mu0 += __shfl_xor_sync(FULL, mu0, 2);
      mu1 += __shfl_xor_sync(FULL, mu1, 1);
      mu1 += __shfl_xor_sync(FULL, mu1, 2);
      if (c == 0) {
        red[ng * TT + r0] = q0;
        red[ng * TT + r1] = q1;
        red[(NG + ng) * TT + r0] = mu0;
        red[(NG + ng) * TT + r1] = mu1;
      }
      q0 = q1 = mu0 = mu1 = 0.f;
      __syncthreads();
      if (owner) {
        float quad = red[threadIdx.x], mu = red[NG * TT + threadIdx.x];
        for (int g = 1; g < NG; ++g) {
          quad += red[g * TT + threadIdx.x];
          mu += red[(NG + g) * TT + threadIdx.x];
        }
        add_moments(a.fuse, mu, quad, gss, prior, we, acc);
      }
    }
  }
  finish(a, owner, threadIdx.x, acc);
}

// ---- launch ------------------------------------------------------------------

// the mma variant's n-block: 32 columns at K <= SMALL_K (one block, one chunk
// a product), else 64
__host__ __device__ inline int mma_nbc(int K) { return K <= SMALL_K ? 32 : 64; }

// dynamic shared memory of one block (ops.py::smem_bytes adds SMEM_STATIC)
inline size_t smem_bytes(int variant, int tt, int K) {
  if (variant == MMA) return sizeof(float) * (size_t)mma_floats(tt, mma_nbc(K), K);
  const int kp = (K + 3) / 4 * 4;
  const int r = kp / 4, ks = r % 2 ? kp : kp + 4;
  return sizeof(float) * 2 * (size_t)(2 * kp * ks + kp + 4 + ((tt * K + 3) & ~3));
}

template <typename Kernel>
int launch_kernel(Kernel kernel, const Args& a, int threads, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.t + a.tt - 1) / a.tt, a.groups, a.T);
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Validate a plan (kernels/epilogue/ops.py::plan_fleet mirrors the rules)
// and launch it.  variant 0 small: K <= 32, tt 16 or 32.  variant 1 mma:
// tt 128 at K <= 32 (one 32-column n-block), else tt 32 or 16.  groups of
// ceil(m / groups) consecutive experts.
inline int launch_epilogue(Args a, int variant, cudaStream_t s) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.T <= 0 || a.T > 65535 || a.m <= 0 || a.t <= 0 || a.K <= 0 || a.groups <= 0 ||
      a.groups > a.m || a.groups > 65535 || a.fuse < NONE || a.fuse > RBCM ||
      (a.groups > 1 && (a.part == nullptr || a.counters == nullptr)) ||
      (int64_t)3 * a.T * a.t > INT32_MAX)
    return bad;
  a.eg = (a.m + a.groups - 1) / a.groups;
  if ((a.m + a.eg - 1) / a.eg != a.groups) return bad;
  const size_t smem = smem_bytes(variant, a.tt, a.K);
  if (smem + SMEM_STATIC > SMEM_MAX) return bad;
  if (variant == SMALL) {
    if (a.K > SMALL_K || (a.tt != 16 && a.tt != 32)) return bad;
    const int threads = TPP * a.tt;
    switch ((a.K + 3) / 4) {
      case 1: return launch_kernel(small_kernel<4>, a, threads, smem, s);
      case 2: return launch_kernel(small_kernel<8>, a, threads, smem, s);
      case 3: return launch_kernel(small_kernel<12>, a, threads, smem, s);
      case 4: return launch_kernel(small_kernel<16>, a, threads, smem, s);
      case 5: return launch_kernel(small_kernel<20>, a, threads, smem, s);
      case 6: return launch_kernel(small_kernel<24>, a, threads, smem, s);
      case 7: return launch_kernel(small_kernel<28>, a, threads, smem, s);
      default: return launch_kernel(small_kernel<32>, a, threads, smem, s);
    }
  }
  if (variant != MMA) return bad;
  const uintptr_t any = reinterpret_cast<uintptr_t>(a.G) | reinterpret_cast<uintptr_t>(a.Ainv) |
                        reinterpret_cast<uintptr_t>(a.P);
  a.vec = a.K % 4 == 0 && (any & 15) == 0;
  if (a.K <= SMALL_K)  // eight m-tiles, each warp all four n-tiles of the 32 columns
    return a.tt == 128 ? launch_kernel(mma_kernel<8, 1, 4>, a, MMA_NT, smem, s) : bad;
  switch (a.tt) {
    case 16: return launch_kernel(mma_kernel<1, 8, 1>, a, MMA_NT, smem, s);
    case 32: return launch_kernel(mma_kernel<2, 4, 2>, a, MMA_NT, smem, s);
    default: return bad;
  }
}

}  // namespace
