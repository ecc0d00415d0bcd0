// Single-token GQA decode attention over a (ring) KV cache, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/decode_attn/decode_attn.py::
// decode_attn_pallas (_kernel) together with the division its wrapper
// (ops.py) does after it: for batch b, KV head kv and query head g of that
// KV head, out = sum_s w_s V[b, s, kv] with w the softmax over the S cache
// slots of q . K[b, s, kv]; a slot is valid when kpos >= 0, kpos <= pos and,
// with a window, kpos > pos - window.  With a softcap (gemma2: 50) each
// valid slot's score s becomes cap tanh(s / cap) before the softmax, as
// repro/models/decode.py::_attn_decode caps the scores before it masks
// them; an invalid slot is never scored, so the cap never meets the mask.
// The reference scores an invalid slot with its finite NEG = -1e30, so in
// a row with a valid slot an invalid slot's weight exp(NEG - m) is exactly
// 0 in fp32, and a row with no valid slot gives the mean of V over its S
// slots (exp(NEG - NEG) = 1 each).
// q fp32 or bf16, K/V fp32 or bf16 (template parameters), every product
// and sum in fp32.
//
// What bounds it on the H100: bytes — the K and V rows of the valid slots.
// At the kernels bench shape (B = 8, S = 8192, KV = 4, G = 8, hd = 128,
// K/V bf16, every slot valid) that is 134 MB (40 us at 3.35 TB/s) for
// 1.07 GFLOP (16 us at 67 TFLOP/s fp32); a gemma2-2b local layer
// (hd = 256, window 4096 of S = 8192) needs half its cache.  The earlier
// kernel read every slot's K row before its mask (a window saved no
// bytes), a thread a row (uncoalesced), and on the CUDA cores its score
// phase read q from shared memory once per 8 multiply-adds.
//
// Design.  Both kernels read kpos first and compact the valid slots into
// a list (ballots), then read only the listed slots' K and V rows: a
// range without a valid slot reads nothing but its kpos, and a slot
// outside the window costs neither its K nor its V row.  The warp kernel
// copies the rows with 16-byte cp.async, consecutive lanes on consecutive
// 16 bytes of a row, into shared memory whose row pitch is an odd number
// of 16-byte units (conflict-free reads), through a ring of two stages —
// the next stage's rows load while one is used.
//
// The warp kernel (decode_attn_warp, plan path "mma": bf16 K/V with 16-byte
// rows, hd <= 256) works in the manner of split-K decoding: a block of
// four warps owns one (b, kv), a chunk of up to 8 query heads and a range
// of up to 2048 slots, and each warp works alone, with no block barrier,
// on a quarter of it in stages of 16 valid slots on the tensor cores
// (mma.sync m16n8k16 bf16, fp32 accumulate): S^T = K Q^T with q split
// exactly into three bf16 terms (one for bf16 q; K is bf16 already, so
// every product is exact), the online softmax on the score fragments
// (shuffles), then O^T += V^T P^T with the weights split exactly into
// three bf16 terms and moved into the operand layout by movmatrix, V^T
// read by ldmatrix.trans.  The four warps' partials are merged in warp
// order at the end.  plan() gives as many ranges as the SMs hold blocks at
// once.  The block kernel (decode_attn_partial, path "simt": fp32 K/V,
// hd > 256 or rows that are not 16-byte aligned) is 128 threads on the
// CUDA cores: it compacts 1024 slots at a time and takes tiles of up to
// 128 listed slots, scoring with a thread a slot (one K read from global
// memory shared by the chunk's heads), max and sum with a warp per head,
// and the weighted V sum over (slot group, 8-column group) threads.
//
// Each range writes its unnormalized (acc, m, denom); one that saw no
// valid slot writes m = -inf, denom = 0, acc = 0.  decode_attn_combine,
// one block per (b, kv, g), merges the ranges in order — no atomics, the
// same bits every run — and divides by max(denom, 1e-30) as the
// reference's wrapper does; where no range saw a valid slot (M = -inf) it
// writes the mean of V over the S slots, the reference's answer for a row
// with no valid key.  pos is read on the device (from a 0-d tensor) or
// passed by value; offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 128;       // threads per block
constexpr int GC = 8;         // query heads per block (a G chunk)
constexpr int HD_MAX = 512;   // largest head dim
constexpr int WIN = NT * 8;   // kpos slots compacted per window

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// gemma2's attention logit softcap, cap tanh(s / cap), on a valid slot's
// raw score (before the running max); with has_cap 0 the score as it was
__device__ __forceinline__ float softcap(float s, int has_cap, float cap) {
  return has_cap ? cap * tanhf(s / cap) : s;
}

// eight consecutive elements from a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// bf16 pair (lo in the low half), and q split exactly into bf16 terms
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D += A B: m16n8k16, A row-major and B column-major bf16, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four 8 x 8 bf16 matrices of a 16 x 16 tile (row-major in shared memory)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* row_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(row_addr))));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The CUDA-core path (plan path "simt": fp32 K/V, hd > 256, or K/V rows
// that are not a whole number of 16 bytes).  A block of NT threads owns
// one (b, kv), a chunk of up to GC query heads and one range of S.  It
// reads kpos first, WIN slots at a time, and compacts the valid slots into
// `list` (ballots and a block prefix sum), so an invalid slot costs
// neither its K nor its V row.  Tiles of up to NT listed slots then take
// the online softmax: thread t scores listed slot t for every head of the
// chunk from one read of its K row, straight from global memory (16-byte
// loads on the VEC path), in 64-column sums added in order (one fp32 chain
// over hd = 512 strays past 1e-5 max|V|); the tile's max and sum per head
// are warp reductions; the weighted V sum is split over (slot group,
// 8-column group) threads with 16-byte loads of V (VEC), or thread h owns
// columns h + NT c (scalar loads), and the slot groups' sums are added in
// group order at the end.  Staging the rows in shared memory with
// cp.async measured slower on this path: a stage of 512-byte rows held 16
// slots, and its block barriers and per-head reductions cost more than
// the coalesced copy saved (PERF.md).
template <typename TQ, typename TKV, bool VEC>
__global__ void __launch_bounds__(NT, 4)
decode_attn_partial(int S, int KV, int G, int hd, int ngc, int sps,
                    const TQ* __restrict__ q,          // (B, KV, G, hd)
                    const TKV* __restrict__ K,         // (B, S, KV, hd)
                    const TKV* __restrict__ V,         // (B, S, KV, hd)
                    const int32_t* __restrict__ kpos,  // (B, S)
                    const int32_t* __restrict__ pos_ptr, int64_t pos_val,
                    int has_window, int64_t window, int has_cap, float cap, int nsplit,
                    float* __restrict__ part_acc,      // (B, KV, nsplit, G, hd)
                    float* __restrict__ part_m,        // (B, KV, nsplit, G)
                    float* __restrict__ part_d) {      // (B, KV, nsplit, G)
  // q and the tile's scores while the tiles run; then, on the VEC path,
  // the slot groups' partial sums (NT / (hd / 8) x GC x hd <= 8192 floats)
  __shared__ __align__(16) float smem[2 * GC * HD_MAX];
  __shared__ int list[WIN];  // the valid slots of the compacted window
  __shared__ float m_run[GC], d_run[GC], m_new[GC], alpha[GC];
  __shared__ int wsum[NT / 32];
  float (*qs)[HD_MAX] = reinterpret_cast<float (*)[HD_MAX]>(smem);
  float (*ps)[GC] = reinterpret_cast<float (*)[GC]>(smem + GC * HD_MAX);  // scores, weights

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gc = blockIdx.x % ngc, split = blockIdx.x / ngc;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int g0 = gc * GC;
  const int gn = min(GC, G - g0);
  // VEC: thread = (slot group sg, column group cg of 8 columns)
  const int ncg = hd / 8;
  const int nsg = VEC ? NT / ncg : 1;
  const int sg = VEC ? tid / ncg : 0, cg = VEC ? tid % ncg : 0;

  const TQ* q_b = q + (((int64_t)b * KV + kv) * G + g0) * hd;
  for (int e = tid; e < gn * hd; e += NT) qs[e / hd][e % hd] = to_f(q_b[e]);
  if (tid < GC) {
    m_run[tid] = -INFINITY;
    d_run[tid] = 0.f;
  }
  const int64_t pos = pos_ptr ? (int64_t)*pos_ptr : pos_val;
  const int64_t row_stride = (int64_t)KV * hd;  // between slots
  const TKV* K_b = K + (int64_t)b * S * row_stride + (int64_t)kv * hd;
  const TKV* V_b = V + (int64_t)b * S * row_stride + (int64_t)kv * hd;
  const int32_t* kp_b = kpos + (int64_t)b * S;
  const int s_begin = split * sps;
  const int s_end = min(S, s_begin + sps);

  // kpos, read before any K or V: the window [scan, scan + WIN) in
  // registers, 8 consecutive slots a thread (-1 past the range)
  int scan = s_begin, list_n = 0, list_pos = 0;
  int kp[8];
  auto fetch = [&]() {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int s = scan + tid * 8 + e;
      kp[e] = s < s_end ? kp_b[s] : -1;
    }
  };
  // compact the fetched window's valid slots into `list` (slot order), then
  // fetch the next window; block-uniform
  auto compact = [&]() {
    unsigned mask = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int64_t k = kp[e];
      if (k >= 0 && k <= pos && (!has_window || k > pos - window)) mask |= 1u << e;
    }
    const int cnt = __popc(mask);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int off = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      const int v = wsum[w];
      off += w < warp ? v : 0;
      total += v;
    }
    const int base = scan + tid * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (mask >> e & 1u) list[off++] = base + e;
    list_n = total;
    list_pos = 0;
    scan += WIN;
    if (scan < s_end) fetch();
    __syncthreads();  // the list is complete; wsum free again
  };

  constexpr int NA = VEC ? 8 : HD_MAX / NT;  // accumulators per head: columns a thread owns
  float acc[NA][GC];
#pragma unroll
  for (int c = 0; c < NA; ++c)
#pragma unroll
    for (int g = 0; g < GC; ++g) acc[c][g] = 0.f;

  if (scan < s_end) fetch();
  __syncthreads();  // q, m_run, d_run
  for (;;) {
    while (list_pos == list_n && scan < s_end) compact();
    if (list_pos == list_n) break;  // the range is done
    const int nv = min(NT, list_n - list_pos);
    const int* rows = list + list_pos;

    // scores of listed slot tid for every head of the chunk, one K row read
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = 0.f;
    if (tid < nv) {
      const TKV* krow = K_b + (int64_t)rows[tid] * row_stride;
      for (int h0 = 0; h0 < hd; h0 += 64) {
        const int h1 = min(hd, h0 + 64);
        float t[GC];
#pragma unroll
        for (int g = 0; g < GC; ++g) t[g] = 0.f;
        if constexpr (VEC) {
#pragma unroll 4
          for (int h = h0; h < h1; h += 8) {
            float kf[8];
            load8(krow + h, kf);
#pragma unroll
            for (int g = 0; g < GC; ++g) {
              if (g < gn) {
                const float4 qa = *reinterpret_cast<const float4*>(&qs[g][h]);
                const float4 qb = *reinterpret_cast<const float4*>(&qs[g][h + 4]);
                float a = t[g];
                a = fmaf(qa.x, kf[0], a); a = fmaf(qa.y, kf[1], a);
                a = fmaf(qa.z, kf[2], a); a = fmaf(qa.w, kf[3], a);
                a = fmaf(qb.x, kf[4], a); a = fmaf(qb.y, kf[5], a);
                a = fmaf(qb.z, kf[6], a); a = fmaf(qb.w, kf[7], a);
                t[g] = a;
              }
            }
          }
        } else {
#pragma unroll 4
          for (int h = h0; h < h1; ++h) {
            const float kf = to_f(krow[h]);
#pragma unroll
            for (int g = 0; g < GC; ++g)
              if (g < gn) t[g] = fmaf(qs[g][h], kf, t[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) s[g] += t[g];
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g)
      ps[tid][g] = tid < nv ? softcap(s[g], has_cap, cap) : -INFINITY;  // past nv: no weight
    __syncthreads();

    // the tile's max per head and the new running max
    for (int g = warp; g < gn; g += NT / 32) {
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) mx = fmaxf(mx, ps[lane + 32 * k][g]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) {
        const float mn = fmaxf(m_run[g], mx);  // finite: the tile has a valid slot
        m_new[g] = mn;
        alpha[g] = expf(m_run[g] - mn);  // 0 on the first tile (m_run = -inf)
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GC; ++g)
      if (g < gn) ps[tid][g] = expf(ps[tid][g] - m_new[g]);  // -inf -> 0
    __syncthreads();

    // the tile's sum per head: the running denominator
    for (int g = warp; g < gn; g += NT / 32) {
      float sm = 0.f;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) sm += ps[lane + 32 * k][g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sm += __shfl_xor_sync(0xffffffffu, sm, o);
      if (lane == 0) {
        d_run[g] = d_run[g] * alpha[g] + sm;
        m_run[g] = m_new[g];
      }
    }

    // rescale and accumulate the weighted V rows
    float al[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) al[g] = g < gn ? alpha[g] : 0.f;
#pragma unroll
    for (int c = 0; c < NA; ++c)
#pragma unroll
      for (int g = 0; g < GC; ++g) acc[c][g] *= al[g];
    if constexpr (VEC) {  // slot group sg takes slots sg, sg + nsg, ...: 8 columns a load
      if (sg < nsg) {
#pragma unroll 2
        for (int j = sg; j < nv; j += nsg) {
          const float4 pa = *reinterpret_cast<const float4*>(&ps[j][0]);
          const float4 pb = *reinterpret_cast<const float4*>(&ps[j][4]);
          const float pw[GC] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
          float vf[8];
          load8(V_b + (int64_t)rows[j] * row_stride + cg * 8, vf);
#pragma unroll
          for (int e = 0; e < NA; ++e)
#pragma unroll
            for (int g = 0; g < GC; ++g) acc[e][g] = fmaf(pw[g], vf[e], acc[e][g]);
        }
      }
    } else {  // thread h owns columns h + NT c: one V read per slot and column
#pragma unroll 4
      for (int j = 0; j < nv; ++j) {
        const float4 pa = *reinterpret_cast<const float4*>(&ps[j][0]);
        const float4 pb = *reinterpret_cast<const float4*>(&ps[j][4]);
        const float pw[GC] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const TKV* vrow = V_b + (int64_t)rows[j] * row_stride;
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          const int h = tid + c * NT;
          if (h < hd) {
            const float v = to_f(vrow[h]);
#pragma unroll
            for (int g = 0; g < GC; ++g) acc[c][g] = fmaf(pw[g], v, acc[c][g]);
          }
        }
      }
    }
    list_pos += nv;
    __syncthreads();  // before the next tile overwrites ps, or a compaction the list
  }

  // a range that saw no valid slot writes acc = 0, m = -inf, denom = 0
  const int64_t base = (((int64_t)b * KV + kv) * nsplit + split) * G + g0;
  if constexpr (VEC) {  // sum the slot groups' partials in group order
    float* red = smem;  // q and the scores are no longer read
    __syncthreads();
    if (sg < nsg) {
#pragma unroll
      for (int g = 0; g < GC; ++g)
        if (g < gn)
#pragma unroll
          for (int e = 0; e < NA; ++e) red[(sg * GC + g) * hd + cg * 8 + e] = acc[e][g];
    }
    __syncthreads();
    for (int o = tid; o < gn * hd; o += NT) {
      const int g = o / hd, h = o % hd;
      float a = 0.f;
      for (int k = 0; k < nsg; ++k) a += red[(k * GC + g) * hd + h];
      part_acc[(base + g) * hd + h] = a;
    }
  } else {
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      const int h = tid + c * NT;
      if (h < hd) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
          if (g < gn) part_acc[(base + g) * hd + h] = acc[c][g];
      }
    }
  }
  if (tid < gn) {
    part_m[base + tid] = m_run[tid];
    part_d[base + tid] = d_run[tid];
  }
}

// The tensor-core path: bf16 K/V with 16-byte rows, hd <= 256.  A block
// of NWW warps owns one (b, kv), a chunk of up to 8 query heads and a
// range of S; each warp works alone on a quarter of the range (at most
// WSPS slots), with no block barrier until the end.  A warp reads its
// range's kpos once (coalesced, every load in flight together) and
// compacts the valid slots into a list (ballots); the list feeds stages of
// 16 slots whose K and V rows are copied with 16-byte cp.async into the
// warp's ring of WNST stages, one in flight while one is used.  Per
// stage: S^T (16 slots x 8 heads) = K Q^T with mma.sync m16n8k16 over
// 16-element k-steps, q split exactly into NTERM bf16 terms (K is bf16
// already, every product exact, fp32 sums); the online softmax on the C
// fragment (a lane holds two slots x two heads; max and sum by three
// shuffles); the weights split exactly into three bf16 terms and moved
// into the B layout with movmatrix; O^T (hd x 8 heads) += V^T P^T, V^T's
// fragments read with ldmatrix.trans.  At the end the warps' (acc, m,
// denom) are merged in warp order through shared memory into the block's
// partial; decode_attn_combine merges the blocks' ranges.
constexpr int WS = 16;       // slots of a warp stage: one m16 tile
constexpr int WSPS = 512;    // most slots in a warp's range: its kpos list
constexpr int WNST = 2;      // stages in a warp's copy ring: one in flight while one is used

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* row_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(row_addr))));
}

// bf16 value of x (round to nearest), and x minus it (exact)
__device__ __forceinline__ float bf16_part(float& x) {
  const float h = __bfloat162float(__float2bfloat16_rn(x));
  x -= h;
  return h;
}

// Shared memory of the warp path (bytes): Q^T's B fragments (shared by the
// block's warps), then for each warp its slot list and its stage ring.
constexpr int NWW = 4;  // warps of a block: each its own range, merged at the end
struct WarpLayout {
  int hdp;    // hd rounded up to 16 (the k-steps and m-tiles)
  int pitch;  // elements between staged rows: an odd number of 16-byte units
  size_t qb, warp0, per_warp, list, kv, total;  // warp w's list / ring at warp0 + w per_warp + list / kv
  __host__ __device__ WarpLayout(int hd, int nterm) {
    hdp = (hd + 15) / 16 * 16;
    pitch = hdp + 8;
    qb = 0;
    warp0 = qb + (size_t)nterm * (hdp / 16) * 32 * sizeof(uint2);
    list = 0;
    kv = WSPS * sizeof(int);
    per_warp = kv + (size_t)2 * WNST * WS * pitch * 2;
    total = warp0 + NWW * per_warp;
  }
};

template <typename TQ, int MT>  // MT: most m-tiles of hd (hd <= 16 MT)
__global__ void __launch_bounds__(32 * NWW)
decode_attn_warp(int S, int KV, int G, int hd, int ngc, int sps,
                 const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ K,
                 const __nv_bfloat16* __restrict__ V, const int32_t* __restrict__ kpos,
                 const int32_t* __restrict__ pos_ptr, int64_t pos_val, int has_window,
                 int64_t window, int has_cap, float cap, int nsplit,
                 float* __restrict__ part_acc,
                 float* __restrict__ part_m, float* __restrict__ part_d) {
  constexpr int NTERM = std::is_same<TQ, __nv_bfloat16>::value ? 1 : 3;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const WarpLayout L(hd, NTERM);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned char* mine = smem + L.warp0 + warp * L.per_warp;
  uint2* qb = reinterpret_cast<uint2*>(smem + L.qb);   // (NTERM, KS, 32), shared
  int* list = reinterpret_cast<int*>(mine + L.list);   // valid slots of this warp's range
  bf16* kvs = reinterpret_cast<bf16*>(mine + L.kv);    // stage i: K at 2i, V at 2i + 1
  const int pitch = L.pitch, hdp = L.hdp, KS = hdp / 16;
  const size_t tile = (size_t)WS * pitch;

  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  // KV heads fastest, so the warps of one slot range read neighbouring rows
  const int kv = blockIdx.x % KV, gc = blockIdx.x / KV % ngc, split = blockIdx.x / KV / ngc;
  const int b = blockIdx.y;
  const int g0 = gc * GC, gn = min(GC, G - g0);
  const int64_t pos = pos_ptr ? (int64_t)*pos_ptr : pos_val;
  const int64_t row_stride = (int64_t)KV * hd;
  const bf16* K_b = K + (int64_t)b * S * row_stride + (int64_t)kv * hd;
  const bf16* V_b = V + (int64_t)b * S * row_stride + (int64_t)kv * hd;
  // the block's range [split sps, + sps) in NWW warp ranges of sps / NWW
  const int wsps = sps / NWW;
  const int s_begin = split * sps + warp * wsps;
  const int s_end = min(S, s_begin + wsps);

  // kpos of the whole range, every load in flight at once
  int kp[WSPS / 32];
  const int32_t* kp_b = kpos + (int64_t)b * S;
#pragma unroll
  for (int i = 0; i < WSPS / 32; ++i) {
    const int s = s_begin + 32 * i + lane;
    kp[i] = s < s_end ? kp_b[s] : -1;
  }
  // Q^T's B fragments: lane holds head g, k rows 2t, 2t+1 (.x) and 2t+8,
  // 2t+9 (.y) of each k-step, per term (every load first)
  const TQ* q_n = q + (((int64_t)b * KV + kv) * G + g0 + g) * hd;
  float qv[MT][4];
#pragma unroll
  for (int ks = 0; ks < MT; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = ks * 16 + 2 * t + (i & 1) + (i >> 1) * 8;
      qv[ks][i] = g < gn && h < hd ? to_f(q_n[h]) : 0.f;
    }
#pragma unroll
  for (int ks = 0; ks < MT; ++ks) {
    if (ks < KS && ks % NWW == warp) {  // the block's warps share the fragments
#pragma unroll
      for (int term = 0; term < NTERM; ++term) {
        float h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = bf16_part(qv[ks][i]);
        qb[(term * KS + ks) * 32 + lane] =
            make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
      }
    }
  }
  // the valid slots, in slot order
  int n_list = 0;
#pragma unroll
  for (int i = 0; i < WSPS / 32; ++i) {
    const int64_t k = kp[i];
    const bool ok = k >= 0 && k <= pos && (!has_window || k > pos - window);
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (ok) list[n_list + __popc(mask & ((1u << lane) - 1))] = s_begin + 32 * i + lane;
    n_list += __popc(mask);
  }
  // columns [hd, hdp) of the staged rows stay zero (the copies stop at hd)
  if (hdp > hd) {
    const int w = hdp - hd;
    for (int e = lane; e < 2 * WNST * WS * w; e += 32)
      kvs[(e / w) * pitch + hd + e % w] = __float2bfloat16(0.f);
  }
  __syncthreads();  // the shared q fragments, this warp's list and zeros

  const int nstage = (n_list + WS - 1) / WS;
  const int nch = hd / 8;  // 16-byte chunks of a row
  auto issue = [&](int i) {  // copy stage i's rows into ring slot i % WNST
    if (i < nstage) {
      bf16* ks_ = kvs + (size_t)(2 * (i % WNST)) * tile;
      bf16* vs_ = ks_ + tile;
      const int nv = min(WS, n_list - WS * i);
      // a short (last) stage: V rows past nv are zeros, so weight 0 times
      // them is 0 (K rows there are masked by their score)
      for (int e = lane; e < (WS - nv) * (hdp / 8); e += 32)
        *reinterpret_cast<uint4*>(vs_ + (nv + e / (hdp / 8)) * pitch + e % (hdp / 8) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      if (32 % nch == 0) {  // a lane keeps its chunk; rows step by 32 / nch
        const int c = lane % nch;
        for (int r = lane / nch; r < nv; r += 32 / nch) {
          const int64_t off = (int64_t)list[WS * i + r] * row_stride + c * 8;
          cp_async16(ks_ + r * pitch + c * 8, K_b + off);
          cp_async16(vs_ + r * pitch + c * 8, V_b + off);
        }
      } else {
        for (int e = lane; e < nv * nch; e += 32) {
          const int r = e / nch, c = e - r * nch;
          const int64_t off = (int64_t)list[WS * i + r] * row_stride + c * 8;
          cp_async16(ks_ + r * pitch + c * 8, K_b + off);
          cp_async16(vs_ + r * pitch + c * 8, V_b + off);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float o[MT][4];  // O^T fragments: rows hd (16 mt + g, + 8), columns heads 2t, 2t + 1
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, d_run[2] = {0.f, 0.f};  // heads 2t, 2t + 1

  for (int i = 0; i < WNST - 1; ++i) issue(i);
  for (int i = 0; i < nstage; ++i) {
    issue(i + WNST - 1);
    cp_async_wait<WNST - 1>();
    __syncwarp();
    const bf16* ks_ = kvs + (size_t)(2 * (i % WNST)) * tile;
    const bf16* vs_ = ks_ + tile;
    const int nv = min(WS, n_list - WS * i);

    // S^T = K Q^T: four accumulators over the k-steps, added in order
    float cc[4][4] = {};
    const bf16* arow = ks_ + ((lane / 8) % 2 * 8 + lane % 8) * pitch + (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < MT; ++ks) {
      if (ks < KS) {
        uint32_t a[4];
        ldmatrix_x4(a, arow + ks * 16);
#pragma unroll
        for (int term = 0; term < NTERM; ++term) {
          const uint2 bq = qb[(term * KS + ks) * 32 + lane];
          mma_bf16(cc[ks % 4], a, bq.x, bq.y);
        }
      }
    }
    // c: (slot g, head 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1); rows past nv: none
    float sc[2][2];  // [head e][slot g, g + 8]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lo = (cc[0][e] + cc[1][e]) + (cc[2][e] + cc[3][e]);
      const float hi = (cc[0][2 + e] + cc[1][2 + e]) + (cc[2][2 + e] + cc[3][2 + e]);
      sc[e][0] = g < nv ? softcap(lo, has_cap, cap) : -INFINITY;
      sc[e][1] = g + 8 < nv ? softcap(hi, has_cap, cap) : -INFINITY;
    }
    float p[2][2], al[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(sc[e][0], sc[e][1]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m_run[e], mx);  // finite: slot 0 of the stage is valid
      p[e][0] = expf(sc[e][0] - mn);
      p[e][1] = expf(sc[e][1] - mn);
      float sm = p[e][0] + p[e][1];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sm += __shfl_xor_sync(0xffffffffu, sm, off);
      al[e] = expf(m_run[e] - mn);  // 0 on the first stage (m_run = -inf)
      d_run[e] = d_run[e] * al[e] + sm;
      m_run[e] = mn;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      o[mt][0] *= al[0]; o[mt][1] *= al[1];
      o[mt][2] *= al[0]; o[mt][3] *= al[1];
    }
    // P^T's B fragments per term: transpose the (slot x head) 8 x 8 blocks
    uint32_t bp[3][2];
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const float h00 = bf16_part(p[0][0]), h10 = bf16_part(p[1][0]);
      const float h01 = bf16_part(p[0][1]), h11 = bf16_part(p[1][1]);
      bp[term][0] = movmatrix_trans(pack_bf16(h00, h10));  // slots 0-7
      bp[term][1] = movmatrix_trans(pack_bf16(h01, h11));  // slots 8-15
    }
    // O^T += V^T P^T: V^T's 16 x 16 tiles by ldmatrix.trans of V's rows
    const bf16* vrow = vs_ + ((lane / 16) * 8 + lane % 8) * pitch + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < KS) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vrow + mt * 16);
#pragma unroll
        for (int term = 0; term < 3; ++term) mma_bf16(o[mt], a, bp[term][0], bp[term][1]);
      }
    }
    __syncwarp();  // before a later issue overwrites this ring slot
  }
  cp_async_wait<0>();

  // this warp's (m, denom, acc) into its ring (used no more): heads 2t,
  // 2t + 1 of the chunk, hd rows 16 mt + g (+ 8)
  float* red = reinterpret_cast<float*>(kvs);  // m[GC], d[GC], acc[GC][hdp]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = 2 * t + (e & 1), h = 16 * mt + g + (e >> 1) * 8;
      if (mt < KS) red[2 * GC + head * hdp + h] = o[mt][e];
    }
  }
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      red[2 * t + e] = m_run[e];
      red[GC + 2 * t + e] = d_run[e];
    }
  }
  __syncthreads();
  // the block's range: the warps' ranges merged in warp order; a warp that
  // saw no valid slot has m = -inf and adds 0, and so does the block
  const int64_t base = (((int64_t)b * KV + kv) * nsplit + split) * G + g0;
  for (int e = threadIdx.x; e < gn * hd; e += 32 * NWW) {
    const int head = e / hd, h = e % hd;
    const float* r0 = reinterpret_cast<const float*>(smem + L.warp0 + L.kv);
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWW; ++w)
      M = fmaxf(M, reinterpret_cast<const float*>(
                       reinterpret_cast<const unsigned char*>(r0) + w * L.per_warp)[head]);
    float acc = 0.f, den = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWW; ++w) {
        const float* rw = reinterpret_cast<const float*>(
            reinterpret_cast<const unsigned char*>(r0) + w * L.per_warp);
        const float wt = expf(rw[head] - M);
        den += rw[GC + head] * wt;
        acc += rw[2 * GC + head * hdp + h] * wt;
      }
    }
    part_acc[(base + head) * hd + h] = acc;
    if (h == 0) {
      part_m[base + head] = M;
      part_d[base + head] = den;
    }
  }
}

// One block of NTC threads per (b, kv, g): combine the split partials.  A
// row where no split saw a valid slot gets the mean of V over the S slots.
// The splits' weights exp(m_s - M) are taken once, NTC at a time, into
// shared memory.  Thread (group q, column c) sums the splits s = q mod
// CG in order over columns c, c + CW, ...; the CG group sums and
// denominators are then added in group order — a fixed order, the same
// bits every run, with CG independent chains of loads per column.
constexpr int NTC = 256;       // threads of the combine
constexpr int CG = 4;          // split groups
constexpr int CW = NTC / CG;   // columns a pass covers
template <typename TKV>
__global__ void __launch_bounds__(NTC)
decode_attn_combine(int S, int KV, int G, int hd, int nsplit, const float* __restrict__ part_acc,
                    const float* __restrict__ part_m, const float* __restrict__ part_d,
                    const TKV* __restrict__ V, float* __restrict__ out) {
  constexpr int HC = HD_MAX / CW;  // column passes at most
  __shared__ float w_s[NTC], d_s[NTC], red[NTC / 32], acc_s[CG][CW + 1], den_s[CG];
  const int tid = threadIdx.x, grp = tid / CW, col = tid % CW;
  const int64_t bkg = blockIdx.x;  // (b * KV + kv) * G + g
  const int64_t bk = bkg / G;
  const int g = static_cast<int>(bkg % G);
  const int64_t first = bk * nsplit * G + g;  // split s at first + s G
  float M = -INFINITY;
  for (int s = tid; s < nsplit; s += NTC) M = fmaxf(M, part_m[first + (int64_t)s * G]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  if (tid % 32 == 0) red[tid / 32] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NTC / 32; ++w) M = fmaxf(M, red[w]);
  if (M == -INFINITY) {  // no valid key: exp(NEG - NEG) = 1 for every slot
    const int64_t b = bk / KV, kv = bk % KV;
    const TKV* v = V + b * S * (int64_t)KV * hd + kv * hd;
    for (int h = tid; h < hd; h += NTC) {
      float a = 0.f;
#pragma unroll 8
      for (int s = 0; s < S; ++s) a += to_f(v[(int64_t)s * KV * hd + h]);
      out[bkg * hd + h] = a / S;
    }
    return;
  }
  float den = 0.f, acc[HC];
#pragma unroll
  for (int c = 0; c < HC; ++c) acc[c] = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += NTC) {
    const int n = min(NTC, nsplit - s0);
    __syncthreads();  // the previous chunk's weights are used
    if (tid < n) {
      const int64_t i = first + (int64_t)(s0 + tid) * G;
      w_s[tid] = expf(part_m[i] - M);  // a split with no valid slot: 0 (its d and acc are 0)
      d_s[tid] = part_d[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int s = grp; s < n; s += CG) {
      const float w = w_s[s];
      den += d_s[s] * w;
      const float* pa = part_acc + (first + (int64_t)(s0 + s) * G) * hd;
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int h = col + CW * c;
        if (h < hd) acc[c] += pa[h] * w;
      }
    }
  }
  if (col == 0) den_s[grp] = den;
  float total_den = 0.f;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < CG; ++q) total_den += den_s[q];
  const float inv_den = 1.f / fmaxf(total_den, 1e-30f);
#pragma unroll
  for (int c = 0; c < HC; ++c) {
    if (CW * c >= hd) break;
    acc_s[grp][col] = acc[c];
    __syncthreads();
    const int h = col + CW * c;
    if (grp == 0 && h < hd) {
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < CG; ++q) a += acc_s[q][col];
      out[bkg * hd + h] = a * inv_den;
    }
    __syncthreads();
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(bool vec, dim3 grid, cudaStream_t st, int S, int KV, int G, int hd, int ngc,
                   int sps, const void* q, const void* K, const void* V, const int32_t* kpos,
                   const int32_t* pos_ptr, int64_t pos_val, int has_window, int64_t window,
                   int has_cap, float cap, int nsplit, float* pa, float* pm, float* pd,
                   float* out) {
  const TQ* q_ = static_cast<const TQ*>(q);
  const TKV *K_ = static_cast<const TKV*>(K), *V_ = static_cast<const TKV*>(V);
  if (vec)
    decode_attn_partial<TQ, TKV, true><<<grid, NT, 0, st>>>(
        S, KV, G, hd, ngc, sps, q_, K_, V_, kpos, pos_ptr, pos_val, has_window, window, has_cap,
        cap, nsplit, pa, pm, pd);
  else
    decode_attn_partial<TQ, TKV, false><<<grid, NT, 0, st>>>(
        S, KV, G, hd, ngc, sps, q_, K_, V_, kpos, pos_ptr, pos_val, has_window, window, has_cap,
        cap, nsplit, pa, pm, pd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<TKV><<<grid.z * grid.y * G, NTC, 0, st>>>(S, KV, G, hd, nsplit, pa, pm,
                                                                pd, V_, out);
  return cudaGetLastError();
}

template <typename TQ, int MT>
cudaError_t launch_warp(dim3 grid, size_t smem, cudaStream_t st, int S, int KV, int G, int hd,
                        int ngc, int sps, const void* q, const void* K, const void* V,
                        const int32_t* kpos, const int32_t* pos_ptr, int64_t pos_val,
                        int has_window, int64_t window, int has_cap, float cap, int nsplit,
                        float* pa, float* pm, float* pd, float* out) {
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_warp<TQ, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 wgrid(grid.y * grid.x, grid.z);  // (KV x chunks x splits, B): KV fastest
  decode_attn_warp<TQ, MT><<<wgrid, 32 * NWW, smem, st>>>(
      S, KV, G, hd, ngc, sps, static_cast<const TQ*>(q),
      static_cast<const __nv_bfloat16*>(K), static_cast<const __nv_bfloat16*>(V), kpos,
      pos_ptr, pos_val, has_window, window, has_cap, cap, nsplit, pa, pm, pd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<__nv_bfloat16><<<grid.z * grid.y * G, NTC, 0, st>>>(
      S, KV, G, hd, nsplit, pa, pm, pd, static_cast<const __nv_bfloat16*>(V), out);
  return cudaGetLastError();
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  vec: 1 when
// hd % 8 == 0 and K, V are 16-byte aligned.  pos_ptr: a device int32, or
// null to use pos_val.  S is cut into nsplit ranges of sps slots (every
// range non-empty).  path 0: the block kernel (tiles of up to 128
// valid slots); path 1: the warp kernel (bf16 K/V, vec, hd <= 256,
// sps a multiple of 4 up to 2048: 4 warps of sps / 4).  The partial
// buffers hold B * KV * nsplit * G (* hd) floats.
extern "C" int repro_decode_attn(int q_bf16, int kv_bf16, int vec, int path, int B, int S,
                                 int KV, int G, int hd, int nsplit, int sps,
                                 const void* q, const void* K, const void* V,
                                 const int32_t* kpos, const int32_t* pos_ptr, int64_t pos_val,
                                 int has_window, int64_t window, int has_cap, float cap,
                                 float* part_acc,
                                 float* part_m, float* part_d, float* out, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;  // an empty output
  if (S <= 0 || hd > HD_MAX || nsplit < 1 || sps < 1 || (int64_t)nsplit * sps < S ||
      (int64_t)(nsplit - 1) * sps >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ngc = (G + GC - 1) / GC;
  const dim3 grid(nsplit * ngc, KV, B);
  cudaError_t err;
  if (path == 1) {
    if (!kv_bf16 || !vec || hd > 256 || sps % NWW || sps > NWW * WSPS)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = WarpLayout(hd, q_bf16 ? 1 : 3).total;
    if (q_bf16)
      err = hd <= 128 ? launch_warp<__nv_bfloat16, 8>(grid, smem, st, S, KV, G, hd, ngc, sps,
                                                      q, K, V, kpos, pos_ptr, pos_val, has_window,
                                                      window, has_cap, cap, nsplit, part_acc,
                                                      part_m, part_d, out)
                      : launch_warp<__nv_bfloat16, 16>(grid, smem, st, S, KV, G, hd, ngc, sps,
                                                       q, K, V, kpos, pos_ptr, pos_val, has_window,
                                                       window, has_cap, cap, nsplit, part_acc,
                                                       part_m, part_d, out);
    else
      err = hd <= 128 ? launch_warp<float, 8>(grid, smem, st, S, KV, G, hd, ngc, sps, q, K, V,
                                              kpos, pos_ptr, pos_val, has_window, window, has_cap,
                                              cap, nsplit, part_acc, part_m, part_d, out)
                      : launch_warp<float, 16>(grid, smem, st, S, KV, G, hd, ngc, sps, q, K, V,
                                               kpos, pos_ptr, pos_val, has_window, window, has_cap,
                                               cap, nsplit, part_acc, part_m, part_d, out);
    return static_cast<int>(err);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool v = vec != 0;
  if (q_bf16 && kv_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(v, grid, st, S, KV, G, hd, ngc, sps, q, K, V,
                                               kpos, pos_ptr, pos_val, has_window, window,
                                               has_cap, cap, nsplit, part_acc, part_m, part_d, out);
  else if (q_bf16)
    err = launch<__nv_bfloat16, float>(v, grid, st, S, KV, G, hd, ngc, sps, q, K, V, kpos,
                                       pos_ptr, pos_val, has_window, window, has_cap, cap,
                                       nsplit, part_acc,
                                       part_m, part_d, out);
  else if (kv_bf16)
    err = launch<float, __nv_bfloat16>(v, grid, st, S, KV, G, hd, ngc, sps, q, K, V, kpos,
                                       pos_ptr, pos_val, has_window, window, has_cap, cap,
                                       nsplit, part_acc,
                                       part_m, part_d, out);
  else
    err = launch<float, float>(v, grid, st, S, KV, G, hd, ngc, sps, q, K, V, kpos, pos_ptr,
                               pos_val, has_window, window, has_cap, cap, nsplit, part_acc,
                               part_m, part_d,
                               out);
  return static_cast<int>(err);
}
