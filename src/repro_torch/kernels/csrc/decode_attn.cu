// Single-token GQA decode attention over a (ring) KV cache, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/decode_attn/decode_attn.py::
// decode_attn_pallas (_kernel) together with the division its wrapper
// (ops.py) does after it: for batch b, KV head kv and query head g of that
// KV head, out = sum_s w_s V[b, s, kv] with w the softmax over the S cache
// slots of q . K[b, s, kv]; a slot is valid when kpos >= 0, kpos <= pos and,
// with a window, kpos > pos - window.  An invalid slot's score is the
// reference's finite NEG = -1e30, not -inf, so a row with no valid slot
// gives the mean of V over the S slots it was given (exp(NEG - NEG) = 1
// for each), as decode_attn_ref does, where -inf would give NaN.  The
// ragged end of S is masked here — no padded slots — so that mean is over
// the real S.  q fp32 or bf16, K/V fp32 or bf16 (template parameters),
// every product and sum in fp32.
//
// What bounds it on the H100: bytes.  At the kernels bench shape (B = 8,
// S = 8192, KV = 4, G = 8, hd = 128, K/V bf16) it reads 134 MB of K/V once
// (40 us at 3.35 TB/s) for 1.07 GFLOP (16 us at 67 TFLOP/s fp32).
//
// Design.  Pass 1: grid (S split x G chunk, KV, B), 128 threads.  A block
// owns one (b, kv), a chunk of up to 8 of its G query heads and one range
// of S, walked in tiles of 128 slots with the online softmax of the TPU
// kernel: thread t computes the scores of slot t for every query head of
// the chunk from ONE read of its K row (16-byte loads where hd % 8 == 0),
// so the G heads share each K load; the tile's max and sum per head are
// warp reductions in a fixed order.  The weighted sum of V rows is split
// over (slot group, 8-column group) threads: each reads 8 columns of a V
// row with one 16-byte load and updates 8 columns x the chunk's heads in
// registers; at the end of the range the slot groups' sums are added in
// group order through shared memory.  (Without 16-byte alignment or with
// hd % 8 != 0, thread h takes columns h, h + 128, ... with scalar loads.)
// Splitting S gives B x KV x splits blocks (about four per SM) where one
// block per (b, kv) would give only 32 at the bench shape on 132 SMs.
// Each block writes its unnormalized (acc, m, denom) partials.  Pass 2,
// one block per (b, kv, g): combine the partials in split order — no
// atomics, the same bits every run — and divide acc by max(denom, 1e-30)
// as the reference's wrapper does.  pos is read on the device (from a 0-d
// tensor) or passed by value; offsets are 64-bit.  Every slot's K row is
// read, valid or not (the mask follows the score), and at hd = 256 a
// thread's 512-byte K row strains L1: the bench shape runs at ~2.7x its
// byte bound, the gemma2-2b local layer at ~4x (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int TS = 128;      // slots per tile = threads per block
constexpr int GC = 8;        // query heads per block (a G chunk)
constexpr int HD_MAX = 512;  // head dim: output columns tid + 128 c, c < 4
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// VEC (hd % 8 == 0, 16-byte aligned K and V): 16-byte loads, and the
// weighted V sum split over (slot group, 8-column group) threads.
// Otherwise scalar loads, thread h owning columns h + 128 c, c < HC.
template <typename TQ, typename TKV, bool VEC, int HC>
__global__ void __launch_bounds__(TS)
decode_attn_partial(int S, int KV, int G, int hd, int ngc, int tps,
                    const TQ* __restrict__ q,        // (B, KV, G, hd)
                    const TKV* __restrict__ K,       // (B, S, KV, hd)
                    const TKV* __restrict__ V,       // (B, S, KV, hd)
                    const int32_t* __restrict__ kpos,  // (B, S)
                    const int32_t* __restrict__ pos_ptr, int64_t pos_val,
                    int has_window, int64_t window, int nsplit,
                    float* __restrict__ part_acc,    // (B, KV, nsplit, G, hd)
                    float* __restrict__ part_m,      // (B, KV, nsplit, G)
                    float* __restrict__ part_d) {    // (B, KV, nsplit, G)
  // q and the tile's scores (5120 floats) while the tiles run; then, on the
  // VEC path, the slot groups' partial sums (128 / (hd / 8) x 8 x hd <= 8192)
  __shared__ __align__(16) float smem[2 * GC * HD_MAX];
  float (*qs)[HD_MAX] = reinterpret_cast<float (*)[HD_MAX]>(smem);
  float (*ps)[GC] = reinterpret_cast<float (*)[GC]>(smem + GC * HD_MAX);  // scores, weights
  __shared__ float m_run[GC], d_run[GC], m_new[GC], alpha[GC];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gc = blockIdx.x % ngc, split = blockIdx.x / ngc;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int g0 = gc * GC;
  const int gn = min(GC, G - g0);
  // VEC: thread = (slot group sg, column group cg of 8 columns)
  const int ncg = hd / 8;
  const int nsg = VEC ? TS / ncg : 1;
  const int sg = VEC ? tid / ncg : 0, cg = VEC ? tid % ncg : 0;

  const TQ* q_b = q + (((int64_t)b * KV + kv) * G + g0) * hd;
  for (int e = tid; e < gn * hd; e += TS) qs[e / hd][e % hd] = to_f(q_b[e]);
  if (tid < GC) {
    m_run[tid] = NEG;
    d_run[tid] = 0.f;
  }
  const int64_t pos = pos_ptr ? (int64_t)*pos_ptr : pos_val;
  constexpr int NA = VEC ? 8 : HC;  // accumulators per head: columns a thread owns
  float acc[NA][GC];
#pragma unroll
  for (int c = 0; c < NA; ++c)
#pragma unroll
    for (int g = 0; g < GC; ++g) acc[c][g] = 0.f;
  __syncthreads();

  const int64_t row_stride = (int64_t)KV * hd;  // between slots
  const TKV* K_b = K + (int64_t)b * S * row_stride + (int64_t)kv * hd;
  const TKV* V_b = V + (int64_t)b * S * row_stride + (int64_t)kv * hd;
  const int t_begin = split * tps * TS;
  const int t_end = min(S, t_begin + tps * TS);

  for (int t0 = t_begin; t0 < t_end; t0 += TS) {
    // scores of slot t0 + tid for every head of the chunk, one K row read
    const int t = t0 + tid;
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = 0.f;
    if (t < t_end) {
      const TKV* krow = K_b + (int64_t)t * row_stride;
      if constexpr (VEC) {
#pragma unroll 4
        for (int h = 0; h < hd; h += 8) {
          float kf[8];
          load8(krow + h, kf);
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            if (g < gn) {
              const float4 qa = *reinterpret_cast<const float4*>(&qs[g][h]);
              const float4 qb = *reinterpret_cast<const float4*>(&qs[g][h + 4]);
              float a = s[g];
              a = fmaf(qa.x, kf[0], a); a = fmaf(qa.y, kf[1], a);
              a = fmaf(qa.z, kf[2], a); a = fmaf(qa.w, kf[3], a);
              a = fmaf(qb.x, kf[4], a); a = fmaf(qb.y, kf[5], a);
              a = fmaf(qb.z, kf[6], a); a = fmaf(qb.w, kf[7], a);
              s[g] = a;
            }
          }
        }
      } else {
        for (int h = 0; h < hd; ++h) {
          const float kf = to_f(krow[h]);
#pragma unroll
          for (int g = 0; g < GC; ++g)
            if (g < gn) s[g] = fmaf(qs[g][h], kf, s[g]);
        }
      }
      const int64_t kp = kpos[(int64_t)b * S + t];
      const bool valid = kp >= 0 && kp <= pos && (!has_window || kp > pos - window);
#pragma unroll
      for (int g = 0; g < GC; ++g) ps[tid][g] = valid ? s[g] : NEG;
    } else {
#pragma unroll
      for (int g = 0; g < GC; ++g) ps[tid][g] = -INFINITY;  // past the range: no slot
    }
    __syncthreads();

    // the tile's max per head and the new running max
    for (int g = warp; g < gn; g += TS / 32) {
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < TS / 32; ++k) mx = fmaxf(mx, ps[lane + 32 * k][g]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) {
        const float mn = fmaxf(m_run[g], mx);  // >= NEG: finite
        m_new[g] = mn;
        alpha[g] = expf(m_run[g] - mn);
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GC; ++g)
      if (g < gn) ps[tid][g] = expf(ps[tid][g] - m_new[g]);  // -inf -> 0
    __syncthreads();

    // the tile's sum per head: the running denominator
    for (int g = warp; g < gn; g += TS / 32) {
      float sm = 0.f;
#pragma unroll
      for (int k = 0; k < TS / 32; ++k) sm += ps[lane + 32 * k][g];
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
    const int nk = min(TS, t_end - t0);
    if constexpr (VEC) {  // slot group sg takes slots sg, sg + nsg, ...: 8 columns a load
      if (sg < nsg) {
#pragma unroll 2
        for (int tt = sg; tt < nk; tt += nsg) {
          const float4 pa = *reinterpret_cast<const float4*>(&ps[tt][0]);
          const float4 pb = *reinterpret_cast<const float4*>(&ps[tt][4]);
          const float pw[GC] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
          float vf[8];
          load8(V_b + (int64_t)(t0 + tt) * row_stride + cg * 8, vf);
#pragma unroll
          for (int e = 0; e < NA; ++e)
#pragma unroll
            for (int g = 0; g < GC; ++g) acc[e][g] = fmaf(pw[g], vf[e], acc[e][g]);
        }
      }
    } else {  // thread h owns columns h + 128 c: one V read per slot and column
#pragma unroll 4
      for (int tt = 0; tt < nk; ++tt) {
        const float4 pa = *reinterpret_cast<const float4*>(&ps[tt][0]);
        const float4 pb = *reinterpret_cast<const float4*>(&ps[tt][4]);
        const float pw[GC] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const TKV* vrow = V_b + (int64_t)(t0 + tt) * row_stride;
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          const int h = tid + c * TS;
          if (h < hd) {
            const float v = to_f(vrow[h]);
#pragma unroll
            for (int g = 0; g < GC; ++g) acc[c][g] = fmaf(pw[g], v, acc[c][g]);
          }
        }
      }
    }
    __syncthreads();  // before the next tile overwrites ps
  }

  const int64_t base = (((int64_t)b * KV + kv) * nsplit + split) * G + g0;
  if constexpr (VEC) {  // sum the slot groups' partials in group order
    float* red = smem;  // q and the scores are no longer read
    if (sg < nsg) {
#pragma unroll
      for (int g = 0; g < GC; ++g)
        if (g < gn)
#pragma unroll
          for (int e = 0; e < NA; ++e) red[(sg * GC + g) * hd + cg * 8 + e] = acc[e][g];
    }
    __syncthreads();
    for (int o = tid; o < gn * hd; o += TS) {
      const int g = o / hd, h = o % hd;
      float a = 0.f;
      for (int k = 0; k < nsg; ++k) a += red[(k * GC + g) * hd + h];
      part_acc[(base + g) * hd + h] = a;
    }
  } else {
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      const int h = tid + c * TS;
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

// One block per (b, kv, g): combine the split partials in split order.
__global__ void __launch_bounds__(TS)
decode_attn_combine(int G, int hd, int nsplit, const float* __restrict__ part_acc,
                    const float* __restrict__ part_m, const float* __restrict__ part_d,
                    float* __restrict__ out) {
  const int64_t bkg = blockIdx.x;  // (b * KV + kv) * G + g
  const int64_t bk = bkg / G;
  const int g = static_cast<int>(bkg % G);
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[(bk * nsplit + s) * G + g]);
  float den = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const int64_t i = (bk * nsplit + s) * G + g;
    den += part_d[i] * expf(part_m[i] - M);
  }
  const float inv_den = 1.f / fmaxf(den, 1e-30f);
  for (int h = threadIdx.x; h < hd; h += TS) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const int64_t i = (bk * nsplit + s) * G + g;
      a += part_acc[i * hd + h] * expf(part_m[i] - M);
    }
    out[bkg * hd + h] = a * inv_den;
  }
}

template <typename TQ, typename TKV>
void launch(bool vec, dim3 grid, cudaStream_t st, int S, int KV, int G, int hd, int ngc,
            int tps, const void* q, const void* K, const void* V, const int32_t* kpos,
            const int32_t* pos_ptr, int64_t pos_val, int has_window, int64_t window,
            int nsplit, float* pa, float* pm, float* pd) {
#define REPRO_PARTIAL(VEC, HC)                                                         \
  decode_attn_partial<TQ, TKV, VEC, HC><<<grid, TS, 0, st>>>(                          \
      S, KV, G, hd, ngc, tps, static_cast<const TQ*>(q), static_cast<const TKV*>(K),   \
      static_cast<const TKV*>(V), kpos, pos_ptr, pos_val, has_window, window, nsplit, \
      pa, pm, pd)
  if (vec)
    REPRO_PARTIAL(true, 1);
  else if (hd <= TS)
    REPRO_PARTIAL(false, 1);
  else if (hd <= 2 * TS)
    REPRO_PARTIAL(false, 2);
  else
    REPRO_PARTIAL(false, 4);
#undef REPRO_PARTIAL
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  vec: 1 when hd % 8 == 0
// and K, V are 16-byte aligned.  pos_ptr: a device int32, or null to use
// pos_val.  Splits of tps tiles of 128 slots each; the partial buffers hold
// B * KV * nsplit * G (* hd) floats.
extern "C" int repro_decode_attn(int q_bf16, int kv_bf16, int vec, int B, int S, int KV,
                                 int G, int hd, int nsplit, int tps, const void* q,
                                 const void* K, const void* V, const int32_t* kpos,
                                 const int32_t* pos_ptr, int64_t pos_val, int has_window,
                                 int64_t window, float* part_acc, float* part_m,
                                 float* part_d, float* out, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;  // an empty output
  if (S <= 0 || hd > HD_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ngc = (G + GC - 1) / GC;
  const dim3 grid(nsplit * ngc, KV, B);
  const bool v = vec != 0;
  if (q_bf16 && kv_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(v, grid, st, S, KV, G, hd, ngc, tps, q, K, V,
                                             kpos, pos_ptr, pos_val, has_window, window,
                                             nsplit, part_acc, part_m, part_d);
  else if (q_bf16)
    launch<__nv_bfloat16, float>(v, grid, st, S, KV, G, hd, ngc, tps, q, K, V, kpos,
                                     pos_ptr, pos_val, has_window, window, nsplit,
                                     part_acc, part_m, part_d);
  else if (kv_bf16)
    launch<float, __nv_bfloat16>(v, grid, st, S, KV, G, hd, ngc, tps, q, K, V, kpos,
                                     pos_ptr, pos_val, has_window, window, nsplit,
                                     part_acc, part_m, part_d);
  else
    launch<float, float>(v, grid, st, S, KV, G, hd, ngc, tps, q, K, V, kpos, pos_ptr,
                             pos_val, has_window, window, nsplit, part_acc, part_m,
                             part_d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_combine<<<B * KV * G, TS, 0, st>>>(G, hd, nsplit, part_acc, part_m, part_d,
                                                 out);
  return static_cast<int>(cudaGetLastError());
}
