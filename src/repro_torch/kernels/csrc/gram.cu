// Tiled fp32 gram block G = X Y^T for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/gram/gram.py::gram_pallas
// (_gram_kernel): G[i, j] = <x_i, y_j>, fp32 accumulation.  The backward
// (dX = g Y, dY = g^T X) runs this kernel on transposed views
// (kernels/gram/ops.py).
//
// What bounds it on the H100, by shape (K is the reduction axis; times
// measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W are in
// PERF.md):
// - The GP request and fit products (128 x 25 and 25 x 25, K = 21) move a
//   few KB and do ~0.1 MFLOP: launch latency bounds them.  One launch of
//   one or two blocks.
// - The forward at large n and p (4449 x 40000, K = 21) writes 712 MB of G
//   for 2 n p K = 7.5 GFLOP: bound by writing G (0.21 ms at 3.35 TB/s).
// - The backward products have a narrow output (4449 x 21 and 40000 x 21)
//   and a long K (40000 and 4449): each reads the 712 MB of g once and does
//   7.5 GFLOP of fp32 FMA, so the pair is bound by operations (0.22 ms at
//   67 TFLOP/s) and by reading g twice (0.43 ms).  The earlier single
//   64 x 64 tile gave them 70 blocks for 132 SMs, each walking all of K in
//   series, with two thirds of each tile padding (7.5 ms for the pair).
//
// Design.  Three tile configurations, chosen per shape by plan() in ops.py:
// "small" 64 x 64 (4 x 4 outputs a thread, 256 threads) for an output of a
// few such tiles over a short K, for an output of 25 to 32 columns and
// where the wide tiles would not fill the card; "narrow24" 128 x 24
// (8 x 4, 96 threads) for an output of at most 24 columns (d = 21 wastes
// an eighth of the tile, not two thirds); "wide" 128 x 128 (8 x 8, 256
// threads) where the output fills the card.
// Where the tiles would not fill the blocks the card holds at once and K
// is long, plan() splits K into as many ranges as fill about two such
// waves (each at least 256): each split (blockIdx.z) writes its partial (splits, n, p)
// block into a workspace the wrapper allocates, and a second kernel adds
// the partials in split order — no atomics, so two runs give the same
// bits.  A block stages (BK x tile) slabs of X and Y in shared memory,
// double-buffered with cp.async so the next slab loads while the current
// one is multiplied.  Operands stay addressed through their strides (the
// backward passes transposed views without copies), and each is copied
// along whichever axis has unit stride: 16-byte cp.async along the rows
// of the slab where the row axis is unit stride and 16-byte aligned (g^T
// in dY, staged k-major), 16-byte cp.async along k where the k axis is
// (g in dX, staged row-major, its rows read as float4 over 4 k), else
// 4-byte cp.async with a warp covering 4 rows x 8 consecutive k or 32
// consecutive rows (X and Y of the forward: d = 21 rows are not 16-byte
// aligned).  Row pitches are padded by four floats, so the copies and the
// float4 reads of the multiply are free of bank conflicts.  Ragged n, p
// and K edges are zero-filled at the copy and masked at the store.  Each
// thread owns groups of 4 consecutive output columns and stores them as
// float4 where p % 4 == 0, so a half-warp writes 256 contiguous bytes of a
// row of G.  No tensor cores: fp32 in, fp32 FMA in k order within a split,
// no TF32, so each split matches a plain fp32 product to rounding.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int PAD = 4;  // floats of padding per slab row: 16-byte aligned, pitch = 4 mod 32

enum LoadMode { LOAD_M16 = 0, LOAD_M1 = 1, LOAD_K1 = 2 };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, zero-filled when !ok (the source is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16 bytes of which the first `bytes` are read, the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the (BK x R) slab k in [k0, k0 + BK) x rows [r0, r0 + R) of an
// operand (M rows, strides s_m, s_k; k < k_end) into dst[k][r].
template <int R, int BK, int NT>
__device__ __forceinline__ void load_slab(float (*dst)[R + PAD], const float* __restrict__ src,
                                          int64_t s_m, int64_t s_k, int mode, int M, int r0,
                                          int k0, int k_end, int tid) {
  if (mode == LOAD_M16) {  // s_m == 1: 16-byte chunks of 4 rows
    constexpr int CH = R / 4;
#pragma unroll 4
    for (int e = tid; e < BK * CH; e += NT) {
      const int k = e / CH, r = (e % CH) * 4;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gk < k_end && gr < M;
      cp_async16(&dst[k][r], ok ? src + gr + gk * s_k : src, ok ? min(4, M - gr) * 4 : 0);
    }
  } else if (mode == LOAD_M1) {  // lanes along the rows
#pragma unroll 4
    for (int e = tid; e < BK * R; e += NT) {
      const int k = e / R, r = e % R;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gk < k_end && gr < M;
      cp_async4(&dst[k][r], ok ? src + gr * s_m + gk * s_k : src, ok);
    }
  } else {  // LOAD_K1: a warp covers 4 rows x 8 consecutive k (32 bytes of each row)
#pragma unroll 4
    for (int e = tid; e < BK * R; e += NT) {
      const int lane = e % 32, grp = e / 32;
      const int k = (grp % (BK / 8)) * 8 + lane / 4;
      const int r = (grp / (BK / 8)) * 4 + lane % 4;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gk < k_end && gr < M;
      cp_async4(&dst[k][r], ok ? src + gr * s_m + gk * s_k : src, ok);
    }
  }
}

// Copy the (R x BK) slab of an operand whose k axis has unit stride and
// whose rows are 16-byte aligned into dst[r][k] (pitch BK + PAD): 16-byte
// cp.async, consecutive lanes on consecutive 16 bytes of a row.
template <int R, int BK, int NT>
__device__ __forceinline__ void load_slab_rows(float* dst, const float* __restrict__ src,
                                               int64_t s_m, int M, int r0, int k0, int k_end,
                                               int tid) {
  constexpr int CH = BK / 4;
#pragma unroll 4
  for (int e = tid; e < R * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 4;
    const int gr = r0 + r, gk = k0 + c;
    const bool ok = gk < k_end && gr < M;
    cp_async16(dst + r * (BK + PAD) + c, ok ? src + gr * s_m + gk : src,
               ok ? min(4, k_end - gk) * 4 : 0);
  }
}

// One block: a (BM x BN) tile of the output over the K range of split
// blockIdx.z, in BK-slabs; the copy of the next slab is in flight while
// the current one is multiplied.  Thread (ty, tx) owns TM rows (AR:
// ty + TY i, else ty TM + i) and TN/4 groups of 4 consecutive columns,
// group c starting at c BN/(TN/4) + 4 tx.  AR: X is staged row-major (its
// k axis has unit stride, 16-byte aligned rows), else k-major like Y.
template <int BM, int BN, int BK, int TM, int TN, int MINB, bool AR>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
gram_kernel(int n, int p, int d, int kps,
            const float* __restrict__ x, int64_t sxn, int64_t sxd, int xmode,
            const float* __restrict__ y, int64_t syp, int64_t syd, int ymode,
            float* __restrict__ out, int vec_store) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  constexpr int NG = TN / 4, GW = BN / NG;  // column groups a thread owns, and their spacing
  constexpr int XK = BM + PAD, XR = BK + PAD;  // pitches of X staged k-major / row-major
  constexpr int XS = AR ? BM * XR : BK * XK;
  static_assert(BK % 8 == 0 && BM % 32 == 0 && BN % 4 == 0 && TM % 4 == 0 && TN % 4 == 0, "");
  __shared__ __align__(16) float xs[2][XS];
  __shared__ __align__(16) float ys[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kps;
  const int k_end = min(d, k_begin + kps);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  auto row_of = [&](int i) { return AR ? ty + TY * i : ty * TM + i; };
  auto issue = [&](int s, int buf) {
    const int k0 = k_begin + s * BK;
    if constexpr (AR)
      load_slab_rows<BM, BK, NT>(xs[buf], x, sxn, n, row0, k0, k_end, tid);
    else
      load_slab<BM, BK, NT>(reinterpret_cast<float(*)[XK]>(xs[buf]), x, sxn, sxd, xmode, n,
                            row0, k0, k_end, tid);
    load_slab<BN, BK, NT>(ys[buf], y, syp, syd, ymode, p, col0, k0, k_end, tid);
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // b: this thread's TN columns of Y at slab row k
  auto load_b = [&](const float (*yb)[BN + PAD], int k, float (&b)[TN]) {
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(&yb[k][c * GW + tx * 4]);
      b[4 * c] = v.x; b[4 * c + 1] = v.y; b[4 * c + 2] = v.z; b[4 * c + 3] = v.w;
    }
  };
  // one k: X k-major, TM rows as float4 reads
  auto mac_k = [&](const float* xb, const float (*yb)[BN + PAD], int k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xb + k * XK + ty * TM + i);
      a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
    }
    load_b(yb, k, b);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  };
  // four k at k0: X row-major, each row's 4 k as one float4 read
  auto mac_r4 = [&](const float* xb, const float (*yb)[BN + PAD], int k0) {
    float a[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(xb + row_of(i) * XR + k0);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[TN];
      load_b(yb, k0 + kk, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
    }
  };
  // one k: X row-major (the ragged end of a range)
  auto mac_r1 = [&](const float* xb, const float (*yb)[BN + PAD], int k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = xb[row_of(i) * XR + k];
    load_b(yb, k, b);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  };

  if (nk > 0) issue(0, 0);
  for (int s = 0; s < nk; ++s) {
    const int cur = s & 1;
    if (s + 1 < nk) {  // the next slab loads while this one is multiplied
      issue(s + 1, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kmax = min(BK, k_end - (k_begin + s * BK));
    const float* xb = xs[cur];
    const float(*yb)[BN + PAD] = ys[cur];
    if constexpr (AR) {
      if (kmax == BK) {
#pragma unroll
        for (int k = 0; k < BK; k += 4) mac_r4(xb, yb, k);
      } else {
        const int k4 = kmax & ~3;
        for (int k = 0; k < k4; k += 4) mac_r4(xb, yb, k);
        for (int k = k4; k < kmax; ++k) mac_r1(xb, yb, k);
      }
    } else {
      if (kmax == BK) {
#pragma unroll
        for (int k = 0; k < BK; ++k) mac_k(xb, yb, k);
      } else {
#pragma unroll 4
        for (int k = 0; k < kmax; ++k) mac_k(xb, yb, k);
      }
    }
    __syncthreads();  // before the next iteration's copy overwrites this slab
  }

  float* o = out + (int64_t)blockIdx.z * n * p;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + row_of(i);
    if (r >= n) continue;
    float* orow = o + (int64_t)r * p;
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      const int col = col0 + c * GW + tx * 4;
      if (vec_store) {  // p % 4 == 0: the group lies wholly inside or outside the row
        if (col < p)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p) orow[col + e] = acc[i][4 * c + e];
      }
    }
  }
}

// out[i] = ws[0][i] + ws[1][i] + ... in split order: the same bits every run
__global__ void __launch_bounds__(256)
gram_split_sum(int64_t total, int splits, const float* __restrict__ ws, float* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    float a = ws[i];
    for (int s = 1; s < splits; ++s) a += ws[s * total + i];
    out[i] = a;
  }
}

int load_mode(const float* ptr, int64_t s_m, int64_t s_k) {
  if (s_m == 1)
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s_k % 4 == 0 ? LOAD_M16 : LOAD_M1;
  return s_k == 1 ? LOAD_K1 : LOAD_M1;
}

// X staged row-major: its k axis has unit stride and its rows are 16-byte aligned
bool rows_aligned(const float* ptr, int64_t s_m, int64_t s_k) {
  return s_k == 1 && s_m % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <int BM, int BN, int BK, int TM, int TN, int MINB, bool AR>
cudaError_t launch_as(cudaStream_t st, int n, int p, int d, int splits, int kps,
                      const float* x, int64_t sxn, int64_t sxd, const float* y, int64_t syp,
                      int64_t syd, float* dst) {
  const dim3 grid((p + BN - 1) / BN, (n + BM - 1) / BM, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const int vec_store = p % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  gram_kernel<BM, BN, BK, TM, TN, MINB, AR><<<grid, (BM / TM) * (BN / TN), 0, st>>>(
      n, p, d, kps, x, sxn, sxd, load_mode(x, sxn, sxd), y, syp, syd, load_mode(y, syp, syd),
      dst, vec_store);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int TM, int TN, int MINB>
cudaError_t launch(cudaStream_t st, int n, int p, int d, int splits, int kps, const float* x,
                   int64_t sxn, int64_t sxd, const float* y, int64_t syp, int64_t syd,
                   float* dst) {
  return rows_aligned(x, sxn, sxd)
             ? launch_as<BM, BN, BK, TM, TN, MINB, true>(st, n, p, d, splits, kps, x, sxn, sxd,
                                                         y, syp, syd, dst)
             : launch_as<BM, BN, BK, TM, TN, MINB, false>(st, n, p, d, splits, kps, x, sxn,
                                                          sxd, y, syp, syd, dst);
}

// Blocks an SM holds of the tile's kernel (the smaller of its two staging
// forms), from the occupancy API.
template <int BM, int BN, int BK, int TM, int TN, int MINB>
int residency() {
  constexpr int NT = (BM / TM) * (BN / TN);
  int a = 0, b = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &a, gram_kernel<BM, BN, BK, TM, TN, MINB, true>, NT, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, gram_kernel<BM, BN, BK, TM, TN, MINB, false>, NT, 0) != cudaSuccess)
    return 0;
  return a < b ? a : b;
}

}  // namespace

// tile: 0 small (64 x 64), 1 wide (128 x 128), 2 narrow24 (128 x 24) —
// the names and shapes of ops.TILES.  K is cut
// into `splits` ranges of `kps` (a multiple of the tile's BK, every range
// non-empty); with splits > 1 the partials go to ws (splits x n x p
// floats) and are summed into out.
extern "C" int repro_gram_f32(int tile, int n, int p, int d, int splits, int kps,
                              const float* x, int64_t sxn, int64_t sxd,
                              const float* y, int64_t syp, int64_t syd,
                              float* ws, float* out, void* stream) {
  if (n <= 0 || p <= 0) return 0;  // an empty output: nothing to launch
  // every split non-empty, together covering K
  if (splits < 1 || (splits > 1 && ws == nullptr) || (int64_t)splits * kps < d ||
      (splits > 1 && (int64_t)(splits - 1) * kps >= d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? ws : out;
  cudaError_t err;
  switch (tile) {
    case 0: err = launch<64, 64, 32, 4, 4, 2>(st, n, p, d, splits, kps, x, sxn, sxd, y, syp, syd, dst); break;
    case 1: err = launch<128, 128, 16, 8, 8, 2>(st, n, p, d, splits, kps, x, sxn, sxd, y, syp, syd, dst); break;
    case 2: err = launch<128, 24, 32, 8, 4, 5>(st, n, p, d, splits, kps, x, sxn, sxd, y, syp, syd, dst); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t total = (int64_t)n * p;
  const int64_t blocks = (total + 255) / 256;
  gram_split_sum<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      total, splits, ws, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the tile's kernel an SM holds (the smaller of its two
// staging forms), from the occupancy API; 0 for an unknown tile.
extern "C" int repro_gram_residency(int tile) {
  switch (tile) {
    case 0: return residency<64, 64, 32, 4, 4, 2>();
    case 1: return residency<128, 128, 16, 8, 8, 2>();
    case 2: return residency<128, 24, 32, 8, 4, 5>();
    default: return 0;
  }
}
