// The shared body of the two fused quantized-gram kernels for Hopper
// (sm_90a): qgram_packed.cu (codes unpacked from the wire's uint32 words)
// and qgram.cu (int32 codes).  Both compute, for every machine b in one
// launch, G[b] = x̂[b] y[b]^T with x̂[b][i, j] = cents[b, j, code[b, i, j]];
// a code outside [0, C) decodes to 0, a masked row (packed) gives a zero
// row.  The body is templated on a row loader that yields the code of
// (row, dimension); everything else — the tiles, the staging, the
// decode, the multiply and the store — is one code path.
//
// What bounds each shape on the H100 (times measured by chip_smoke.py and
// kernels/qgram/timing.py on an NVIDIA H100 80GB HBM3 at 700 W are in
// PERF.md):
// - The GP fit's calls (39 machines x 25 rows x 25 columns, d = 21) and
//   the wire's (39 x 32 x 25): tens of KB in and out, ~1 MFLOP.  Launch
//   latency and the chain of dependent global round trips inside a block
//   bound them.  The earlier design (a 32 x 128 tile, strided decode and
//   staging loops, the meta read before the words) issued about twenty
//   dependent round trips per block.
// - Wide outputs (40 x 1000 x 4449 and broadcast's 40 x 25 x 1000, d = 21,
//   per-machine y): the output write (712 MB: 0.21 ms at 3.35 TB/s).  The
//   earlier design re-decoded a block's rows and restaged y for every
//   32 x 128 tile (44,800 blocks), and lost to the plain version.
// - Long d (the kernels bench shape, 1024 x 128 x 1024, 4 bits a dimension,
//   C = 256): the 2 n p d fp32 operations (268 MFLOP: 4 us at 67 TFLOP/s).
// Where the time still goes (copies of this source with one stage removed,
// timed on the card; PERF.md): at 40 x 1000 x 4449 the multiply and the
// register pressure of the 8 x 4 tile at two blocks an SM, not the decode
// or the copies; at the bench shape the multiply at one block an SM (128
// blocks), with ~8 us of copies, decode and barriers around it.
//
// Design.  Four tile configurations (256 threads each), chosen per shape
// by qgram.ops.plan():
// - "small" 32 x 32 (2 x 2 outputs a thread) for outputs of at most four
//   such tiles an SM, so a fit call spreads over as many SMs as it has
//   tiles;
// - "flat" 32 x 64 (2 x 4) for the rest of at most 32 rows a machine
//   (broadcast's fit call: 0.0089 ms against the small tile's 0.0104);
// - "wide" 64 x 128 (8 x 4, two blocks an SM, streaming stores) for wide
//   outputs;
// - "long" 64 x 128 (8 x 4, one block an SM) for d past one chunk with a
//   table small enough to stage: each chunk's rows of the centroid table
//   are copied to shared memory beside the y slab, a step ahead, and x̂ is
//   gathered from there (a 128 x 128 tile would give the 1024 x 1024 bench
//   output 64 blocks for 132 SMs).
// A block owns a row tile of one machine and walks `walk` consecutive
// column tiles (the plan cuts the columns into groups for a set number of
// blocks an SM).  d is taken in chunks of DK = 32:
// - Where d <= 32 (every GP shape) the block decodes its x̂ rows ONCE into
//   shared memory and keeps them there while it walks its column tiles, so
//   the unpack and the centroid gathers are paid once per row tile, not
//   once per output tile.
// - Where d > 32 each step (column tile, chunk) decodes the next chunk
//   while the current one is multiplied: the next chunk's codes are loaded
//   one step ahead and its centroids gathered before the multiply, stored
//   to the other x̂ buffer after it ("long": gathered from the staged table
//   at the step's start).
// Every independent load goes out before the first use: the packed words
// and the mask of the block's rows are copied to shared memory with
// cp.async in one group, the first y slab in a second, while warp 0 builds
// the meta rows from the machine's rates; then every centroid gather of
// the block's decode is issued at once (the unpack reads shared memory),
// so a fit-shape block waits about two round trips.  y slabs (BC columns
// x 32 of d) are double-buffered with 4-byte cp.async (d = 21 rows are
// not 16-byte aligned), consecutive lanes on consecutive floats of a row.  Shared rows have a pitch of 36 floats
// (16-byte aligned, 4 mod 32 banks), so a quarter-warp's float4 reads of 8
// columns' y are free of bank conflicts and a warp's x̂ read is one
// broadcast; each thread reads 4 k at once for its rows and columns
// (TM + TN float4 loads per 4 TM TN FMA).  Columns of a thread are TX
// apart, so a warp stores 32 (wide) or 16 (small) consecutive floats of a
// row: coalesced at any p, odd p included.  Except on "long", the
// centroids are gathered from L2, not staged: one machine's (d, C) table
// is 344 KB at d = 21 and C = 4096, more than a block's 227 KB; the TPU
// kernels' one-hot
// contraction over C suits its matrix unit, not this card.  Neither the
// codes nor x̂ reach device memory.  fp32 FMA in d order, no tensor cores,
// no TF32, no atomics: two launches give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace qgram {
namespace {  // internal linkage: each kernel library keeps its own instances and launch state

constexpr int DK = 32;          // d-chunk
constexpr int DP = DK + 4;      // shared row pitch in floats: 16-byte rows, 4 mod 32 banks
constexpr int SMEM_MAX = 232448;  // shared memory a block may use on Hopper

struct Args {
  int n, p, d, C, W, walk, tiles_c;
  const float* cents;     // (B, d, C)
  const float* y;         // (B, p, d) or (p, d)
  int64_t y_bs;           // batch stride of y (0: shared)
  float* out;             // (B, n, p)
  const uint32_t* words;  // packed: (B, n, W)
  const int32_t* rates;   // packed: (B, d) code widths
  const float* mask;      // packed: (B, n), or null: every row kept
  const int32_t* codes;   // unpacked: (B, n, d)
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, zero-filled when !ok (the source is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16 bytes, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// int32 codes read straight from device memory; -1 (and any code outside
// the table) fails the gather's bound and decodes to 0.
struct CodeRows {
  const int32_t* codes;  // row 0 of the block's tile
  int d;

  static size_t stage_bytes(const Args&, int) { return 0; }

  __device__ void init(const Args& a, int b, int row0, void*, int, int, int) {
    codes = a.codes + ((int64_t)b * a.n + row0) * a.d;
    d = a.d;
  }
  __device__ void prepare(const Args&, int, int) {}
  __device__ uint32_t code(int r, int gj) const {
    return static_cast<uint32_t>(__ldg(codes + (int64_t)r * d + gj));
  }
  __device__ float scale(int) const { return 1.f; }
};

// Codes unpacked from the block's rows of packed words, staged in shared
// memory with the rows' mask and the machine's meta rows [word, bit,
// width] (built here from the rates: an exclusive prefix sum of the
// widths, word = offset >> 5, bit = offset & 31 — pack_meta of ops.py
// without its six small launches).  The guards of the reference: width 0
// gives code 0, no shift by 32, width >= 32 takes the full mask, the high
// part of a straddling code comes from word + 1, a word past the row's end
// reads as 0.
struct PackedRows {
  const float* mask;     // shared: BR
  int32_t* meta;         // shared: 3 x d, built by prepare()
  const uint32_t* ws;    // shared: BR x W
  int W, d;

  static size_t stage_bytes(const Args& a, int br) {
    return 4 * ((size_t)br + 3 * (size_t)a.d + (size_t)br * a.W);
  }

  __device__ void init(const Args& a, int b, int row0, void* stage, int br, int tid, int nt) {
    W = a.W;
    d = a.d;
    float* ms = static_cast<float*>(stage);
    int32_t* mt = reinterpret_cast<int32_t*>(ms + br);
    uint32_t* wd = reinterpret_cast<uint32_t*>(mt + 3 * d);
    for (int e = tid; e < br; e += nt) {
      const bool ok = row0 + e < a.n;
      if (a.mask == nullptr)
        ms[e] = ok ? 1.f : 0.f;
      else
        cp_async4(ms + e, ok ? a.mask + (int64_t)b * a.n + row0 + e : a.mask, ok);
    }
    const uint32_t* words_b = a.words + ((int64_t)b * a.n + row0) * W;
    const int64_t live = (int64_t)(a.n - row0) * W;
    for (int e = tid; e < br * W; e += nt) {
      const bool ok = e < live;
      cp_async4(wd + e, ok ? words_b + e : a.words, ok);
    }
    mask = ms;
    meta = mt;
    ws = wd;
  }
  // warp 0 scans machine b's rates into the meta rows (after the block's
  // copies are issued, so the rates' round trip overlaps them)
  __device__ void prepare(const Args& a, int b, int tid) {
    if (tid >= 32) return;
    int32_t* mt = meta;
    const int32_t* rates_b = a.rates + (int64_t)b * d;
    uint32_t carry = 0u;
    for (int j0 = 0; j0 < d; j0 += 32) {
      const int j = j0 + tid;
      const uint32_t w = j < d ? static_cast<uint32_t>(__ldg(rates_b + j)) : 0u;
      uint32_t incl = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (tid >= o) incl += t;
      }
      const int32_t offs = static_cast<int32_t>(carry + incl - w);
      if (j < d) {
        mt[j] = offs >> 5;
        mt[d + j] = offs & 31;
        mt[2 * d + j] = static_cast<int32_t>(w);
      }
      carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
    }
  }
  __device__ uint32_t code(int r, int gj) const {
    const uint32_t width = static_cast<uint32_t>(meta[2 * d + gj]);
    if (width == 0u) return 0u;
    const int wi = meta[gj];
    const uint32_t bit = static_cast<uint32_t>(meta[d + gj]);
    const uint32_t* row = ws + r * W;
    const uint32_t lo = (wi >= 0 && wi < W) ? (row[wi] >> bit) : 0u;
    const uint32_t hi = (bit > 0u && wi >= -1 && wi + 1 < W) ? (row[wi + 1] << (32u - bit)) : 0u;
    const uint32_t wmask = width >= 32u ? 0xFFFFFFFFu : ((1u << width) - 1u);
    return (lo | hi) & wmask;
  }
  __device__ float scale(int r) const { return mask[r]; }
};

template <int BR, int BC>
constexpr size_t tile_bytes() {
  return 4 * (size_t)(2 * BR * DP + 2 * BC * DP);  // two x̂ buffers, two y slabs
}

inline size_t table_bytes(int C) { return 4 * (size_t)2 * DK * C; }  // two chunks of centroids

// One block: row tile blockIdx.y of machine blockIdx.z, column tiles
// [blockIdx.x walk, + walk) in order, d in chunks of DK.  Thread (ty, tx)
// owns rows ty + TY i (i < TM) and columns tx + TX j (j < TN); a warp
// covers WY consecutive ty and 32 / WY consecutive tx.
template <class Rows, int BR, int BC, int TM, int TN, int WY, int MINB, bool TAB, bool CS>
__global__ void __launch_bounds__((BR / TM) * (BC / TN), MINB)
qgram_kernel(Args a) {
  constexpr int TX = BC / TN, TY = BR / TM, NT = TX * TY, WX = 32 / WY;
  constexpr int EX = BR * DK / NT, EY = BC * DK / NT;  // decode / copy elements a thread
  static_assert(NT % DK == 0 && (BR * DK) % NT == 0 && (BC * DK) % NT == 0, "");
  static_assert(TX % WX == 0 && TY % WY == 0, "");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [2][BR][DP]
  float* ys = smem + 2 * BR * DP;    // [2][BC][DP]
  float* tab = ys + 2 * BC * DP;     // TAB: [2][DK][C] centroids of a chunk
  void* stage = tab + (TAB ? 2 * DK * a.C : 0);  // the loader's staged rows

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % (TX / WX)) * WX + lane % WX;
  const int ty = (warp / (TX / WX)) * WY + lane / WX;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BR;
  const int ct0 = blockIdx.x * a.walk;
  const int nct = min(a.walk, a.tiles_c - ct0);
  const int nk = a.d > DK ? (a.d + DK - 1) / DK : 1;
  const bool resident = nk == 1;  // x̂ decoded once, kept for every column tile
  const int steps = nct * nk;
  const float* cents_b = a.cents + (int64_t)b * a.d * a.C;
  const float* y_b = a.y + (int64_t)b * a.y_bs;

  Rows rows;
  rows.init(a, b, row0, stage, BR, tid, NT);
  cp_async_commit();

  // TAB: chunk kc's rows of the machine's table into tab[buf] (16-byte
  // copies where the table allows them)
  const bool tab16 = a.C % 4 == 0 && reinterpret_cast<uintptr_t>(cents_b) % 16 == 0;
  auto issue_tab = [&](int kc, int buf) {
    const int live = min(DK, a.d - kc * DK) * a.C;
    const float* src = cents_b + (int64_t)kc * DK * a.C;
    float* dst = tab + buf * DK * a.C;
    if (tab16) {
      for (int e = 4 * tid; e < DK * a.C; e += 4 * NT)
        cp_async16(dst + e, e < live ? src + e : cents_b, e < live);
    } else {
      for (int e = tid; e < DK * a.C; e += NT) cp_async4(dst + e, e < live ? src + e : cents_b, e < live);
    }
  };
  // the y slab of step s (column tile ct0 + s / nk, chunk s % nk) into ys[buf]
  auto issue_y = [&](int s, int buf) {
    const int c0 = (ct0 + s / nk) * BC, k0 = (s % nk) * DK;
    float* dst = ys + buf * BC * DP;
#pragma unroll
    for (int i = 0; i < EY; ++i) {
      const int e = tid + NT * i;
      const int c = e / DK, k = e % DK;
      const int gc = c0 + c, gk = k0 + k;
      const bool ok = gc < a.p && gk < a.d;
      cp_async4(dst + c * DP + k, ok ? y_b + (int64_t)gc * a.d + gk : y_b, ok);
    }
    if constexpr (TAB) issue_tab(s % nk, buf);
    cp_async_commit();
  };

  uint32_t code[EX];
  float val[EX];
  // the codes of chunk kc of the block's rows (all loads issued, none used)
  auto fetch = [&](int kc) {
#pragma unroll
    for (int i = 0; i < EX; ++i) {
      const int e = tid + NT * i;
      const int r = e / DK, gj = kc * DK + e % DK;
      code[i] = (row0 + r < a.n && gj < a.d) ? rows.code(r, gj) : 0xFFFFFFFFu;
    }
  };
  // their centroids (every gather issued before any is used)
  auto gather = [&](int kc) {
#pragma unroll
    for (int i = 0; i < EX; ++i) {
      const int e = tid + NT * i;
      const int gj = kc * DK + e % DK;
      val[i] = code[i] < static_cast<uint32_t>(a.C)
                   ? __ldg(cents_b + (int64_t)gj * a.C + code[i]) * rows.scale(e / DK)
                   : 0.f;
    }
  };
  // TAB: their centroids from the staged chunk tab[buf]
  auto gather_tab = [&](int buf) {
    const float* t = tab + buf * DK * a.C;
#pragma unroll
    for (int i = 0; i < EX; ++i) {
      const int e = tid + NT * i;
      val[i] = code[i] < static_cast<uint32_t>(a.C)
                   ? t[(e % DK) * a.C + code[i]] * rows.scale(e / DK)
                   : 0.f;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < EX; ++i) {
      const int e = tid + NT * i;
      xs[buf * BR * DP + (e / DK) * DP + e % DK] = val[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // four k from k: TN columns of y, then row by row x̂, as float4 reads
  auto mac4 = [&](const float* xb, const float* yb, int k) {
    float4 bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(yb + (tx + TX * j) * DP + k);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(xb + (ty + TY * i) * DP + k);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float s = acc[i][j];
        s = fmaf(av.x, bv[j].x, s);
        s = fmaf(av.y, bv[j].y, s);
        s = fmaf(av.z, bv[j].z, s);
        s = fmaf(av.w, bv[j].w, s);
        acc[i][j] = s;
      }
    }
  };

  // one k: the ragged end of d
  auto mac1 = [&](const float* xb, const float* yb, int k) {
    float bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = yb[(tx + TX * j) * DP + k];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float av = xb[(ty + TY * i) * DP + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
    }
  };

  auto store = [&](int ct) {
    const int c0 = ct * BC;
    float* ob = a.out + ((int64_t)b * a.n + row0) * a.p + c0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + TX * j;
        if (row0 + r < a.n && c0 + c < a.p) {
          if constexpr (CS)
            __stcs(ob + (int64_t)r * a.p + c, acc[i][j]);
          else
            ob[(int64_t)r * a.p + c] = acc[i][j];
        }
        acc[i][j] = 0.f;
      }
    }
  };

  auto mac = [&](const float* xb, const float* yb, int kc) {
    const int kmax = min(DK, a.d - kc * DK);
    if (kmax == DK) {
#pragma unroll
      for (int k = 0; k < DK; k += 4) mac4(xb, yb, k);
    } else {
      const int k4 = kmax & ~3;
      for (int k = 0; k < k4; k += 4) mac4(xb, yb, k);
      for (int k = k4; k < kmax; ++k) mac1(xb, yb, k);
    }
  };

  issue_y(0, 0);
  rows.prepare(a, b, tid);
  cp_async_wait<1>();  // the loader's staged rows have landed
  __syncthreads();
  if constexpr (TAB) {
    // Each step stages its chunk's table with its y slab, one step ahead;
    // x̂ of the chunk is gathered from shared memory at the step's start.
    fetch(0);
    for (int s = 0; s < steps; ++s) {
      const int cur = s & 1, kc = s % nk;
      if (s + 1 < steps) {
        issue_y(s + 1, cur ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this step's y slab and table have landed
      gather_tab(cur);
      put(0);
      if (s + 1 < steps) fetch((s + 1) % nk);  // in flight during the multiply
      __syncthreads();
      mac(xs, ys + cur * BC * DP, kc);
      if (kc == nk - 1) store(ct0 + s / nk);
      __syncthreads();  // before the next step's copies and decode overwrite what this one read
    }
    return;
  }
  // x̂ decoded once (d <= DK), or by chunk: the next chunk's centroids are
  // gathered, and the codes of the one after loaded, while this step
  // multiplies; the gathered values reach the other x̂ buffer after it.
  fetch(0);
  gather(0);
  put(0);
  if (!resident) fetch(1 % nk);
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1, kc = s % nk;
    if (s + 1 < steps) {  // the next y slab loads while this step runs
      issue_y(s + 1, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool next_x = !resident && s + 1 < steps;
    if (next_x) {
      gather((s + 1) % nk);
      if (s + 2 < steps) fetch((s + 2) % nk);
    }
    mac(xs + (resident ? 0 : cur) * BR * DP, ys + cur * BC * DP, kc);
    if (next_x) put(cur ^ 1);
    if (kc == nk - 1) store(ct0 + s / nk);
    __syncthreads();  // before the next step's copies overwrite what this one read
  }
}

template <class Rows, int BR, int BC, int TM, int TN, int WY, int MINB, bool TAB = false,
          bool CS = false>
int launch(Args a, int batch, cudaStream_t st) {
  const int tiles_r = (a.n + BR - 1) / BR;
  a.tiles_c = (a.p + BC - 1) / BC;
  if (a.walk < 1 || a.d < 0 || a.W < 0 || tiles_r > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (a.tiles_c + a.walk - 1) / a.walk;
  const size_t smem =
      tile_bytes<BR, BC>() + (TAB ? table_bytes(a.C) : 0) + Rows::stage_bytes(a, BR);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qgram_kernel<Rows, BR, BC, TM, TN, WY, MINB, TAB, CS>;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  kernel<<<dim3(groups, tiles_r, batch), (BR / TM) * (BC / TN), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// variant: 0 small, 1 flat, 2 wide, 3 long — the names and shapes of
// qgram.ops.TILES (rows, columns, outputs a thread, warp layout, blocks an
// SM at least, staged table, streaming stores)
template <class Rows>
int launch_variant(int variant, const Args& a, int batch, cudaStream_t st) {
  switch (variant) {
    case 0: return launch<Rows, 32, 32, 2, 2, 2, 4>(a, batch, st);
    case 1: return launch<Rows, 32, 64, 2, 4, 2, 4>(a, batch, st);
    case 2: return launch<Rows, 64, 128, 8, 4, 1, 2, false, true>(a, batch, st);
    case 3: return launch<Rows, 64, 128, 8, 4, 1, 1, true>(a, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace qgram
