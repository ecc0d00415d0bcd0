// Per-symbol decode for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/quant/quant.py::decode_pallas
// (_decode_kernel): x̂[i, j] = cents[j, code[i, j]].  The TPU kernel
// expresses the lookup as a one-hot contraction over the table, so a code
// outside [0, C) — the -1 pad sentinel among them — matches no column and
// decodes to 0; this kernel keeps that: it reads the table only for a code
// in range and writes 0 otherwise.  The output is a copy of table entries,
// so it equals the plain version bit for bit (NaN payloads, -0.0 and +-inf
// included).
//
// What bounds it on the H100: bytes — the codes read and the values
// written (4 bytes each a symbol) and the looked-up table entries; no
// arithmetic.  At the paths' shapes (25 x 21 on the wire, 1024 x 128 at
// the kernels bench) the call is bound by launch latency and by its one
// dependent chain: load a code, then the entry it names, then store.
//
// Design (ops.py decode_plan picks the variant and the rows of a tile):
// - "tile": a 256-thread block owns BN rows x BD = 32 dimensions.  It
//   loads the tile's codes coalesced (16-byte vectors when d % 4 == 0 and
//   both pointers are 16-byte aligned; 4-byte loads otherwise, so a view
//   with a storage offset takes this path) into a shared tile of pitch
//   BD + 1 words (conflict-free by row and by column).  Warp w then looks
//   up columns w, w + 8, w + 16, w + 24 with its lanes walking the rows, so
//   a warp's 32 lookups fall in one dimension's row of the table — a few
//   sectors, not 32 — with BN / 8 of them in flight a thread.  Each value
//   replaces its code in the shared tile, which is stored coalesced as it
//   was loaded.  Index arithmetic is 32-bit inside the tile, with one
//   64-bit base offset a block.
// - "flat": one thread a symbol in row-major order, 32-bit indices, for a
//   call of at most 8192 symbols, or d < BD where the tile would take its
//   4-byte path or idle over half its columns: there the tile's barriers
//   and idle lanes cost more than the sectors it saves.
//
// What the stage copies found (copies with one stage removed, timed in
// one call; PERF.md section 6): in the one-thread-a-symbol gather this
// replaces, the code load and the lookup each held about half of the time
// above the launch floor (32 lanes looked up 32 dimensions' rows, a
// sector each), the 64-bit division a twelfth, the store nothing.  In the
// tile no stage holds more than a quarter of it; the rest is the blocks'
// fixed cost.  Staging the block's table rows in shared memory (cp.async,
// issued before the code loads) measured slower than the tile at every
// shape but one: its BD x C x 4 bytes a block cost more than the one L2
// round trip it saves, and at C = 1024 it leaves one block an SM.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;           // threads a block
constexpr int NW = NT / 32;       // warps a block
constexpr int BD = 32;            // dimensions a tile
constexpr int PITCH = BD + 1;     // words a shared tile row: conflict-free by row and by column
constexpr int QUADS = BD / 4;     // 16-byte vectors a tile row

enum Variant { FLAT = 0, TILE = 1 };

__global__ void __launch_bounds__(NT)
decode_flat(int total, int d, int C, const int32_t* __restrict__ codes,
            const float* __restrict__ cents, float* __restrict__ out) {
  const int k = blockIdx.x * NT + threadIdx.x;
  if (k >= total) return;
  const int32_t code = __ldg(codes + k);
  const int j = k % d;
  out[k] = static_cast<unsigned>(code) < static_cast<unsigned>(C)
               ? __ldg(cents + static_cast<size_t>(j) * C + code)
               : 0.f;
}

template <int BN>
__global__ void __launch_bounds__(NT)
decode_tile(int n, int d, int C, int vec, const int32_t* __restrict__ codes,
            const float* __restrict__ cents, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem4);  // BN x PITCH words
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * BN, j0 = blockIdx.y * BD;
  const int rows = min(BN, n - r0), dims = min(BD, d - j0);

  // 1. the codes: -1 past the tile's edge
  const size_t base = static_cast<size_t>(r0) * d + j0;
  const int32_t* cb = codes + base;
  if (vec) {
#pragma unroll
    for (int it = 0; it < BN * QUADS / NT; ++it) {
      const int i = t + it * NT, r = i / QUADS, q = i % QUADS;
      int4 c = make_int4(-1, -1, -1, -1);
      if (r < rows && 4 * q < dims) c = __ldg(reinterpret_cast<const int4*>(cb + r * d + 4 * q));
      uint32_t* s = tile + r * PITCH + 4 * q;
      s[0] = c.x;
      s[1] = c.y;
      s[2] = c.z;
      s[3] = c.w;
    }
  } else {
#pragma unroll
    for (int it = 0; it < BN * BD / NT; ++it) {
      const int i = t + it * NT, r = i / BD, c = i % BD;
      tile[r * PITCH + c] = (r < rows && c < dims) ? __ldg(cb + r * d + c) : -1;
    }
  }
  __syncthreads();

  // 2. warp w looks up columns w, w + NW, ...; its lanes walk the rows
  constexpr int CPW = BD / NW, RPL = BN / 32;
  const int lane = t & 31, w = t >> 5;
  int32_t code[CPW][RPL];
#pragma unroll
  for (int ci = 0; ci < CPW; ++ci)
#pragma unroll
    for (int k = 0; k < RPL; ++k) code[ci][k] = tile[(lane + 32 * k) * PITCH + w + NW * ci];
  float v[CPW][RPL];
#pragma unroll
  for (int ci = 0; ci < CPW; ++ci) {
    const int c = w + NW * ci;  // a column past d holds only -1 codes: its row is never read
    const float* row = cents + static_cast<size_t>(j0 + c) * C;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int32_t cd = code[ci][k];
      v[ci][k] = 0.f;
      if (static_cast<unsigned>(cd) < static_cast<unsigned>(C))
        v[ci][k] = __ldg(row + cd);
    }
  }
#pragma unroll
  for (int ci = 0; ci < CPW; ++ci)
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      tile[(lane + 32 * k) * PITCH + w + NW * ci] = __float_as_uint(v[ci][k]);
  __syncthreads();

  // 3. the values out, as the codes came in
  float* ob = out + base;
  if (vec) {
#pragma unroll
    for (int it = 0; it < BN * QUADS / NT; ++it) {
      const int i = t + it * NT, r = i / QUADS, q = i % QUADS;
      if (r < rows && 4 * q < dims) {
        const uint32_t* s = tile + r * PITCH + 4 * q;
        *reinterpret_cast<float4*>(ob + r * d + 4 * q) =
            make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]),
                        __uint_as_float(s[3]));
      }
    }
  } else {
#pragma unroll
    for (int it = 0; it < BN * BD / NT; ++it) {
      const int i = t + it * NT, r = i / BD, c = i % BD;
      if (r < rows && c < dims) ob[r * d + c] = __uint_as_float(tile[r * PITCH + c]);
    }
  }
}

template <int BN>
cudaError_t launch_tile(int n, int d, int C, size_t smem, cudaStream_t st,
                        const int32_t* codes, const float* cents, float* out) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = d % 4 == 0 && aligned(codes) && aligned(out);
  const dim3 grid((n + BN - 1) / BN, (d + BD - 1) / BD);
  decode_tile<BN><<<grid, NT, smem, st>>>(n, d, C, vec, codes, cents, out);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 flat, 1 tile (ops.py _DECODE_VARIANT_ID); bn: rows a tile (32
// or 64); smem: the block's dynamic shared memory in bytes (ops.py
// decode_smem_bytes, under the default 48 KB).  Returns the CUDA error of
// the launch.
extern "C" int repro_quant_decode_f32(int variant, int bn, int smem, int n, int d, int C,
                                      const int32_t* codes, const float* cents, float* out,
                                      void* stream) {
  if (n <= 0 || d <= 0) return 0;  // an empty output: nothing to launch
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (variant == FLAT) {
    const int total = n * d;
    decode_flat<<<(total + NT - 1) / NT, NT, 0, st>>>(total, d, C, codes, cents, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != TILE) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (bn == 32) err = launch_tile<32>(n, d, C, sm, st, codes, cents, out);
  if (bn == 64) err = launch_tile<64>(n, d, C, sm, st, codes, cents, out);
  return static_cast<int>(err);
}
