// Per-symbol encode for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/quant/quant.py::encode_pallas
// (_encode_kernel): code[i, j] = #{e in edges[j, :] : e < x[i, j]}, the
// number of dimension j's scaled bin edges strictly below the symbol.  The
// +inf pads of a row never count, a NaN symbol counts nothing (every
// comparison is false), +inf counts every finite edge, a rate-0 dimension
// (a row of +inf) encodes to 0.
//
// What bounds it on the H100: the bytes are x, the codes and the live
// part of the table — on the wire path (25 rows x 21 dims against a table
// of E = 128 to 4096 edges a row; 344 KB at 4096) a few KB to a few
// hundred, at the kernels bench shape (1024 x 128 symbols, 256 edges a
// row) 1.2 MB — and the operations a binary search's ceil(log2(E + 1))
// comparisons a symbol, so a call is bound by launch latency and by the
// latency of its dependent steps: stage the rows, then one shared-memory
// load per search step.
//
// Design: a 256-thread block owns one dimension j and 256 of its symbols,
// one a thread.  It stages row j of the table into shared memory, up to
// CHUNK edges at a time (the whole row up to 8192 edges, 32 KB), with
// 16-byte cp.async copies (4-byte loads when the row is not 16-byte
// aligned).  While staging, each thread checks that its edges do not
// decrease (a <= b for each adjacent pair, the pair across into the next
// thread's copy included, so a NaN edge fails); __syncthreads_and both
// publishes the chunk and combines the check, one barrier.  The count over
// a chunk whose edges do not decrease is a branchless lower-bound binary
// search on the plain version's own predicate edge < x (the predicate is
// then true on a prefix of the chunk, for every x: NaN, +-inf, +-0.0 and
// duplicate edges included); over any other chunk, a full count from
// shared memory.  Both are exact integer counts of the same set, so the
// kernel equals the plain version bit for bit on every table, sorted or
// not; the chunks' counts are summed.  Every table build_scaled_tables
// makes ascends (its +inf pads last), so the paths take the search.
// A warp's symbols of one dimension lie d words apart in x and in the
// codes, so each load and store of x and the codes touches a sector a
// symbol; a block owning several dimensions reads them in runs, but its
// wider staging and bookkeeping measured slower at every shape the paths
// use (PERF.md section 6).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;                // threads (symbols) of a block
constexpr int CHUNK = 8192;            // edges staged at a time (ops.py ENCODE_CHUNK)
constexpr int PER = CHUNK / (4 * NT);  // 16-byte copies a thread, at most

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__global__ void __launch_bounds__(NT)
quant_encode_kernel(int n, int d, int E, const float* __restrict__ x,
                    const float* __restrict__ edges, int32_t* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int j = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * NT + tid;
  const bool live = i < n;
  const float xv = live ? x[i * d + j] : 0.f;
  const float* row = edges + (int64_t)j * E;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;  // uniform

  int code = 0;
  for (int c0 = 0; c0 < E; c0 += CHUNK) {
    const int L = min(CHUNK, E - c0);
    const float* src = row + c0;
    if (c0 > 0) __syncthreads();  // the last chunk's searches are done
    bool ok = true;
    if (vec) {
      const int L4 = L & ~3;
      float next[PER];  // the edge after each copy: the neighbour's first
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = 4 * (tid + k * NT);
        if (e < L4) {
          cp_async16(s + e, src + e);
          next[k] = e + 4 < L ? __ldg(src + e + 4) : 0.f;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = 4 * (tid + k * NT);
        if (e < L4) {  // this thread's own copy: visible to it after the wait
          const float4 v = *reinterpret_cast<const float4*>(s + e);
          ok = ok && v.x <= v.y && v.y <= v.z && v.z <= v.w &&
               (e + 4 >= L || v.w <= next[k]);
        }
      }
      for (int e = L4 + tid; e < L; e += NT) {  // the tail of a row of E % 4 != 0
        const float v = __ldg(src + e);
        s[e] = v;
        ok = ok && (e + 1 >= L || v <= __ldg(src + e + 1));
      }
    } else {
      for (int e = tid; e < L; e += NT) {
        const float v = __ldg(src + e);
        s[e] = v;
        ok = ok && (e + 1 >= L || v <= __ldg(src + e + 1));
      }
    }
    const bool ascends = __syncthreads_and(ok);  // the chunk staged and checked
    if (live) {
      if (ascends) {  // lower bound: #(edges < x) over a non-decreasing chunk
        int base = 0;
        for (int len = L; len > 1;) {
          const int half = len >> 1;
          base = s[base + half] < xv ? base + half : base;
          len -= half;
        }
        code += base + (s[base] < xv);
      } else {
        int c = 0;
        for (int e = 0; e < L; ++e) c += s[e] < xv;
        code += c;
      }
    }
  }
  if (live) out[i * d + j] = code;
}

}  // namespace

extern "C" int repro_quant_encode_f32(int n, int d, int E, const float* x,
                                      const float* edges, int32_t* out,
                                      void* stream) {
  if (n <= 0 || d <= 0) return 0;  // an empty output: nothing to launch
  if (E < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + NT - 1) / NT, d);
  const size_t smem = sizeof(float) * (size_t)(E < CHUNK ? E : CHUNK);
  quant_encode_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      n, d, E, x, edges, out);
  return static_cast<int>(cudaGetLastError());
}
