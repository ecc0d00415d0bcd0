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
// bytes; the time is set by launch latency and by the dependent steps of
// a block, as for the single-tenant kernel.
//
// Design: the tenant is the grid's z axis (blockIdx.z); each tenant's
// operands are addressed from their own base pointers, and a block reads
// and writes only its tenant's slices and its tenant's tile counters, so
// tenants never share an accumulator and one tenant's operands (a NaN, a
// weight of 0) cannot reach another's rows.  Within a tenant, the single-
// tenant kernels of epilogue_body.cuh unchanged (the single-tenant entry
// is this launch at T = 1): a block owns a tile of test points and one
// group of consecutive experts, and when the T * ceil(t / tt) tiles cannot
// fill the card the experts are split into groups whose partials, laid out
// (groups, T, 3, t), the last block of each tile sums in group order.

#include "epilogue_body.cuh"

// fuse: 0 none, 1 kl, 2 poe, 3 gpoe, 4 bcm, 5 rbcm.  T: tenants (at most
// 65535, the grid's z limit).  variant, tt, groups: as repro_epilogue_f32;
// when groups > 1, scratch holds groups x T x 3 x t floats and counters
// T x ceil(t / tt) ints, zero on entry and left zero on exit.
extern "C" int repro_epilogue_fleet_f32(int fuse, int T, int m, int t, int K, int variant,
                                        int tt, int groups, const float* G,
                                        const float* Ainv, const float* P,
                                        const float* walpha, const float* gss,
                                        const float* prior, const float* w, float* out,
                                        float* scratch, int* counters, void* stream) {
  const Args a{fuse, T, m, t, K, tt, 0, groups, 0, G, Ainv, P, walpha, gss, prior, w,
               out, scratch, counters};
  return launch_epilogue(a, variant, static_cast<cudaStream_t>(stream));
}
