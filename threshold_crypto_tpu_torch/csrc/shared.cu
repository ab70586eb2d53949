// Kernels B16, selmadd and dblw, for sm_90a, in G1 (Fq) and G2 (Fq2) forms,
// one thread per accumulator lane: the two halves of the shared-window
// Horner step as separate launches.
//
// B16 `selmadd_kernel` replaces threshold_crypto_tpu/device/pallas_curve.py
// `_mk_selmadd_kernel` (:410, through `_selmadd_impl` :490): per
// accumulator lane, acc + table[d − 1] with the complete Jacobian add where
// the lane's digit d is not 0. `dblw_kernel` replaces `_mk_dblw_kernel`
// (:433, through `_dblw_impl` :505): acc <- 2^w·acc, w doublings. The JAX
// package runs them only in its DIRECT branch of `msm_pallas_shared`
// (:970-983): one block of accumulators, per window one dblw, then one
// selmadd per block of lanes of the table and digits. Here that is
// `msm_pallas_shared(..., fused=False)` in device/cuda_curve.py, which the
// threshold combine's "bitscan" path runs at window 1 (255 windows).
//
// The TPU kernels took the block of table and digits that their BlockSpec
// cut out. Here selmadd takes the whole table and one window's digits with
// the block's first lane `start`, and masks the ragged edge itself: an
// accumulator lane past the last lane has digit 0.
//
// Layout. Packed limb-major int32[k·24, n] (device/packed.py): acc and out
// [3k·24, accs] Jacobian; the table its entries 1P..(nent)P one after the
// other, [nent·3k·24, n]; the digits int32[n]. Neighbouring threads own
// neighbouring lanes, so row loads are coalesced.
//
// What bounds it. selmadd needs the general path of one complete add per
// lane with a nonzero digit (16 / 44 Fq products, G1 / G2) against the
// accumulator in and out and the one table entry read; dblw needs w
// doublings (7 / 16 products each) per lane against the accumulator in and
// out: the multiply issue rate bounds both. At the combine's 1024
// accumulators each launch runs 8 blocks of 128 threads on 132 SMs, so both
// are latency-bound; a launch is one point operation per lane.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

using tc::kThreads;

template <class F>
__global__ void __launch_bounds__(kThreads)
selmadd_kernel(const int32_t* __restrict__ acc,
               const int32_t* __restrict__ table,
               const int32_t* __restrict__ digits, int32_t* __restrict__ out,
               int accs, int n, int nent, int start) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= accs) return;
  tc::selmadd_lane<F>(acc, table, digits, out, accs, n, nent, start, j);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
dblw_kernel(const int32_t* __restrict__ acc, int32_t* __restrict__ out,
            int accs, int window) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= accs) return;
  tc::dblw_lane<F>(acc, out, accs, window, j);
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

template <class F>
int launch_selmadd(const void* acc, const void* table, const void* digits,
                   void* out, int accs, int n, int nent, int start,
                   void* stream) {
  if (accs <= 0) return 0;
  selmadd_kernel<F><<<grid_for(accs), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(digits), static_cast<int32_t*>(out), accs,
      n, nent, start);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_dblw(const void* acc, void* out, int accs, int window,
                void* stream) {
  if (accs <= 0) return 0;
  dblw_kernel<F><<<grid_for(accs), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<int32_t*>(out), accs,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tc_g1_selmadd(const void* acc, const void* table,
                             const void* digits, void* out, int accs, int n,
                             int nent, int start, void* stream) {
  return launch_selmadd<tc::Fq>(acc, table, digits, out, accs, n, nent,
                                start, stream);
}

extern "C" int tc_g2_selmadd(const void* acc, const void* table,
                             const void* digits, void* out, int accs, int n,
                             int nent, int start, void* stream) {
  return launch_selmadd<tc::Fq2>(acc, table, digits, out, accs, n, nent,
                                 start, stream);
}

extern "C" int tc_g1_dblw(const void* acc, void* out, int accs, int window,
                          void* stream) {
  return launch_dblw<tc::Fq>(acc, out, accs, window, stream);
}

extern "C" int tc_g2_dblw(const void* acc, void* out, int accs, int window,
                          void* stream) {
  return launch_dblw<tc::Fq2>(acc, out, accs, window, stream);
}
