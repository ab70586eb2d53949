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
// accumulators a launch is one point operation per lane on a few SMs, so
// the chain of one lane's products sets its time: the latency of 16 / 44
// (selmadd) or 7w / 16w (dblw) products in series, one after another.
//
// The lane bodies run on B13's register engine (ladder_engine.cuh
// `selmadd_lane_r`, `dblw_lane_r`): field values in registers, one
// out-of-line carry-save Montgomery product, the add's T == Q case a
// branch into the doubling. curve.cuh's formulas, which B16 ran before,
// passed every operand through a per-thread local-memory frame and
// computed the doubling branch of every complete add on every lane (23 Fq
// products where the general path needs 16). Occupancy does not matter at
// this width, so both kernels take the 255-register cap, where the fewest
// values spill (G2 selmadd still does: its add holds T and nine Fq2
// temporaries).
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "ladder_engine.cuh"

namespace {

// Threads a block, and the blocks of them __launch_bounds__ asks to fit on
// an SM: 65,536 / 256 registers a thread, so ptxas's cap is 255 whatever
// the block. At the combine's 1,024 accumulators, blocks of 128 threads (8
// blocks: a warp on each sub-partition of 8 SMs) and of 32 (32 blocks on
// 32 SMs) time within 2 % of each other from a CUDA graph
// (tools/b16_variants.py; NVIDIA H100 80GB HBM3, 700 W: selmadd G1 0.0284
// / 0.0285 ms, G2 0.0924 / 0.0919, dblw G1 0.0105 / 0.0103, G2 0.0216 /
// 0.0220): a warp has a sub-partition to itself either way, and one lane's
// chain of products sets the time. So the block stays 128.
constexpr int kBlockThreads = 128;
constexpr int kMinBlocks = 256 / kBlockThreads;

template <class F>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
selmadd_kernel(const int32_t* __restrict__ acc,
               const int32_t* __restrict__ table,
               const int32_t* __restrict__ digits, int32_t* __restrict__ out,
               int accs, int n, int nent, int start) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < accs)
    tc::selmadd_lane_r<F>(acc, table, digits, out, accs, n, nent, start, j);
}

template <class F>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
dblw_kernel(const int32_t* __restrict__ acc, int32_t* __restrict__ out,
            int accs, int window) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < accs) tc::dblw_lane_r<F>(acc, out, accs, window, j);
}

inline dim3 grid_for(int n) {
  return dim3((n + kBlockThreads - 1) / kBlockThreads);
}

template <class F>
int launch_selmadd(const void* acc, const void* table, const void* digits,
                   void* out, int accs, int n, int nent, int start,
                   void* stream) {
  if (accs <= 0) return 0;
  selmadd_kernel<F><<<grid_for(accs), kBlockThreads, 0,
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
  dblw_kernel<F><<<grid_for(accs), kBlockThreads, 0,
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
