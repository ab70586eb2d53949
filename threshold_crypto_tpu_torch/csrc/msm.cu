// The shared-window MSM kernels B10 (madd) and B11 (winacc) for sm_90a, in
// G1 (Fq) and G2 (Fq2) forms, one thread per lane or per accumulator.
//
// B10 `madd_kernel` replaces threshold_crypto_tpu/device/pallas_curve.py
// `_mk_madd_kernel` (:397; `_k_g1_madd` / `_k_g2_madd` :451-452): per lane
// acc ← acc + Q, the complete mixed add, which builds the table
// 1P..(2^w−1)P of the shared MSM (2^w − 2 launches per MSM).
//
// B11 `winacc_kernel` replaces `_mk_winacc_kernel` (:534, launched by
// `_winacc_impl` :581), the whole Horner phase of the shared-window MSM in
// one launch. The TPU kernel walked a sequential (window × block) grid and
// carried ONE 1024-lane accumulator in VMEM scratch from step to step. CUDA
// blocks run in no order, so the sequential grid dimension becomes a loop
// inside each thread: accumulator j owns lanes j, j + A, j + 2A, … and, per
// window (MSB first), doubles itself w times, then adds table[d − 1] for
// each of its lanes with a digit d ≠ 0 (a branch on the digit, and one
// indexed load of the one entry, where the TPU selected over all entries;
// a digit outside 1..2^w − 1 reads entry 0, as the TPU's select chain
// does). It writes A partial sums, which device/cuda_curve.py folds in
// torch. A is free (ACCUMULATORS there): the TPU's 1024 would fill 8 of
// 132 SMs.
//
// Layout. Packed limb-major int32[k·24, n] (device/packed.py): acc and the
// table entries are Jacobian (G1 X, Y, Z; G2 X0, X1, Y0, Y1, Z0, Z1), Q is
// affine; digits are int32[D, n]. Neighbouring threads own neighbouring
// lanes, so each row load is coalesced; the table entry a thread reads
// depends on its digit, so a warp's loads of one window spread over up to
// 2^w − 1 rows.
//
// What bounds it. The bounds count only the general path of each add,
// which is all the function needs. B10 needs 11 products per lane (8
// products and 3 squares: G1 11 Fq products; G2 30, an Fq2 product being 3
// and a square 2) against 8k·96 bytes of traffic per lane: the multiply
// issue rate bounds it. B11 needs 16 products per nonzero digit (12 and 4
// squares: G1 16 Fq, G2 44) plus w doublings of 7 (2 and 5 squares: G1 7,
// G2 16) per accumulator and window, against one read of the table
// (21k·96 bytes per lane) and the digits: the multiply issue rate bounds it
// by far. The accumulator stays in the thread for the whole launch.
//
// Both run on B13's register engine (ladder_engine.cuh `madd_lane_r`,
// `winacc_lane_r`): field values in registers, one out-of-line carry-save
// Montgomery product, the add's doubling case a branch (curve.cuh's
// formulas, which B10 ran before, pass every operand through a
// local-memory frame and compute the doubling branch on every lane). In
// B10 the table build's first launch takes that branch on every lane (acc
// = Q), the others on none. In B11 one loop serves every step of an
// accumulator, each pass a doubling or the next lane's add, so the kernel
// holds one copy of each formula (code size set B13's pace). A random
// digit spreads a warp's loads of one window over up to 2^w − 1 entry
// rows, about 5× the sectors it uses; tools/b11_variants.py measures that
// gather.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "curve.cuh"
#include "ladder_engine.cuh"

namespace {

using tc::kThreads;

// B10's blocks of kThreads that must fit on an SM together, per field:
// __launch_bounds__ caps the registers at 65,536 / (kThreads · blocks) a
// thread. At the RLC path's 262,144 lanes the grid is 2,048 blocks, so
// more blocks an SM could hide the product's latency; yet the caps of 255,
// 168 and 128 registers time within 1.4 % of one another in G1, and 128
// spills and is 5-8 % slower in G2 (tools/b10_variants.py, PERF.md §6). Each
// field takes the most blocks whose code spills no more than at the 255
// cap: 3 in G1 (no spills), 2 in G2.
template <class F>
struct MaddBlocks;
template <>
struct MaddBlocks<tc::Fq> {
  static constexpr int value = 3;
};
template <>
struct MaddBlocks<tc::Fq2> {
  static constexpr int value = 2;
};

template <class F>
__global__ void __launch_bounds__(kThreads, MaddBlocks<F>::value)
madd_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ q,
            int32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) tc::madd_lane_r<F>(acc, q, out, n, lane);
}

// B11's blocks of kThreads that must fit on an SM together, per field:
// __launch_bounds__ caps the registers at 65,536 / (kThreads · blocks) a
// thread. At the RLC path's A = 16,384 one block runs on each of 128 SMs
// whatever the cap, so both fields take the 255 cap (2 blocks), where
// fewer values spill (tools/b11_variants.py times the other caps).
template <class F>
struct WinaccBlocks;
template <>
struct WinaccBlocks<tc::Fq> {
  static constexpr int value = 2;
};
template <>
struct WinaccBlocks<tc::Fq2> {
  static constexpr int value = 2;
};

template <class F>
__global__ void __launch_bounds__(kThreads, WinaccBlocks<F>::value)
winacc_kernel(const int32_t* __restrict__ table,
              const int32_t* __restrict__ digits, int32_t* __restrict__ out,
              int n, int accs, int ndig, int window) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < accs)
    tc::winacc_lane_r<F>(table, digits, out, n, accs, ndig, window, j);
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

template <class F>
int launch_madd(const void* acc, const void* q, void* out, int n,
                void* stream) {
  if (n <= 0) return 0;
  madd_kernel<F><<<grid_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const int32_t*>(q),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_winacc(const void* table, const void* digits, void* out, int n,
                  int accs, int ndig, int window, void* stream) {
  if (accs <= 0) return 0;
  winacc_kernel<F><<<grid_for(accs), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(digits),
      static_cast<int32_t*>(out), n, accs, ndig, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tc_g1_madd(const void* acc, const void* q, void* out, int n,
                          void* stream) {
  return launch_madd<tc::Fq>(acc, q, out, n, stream);
}

extern "C" int tc_g2_madd(const void* acc, const void* q, void* out, int n,
                          void* stream) {
  return launch_madd<tc::Fq2>(acc, q, out, n, stream);
}

extern "C" int tc_g1_winacc(const void* table, const void* digits, void* out,
                            int n, int accs, int ndig, int window,
                            void* stream) {
  return launch_winacc<tc::Fq>(table, digits, out, n, accs, ndig, window,
                               stream);
}

extern "C" int tc_g2_winacc(const void* table, const void* digits, void* out,
                            int n, int accs, int ndig, int window,
                            void* stream) {
  return launch_winacc<tc::Fq2>(table, digits, out, n, accs, ndig, window,
                                stream);
}
