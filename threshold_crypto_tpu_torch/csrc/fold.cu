// Kernel B19, one level of the pairwise fold, for sm_90a, in G1 (Fq) and G2
// (Fq2) forms, one thread per output lane.
//
// `fold_level_kernel` runs one level of `DeviceCurve.fold_axis`
// (device/curve.py): the sum over one batch axis by a pairwise tree of
// complete adds, which closes every MSM (B11's and B16's partial sums, the
// per-lane ladders of B13 and B15), the DKG's row and value commitments
// and the sharded partials. It replaces no TPU kernel: the JAX package's
// `_tree_sum` (threshold_crypto_tpu/device/curve.py) is XLA adds, and each
// level was one stacked torch `jac_add` (device/curve.py), five B1
// launches and a few hundred torch ops whose dispatch the host paced.
//
// Layout. Packed limb-major int32[3k·24, n] (device/packed.py), Jacobian
// (G1 X, Y, Z; G2 X0, X1, Y0, Y1, Z0, Z1), the lanes fold index major: lane
// f·rest + r holds entry f of batch r. For m entries a level writes a new
// [3k·24, half], half = ⌈m/2⌉·rest: lane i is lane i plus lane i + half,
// the plain tree's pairing of the first half of the entries with the
// second. On an odd level the last rest lanes have no partner; the plain
// tree pads with infinity, and the lane body gives what its select gives.
// So every level equals the torch tree's Jacobian limbs bit for bit.
// Neighbouring threads own neighbouring lanes, so each limb row's load and
// store is coalesced.
//
// What bounds it. The general path of one complete add a lane (16 / 44 Fq
// products, G1 / G2; the frozen yardstick counts 23 / 69, the torch form
// computing its doubling branch on every lane) against 2 · 3k · 96 bytes
// read and 3k · 96 written: the 32-bit multiply rate, about twice the
// bytes' time. The lane body (ladder_engine.cuh `fold_lane_r`) is
// `jac_add` on B13's register engine with its T == Q case a branch into
// `jac_dbl`, the add of B16's selmadd. A level runs from 946,688 lanes
// (the DKG's row commitments) down to 1 (the last of the RLC fold); the
// grid follows the lane count, and a narrow level's time is one add's
// chain of products.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "ladder_engine.cuh"

namespace {

constexpr int kThreads = 128;

// Blocks of kThreads that must fit on an SM together, per field:
// __launch_bounds__ caps the registers at 65,536 / (kThreads · blocks) a
// thread. As B13's (csrc/ladder.cu Step4Blocks), whose lane body holds the
// same complete add: G1 at the 168-register cap (3 blocks; ptxas leaves
// the same 144-byte frame as B13's G1), G2 at 255 (2), where it spills
// least.
template <class F>
struct FoldBlocks;
template <>
struct FoldBlocks<tc::Fq> {
  static constexpr int value = 3;
};
template <>
struct FoldBlocks<tc::Fq2> {
  static constexpr int value = 2;
};

template <class F>
__global__ void __launch_bounds__(kThreads, FoldBlocks<F>::value)
fold_level_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  int n, int half) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < half) tc::fold_lane_r<F>(in, out, n, half, lane);
}

template <class F>
int launch_fold_level(const void* in, void* out, int n, int half,
                      void* stream) {
  if (half <= 0) return 0;
  fold_level_kernel<F><<<(half + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n, half);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tc_g1_fold_level(const void* in, void* out, int n, int half,
                                void* stream) {
  return launch_fold_level<tc::Fq>(in, out, n, half, stream);
}

extern "C" int tc_g2_fold_level(const void* in, void* out, int n, int half,
                                void* stream) {
  return launch_fold_level<tc::Fq2>(in, out, n, half, stream);
}
