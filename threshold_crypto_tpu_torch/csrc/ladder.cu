// The per-lane ladder kernels B13 (step4) and B15 (step) for sm_90a, in G1
// (Fq) and G2 (Fq2) forms, one thread per lane.
//
// B13 `step4_kernel` replaces threshold_crypto_tpu/device/pallas_curve.py
// `_mk_step4_kernel` (:385; `_k_g1_msm_step4` / `_k_g2_msm_step4`
// :449-450, per step `_msm_step_w4` :355): T <- 16T + table[d − 1] per lane
// for one base-16 digit d, the complete add gated on d != 0. B15
// `step_kernel` replaces `_mk_step_kernel` (:373; `_k_g1_msm_step` /
// `_k_g2_msm_step` :447-448, body `_msm_step` :143): T <- 2T (+ Q affine
// where the bit is set). Their callers are the ladders of
// device/cuda_curve.py: `msm_pallas` (window 4 and 1), `scalar_mul_pallas`
// (encrypt's three 255-bit scalar-muls, 64 digits) and
// `scalar_mul_fixed_pallas` (hash_g2's 507-bit cofactor, 127 digits).
//
// The TPU drove each kernel once per digit (or bit) from a `lax.scan`,
// with the accumulator in HBM between steps. Here the digit loop runs
// inside the thread: a whole ladder is one launch, and the accumulator
// never leaves the thread. D = 1 is exactly the TPU kernel.
//
// Layout. Packed limb-major int32[k·24, n] (device/packed.py): the
// accumulator in and out [3k·24, n] Jacobian; B13's table the 15 Jacobian
// entries 1P..15P one after the other, [15·3k·24, n]; B15's Q affine
// [2k·24, n]; digits or bits int32[D, n]. Neighbouring threads own
// neighbouring lanes, so every row load is coalesced; B13 reads one table
// entry by index, so a warp's loads of one digit spread over the rows of
// up to 15 entries for per-lane scalars, and over one for a fixed scalar
// (the cofactor), where every lane has the same digit.
//
// What bounds it. Per digit B13 needs 4 doublings (7 products: G1 7 Fq,
// G2 16) and, for d != 0, the general path of the complete add (16 / 44),
// against 3k·96·2 bytes of accumulator and 3k·96 bytes per table entry
// read: the multiply issue rate bounds it by far. Per bit B15 needs one
// doubling and, for a set bit, the general path of the mixed add (11 / 30)
// against 8k·96 bytes a lane: the multiply issue rate again.
//
// Both run on the register engine of ladder_engine.cuh (`step4_lane_r`,
// `step_lane_r`): field values in registers, one out-of-line carry-save
// Montgomery product in PTX, and the add's doubling case a branch through
// the ladder's own doubling.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "ladder_engine.cuh"

namespace {

constexpr int kThreads = 128;

// B15's blocks of kThreads that must fit on an SM together, per field:
// __launch_bounds__ caps the registers at 65,536 / (kThreads · blocks) a
// thread. G1 takes 164 registers, no frame, at a cap of 168 (3 blocks) and
// of 255 (2 blocks) alike; G2 spills at 255 (584-byte frame). Holding Q in
// registers across the bits in place of reading it where it is used timed
// within 1 % at the full card and 3 % slower in G2 at the combine's 4096
// lanes (NVIDIA H100 80GB HBM3, 700 W; tools/b15_variants.py).
template <class F>
struct StepBlocks;
template <>
struct StepBlocks<tc::Fq> {
  static constexpr int value = 3;
};
template <>
struct StepBlocks<tc::Fq2> {
  static constexpr int value = 2;
};

template <class F>
__global__ void __launch_bounds__(kThreads, StepBlocks<F>::value)
step_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ q,
            const int32_t* __restrict__ bits, int32_t* __restrict__ out,
            int n, int nbits) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) tc::step_lane_r<F>(acc, q, bits, out, n, nbits, lane);
}

// B13's blocks of kThreads that must fit on an SM together, per field:
// __launch_bounds__ caps the registers at 65,536 / (kThreads · blocks) a
// thread. G1 at 3 blocks (cap 168) ran the DKG's 2^19-lane launch 6 %
// faster than at 2 (cap 255: 212 registers, no frame) for a 144-byte frame
// outside the product (NVIDIA H100 80GB HBM3, 700 W; tools/b13_variants.py);
// G2 keeps the 255 cap, where it spills least.
template <class F>
struct Step4Blocks;
template <>
struct Step4Blocks<tc::Fq> {
  static constexpr int value = 3;
};
template <>
struct Step4Blocks<tc::Fq2> {
  static constexpr int value = 2;
};

template <class F>
__global__ void __launch_bounds__(kThreads, Step4Blocks<F>::value)
step4_kernel(const int32_t* __restrict__ acc,
             const int32_t* __restrict__ table,
             const int32_t* __restrict__ digits, int32_t* __restrict__ out,
             int n, int ndig) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) tc::step4_lane_r<F>(acc, table, digits, out, n, ndig, lane);
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

template <class F>
int launch_step(const void* acc, const void* q, const void* bits, void* out,
                int n, int nbits, void* stream) {
  if (n <= 0) return 0;
  step_kernel<F><<<grid_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const int32_t*>(q),
      static_cast<const int32_t*>(bits), static_cast<int32_t*>(out), n,
      nbits);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_step4(const void* acc, const void* table, const void* digits,
                 void* out, int n, int ndig, void* stream) {
  if (n <= 0) return 0;
  step4_kernel<F><<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(digits), static_cast<int32_t*>(out), n,
      ndig);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tc_g1_step(const void* acc, const void* q, const void* bits,
                          void* out, int n, int nbits, void* stream) {
  return launch_step<tc::Fq>(acc, q, bits, out, n, nbits, stream);
}

extern "C" int tc_g2_step(const void* acc, const void* q, const void* bits,
                          void* out, int n, int nbits, void* stream) {
  return launch_step<tc::Fq2>(acc, q, bits, out, n, nbits, stream);
}

extern "C" int tc_g1_step4(const void* acc, const void* table,
                           const void* digits, void* out, int n, int ndig,
                           void* stream) {
  return launch_step4<tc::Fq>(acc, table, digits, out, n, ndig, stream);
}

extern "C" int tc_g2_step4(const void* acc, const void* table,
                           const void* digits, void* out, int n, int ndig,
                           void* stream) {
  return launch_step4<tc::Fq2>(acc, table, digits, out, n, ndig, stream);
}
