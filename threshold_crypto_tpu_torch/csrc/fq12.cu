// The Fq12 kernels of the final exponentiation, B6-B9 and B18, and the
// test entry of the engine B3, for sm_90a.
//
// B6 `cyclo_sqr_group_kernel` replaces threshold_crypto_tpu/device/
// pallas_tower.py `_k_cyclo_sqr` (:956), the Granger-Scott squaring, on
// the lane-group engine of tower_group.cuh: one lane over a group of
// tc::grp::kGroup threads, its 18 Fq products dealt over the group (3 a
// thread at kGroup = 8), the operands in registers and the values in the
// block's shared memory. B7 `cyclo_sqr_mul_group_kernel` replaces
// `_k_cyclo_sqr_mul` (:932), acc²·g, the 1-bit step of exp-by-x, on the
// same engine: B6's 18 products, then the Fq12 product's 54 (3 + 7 a
// thread). B8 `fq12_mul_group_kernel` replaces `_k_fq12_mul` (:960) on the
// same engine: B7's second half, the 54 products in one phase (7 a
// thread). B9 `fq12_sqr_group_kernel` replaces `_k_fq12_sqr` (:964), the
// complex square, on the same engine: B4's first layer without the
// doubling, 36 products in one phase (5 a thread).
//
// B18 replaces no Pallas kernel: the JAX package runs these steps through
// XLA's tower (threshold_crypto_tpu/device/pairing.py `_easy_part`,
// `_jit_glue1`, `_jit_glue2`; :257-271, :507-523), and the port ran them
// through its torch tower, one stacked field op at a time. On the same
// engine: `frob_mul_group_kernel` a·σ_k(b) (10 products by the Frobenius
// constants, then B8's 54; 2 + 7 rounds a thread), `easy_down_group_kernel`
// f down the tower to the Fq2 norm n whose inverse f⁻¹ needs (62
// products, 10 rounds) and `easy_up_group_kernel` from n⁻¹ (one B2 launch
// between the two) back to frob₂(x)·x for x = conj(f)·f⁻¹ (111 products,
// 17 rounds), against 36, 33 and 33 × 24 int32 rows a lane read or
// written: the multiply issue rate bounds them.
//
// `engine_kernel` runs B3 (replacing `_k_mul16`/`_k_mul13` and `k_add`,
// `k_sub`, `k_neg`, `k_small`, :140-323) on its own: B3 has no launch of its own on the
// path, so this entry is how it is held against the plain field
// operations. It runs the field every redesigned kernel runs on,
// ladder_engine.cuh's `reg::` engine (`engine_lane_r`: operands in
// registers, the carry-save product `mont_mul_words<FqField>` inlined,
// carry-chain add and subtract, `fp_neg`, and k·a by a short add chain),
// one thread a (component, lane) over a 2-D grid (lanes × components),
// where before one thread ran a lane's m components on fq.cuh's
// `__noinline__` functions over a local-memory frame. Its 7 × 24 int32
// rows a value (a, b in; five results out) are read and written once,
// coalesced across the warp's lanes: bound by bytes.
//
// Layout. Packed limb-major int32[12·24, n] Fq12 values (device/packed.py);
// neighbouring threads read neighbouring words.
//
// What bounds it. Per lane, B6 runs 18 Fq products (10,584 IMAD results)
// against 2 × 1,152 bytes, B7 72 products against 3 × 1,152 bytes, B8 54
// against 3 × 1,152 and B9 36 against 2 × 1,152: on an H100 SXM the
// multiply issue rate bounds B7-B9, and B6 sits near the balance point
// (its bytes take about as long as its products). On the lane-group
// engine a group of 8 threads runs a lane's products, so the RLC check's
// 512-lane launches of B6-B9 run 128 blocks of 32 threads (4 lanes each)
// where one thread a lane filled 4 SMs, and a launch takes the latency of
// 3 (B6), 10 (B7), 7 (B8) or 5 (B9) products in series where one thread
// took 18, 72, 54 or 36.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "tower_group.cuh"

namespace {

// Threads of a B3 block (lanes of one component).
constexpr int kEngineThreads = 128;

// B6: 2^lane_shift lanes a block, kGroup threads a lane.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
cyclo_sqr_group_kernel(const int32_t* __restrict__ f,
                       int32_t* __restrict__ fo, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 cyclo_sqr_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(cyclo_sqr_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(f, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kB6LaneWords);
  __syncthreads();
  run_schedule(kB6PhaseOps, kB6Ops, kB6Terms, kB6Phases,
               smem + (tid / kGroup) * kB6LaneWords);
  __syncthreads();
  stage_out(fo, kB6OutSlots, 12, n, lane0, lane_shift, tid, nthreads, smem,
            kB6LaneWords);
}

// B7: f in slots 0-11, g in 12-23.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
cyclo_sqr_mul_group_kernel(const int32_t* __restrict__ f,
                           const int32_t* __restrict__ g,
                           int32_t* __restrict__ fo, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 cyclo_sqr_mul_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(cyclo_sqr_mul_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(f, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kB7LaneWords);
  stage_in(g, 12, 12, n, lane0, lane_shift, tid, nthreads, smem,
           kB7LaneWords);
  __syncthreads();
  run_schedule(kB7PhaseOps, kB7Ops, kB7Terms, kB7Phases,
               smem + (tid / kGroup) * kB7LaneWords);
  __syncthreads();
  stage_out(fo, kB7OutSlots, 12, n, lane0, lane_shift, tid, nthreads, smem,
            kB7LaneWords);
}

// B8: a in slots 0-11, b in 12-23.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
fq12_mul_group_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      int32_t* __restrict__ fo, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 fq12_mul_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(fq12_mul_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(a, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kB8LaneWords);
  stage_in(b, 12, 12, n, lane0, lane_shift, tid, nthreads, smem,
           kB8LaneWords);
  __syncthreads();
  run_schedule(kB8PhaseOps, kB8Ops, kB8Terms, kB8Phases,
               smem + (tid / kGroup) * kB8LaneWords);
  __syncthreads();
  stage_out(fo, kB8OutSlots, 12, n, lane0, lane_shift, tid, nthreads, smem,
            kB8LaneWords);
}

// B9: a in slots 0-11.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
fq12_sqr_group_kernel(const int32_t* __restrict__ a,
                      int32_t* __restrict__ fo, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 fq12_sqr_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(fq12_sqr_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(a, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kB9LaneWords);
  __syncthreads();
  run_schedule(kB9PhaseOps, kB9Ops, kB9Terms, kB9Phases,
               smem + (tid / kGroup) * kB9LaneWords);
  __syncthreads();
  stage_out(fo, kB9OutSlots, 12, n, lane0, lane_shift, tid, nthreads, smem,
            kB9LaneWords);
}

// B18 frob_mul: a in slots 0-11, b in 12-23; k = 1 or 2 picks σ_k's
// schedule.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
frob_mul_group_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      int32_t* __restrict__ fo, int k, int n,
                      int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 frob_mul_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(frob_mul_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  const bool p2 = k == 2;
  stage_in(a, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kFrobMulLaneWords);
  stage_in(b, 12, 12, n, lane0, lane_shift, tid, nthreads, smem,
           kFrobMulLaneWords);
  __syncthreads();
  run_schedule(p2 ? kFrobMul2PhaseOps : kFrobMul1PhaseOps,
               p2 ? kFrobMul2Ops : kFrobMul1Ops,
               p2 ? kFrobMul2Terms : kFrobMul1Terms,
               p2 ? kFrobMul2Phases : kFrobMul1Phases,
               smem + (tid / kGroup) * kFrobMulLaneWords);
  __syncthreads();
  stage_out(fo, p2 ? kFrobMul2OutSlots : kFrobMul1OutSlots, 12, n, lane0,
            lane_shift, tid, nthreads, smem, kFrobMulLaneWords);
}

// B18 easy_down: f in slots 0-11; out n as int32[n, 24] limb rows and
// s, m, c0-c2, tt as packed int32[20·24, n].
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
easy_down_group_kernel(const int32_t* __restrict__ f,
                       int32_t* __restrict__ norm,
                       int32_t* __restrict__ inter, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 easy_down_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(easy_down_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(f, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kEasyDownLaneWords);
  __syncthreads();
  run_schedule(kEasyDownPhaseOps, kEasyDownOps, kEasyDownTerms,
               kEasyDownPhases, smem + (tid / kGroup) * kEasyDownLaneWords);
  __syncthreads();
  stage_out_rows(norm, kEasyDownOutSlots[0], n, lane0, lane_shift, tid,
                 nthreads, smem, kEasyDownLaneWords);
  stage_out(inter, kEasyDownOutSlots + 1, kEasyDownOutputs - 1, n, lane0,
            lane_shift, tid, nthreads, smem, kEasyDownLaneWords);
}

// B18 easy_up: s, m, c0-c2, tt in slots 0-19, n⁻¹ (limb rows) in 20.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
easy_up_group_kernel(const int32_t* __restrict__ inter,
                     const int32_t* __restrict__ ninv,
                     int32_t* __restrict__ fo, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 easy_up_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(easy_up_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(inter, kEasyUpInputs - 1, 0, n, lane0, lane_shift, tid, nthreads,
           smem, kEasyUpLaneWords);
  stage_in_rows(ninv, kEasyUpInputs - 1, n, lane0, lane_shift, tid, nthreads,
                smem, kEasyUpLaneWords);
  __syncthreads();
  run_schedule(kEasyUpPhaseOps, kEasyUpOps, kEasyUpTerms, kEasyUpPhases,
               smem + (tid / kGroup) * kEasyUpLaneWords);
  __syncthreads();
  stage_out(fo, kEasyUpOutSlots, 12, n, lane0, lane_shift, tid, nthreads,
            smem, kEasyUpLaneWords);
}

// B3: lanes along x, the m components along y.
__global__ void __launch_bounds__(kEngineThreads)
engine_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, int m, int k, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) tc::engine_lane_r(a, b, out, blockIdx.y, m, k, n, lane);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* out(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

extern "C" int tc_cyclo_sqr(const void* f, void* fo, int n, void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kB6LaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(cyclo_sqr_group_kernel), s.bytes,
      allowed);
  if (err != 0) return err;
  cyclo_sqr_group_kernel<<<s.blocks, s.threads, s.bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      in(f), out(fo), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_cyclo_sqr_mul(const void* f, const void* g, void* fo, int n,
                                void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kB7LaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(cyclo_sqr_mul_group_kernel), s.bytes,
      allowed);
  if (err != 0) return err;
  cyclo_sqr_mul_group_kernel<<<s.blocks, s.threads, s.bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      in(f), in(g), out(fo), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_fq12_mul(const void* a, const void* b, void* fo, int n,
                           void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kB8LaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(fq12_mul_group_kernel), s.bytes,
      allowed);
  if (err != 0) return err;
  fq12_mul_group_kernel<<<s.blocks, s.threads, s.bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      in(a), in(b), out(fo), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_fq12_sqr(const void* a, void* fo, int n, void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kB9LaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(fq12_sqr_group_kernel), s.bytes,
      allowed);
  if (err != 0) return err;
  fq12_sqr_group_kernel<<<s.blocks, s.threads, s.bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      in(a), out(fo), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_frob_mul(const void* a, const void* b, void* fo, int k,
                           int n, void* stream) {
  if (n <= 0) return 0;
  if (k != 1 && k != 2) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;
  const tc::grp::Shape s =
      tc::grp::group_shape(n, tc::grp::kFrobMulLaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(frob_mul_group_kernel), s.bytes,
      allowed);
  if (err != 0) return err;
  frob_mul_group_kernel<<<s.blocks, s.threads, s.bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      in(a), in(b), out(fo), k, n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_easy_down(const void* f, void* norm, void* inter, int n,
                            void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s =
      tc::grp::group_shape(n, tc::grp::kEasyDownLaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(easy_down_group_kernel), s.bytes,
      allowed);
  if (err != 0) return err;
  easy_down_group_kernel<<<s.blocks, s.threads, s.bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      in(f), out(norm), out(inter), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_easy_up(const void* inter, const void* ninv, void* fo,
                          int n, void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kEasyUpLaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(easy_up_group_kernel), s.bytes, allowed);
  if (err != 0) return err;
  easy_up_group_kernel<<<s.blocks, s.threads, s.bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      in(inter), in(ninv), out(fo), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_fq_engine(const void* a, const void* b, void* out_, int m,
                            int k, int n, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (k < 1 || m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kEngineThreads - 1) / kEngineThreads, m);
  engine_kernel<<<grid, kEngineThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(in(a), in(b), out(out_),
                                                       m, k, n);
  return static_cast<int>(cudaGetLastError());
}
