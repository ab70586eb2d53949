// The fused Miller-loop kernels B4 `dbl_fold` and B5 `add_fold`, and the
// unfused Miller pieces B17, for sm_90a.
//
// B4 `dbl_fold_kernel` replaces threshold_crypto_tpu/device/pallas_tower.py
// `_k_dbl_fold` (:906): T ← 2T and f ← f²·l_tangent(P) in one launch. B5
// `add_fold_kernel` replaces `_k_add_fold` (:918): T ← T + Q and
// f ← f·l_chord(P). The driver runs B4 on each of the 63 bits of |x| after
// the first and B5 on its five 1-bits, over every pair of the batch.
//
// Layout. Packed limb-major int32[k·24, n] (device/packed.py): f k = 12,
// T k = 6, Q k = 4, P k = 2. Outputs are separate tensors.
//
// B4 and B5 run on the lane-group engine of tower_group.cuh: one lane
// over a group of tc::grp::kGroup threads, its Fq products dealt over the
// group from a static schedule, the operands in registers and the values
// in the block's shared memory; the block stages its lanes' f, T (Q) and
// P as coalesced rows in and f, T out. What bounds them: B4 runs 122
// products (71,736 32-bit IMAD results) in four dependent layers (48, 19,
// 16, 39) against 3,648 bytes a lane, B5 80 (6, 14, 48, 12: `add_step`'s
// layers, the line product's 39 in the third) against 4,032, the
// multiply issue rate by about 3.9× and 2.3× over the bytes on an H100
// SXM; one thread a lane left the check's 1,024-lane launches on 8 SMs at
// the latency of 122 (80) products in series, where a group runs 16 (11)
// of them a thread.
//
// B17 replaces the four unfused pieces of the same file: `_k_dbl_step`
// (:886, T ← 2T and the tangent line out), `_k_add_step` (:895, T ← T + Q
// and the chord line out), `_k_f_sqr_fold` (:940, f ← f²·line) and
// `_k_f_fold` (:948, f ← f·line). The line leaves as int32[144, n] in the
// JAX kernel's plane order (c0, c1, c4; re then im). B4 is `dbl_step` then
// `f_sqr_fold`, B5 `add_step` then `f_fold`, bit for bit: the same field
// elements, cut where the line is written. Split, each iteration moves one
// more line through device memory (1,152 bytes a lane out, then in), and
// each piece is bound by its multiplies as B4/B5 are: dbl_step 47 Fq
// products against 1,920 bytes a lane, add_step 41 against 2,304,
// f_sqr_fold 75 against 2,880 and f_fold 39 against 2,880. No JAX path
// calls the pieces; the port's composition check drives a whole Miller
// loop through them against B4/B5.
//
// B17 runs on the same engine as B4 and B5, each piece B4's or B5's
// schedule cut at the line (tools/tower_group_schedule.py): `dbl_step`
// B4's layers 1-3 without f² (12, 19, 16 Fq products), `f_sqr_fold` f²
// and B4's layer 4 (36, 39), `add_step` B5's layers without the line
// product (6, 14, 9, 12), `f_fold` that product (39); a thread of a
// group of 8 runs 7, 10, 7 and 5 products where one thread a lane (on
// tower.cuh, before) ran 47, 75, 41 and 39 in series.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0, so a launch refused for its registers,
// stack or shared memory is never silent.

#include <cstdint>
#include <cuda_runtime.h>

#include "tower_group.cuh"

namespace {

// B4: 2^lane_shift lanes a block, kGroup threads a lane.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
dbl_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ T,
                const int32_t* __restrict__ P, int32_t* __restrict__ fo,
                int32_t* __restrict__ To, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 dbl_fold_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(dbl_fold_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(f, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kB4LaneWords);
  stage_in(T, 6, 12, n, lane0, lane_shift, tid, nthreads, smem,
           kB4LaneWords);
  stage_in(P, 2, 18, n, lane0, lane_shift, tid, nthreads, smem,
           kB4LaneWords);
  __syncthreads();
  run_schedule(kB4PhaseOps, kB4Ops, kB4Terms, kB4Phases,
               smem + (tid / kGroup) * kB4LaneWords);
  __syncthreads();
  stage_out(fo, kB4OutSlots, 12, n, lane0, lane_shift, tid, nthreads, smem,
            kB4LaneWords);
  stage_out(To, kB4OutSlots + 12, 6, n, lane0, lane_shift, tid, nthreads,
            smem, kB4LaneWords);
}

// B5: f in slots 0-11, T 12-17, Q 18-21, P 22-23.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
add_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ T,
                const int32_t* __restrict__ Q, const int32_t* __restrict__ P,
                int32_t* __restrict__ fo, int32_t* __restrict__ To, int n,
                int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 add_fold_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(add_fold_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(f, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kB5LaneWords);
  stage_in(T, 6, 12, n, lane0, lane_shift, tid, nthreads, smem,
           kB5LaneWords);
  stage_in(Q, 4, 18, n, lane0, lane_shift, tid, nthreads, smem,
           kB5LaneWords);
  stage_in(P, 2, 22, n, lane0, lane_shift, tid, nthreads, smem,
           kB5LaneWords);
  __syncthreads();
  run_schedule(kB5PhaseOps, kB5Ops, kB5Terms, kB5Phases,
               smem + (tid / kGroup) * kB5LaneWords);
  __syncthreads();
  stage_out(fo, kB5OutSlots, 12, n, lane0, lane_shift, tid, nthreads, smem,
            kB5LaneWords);
  stage_out(To, kB5OutSlots + 12, 6, n, lane0, lane_shift, tid, nthreads,
            smem, kB5LaneWords);
}

// B17 dbl_step: T in slots 0-5, P 6-7; out T, then the line.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
dbl_step_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ P,
                int32_t* __restrict__ To, int32_t* __restrict__ line, int n,
                int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 dbl_step_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(dbl_step_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(T, 6, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kDblStepLaneWords);
  stage_in(P, 2, 6, n, lane0, lane_shift, tid, nthreads, smem,
           kDblStepLaneWords);
  __syncthreads();
  run_schedule(kDblStepPhaseOps, kDblStepOps, kDblStepTerms, kDblStepPhases,
               smem + (tid / kGroup) * kDblStepLaneWords);
  __syncthreads();
  stage_out(To, kDblStepOutSlots, 6, n, lane0, lane_shift, tid, nthreads,
            smem, kDblStepLaneWords);
  stage_out(line, kDblStepOutSlots + 6, 6, n, lane0, lane_shift, tid,
            nthreads, smem, kDblStepLaneWords);
}

// B17 add_step: T in slots 0-5, Q 6-9, P 10-11; out T, then the line.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
add_step_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ Q,
                const int32_t* __restrict__ P, int32_t* __restrict__ To,
                int32_t* __restrict__ line, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 add_step_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(add_step_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(T, 6, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kAddStepLaneWords);
  stage_in(Q, 4, 6, n, lane0, lane_shift, tid, nthreads, smem,
           kAddStepLaneWords);
  stage_in(P, 2, 10, n, lane0, lane_shift, tid, nthreads, smem,
           kAddStepLaneWords);
  __syncthreads();
  run_schedule(kAddStepPhaseOps, kAddStepOps, kAddStepTerms, kAddStepPhases,
               smem + (tid / kGroup) * kAddStepLaneWords);
  __syncthreads();
  stage_out(To, kAddStepOutSlots, 6, n, lane0, lane_shift, tid, nthreads,
            smem, kAddStepLaneWords);
  stage_out(line, kAddStepOutSlots + 6, 6, n, lane0, lane_shift, tid,
            nthreads, smem, kAddStepLaneWords);
}

// B17 f_sqr_fold: f in slots 0-11, the line 12-17.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
f_sqr_fold_kernel(const int32_t* __restrict__ f,
                  const int32_t* __restrict__ line, int32_t* __restrict__ fo,
                  int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 f_sqr_fold_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(f_sqr_fold_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(f, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kFSqrFoldLaneWords);
  stage_in(line, 6, 12, n, lane0, lane_shift, tid, nthreads, smem,
           kFSqrFoldLaneWords);
  __syncthreads();
  run_schedule(kFSqrFoldPhaseOps, kFSqrFoldOps, kFSqrFoldTerms,
               kFSqrFoldPhases, smem + (tid / kGroup) * kFSqrFoldLaneWords);
  __syncthreads();
  stage_out(fo, kFSqrFoldOutSlots, 12, n, lane0, lane_shift, tid, nthreads,
            smem, kFSqrFoldLaneWords);
}

// B17 f_fold: f in slots 0-11, the line 12-17.
__global__ void __launch_bounds__(tc::grp::kMaxThreads, tc::grp::kMinBlocks)
f_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ line,
              int32_t* __restrict__ fo, int n, int lane_shift) {
  using namespace tc::grp;
  extern __shared__ uint4 f_fold_scratch[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(f_fold_scratch);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane0 = blockIdx.x << lane_shift;
  stage_in(f, 12, 0, n, lane0, lane_shift, tid, nthreads, smem,
           kFFoldLaneWords);
  stage_in(line, 6, 12, n, lane0, lane_shift, tid, nthreads, smem,
           kFFoldLaneWords);
  __syncthreads();
  run_schedule(kFFoldPhaseOps, kFFoldOps, kFFoldTerms, kFFoldPhases,
               smem + (tid / kGroup) * kFFoldLaneWords);
  __syncthreads();
  stage_out(fo, kFFoldOutSlots, 12, n, lane0, lane_shift, tid, nthreads,
            smem, kFFoldLaneWords);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* out(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

extern "C" int tc_dbl_fold(const void* f, const void* T, const void* P,
                           void* fo, void* To, int n, void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kB4LaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(dbl_fold_kernel), s.bytes, allowed);
  if (err != 0) return err;
  dbl_fold_kernel<<<s.blocks, s.threads, s.bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      in(f), in(T), in(P), out(fo), out(To), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_add_fold(const void* f, const void* T, const void* Q,
                           const void* P, void* fo, void* To, int n,
                           void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kB5LaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(add_fold_kernel), s.bytes, allowed);
  if (err != 0) return err;
  add_fold_kernel<<<s.blocks, s.threads, s.bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      in(f), in(T), in(Q), in(P), out(fo), out(To), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_dbl_step(const void* T, const void* P, void* To, void* line,
                           int n, void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kDblStepLaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(dbl_step_kernel), s.bytes, allowed);
  if (err != 0) return err;
  dbl_step_kernel<<<s.blocks, s.threads, s.bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      in(T), in(P), out(To), out(line), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_add_step(const void* T, const void* Q, const void* P,
                           void* To, void* line, int n, void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kAddStepLaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(add_step_kernel), s.bytes, allowed);
  if (err != 0) return err;
  add_step_kernel<<<s.blocks, s.threads, s.bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      in(T), in(Q), in(P), out(To), out(line), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_f_sqr_fold(const void* f, const void* line, void* fo, int n,
                             void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s =
      tc::grp::group_shape(n, tc::grp::kFSqrFoldLaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(f_sqr_fold_kernel), s.bytes, allowed);
  if (err != 0) return err;
  f_sqr_fold_kernel<<<s.blocks, s.threads, s.bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      in(f), in(line), out(fo), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_f_fold(const void* f, const void* line, void* fo, int n,
                         void* stream) {
  if (n <= 0) return 0;
  static int allowed = 0;
  const tc::grp::Shape s = tc::grp::group_shape(n, tc::grp::kFFoldLaneWords);
  const int err = tc::grp::allow_scratch(
      reinterpret_cast<const void*>(f_fold_kernel), s.bytes, allowed);
  if (err != 0) return err;
  f_fold_kernel<<<s.blocks, s.threads, s.bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      in(f), in(line), out(fo), n, s.shift);
  return static_cast<int>(cudaGetLastError());
}
