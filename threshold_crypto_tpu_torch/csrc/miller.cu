// The fused Miller-loop kernels B4 `dbl_fold` and B5 `add_fold`, and the
// unfused Miller pieces B17, for sm_90a.
//
// B4 `dbl_fold_kernel` replaces threshold_crypto_tpu/device/pallas_tower.py
// `_k_dbl_fold` (:906): T ← 2T and f ← f²·l_tangent(P) in one launch. B5
// `add_fold_kernel` replaces `_k_add_fold` (:918): T ← T + Q and
// f ← f·l_chord(P). The driver runs B4 on each of the 63 bits of |x| after
// the first and B5 on its five 1-bits, over every pair of the batch.
//
// Layout. Packed limb-major int32[k·24, n] (tower.cuh): f k = 12, T k = 6,
// Q k = 4, P k = 2. Outputs are separate tensors.
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
// B17 runs one thread per lane on tower.cuh (`__noinline__` tower
// functions over the engine of fq.cuh), every intermediate in the thread's
// registers and local memory: one read and one write of T and the line
// per piece.
//
// B17 replaces the four unfused pieces of the same file: `_k_dbl_step`
// (:886, T ← 2T and the tangent line out), `_k_add_step` (:895, T ← T + Q
// and the chord line out), `_k_f_sqr_fold` (:940, f ← f²·line) and
// `_k_f_fold` (:948, f ← f·line). The line leaves as int32[144, n] in the
// JAX kernel's plane order (c0, c1, c4; re then im). B4 is `dbl_step` then
// `f_sqr_fold`, B5 `add_step` then `f_fold`, bit for bit: the same field
// elements, cut where the line is written. Split, each
// iteration moves one more line through device memory (1,152 bytes a lane
// out, then in), and each piece is bound by its multiplies as B4/B5 are:
// dbl_step 47 Fq products against 1,920 bytes a lane, add_step 41 against
// 2,304, f_sqr_fold 75 against 2,880 and f_fold 39 against 2,880. No JAX
// path calls the pieces; the port's composition check drives a whole
// Miller loop through them against B4/B5.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0, so a launch refused for its registers,
// stack or shared memory is never silent.

#include <cstdint>
#include <cuda_runtime.h>

#include "tower.cuh"
#include "tower_group.cuh"

namespace {

using tc::kThreads;

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

__global__ void __launch_bounds__(kThreads)
dbl_step_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ P,
                int32_t* __restrict__ To, int32_t* __restrict__ line, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::dbl_step_lane(T, P, To, line, n, lane);
}

__global__ void __launch_bounds__(kThreads)
add_step_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ Q,
                const int32_t* __restrict__ P, int32_t* __restrict__ To,
                int32_t* __restrict__ line, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::add_step_lane(T, Q, P, To, line, n, lane);
}

__global__ void __launch_bounds__(kThreads)
f_sqr_fold_kernel(const int32_t* __restrict__ f,
                  const int32_t* __restrict__ line, int32_t* __restrict__ fo,
                  int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::f_sqr_fold_lane(f, line, fo, n, lane);
}

__global__ void __launch_bounds__(kThreads)
f_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ line,
              int32_t* __restrict__ fo, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::f_fold_lane(f, line, fo, n, lane);
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

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
  dbl_step_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      in(T), in(P), out(To), out(line), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_add_step(const void* T, const void* Q, const void* P,
                           void* To, void* line, int n, void* stream) {
  if (n <= 0) return 0;
  add_step_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      in(T), in(Q), in(P), out(To), out(line), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_f_sqr_fold(const void* f, const void* line, void* fo, int n,
                             void* stream) {
  if (n <= 0) return 0;
  f_sqr_fold_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      in(f), in(line), out(fo), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_f_fold(const void* f, const void* line, void* fo, int n,
                         void* stream) {
  if (n <= 0) return 0;
  f_fold_kernel<<<grid_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      in(f), in(line), out(fo), n);
  return static_cast<int>(cudaGetLastError());
}
