// The fused Miller-loop kernels B4 `dbl_fold` and B5 `add_fold`, and the
// unfused Miller pieces B17, for sm_90a, one thread per lane.
//
// B4 `dbl_fold_kernel` replaces threshold_crypto_tpu/device/pallas_tower.py
// `_k_dbl_fold` (:906): T ← 2T and f ← f²·l_tangent(P) in one launch. B5
// `add_fold_kernel` replaces `_k_add_fold` (:918): T ← T + Q and
// f ← f·l_chord(P). The driver runs B4 on each of the 63 bits of |x| after
// the first and B5 on its five 1-bits, over every pair of the batch.
//
// Layout. Packed limb-major int32[k·24, n] (tower.cuh): f k = 12, T k = 6,
// Q k = 4, P k = 2; thread `lane` reads column `lane` of every row, so a
// warp reads 32 neighbouring words per row. Outputs are separate tensors.
//
// What bounds it. B4 runs 122 Fq products per lane (36 for f², 47 for the
// doubling and its line, 39 for the sparse fold; the JAX kernel's 127 less
// one for each of its five Fq2 squares, which run here as 2-product
// squares) against 912 rows × 4 bytes of traffic: 71,736 32-bit IMAD
// results against 3,648 bytes, so the multiply issue rate bounds it, by
// about 3.9× over the bytes on an H100 SXM. B5 runs 80 products (41 + 39)
// against 4,032 bytes, also bound by the multiplies (2.3×). The design
// keeps f, T and every intermediate of the iteration in the thread's
// registers and local memory: one read and one write of f and T per
// iteration, as the TPU kernel kept them in VMEM. At 16,384 lanes and 128
// threads per block the grid is 128 blocks on 132 SMs, one block each: the
// card is not filled, and the 4 warps per SM do not hide the multiply
// latency. Occupancy is a later change's work.
//
// B17 replaces the four unfused pieces of the same file: `_k_dbl_step`
// (:886, T ← 2T and the tangent line out), `_k_add_step` (:895, T ← T + Q
// and the chord line out), `_k_f_sqr_fold` (:940, f ← f²·line) and
// `_k_f_fold` (:948, f ← f·line). The line leaves as int32[144, n] in the
// JAX kernel's plane order (c0, c1, c4; re then im). B4 is `dbl_step` then
// `f_sqr_fold`, B5 `add_step` then `f_fold`, bit for bit: the same tower
// functions in the same order, cut where the line is written. Split, each
// iteration moves one more line through device memory (1,152 bytes a lane
// out, then in), and each piece is bound by its multiplies as B4/B5 are:
// dbl_step 47 Fq products against 1,920 bytes a lane, add_step 41 against
// 2,304, f_sqr_fold 75 against 2,880 and f_fold 39 against 2,880. No JAX
// path calls the pieces; the port's composition check drives a whole
// Miller loop through them against B4/B5.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0, so a launch refused for its registers
// or stack is never silent.

#include <cstdint>
#include <cuda_runtime.h>

#include "tower.cuh"

namespace {

using tc::kThreads;

__global__ void __launch_bounds__(kThreads)
dbl_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ T,
                const int32_t* __restrict__ P, int32_t* __restrict__ fo,
                int32_t* __restrict__ To, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::dbl_fold_lane(f, T, P, fo, To, n, lane);
}

__global__ void __launch_bounds__(kThreads)
add_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ T,
                const int32_t* __restrict__ Q, const int32_t* __restrict__ P,
                int32_t* __restrict__ fo, int32_t* __restrict__ To, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::add_fold_lane(f, T, Q, P, fo, To, n, lane);
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
  dbl_fold_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      in(f), in(T), in(P), out(fo), out(To), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_add_fold(const void* f, const void* T, const void* Q,
                           const void* P, void* fo, void* To, int n,
                           void* stream) {
  if (n <= 0) return 0;
  add_fold_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      in(f), in(T), in(Q), in(P), out(fo), out(To), n);
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
