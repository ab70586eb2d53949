// Kernel B14, lagrange_rowprod, for sm_90a: the all-pairs Lagrange
// denominators of the threshold combine.
//
// Replaces threshold_crypto_tpu/device/pallas_fr.py `_mk_lagr_kernel`
// (:244, launched by `_rowprod_call` :266; cell `_cell` :203): for every i,
// Π_{j≠i}(x_j − x_i) mod r over Montgomery Fr values, and zcnt[i], the
// number of j (the diagonal included) with x_j == x_i. TPU lanes cannot
// gather, so the TPU kernel rotated a j-tile across lanes and sublanes
// (a systolic sweep of 1024 steps per tile pair) and carried the product
// over a sequential (i-block × j-block) grid in VMEM. Here a thread owns
// one i and reads the j values from shared memory, where every thread of a
// block reads the same word at once (a broadcast).
//
// Grid. blockIdx.x picks 128 i lanes; blockIdx.y picks a chunk of the j
// range (`chunk` values, a multiple of 128), which the block stages 128 at
// a time in shared memory, so the x values are read from device memory
// once per block. CUDA blocks run in no order, so each chunk writes its own
// partial product and count: prod [S, n, 16], cnt [S, n] with
// S = ⌈n / chunk⌉. The wrapper folds the S partial products with B1
// products and sums the counts (device/cuda_fr.py). Without the j split,
// n = 4096 would give 32 blocks for 132 SMs; with chunk = 128 it gives
// 32 × 32.
//
// What bounds it. n² Fr products of 264 IMAD results (less one per zero
// difference) against 16·4·n bytes read and (S·(16 + 1)·4)·n written: the
// integer multiply issue rate bounds it by far (n = 4096: 16.8 M products).
// The product is the register engine's carry-save one (fr.cuh), its
// operands in registers; a thread runs kLagrAccs product chains (fr.cuh
// `lagr_sweep`), folded into one at the end of its chunk.
//
// The launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

using tc::kLagrAccs;
using tc::kThreads;

__global__ void __launch_bounds__(kThreads)
lagr_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ prod,
            int32_t* __restrict__ cnt, int n, int chunk) {
  __shared__ tc::Fr tile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(n, j0 + chunk);
  tc::Fr xi, acc[kLagrAccs];
  int zc = 0;
#pragma unroll
  for (int a = 0; a < kLagrAccs; ++a) tc::fr_set_one(acc[a]);
  if (i < n) {
    tc::load_fr(xi, xs, i);
  } else {
    xi = acc[0];
  }
  // Every thread of the block takes part in the staging, the lanes past n
  // included, so no thread leaves before a barrier.
  for (int t = j0; t < j1; t += kThreads) {
    const int m = min(kThreads, j1 - t);
    __syncthreads();
    if (threadIdx.x < m) tc::load_fr(tile[threadIdx.x], xs, t + threadIdx.x);
    __syncthreads();
    if (i < n) tc::lagr_sweep(acc, zc, xi, tile, m);
  }
  if (i < n) {
    tc::Fr p;
    tc::lagr_fold(p, acc);
    tc::store_fr(prod + static_cast<size_t>(blockIdx.y) * n * tc::kFrLimbs,
                 p, i);
    cnt[static_cast<size_t>(blockIdx.y) * n + i] = zc;
  }
}

}  // namespace

extern "C" int tc_lagrange_rowprod(const void* xs, void* prod, void* cnt,
                                   int n, int chunk, void* stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || chunk % tc::kThreads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + tc::kThreads - 1) / tc::kThreads,
                  (n + chunk - 1) / chunk);
  lagr_kernel<<<grid, tc::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(prod),
      static_cast<int32_t*>(cnt), n, chunk);
  return static_cast<int>(cudaGetLastError());
}
