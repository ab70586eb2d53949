// B12 `sha3_chunks_kernel` for sm_90a: SHA3-256 of K independent 2176-byte
// chunks, one thread per chunk.
//
// Replaces threshold_crypto_tpu/device/keccak.py `_k_sha3` (:197, launched
// by `_sha3_chunks_pallas` :237), which walked a sequential (chunk block,
// permutation) grid with the [50, 8, 128] half-lane state in VMEM scratch.
// Here each thread keeps its chunk's state in registers for all 17
// permutations (keccak.cuh), so nothing is carried between blocks and the
// grid order does not matter.
//
// What bounds it. Per chunk, 2,176 bytes in and 32 out, against 17
// permutations of 24 rounds of 126 64-bit xor/and/not and 29 rotations
// (theta 55 and 5, rho 24, chi 75, iota 1), each two 32-bit operations:
// 310 per round, 126,480 per chunk. At 64 such results per clock per SM
// that is about 11× the time of the chunk's bytes on an H100 SXM, so the
// integer issue rate bounds it. A thread reads its chunk as a row of 544 words, so
// the 32 threads of a warp read 32 rows 2,176 bytes apart: each 136-byte
// rate block is a few cache lines per thread, read whole through L1.
//
// The launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"
#include "keccak.cuh"

namespace {

using tc::kThreads;

__global__ void __launch_bounds__(kThreads)
sha3_chunks_kernel(const int32_t* __restrict__ words,
                   int32_t* __restrict__ out, int k) {
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk >= k) return;
  tc::sha3_chunk_lane(words, out, chunk);
}

}  // namespace

extern "C" int tc_sha3_chunks(const void* words, void* out, int k,
                              void* stream) {
  if (k <= 0) return 0;
  sha3_chunks_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), static_cast<int32_t*>(out), k);
  return static_cast<int>(cudaGetLastError());
}
