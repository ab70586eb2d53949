// The Fq12 kernels of the final exponentiation, B6-B9, and the test entry
// of the engine B3, for sm_90a, one thread per lane.
//
// B6 `cyclo_sqr_kernel` replaces threshold_crypto_tpu/device/
// pallas_tower.py `_k_cyclo_sqr` (:956), the Granger-Scott squaring; with a
// second operand it is B7, `_k_cyclo_sqr_mul` (:932), acc²·g, the 1-bit
// step of exp-by-x. B8 `fq12_mul_kernel` replaces `_k_fq12_mul` (:960);
// without a second operand it is B9, `_k_fq12_sqr` (:964). `engine_kernel`
// runs B3 (fq.cuh, replacing `_k_mul16`/`_k_mul13` and `k_add`, `k_sub`,
// `k_neg`, `k_small`, :140-323) on its own: B3 has no launch of its own on
// the path, so this entry is how it is held against the plain field
// operations.
//
// Layout. Packed limb-major int32[12·24, n] Fq12 values (tower.cuh);
// neighbouring threads read neighbouring words.
//
// What bounds it. Per lane, B6 runs 18 Fq products (10,584 IMAD results)
// against 2 × 1,152 bytes, B7 72 products against 3 × 1,152 bytes, B8 54
// against 3 × 1,152 and B9 36 against 2 × 1,152: on an H100 SXM the
// multiply issue rate bounds B7-B9, and B6 sits near the balance point
// (its bytes take about as long as its products). f and every intermediate
// stay in the thread's registers and local memory. At 8,192 lanes and 128
// threads per block the grid is 64 blocks on 132 SMs: half the card idles.
// Occupancy is a later change's work.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "tower.cuh"

namespace {

using tc::kThreads;

// g == nullptr: B6; else B7.
__global__ void __launch_bounds__(kThreads)
cyclo_sqr_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ g,
                 int32_t* __restrict__ fo, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::cyclo_sqr_lane(f, g, fo, n, lane);
}

// b == nullptr: B9; else B8.
__global__ void __launch_bounds__(kThreads)
fq12_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ fo, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::fq12_mul_lane(a, b, fo, n, lane);
}

__global__ void __launch_bounds__(kThreads)
engine_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, int m, int k, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::engine_lane(a, b, out, m, k, n, lane);
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* out(void* p) { return static_cast<int32_t*>(p); }

int launch_cyclo(const void* f, const void* g, void* fo, int n, void* stream) {
  if (n <= 0) return 0;
  cyclo_sqr_kernel<<<grid_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(in(f), in(g),
                                                          out(fo), n);
  return static_cast<int>(cudaGetLastError());
}

int launch_mul(const void* a, const void* b, void* fo, int n, void* stream) {
  if (n <= 0) return 0;
  fq12_mul_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(in(a), in(b),
                                                         out(fo), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tc_cyclo_sqr(const void* f, void* fo, int n, void* stream) {
  return launch_cyclo(f, nullptr, fo, n, stream);
}

extern "C" int tc_cyclo_sqr_mul(const void* f, const void* g, void* fo, int n,
                                void* stream) {
  return launch_cyclo(f, g, fo, n, stream);
}

extern "C" int tc_fq12_mul(const void* a, const void* b, void* fo, int n,
                           void* stream) {
  return launch_mul(a, b, fo, n, stream);
}

extern "C" int tc_fq12_sqr(const void* a, void* fo, int n, void* stream) {
  return launch_mul(a, nullptr, fo, n, stream);
}

extern "C" int tc_fq_engine(const void* a, const void* b, void* out_, int m,
                            int k, int n, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  engine_kernel<<<grid_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(in(a), in(b), out(out_),
                                                       m, k, n);
  return static_cast<int>(cudaGetLastError());
}
