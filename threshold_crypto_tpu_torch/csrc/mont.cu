// Montgomery product (B1) and fixed-exponent power (B2) over BLS12-381 Fq
// and Fr, one thread per lane, for sm_90a.
//
// B1 `mont_mul_kernel` replaces threshold_crypto_tpu/device/pallas_mont.py
// `_mul_kernel`; B2 `mont_pow_kernel` replaces `_pow_kernel` there.
//
// Layout. A lane is an element as the Python side holds it: int32[L] of
// 16-bit limbs, least significant first (L = 24 for Fq, 16 for Fr), lanes
// row-major [N, L]. Each thread packs its limbs into S = L/2 32-bit words.
// R = 2^(16 L) = 2^(32 S) either way, so the Montgomery form and the
// canonical output are bit-identical with the TPU kernel's.
//
// Arithmetic. The engine of fq.cuh (B3), shared with the tower kernels:
// CIOS (coarsely integrated operand scanning) on 32-bit words with 64-bit
// accumulation: S rounds of t += a·b_i, then t += q·p with
// q = t_0·(−p⁻¹) mod 2^32 and a one-word shift; t < 2p at the end, and one
// conditional subtract of p makes it canonical.
//
// What bounds it. Per product: 2·S² 32×32→64-bit multiply-adds (two
// 32-bit IMAD results each) plus S low multiplies; at S = 12 that is 588
// IMAD results against 3·96 bytes moved. On an H100 SXM (3.35 TB/s; 64
// IMAD results per clock per SM, 132 SMs at 1.98 GHz) the bytes take about
// 2.4× as long as the multiplies: the product kernel is bound by memory
// traffic, with the 32-bit integer multiply issue rate the other side.
// The row-major [N, L] loads are not coalesced (each thread reads its own
// 96 bytes); a later change may go limb-major. The power kernel reads and
// writes one element per lane and runs up to 2 products per exponent bit:
// it is bound by the multiply issue rate.
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

using tc::kThreads;
using tc::Modulus;

template <int S>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int n, const Modulus<S> m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t off = static_cast<size_t>(lane) * (2 * S);
  uint32_t x[S], y[S];
  tc::load_row<S>(a + off, x);
  tc::load_row<S>(b + off, y);
  tc::mont_mul<S>(x, x, y, m);
  tc::store_row<S>(out + off, x);
}

// acc = a^e, e given MSB first as bits[0..nbits). Every lane reads the same
// bit, so the branch is warp-uniform. acc starts at 1, so 0^e = 0.
template <int S>
__global__ void __launch_bounds__(kThreads)
mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                int n, const int32_t* __restrict__ bits, int nbits,
                const Modulus<S> m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t off = static_cast<size_t>(lane) * (2 * S);
  uint32_t base[S], acc[S];
  tc::load_row<S>(a + off, base);
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = m.one[k];
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    tc::mont_mul<S>(acc, acc, acc, m);
    if (bits[i]) tc::mont_mul<S>(acc, acc, base, m);
  }
  tc::store_row<S>(out + off, acc);
}

// mod = p words[S], n0, one words[S] (host memory).
template <int S>
Modulus<S> modulus_from(const uint32_t* mod) {
  Modulus<S> m;
  for (int k = 0; k < S; ++k) m.p[k] = mod[k];
  m.n0 = mod[S];
  for (int k = 0; k < S; ++k) m.one[k] = mod[S + 1 + k];
  return m;
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int tc_mont_mul(const void* a, const void* b, void* out, int n,
                           int words, const uint32_t* mod, void* stream) {
  if (n <= 0) return 0;
  const auto* ap = static_cast<const int32_t*>(a);
  const auto* bp = static_cast<const int32_t*>(b);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (words == 12) {
    mont_mul_kernel<12><<<grid_for(n), kThreads, 0, s>>>(
        ap, bp, op, n, modulus_from<12>(mod));
  } else if (words == 8) {
    mont_mul_kernel<8><<<grid_for(n), kThreads, 0, s>>>(
        ap, bp, op, n, modulus_from<8>(mod));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_mont_pow(const void* a, void* out, int n, const void* bits,
                           int nbits, int words, const uint32_t* mod,
                           void* stream) {
  if (n <= 0) return 0;
  const auto* ap = static_cast<const int32_t*>(a);
  auto* op = static_cast<int32_t*>(out);
  const auto* bp = static_cast<const int32_t*>(bits);
  auto s = static_cast<cudaStream_t>(stream);
  if (words == 12) {
    mont_pow_kernel<12><<<grid_for(n), kThreads, 0, s>>>(
        ap, op, n, bp, nbits, modulus_from<12>(mod));
  } else if (words == 8) {
    mont_pow_kernel<8><<<grid_for(n), kThreads, 0, s>>>(
        ap, op, n, bp, nbits, modulus_from<8>(mod));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
