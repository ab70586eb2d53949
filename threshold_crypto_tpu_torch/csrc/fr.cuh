// The scalar field Fr of BLS12-381 on the register engine's product, and
// the per-lane body of B14 (lagrange_rowprod), the all-pairs Lagrange
// denominator sweep.
//
// Replaces the Fr engine of threshold_crypto_tpu/device/pallas_fr.py
// (`k_mul` :88, the 16×16-bit SOS Montgomery product; `k_sub` :141) and the
// body of its cell (:203): for one i, the product over the j of
// (x_j − x_i), a zero difference multiplying as 1 and counted instead. Here
// each thread owns one i and works on 8 32-bit words with 64-bit
// accumulation: R = 2^256 either way, so every product is the canonical
// Montgomery value the TPU kernel gives, in any order of the j.
//
// The product is ladder_engine.cuh's carry-save CIOS over `reg::FrField`
// (the one B1 and B2 run): per word of b, the 8 multiply-adds of a round
// do not depend on one another, where a carry chain through the words
// serialises them. The subtraction is the engine's carry chains. An Fr
// product is 2·8² 32×32→64-bit multiply-adds plus 8 low multiplies: 264
// 32-bit IMAD results, with the operands in registers.
//
// The sweep keeps K accumulators a lane (kLagrAccs): the j values of a tile
// go to them in turn, so K product chains can run side by side. A
// difference of zero multiplies as R mod r (1 in Montgomery form, so the
// product is unchanged) and adds one to the count: the K products of a
// step run without a branch, and the count is the diagonal's and any
// duplicate's, as before. `lagr_fold` multiplies the K accumulators
// together: a product over the same multiset of values is the same
// canonical value in any order.
//
// Layout. Fr values are the public row-major int32[N, 16] of 16-bit limbs
// (load_row / store_row of fq.cuh pack two limbs into a word).

#pragma once

#include "fq.cuh"
#include "ladder_engine.cuh"

namespace tc {

using reg::FrField;

constexpr int kFrWords = FrField::kWords;
constexpr int kFrLimbs = 2 * kFrWords;  // 16-bit limbs of the public layout

// B14's accumulators a lane: the product chains of `lagr_sweep` that run
// side by side. At N = 4096 one, two and four took 0.494, 0.501 and 0.517
// ms (NVIDIA H100 80GB HBM3, 700 W; tools/b15_variants.py): the warps of
// an SM already hide a product's latency there, and more chains only add
// registers (56, 62, 92).
constexpr int kLagrAccs = 1;

struct Fr {
  uint32_t w[kFrWords];
};

// r = a·b·R^-1 mod r. r may alias a or b.
__device__ __forceinline__ void fr_mul(Fr& r, const Fr& a, const Fr& b) {
  reg::mont_mul_words<FrField>(r.w, a.w, b.w);
}

// r = (a − b) mod r. r may alias a or b.
__device__ __forceinline__ void fr_sub(Fr& r, const Fr& a, const Fr& b) {
  reg::mod_sub_words<FrField>(r.w, a.w, b.w);
}

__device__ __forceinline__ bool fr_is_zero(const Fr& a) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < kFrWords; ++k) any |= a.w[k];
  return any == 0;
}

__device__ __forceinline__ void fr_set_one(Fr& a) {
#pragma unroll
  for (int k = 0; k < kFrWords; ++k) a.w[k] = FrField::one(k);
}

// Lane i of a row-major [n, 16] tensor.
__device__ __forceinline__ void load_fr(Fr& x, const int32_t* xs, int i) {
  load_row<kFrWords>(xs + static_cast<size_t>(i) * kFrLimbs, x.w);
}

__device__ __forceinline__ void store_fr(int32_t* dst, const Fr& x, int i) {
  store_row<kFrWords>(dst + static_cast<size_t>(i) * kFrLimbs, x.w);
}

// The j-sweep of B14 for one lane i over m values xj[0..m): value j
// multiplies acc[j mod K] by (x_j − x_i), or by R mod r where the
// difference is zero, and then adds one to zc (the diagonal j = i, and any
// x_j equal to x_i). A step of the loop takes K values; past m (the last
// step of a ragged tile) a slot multiplies by R mod r and counts nothing.
template <int K>
__device__ __forceinline__ void lagr_sweep(Fr (&acc)[K], int& zc,
                                           const Fr& xi, const Fr* xj,
                                           int m) {
  Fr one;
  fr_set_one(one);
#pragma unroll 1
  for (int j = 0; j < m; j += K) {
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const bool live = j + a < m;
      Fr d;
      fr_sub(d, xj[live ? j + a : m - 1], xi);
      const bool zero = fr_is_zero(d);
      zc += live && zero;
      if (!live || zero) d = one;
      fr_mul(acc[a], acc[a], d);
    }
  }
}

// out = the product of the K accumulators.
template <int K>
__device__ __forceinline__ void lagr_fold(Fr& out, const Fr (&acc)[K]) {
  out = acc[0];
#pragma unroll
  for (int a = 1; a < K; ++a) fr_mul(out, out, acc[a]);
}

}  // namespace tc
