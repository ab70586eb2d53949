// The scalar field Fr of BLS12-381 on the engine of fq.cuh, and the
// per-lane body of B14 (lagrange_rowprod), the all-pairs Lagrange
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
// An Fr product is 2·8² 32×32→64-bit multiply-adds plus 8 low multiplies:
// 264 32-bit IMAD results. The sweep is inlined into the kernel: 8 words
// are few enough that the operands stay in registers.
//
// Layout. Fr values are the public row-major int32[N, 16] of 16-bit limbs
// (load_row / store_row of fq.cuh pack two limbs into a word).
//
// The field's constants (r, −r⁻¹ mod 2^32, R mod r) are those of
// ladder_engine.cuh's `reg::FrField`, the descriptor B1 and B2 use.

#pragma once

#include "fq.cuh"
#include "ladder_engine.cuh"

namespace tc {

using reg::FrField;

constexpr int kFrWords = FrField::kWords;
constexpr int kFrLimbs = 2 * kFrWords;  // 16-bit limbs of the public layout

__constant__ Modulus<kFrWords> kFr = {
    {FrField::p(0), FrField::p(1), FrField::p(2), FrField::p(3),
     FrField::p(4), FrField::p(5), FrField::p(6), FrField::p(7)},
    FrField::kN0,
    {FrField::one(0), FrField::one(1), FrField::one(2), FrField::one(3),
     FrField::one(4), FrField::one(5), FrField::one(6), FrField::one(7)},
};

struct Fr {
  uint32_t w[kFrWords];
};

// r = a·b·R^-1 mod r. r may alias a or b.
__device__ __forceinline__ void fr_mul(Fr& r, const Fr& a, const Fr& b) {
  mont_mul<kFrWords>(r.w, a.w, b.w, kFr);
}

// r = (a − b) mod r. r may alias a or b.
__device__ __forceinline__ void fr_sub(Fr& r, const Fr& a, const Fr& b) {
  mod_sub<kFrWords>(r.w, a.w, b.w, kFr);
}

__device__ __forceinline__ bool fr_is_zero(const Fr& a) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < kFrWords; ++k) any |= a.w[k];
  return any == 0;
}

__device__ __forceinline__ void fr_set_one(Fr& a) {
#pragma unroll
  for (int k = 0; k < kFrWords; ++k) a.w[k] = kFr.one[k];
}

// Lane i of a row-major [n, 16] tensor.
__device__ __forceinline__ void load_fr(Fr& x, const int32_t* xs, int i) {
  load_row<kFrWords>(xs + static_cast<size_t>(i) * kFrLimbs, x.w);
}

__device__ __forceinline__ void store_fr(int32_t* dst, const Fr& x, int i) {
  store_row<kFrWords>(dst + static_cast<size_t>(i) * kFrLimbs, x.w);
}

// The j-sweep of B14 for one lane i: for each of the m values xj[0..m),
// acc ·= (x_j − x_i) where the difference is not zero, and zc += 1 where it
// is (the diagonal j = i, and any x_j equal to x_i). The branch diverges
// only on those lanes.
__device__ __forceinline__ void lagr_sweep(Fr& acc, int& zc, const Fr& xi,
                                           const Fr* xj, int m) {
  for (int j = 0; j < m; ++j) {
    Fr d;
    fr_sub(d, xj[j], xi);
    if (fr_is_zero(d)) {
      ++zc;
    } else {
      fr_mul(acc, acc, d);
    }
  }
}

}  // namespace tc
