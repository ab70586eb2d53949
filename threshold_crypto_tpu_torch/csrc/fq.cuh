// B3's first engine: per-lane Montgomery arithmetic over BLS12-381 Fq
// (and, for B14's Fr in fr.cuh, any field of S 32-bit words). No launcher
// runs its `__noinline__` field functions any more: B3's test entry runs
// on ladder_engine.cuh's `reg::` field (`engine_lane_r`), as every
// redesigned kernel does. They stay as the engine of tower.cuh's and
// curve.cuh's old bodies, which the g++ harnesses and tools/*_variants.py
// hold the kernels against; `load_row` / `store_row`, `Modulus` and
// `kThreads` still serve mont.cu, fr.cuh and keccak.cu.
//
// Replaces the stacked in-kernel engine of threshold_crypto_tpu/device/
// pallas_tower.py: `_k_mul16` (:140) / `_k_mul13` (:197) and `k_add`,
// `k_sub`, `k_neg`, `k_small` (:253-323). The TPU engine ran 16- or 13-bit
// limbs across the vector lanes because its VPU has no carry flag and no
// wide multiply; here each thread owns one lane and works on S 32-bit words
// with 64-bit accumulation. R = 2^(32 S) = 2^384 for Fq, which is the
// public form already, so no engine-form conversion is needed and every
// result is the canonical value the TPU kernels produce.
//
// What bounds it. A product is S² 32×32→64-bit multiply-adds for a·b and
// S² + S for the reduction (588 32-bit IMAD results at S = 12), against
// 3·48 bytes of operands in registers or local memory: inside the tower
// kernels the engine is bound by the integer multiply issue rate. `fq_mul`,
// `fq_add`, `fq_sub` and `fq_neg` are __noinline__ so that each kernel holds
// one copy of each and ptxas compiles a few hundred instructions per
// function instead of tens of thousands of unrolled ones; the price is
// operands in local memory (L1-cached) and a call per operation.
//
// Layouts. B14 reads lanes row-major ([N, 2S] int32 16-bit limbs); the
// tower kernels read the packed limb-major layout [k·24, N] (row c·24 + l
// holds limb l of component c for every lane), so neighbouring threads read
// neighbouring addresses. Two 16-bit limbs become one 32-bit word on load;
// only the low 16 bits of each int32 are read.

#pragma once

#include <cstdint>

namespace tc {

constexpr int kThreads = 128;

template <int S>
struct Modulus {
  uint32_t p[S];    // the modulus, 32-bit words, least significant first
  uint32_t n0;      // -p^-1 mod 2^32
  uint32_t one[S];  // R mod p: 1 in Montgomery form
};

// ---------------------------------------------------------------------------
// Generic S-word arithmetic (inlined into its caller)
// ---------------------------------------------------------------------------

template <int S>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         uint32_t (&w)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint32_t lo = static_cast<uint32_t>(src[2 * k]) & 0xFFFFu;
    const uint32_t hi = static_cast<uint32_t>(src[2 * k + 1]);
    w[k] = lo | (hi << 16);
  }
}

template <int S>
__device__ __forceinline__ void store_row(int32_t* __restrict__ dst,
                                          const uint32_t (&w)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    dst[2 * k] = static_cast<int32_t>(w[k] & 0xFFFFu);
    dst[2 * k + 1] = static_cast<int32_t>(w[k] >> 16);
  }
}

// r = a·b·R^-1 mod p for a, b < p (CIOS: S rounds of t += a·b_i, then
// t += q·p with q = t_0·n0 and a one-word shift; t < 2p at the end, and one
// conditional subtract of p makes it canonical). r may alias a or b: it is
// written last.
template <int S>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[S],
                                         const uint32_t (&a)[S],
                                         const uint32_t (&b)[S],
                                         const Modulus<S>& m) {
  uint32_t t[S + 2];
#pragma unroll
  for (int j = 0; j < S + 2; ++j) t[j] = 0;

#pragma unroll
  for (int i = 0; i < S; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      c += static_cast<uint64_t>(a[j]) * b[i] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[S];
    t[S] = static_cast<uint32_t>(c);
    t[S + 1] = static_cast<uint32_t>(c >> 32);

    const uint32_t q = t[0] * m.n0;
    c = (static_cast<uint64_t>(q) * m.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < S; ++j) {
      c += static_cast<uint64_t>(q) * m.p[j] + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[S];
    t[S - 1] = static_cast<uint32_t>(c);
    t[S] = t[S + 1] + static_cast<uint32_t>(c >> 32);
  }

  // t < 2p: subtract p unless that borrows out of the top word.
  uint32_t d[S];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const uint64_t x = static_cast<uint64_t>(t[j]) - m.p[j] - borrow;
    d[j] = static_cast<uint32_t>(x);
    borrow = static_cast<uint32_t>(x >> 63);
  }
  const bool take = (t[S] != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < S; ++j) r[j] = take ? d[j] : t[j];
}

// r = (a + b) mod p for a, b < p. r may alias a or b.
template <int S>
__device__ __forceinline__ void mod_add(uint32_t (&r)[S],
                                        const uint32_t (&a)[S],
                                        const uint32_t (&b)[S],
                                        const Modulus<S>& m) {
  uint32_t s[S], d[S];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    c += static_cast<uint64_t>(a[j]) + b[j];
    s[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  const uint32_t over = static_cast<uint32_t>(c);
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const uint64_t x = static_cast<uint64_t>(s[j]) - m.p[j] - borrow;
    d[j] = static_cast<uint32_t>(x);
    borrow = static_cast<uint32_t>(x >> 63);
  }
  const bool take = (over != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < S; ++j) r[j] = take ? d[j] : s[j];
}

// r = (a − b) mod p for a, b < p. r may alias a or b.
template <int S>
__device__ __forceinline__ void mod_sub(uint32_t (&r)[S],
                                        const uint32_t (&a)[S],
                                        const uint32_t (&b)[S],
                                        const Modulus<S>& m) {
  uint32_t d[S];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const uint64_t x = static_cast<uint64_t>(a[j]) - b[j] - borrow;
    d[j] = static_cast<uint32_t>(x);
    borrow = static_cast<uint32_t>(x >> 63);
  }
  // On a borrow add p back; the mask keeps the code free of data branches.
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    c += static_cast<uint64_t>(d[j]) + (m.p[j] & mask);
    r[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

// r = −a mod p (0 stays 0). r may alias a.
template <int S>
__device__ __forceinline__ void mod_neg(uint32_t (&r)[S],
                                        const uint32_t (&a)[S],
                                        const Modulus<S>& m) {
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) any |= a[j];
  const uint32_t mask = any ? 0xFFFFFFFFu : 0u;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const uint64_t x = static_cast<uint64_t>(m.p[j]) - a[j] - borrow;
    r[j] = static_cast<uint32_t>(x) & mask;
    borrow = static_cast<uint32_t>(x >> 63);
  }
}

// ---------------------------------------------------------------------------
// BLS12-381 Fq: S = 12, R = 2^384
// ---------------------------------------------------------------------------

constexpr int kFqWords = 12;
constexpr int kFqLimbs = 24;  // 16-bit limbs of the public layout

__constant__ Modulus<kFqWords> kFq = {
    {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
     0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
     0x397fe69au, 0x1a0111eau},
    0xfffcfffdu,
    {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
     0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
     0xfa80e493u, 0x15f65ec3u},
};

struct Fq {
  uint32_t w[kFqWords];
};

__device__ __noinline__ void fq_mul(Fq& r, const Fq& a, const Fq& b) {
  mont_mul<kFqWords>(r.w, a.w, b.w, kFq);
}

__device__ __noinline__ void fq_add(Fq& r, const Fq& a, const Fq& b) {
  mod_add<kFqWords>(r.w, a.w, b.w, kFq);
}

__device__ __noinline__ void fq_sub(Fq& r, const Fq& a, const Fq& b) {
  mod_sub<kFqWords>(r.w, a.w, b.w, kFq);
}

__device__ __noinline__ void fq_neg(Fq& r, const Fq& a) {
  mod_neg<kFqWords>(r.w, a.w, kFq);
}

// r = k·a for a small static k ≥ 1, by the addition tree of the JAX
// package's `k_small` / `mont.mul_small`. r may alias a.
__device__ __forceinline__ void fq_small(Fq& r, const Fq& a, int k) {
  Fq acc = a, res = a;
  bool have = false;
  while (k) {
    if (k & 1) {
      if (have) {
        fq_add(res, res, acc);
      } else {
        res = acc;
        have = true;
      }
    }
    k >>= 1;
    if (k) fq_add(acc, acc, acc);
  }
  r = res;
}

// Limb-major loads and stores of Fq values: component c of a packed
// [k·24, n] tensor for one lane.
__device__ __forceinline__ void load_fq(Fq& x, const int32_t* __restrict__ src,
                                        int c, int n, int lane) {
  const int32_t* row = src + static_cast<size_t>(c) * kFqLimbs * n + lane;
#pragma unroll
  for (int k = 0; k < kFqWords; ++k) {
    const uint32_t lo =
        static_cast<uint32_t>(row[static_cast<size_t>(2 * k) * n]) & 0xFFFFu;
    const uint32_t hi =
        static_cast<uint32_t>(row[static_cast<size_t>(2 * k + 1) * n]);
    x.w[k] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void store_fq(int32_t* __restrict__ dst,
                                         const Fq& x, int c, int n, int lane) {
  int32_t* row = dst + static_cast<size_t>(c) * kFqLimbs * n + lane;
#pragma unroll
  for (int k = 0; k < kFqWords; ++k) {
    row[static_cast<size_t>(2 * k) * n] =
        static_cast<int32_t>(x.w[k] & 0xFFFFu);
    row[static_cast<size_t>(2 * k + 1) * n] =
        static_cast<int32_t>(x.w[k] >> 16);
  }
}

}  // namespace tc
