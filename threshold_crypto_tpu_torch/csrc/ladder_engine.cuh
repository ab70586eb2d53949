// B13's register-resident G1/G2 engine, and the lane bodies on it: B13's
// `step4_lane_r` and B11's `winacc_lane_r`.
//
// Replaces, for kernels B13 (csrc/ladder.cu `step4_kernel`) and B11
// (csrc/msm.cu `winacc_kernel`), the formulas of
// threshold_crypto_tpu/device/pallas_curve.py `_msm_step_w4` (:355; kernel
// `_mk_step4_kernel` :385): per lane and base-16 digit d, T <- 16T, then
// T + table[d − 1] with the complete Jacobian add where d != 0; and of
// `_mk_winacc_kernel` (:534): per window w doublings, then the complete
// add of table[d − 1] for each lane an accumulator owns. The other curve
// kernels (B10, B15, B16) keep curve.cuh.
//
// What bounds it. Per digit 4 doublings (7 Fq products each in G1, 16 in
// G2) and, for d != 0, the general path of the complete add (16 / 44),
// against 288 (576) bytes of table entry a digit: the 32-bit multiply
// issue rate bounds it by far, as long as the operands stay in registers.
// curve.cuh's engine passes every operand and result of every field op
// through a per-thread local-memory frame (__noinline__ over struct
// references; 1,296 bytes for G1 B13), and its complete add computes the
// doubling branch on every lane and selects it (23 Fq products where the
// general path needs 16).
//
// What this engine does about it.
// * An Fq is 12 uint32_t in registers. The point formulas and the field
//   ops are __forceinline__; the one out-of-line function, the Montgomery
//   product `fp_mul_call`, takes its operands and returns its result by
//   value, and ptxas passes them in registers (0-byte frame). Nothing is
//   indexed at run time.
// * The product is CIOS with carry-save rounds, in inline PTX: per word
//   b_i, every word j of t + a·b_i (then of t + q·p) is one 32×32+64-bit
//   multiply-add, s_j = x_j·y + t_j + h_j < 2^64 (add.cc / addc, then
//   mad.lo.cc / madc.hi: one IMAD.WIDE), whose low word stays at j and
//   whose high word waits in h_{j+1} for the next step. The twelve words
//   of a step do not depend on one another, where a carry chain through
//   the words (mad.lo.cc / madc.hi.cc) serialises all of them. t_0 is
//   exact, so q = t_0·n0 is CIOS's. p < 2^381, so the running sum stays
//   below 2^414 and fits 13 words; one carry chain folds h in at the end
//   (the sum < 2p fits 12 words) and one conditional subtract gives the
//   canonical product, the value fq.cuh's mont_mul gives. Add and sub are
//   carry chains with one conditional subtract or add of p.
// * One copy of the product: inlined at the ladder's 23 product sites (the
//   doubling's 7, the add's 16), the unrolled product makes ~22 k SASS
//   instructions of G1 kernel, and instruction fetch rather than the
//   multiply rate sets the pace; out of line it is ~3.3 k, about half the
//   time at the DKG's launch shape (NVIDIA H100 80GB HBM3, 700 W;
//   tools/b13_variants.py).
// * The doubling case of the complete add (T == Q) is a branch, taken only
//   where h == 0 and r == 0 with neither point at infinity: T is left as it
//   is and one more doubling runs before the next digit's four (or after
//   the last digit), through the same doubling code. That doubling is
//   `jac_dbl`'s, whose formulas are those of the add's Xd, Yd, Zd, so the
//   result is the same, bit for bit, as the select of curve.cuh. The
//   T == −Q case and the infinity cases stay data selects, in curve.cuh's
//   order (T == −Q, then Q at infinity, then T at infinity).
// * The formulas are curve.cuh's (the JAX ones): the same products, small
//   multiples by curve.cuh's addition trees, squares as squares (Fq2: two
//   products). Every value is canonical, so every coordinate equals the
//   plain versions' limbs. They are scheduled so that few temporaries are
//   live at once; Q is read from the table where it is first used.
// * No function body returns early (an early return from a __noinline__
//   body was miscompiled for Fq on sm_90a by nvcc 12.9).
//
// Off the card (g++ behind stub qualifiers, for the tests) the same
// arithmetic runs in plain C++: `Chain` keeps the carry flag in a member,
// `mad_wide` is a 64-bit multiply-add. The PTX form is checked on the card
// by chip_smoke.py (phase 3).

#pragma once

#include <cstdint>

namespace tc {

struct Fq;
struct Fq2;

namespace reg {

constexpr int kWords = 12;  // 32-bit words of an Fq, least significant first
constexpr int kLimbs = 24;  // 16-bit limbs of the packed layout
constexpr uint32_t kN0 = 0xfffcfffdu;  // -p^-1 mod 2^32

// The BLS12-381 base field modulus p, word j.
__device__ __forceinline__ constexpr uint32_t p_word(int j) {
  switch (j) {
    case 0: return 0xffffaaabu;
    case 1: return 0xb9feffffu;
    case 2: return 0xb153ffffu;
    case 3: return 0x1eabfffeu;
    case 4: return 0xf6b0f624u;
    case 5: return 0x6730d2a0u;
    case 6: return 0xf38512bfu;
    case 7: return 0x64774b84u;
    case 8: return 0x434bacd7u;
    case 9: return 0x4b1ba7b6u;
    case 10: return 0x397fe69au;
    default: return 0x1a0111eau;
  }
}

// R mod p (1 in Montgomery form, R = 2^384), word j.
__device__ __forceinline__ constexpr uint32_t one_word(int j) {
  switch (j) {
    case 0: return 0x0002fffdu;
    case 1: return 0x76090000u;
    case 2: return 0xc40c0002u;
    case 3: return 0xebf4000bu;
    case 4: return 0x53c758bau;
    case 5: return 0x5f489857u;
    case 6: return 0x70525745u;
    case 7: return 0x77ce5853u;
    case 8: return 0xa256ec6du;
    case 9: return 0x5c071a97u;
    case 10: return 0xfa80e493u;
    default: return 0x15f65ec3u;
  }
}

// ---------------------------------------------------------------------------
// Carry chains and the wide multiply-add: PTX on the card, the same
// arithmetic in C++ elsewhere
// ---------------------------------------------------------------------------

#if defined(__CUDA_ARCH__)
// The carry flag is the condition-code register between consecutive
// instructions of a chain; `asm volatile` keeps the chain in order.
struct Chain {
  __device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
};

// (lo, hi) = a·b + c + d, which is < 2^64 for 32-bit a, b, c, d: c + d as
// a 33-bit (s, k), then one 32×32+64-bit multiply-add (IMAD.WIDE).
__device__ __forceinline__ void mad_wide(uint32_t& lo, uint32_t& hi,
                                         uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  asm("{\n\t.reg .u32 s, k;\n\t"
      "add.cc.u32 s, %2, %3;\n\t"
      "addc.u32 k, 0, 0;\n\t"
      "mad.lo.cc.u32 %0, %4, %5, s;\n\t"
      "madc.hi.u32 %1, %4, %5, k;\n\t}"
      : "=r"(lo), "=r"(hi) : "r"(c), "r"(d), "r"(a), "r"(b));
}
#else
// The PTX semantics in C++: `cf` is the carry flag (for sub, the borrow).
struct Chain {
  uint32_t cf = 0;
  __device__ __forceinline__ uint32_t put(uint64_t s) {
    cf = static_cast<uint32_t>(s >> 32) & 1u;
    return static_cast<uint32_t>(s);
  }
  __device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
    return put(static_cast<uint64_t>(a) + b);
  }
  __device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
    return put(static_cast<uint64_t>(a) + b + cf);
  }
  __device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
    return a + b + cf;
  }
  __device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
    return put(static_cast<uint64_t>(a) - b);
  }
  __device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
    return put(static_cast<uint64_t>(a) - b - cf);
  }
  __device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
    return a - b - cf;
  }
};

__device__ __forceinline__ void mad_wide(uint32_t& lo, uint32_t& hi,
                                         uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  const uint64_t v = static_cast<uint64_t>(a) * b + c + d;
  lo = static_cast<uint32_t>(v);
  hi = static_cast<uint32_t>(v >> 32);
}
#endif

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

struct Fp {
  uint32_t w[kWords];
};

// One step of a carry-save round: for every word j at once,
// s_j = x_j·y + t_j + h_j < 2^64, t_j <- lo s_j, h_{j+1} <- hi s_j; the top
// word t_12 takes h_12 (the sum stays below 2^414, so it cannot carry).
__device__ __forceinline__ void cs_step(uint32_t (&t)[kWords + 1],
                                        uint32_t (&h)[kWords + 1],
                                        const uint32_t (&x)[kWords],
                                        uint32_t y) {
  uint32_t hn[kWords + 1];
  hn[0] = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    mad_wide(t[j], hn[j + 1], x[j], y, t[j], h[j]);
  t[kWords] += h[kWords];
#pragma unroll
  for (int j = 0; j <= kWords; ++j) h[j] = hn[j];
}

// r = a·b·R^-1 mod p, canonical, for canonical a, b: CIOS in carry-save
// rounds. t + h is the running sum, word j worth t_j + h_j (each < 2^32).
// r may alias a or b: it is written last.
__device__ __forceinline__ void fp_mul_body(Fp& r, const Fp& a,
                                            const Fp& b) {
  uint32_t t[kWords + 1], h[kWords + 1], pw[kWords];
#pragma unroll
  for (int j = 0; j <= kWords; ++j) t[j] = h[j] = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) pw[j] = p_word(j);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    cs_step(t, h, a.w, b.w[i]);
    cs_step(t, h, pw, t[0] * kN0);     // t_0 becomes 0
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      t[j] = t[j + 1];
      h[j] = h[j + 1];
    }
    t[kWords] = h[kWords] = 0;
  }
  Chain c;
  uint32_t d[kWords];
  t[0] = c.add_cc(t[0], h[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) t[j] = c.addc_cc(t[j], h[j]);
  d[0] = c.sub_cc(t[0], p_word(0));
#pragma unroll
  for (int j = 1; j < kWords; ++j) d[j] = c.subc_cc(t[j], p_word(j));
  const uint32_t borrow = c.subc(0u, 0u);  // 0 or all ones
#pragma unroll
  for (int j = 0; j < kWords; ++j) r.w[j] = borrow ? t[j] : d[j];
}

// The product's one copy in the kernel; operands and result in registers.
__device__ __noinline__ Fp fp_mul_call(Fp a, Fp b) {
  Fp r;
  fp_mul_body(r, a, b);
  return r;
}

__device__ __forceinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  r = fp_mul_call(a, b);
}

// r = (a + b) mod p for canonical a, b (a + b < 2^382: no carry out).
__device__ __forceinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t s[kWords], d[kWords];
  Chain c;
  s[0] = c.add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) s[j] = c.addc_cc(a.w[j], b.w[j]);
  d[0] = c.sub_cc(s[0], p_word(0));
#pragma unroll
  for (int j = 1; j < kWords; ++j) d[j] = c.subc_cc(s[j], p_word(j));
  const uint32_t borrow = c.subc(0u, 0u);
#pragma unroll
  for (int j = 0; j < kWords; ++j) r.w[j] = borrow ? s[j] : d[j];
}

// r = (a − b) mod p for canonical a, b: on a borrow, p is added back (the
// carry out of that add is the 2^384 the borrow lent).
__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t d[kWords];
  Chain c;
  d[0] = c.sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) d[j] = c.subc_cc(a.w[j], b.w[j]);
  const uint32_t mask = c.subc(0u, 0u);
  r.w[0] = c.add_cc(d[0], p_word(0) & mask);
#pragma unroll
  for (int j = 1; j < kWords - 1; ++j)
    r.w[j] = c.addc_cc(d[j], p_word(j) & mask);
  r.w[kWords - 1] = c.addc(d[kWords - 1], p_word(kWords - 1) & mask);
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) any |= a.w[j];
  return any == 0;
}

__device__ __forceinline__ void fp_set(Fp& r, bool one) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) r.w[j] = one ? one_word(j) : 0u;
}

// Component c of a packed [k·24, n] tensor for one lane (two 16-bit limbs
// make one word; only the low 16 bits of each int32 are read).
__device__ __forceinline__ void fp_load(Fp& x,
                                        const int32_t* __restrict__ src,
                                        int c, int n, int lane) {
  const int32_t* row = src + static_cast<size_t>(c) * kLimbs * n + lane;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t lo =
        static_cast<uint32_t>(row[static_cast<size_t>(2 * k) * n]) & 0xFFFFu;
    const uint32_t hi =
        static_cast<uint32_t>(row[static_cast<size_t>(2 * k + 1) * n]);
    x.w[k] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void fp_store(int32_t* __restrict__ dst,
                                         const Fp& x, int c, int n,
                                         int lane) {
  int32_t* row = dst + static_cast<size_t>(c) * kLimbs * n + lane;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    row[static_cast<size_t>(2 * k) * n] =
        static_cast<int32_t>(x.w[k] & 0xFFFFu);
    row[static_cast<size_t>(2 * k + 1) * n] =
        static_cast<int32_t>(x.w[k] >> 16);
  }
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u² + 1), with tower.cuh's products
// ---------------------------------------------------------------------------

struct Fp2 {
  Fp c0, c1;
};

// The field vocabulary of the formulas, overloaded for Fp (G1) and Fp2 (G2).
__device__ __forceinline__ void f_mul(Fp& r, const Fp& a, const Fp& b) {
  fp_mul(r, a, b);
}
__device__ __forceinline__ void f_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }
__device__ __forceinline__ void f_add(Fp& r, const Fp& a, const Fp& b) {
  fp_add(r, a, b);
}
__device__ __forceinline__ void f_sub(Fp& r, const Fp& a, const Fp& b) {
  fp_sub(r, a, b);
}
__device__ __forceinline__ bool f_is_zero(const Fp& a) {
  return fp_is_zero(a);
}
__device__ __forceinline__ void f_set(Fp& r, bool one) { fp_set(r, one); }

// Karatsuba: t0 = a0·b0, t1 = a1·b1, t2 = (a0+a1)(b0+b1);
// (t0 − t1, t2 − t0 − t1). r may alias a or b.
__device__ __forceinline__ void f_mul(Fp2& r, const Fp2& a, const Fp2& b) {
  Fp t0, t1, sa, sb;
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_mul(sa, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(sa, sa, t0);
  fp_sub(r.c1, sa, t1);
}

// a² = ((a0+a1)(a0−a1), 2·a0·a1). r may alias a.
__device__ __forceinline__ void f_sqr(Fp2& r, const Fp2& a) {
  Fp s, d, m;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_add(r.c1, m, m);
}
__device__ __forceinline__ void f_add(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ void f_sub(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ bool f_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
__device__ __forceinline__ void f_set(Fp2& r, bool one) {
  fp_set(r.c0, one);
  fp_set(r.c1, false);
}

__device__ __forceinline__ void f_load(Fp& x, const int32_t* src, int c,
                                       int n, int lane) {
  fp_load(x, src, c, n, lane);
}
__device__ __forceinline__ void f_load(Fp2& x, const int32_t* src, int c,
                                       int n, int lane) {
  fp_load(x.c0, src, c, n, lane);
  fp_load(x.c1, src, c + 1, n, lane);
}
__device__ __forceinline__ void f_store(int32_t* dst, const Fp& x, int c,
                                        int n, int lane) {
  fp_store(dst, x, c, n, lane);
}
__device__ __forceinline__ void f_store(int32_t* dst, const Fp2& x, int c,
                                        int n, int lane) {
  fp_store(dst, x.c0, c, n, lane);
  fp_store(dst, x.c1, c + 1, n, lane);
}

// The engine's field for curve.cuh's field types, and its Fq components.
template <class F>
struct Field;
template <>
struct Field<Fq> {
  using type = Fp;
  static constexpr int k = 1;
};
template <>
struct Field<Fq2> {
  using type = Fp2;
  static constexpr int k = 2;
};

// ---------------------------------------------------------------------------
// Jacobian points (infinity iff Z == 0)
// ---------------------------------------------------------------------------

template <class R>
struct Jac {
  R X, Y, Z;
};

// The doubling of `curve.cuh` `jac_dbl` in place: A = X², B = Y²,
// S = Y·Z, E = 3A, C = B², D = 2((X + B)² − A − C); X' = E² − 2D,
// Y' = E(D − X') − 8C, Z' = 2S. Z = 0 stays 0.
template <class R>
__device__ __forceinline__ void jac_dbl(Jac<R>& T) {
  R A, B, t;
  f_mul(t, T.Y, T.Z);        // S
  f_add(T.Z, t, t);          // Z' = 2S
  f_sqr(B, T.Y);             // B
  f_sqr(A, T.X);             // A
  f_add(T.X, T.X, B);        // X + B
  f_sqr(B, B);               // C = B²
  f_sqr(T.X, T.X);           // (X + B)²
  f_sub(T.X, T.X, A);
  f_sub(T.X, T.X, B);
  f_add(T.X, T.X, T.X);      // D
  f_add(t, A, A);
  f_add(A, A, t);            // E = 3A
  f_sqr(T.Y, A);             // E²
  f_add(t, T.X, T.X);
  f_sub(T.Y, T.Y, t);        // X' = E² − 2D
  f_sub(t, T.X, T.Y);
  f_mul(t, A, t);            // E(D − X')
  T.X = T.Y;
  f_add(B, B, B);
  f_add(B, B, B);
  f_add(B, B, B);            // 8C
  f_sub(T.Y, t, B);          // Y' = E(D − X') − 8C
}

// T <- T + Q for Q the Jacobian point at component c0 of `table` (read
// where first used), with `curve.cuh` `jac_add`'s general path (the same
// 16 / 44 products) and selects. Where T == Q (h == 0, r == 0, neither at
// infinity) T is left as it is and `dbl` is set: the caller's next
// doubling of T is the add's result 2T.
template <class R>
__device__ __forceinline__ void jac_add(Jac<R>& T, const int32_t* table,
                                        int c0, int kc, int n, int lane,
                                        int& dbl) {
  R Z2, z2z, Z1Z2, u1, s1, z1z, z1c, h, r;
  f_load(Z2, table, c0 + 2 * kc, n, lane);
  const bool inf1 = f_is_zero(T.Z);
  const bool inf2 = f_is_zero(Z2);
  f_sqr(z2z, Z2);
  f_mul(Z1Z2, T.Z, Z2);
  f_mul(Z2, z2z, Z2);        // z2c = Z2³
  f_mul(u1, T.X, z2z);       // u1 = X1·Z2²
  f_mul(s1, T.Y, Z2);        // s1 = Y1·Z2³
  f_sqr(z1z, T.Z);
  f_mul(z1c, z1z, T.Z);
  f_load(h, table, c0, n, lane);
  f_mul(h, h, z1z);          // u2 = X2·Z1²
  f_sub(h, h, u1);           // h = u2 − u1
  f_load(r, table, c0 + kc, n, lane);
  f_mul(r, r, z1c);          // s2 = Y2·Z1³
  f_sub(r, r, s1);           // r = s2 − s1
  const bool h0 = f_is_zero(h);
  const bool r0 = f_is_zero(r);

  R Xo, Yo, Zo;
  f_mul(Zo, Z1Z2, h);        // Zo = Z1Z2·h
  f_sqr(z2z, h);             // hh
  f_mul(h, h, z2z);          // hhh
  f_mul(u1, u1, z2z);        // v = u1·hh
  f_sqr(Xo, r);              // r²
  f_sub(Xo, Xo, h);
  f_add(z2z, u1, u1);
  f_sub(Xo, Xo, z2z);        // Xo = r² − hhh − 2v
  f_sub(z2z, u1, Xo);
  f_mul(z2z, r, z2z);        // r(v − Xo)
  f_mul(s1, s1, h);          // s1·hhh
  f_sub(Yo, z2z, s1);        // Yo

  if (h0 && r0 && !inf1 && !inf2) {
    dbl = 1;                 // T == Q: 2T, by the caller's next doubling
  } else {
    if (h0 && !r0) {         // T == −Q -> infinity
      f_set(Xo, true);
      f_set(Yo, true);
      f_set(Zo, false);
    }
    if (inf2) {              // T + 0
      Xo = T.X;
      Yo = T.Y;
      Zo = T.Z;
    }
    if (inf1) {              // 0 + Q
      f_load(Xo, table, c0, n, lane);
      f_load(Yo, table, c0 + kc, n, lane);
      f_load(Zo, table, c0 + 2 * kc, n, lane);
    }
    T.X = Xo;
    T.Y = Yo;
    T.Z = Zo;
  }
}

}  // namespace reg

// B13 (`_k_g1_msm_step4` / `_k_g2_msm_step4`) with the ladder inside the
// thread, on the register engine: acc [3k·24, n] Jacobian, table
// [15·3k·24, n] (1P..15P, Jacobian), digits [ndig, n] base 16, MSB first;
// per digit d, T <- 16T, then T + table[d − 1] where d != 0; a digit
// outside 1..15 reads entry 0. T is loaded once and stored once. The add's
// doubling case adds one doubling to the next pass of the doubling loop
// (or to a last pass after the digits), so one copy of the doubling code
// serves both. F is curve.cuh's field type, tc::Fq (G1) or tc::Fq2 (G2).
template <class F>
__device__ __forceinline__ void step4_lane_r(const int32_t* acc_in,
                                             const int32_t* table,
                                             const int32_t* digits,
                                             int32_t* out, int n, int ndig,
                                             int lane) {
  using R = typename reg::Field<F>::type;
  constexpr int kc = reg::Field<F>::k;
  reg::Jac<R> T;
  reg::f_load(T.X, acc_in, 0, n, lane);
  reg::f_load(T.Y, acc_in, kc, n, lane);
  reg::f_load(T.Z, acc_in, 2 * kc, n, lane);
  int dbl = 0;
#pragma unroll 1
  for (int w = 0; w <= ndig; ++w) {
    const int doublings = (w < ndig ? 4 : 0) + dbl;
    dbl = 0;
#pragma unroll 1
    for (int i = 0; i < doublings; ++i) reg::jac_dbl(T);
    if (w < ndig) {
      const int d = digits[static_cast<size_t>(w) * n + lane];
      if (d != 0) {
        const int e = (d >= 1 && d <= 15) ? d - 1 : 0;
        reg::jac_add(T, table, e * 3 * kc, kc, n, lane, dbl);
      }
    }
  }
  reg::f_store(out, T.X, 0, n, lane);
  reg::f_store(out, T.Y, kc, n, lane);
  reg::f_store(out, T.Z, 2 * kc, n, lane);
}

// B11 (`_mk_winacc_kernel`) on the register engine: accumulator j of `accs`
// starts at infinity and owns lanes j, j + accs, j + 2·accs, … of the n;
// for each of the ndig windows (MSB first) it doubles `window` times, then
// adds table[d − 1] for each lane it owns whose digit d is not 0, in lane
// order (a digit outside 1..2^window − 1 reads entry 0). table: entries
// 1P..(2^window − 1)P of 3k components each, [(2^window − 1)·3k·24, n];
// digits [ndig, n]; out: the accumulators, [3k·24, accs].
//
// Up to n / accs adds follow one another inside a window, so the add's
// doubling case (T == Q) cannot wait for the next window's doublings as in
// `step4_lane_r`: it must be 2T before the next add. One loop runs every
// step, each pass either a doubling, while doublings are pending, or the
// next owned lane's add; the window's `window` doublings, the doubling of
// an add's T == Q case and a last pending one before the store all go
// through it, so the kernel holds one copy of each formula.
template <class F>
__device__ __forceinline__ void winacc_lane_r(const int32_t* table,
                                              const int32_t* digits,
                                              int32_t* out, int n, int accs,
                                              int ndig, int window, int j) {
  using R = typename reg::Field<F>::type;
  constexpr int kc = reg::Field<F>::k;
  const int nent = (1 << window) - 1;
  reg::Jac<R> T;
  reg::f_set(T.X, true);
  reg::f_set(T.Y, true);
  reg::f_set(T.Z, false);
  int w = -1;        // the window whose lanes are being added
  int lane = n;      // its next owned lane; n or more: none left
  int pending = 0;   // doublings due before the next add
  bool more = true;
#pragma unroll 1
  while (more) {
    if (pending == 0 && lane >= n && w + 1 < ndig) {
      ++w;
      lane = j;
      pending = window;
    }
    if (pending > 0) {
      reg::jac_dbl(T);
      --pending;
    } else if (lane < n) {
      const int d = digits[static_cast<size_t>(w) * n + lane];
      if (d != 0) {
        const int e = (d >= 1 && d <= nent) ? d - 1 : 0;
        reg::jac_add(T, table, e * 3 * kc, kc, n, lane, pending);
      }
      lane += accs;
    } else {
      more = false;
    }
  }
  reg::f_store(out, T.X, 0, accs, j);
  reg::f_store(out, T.Y, kc, accs, j);
  reg::f_store(out, T.Z, 2 * kc, accs, j);
}

}  // namespace tc
