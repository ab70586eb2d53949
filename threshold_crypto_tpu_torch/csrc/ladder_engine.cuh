// B13's register-resident G1/G2 engine, and the lane bodies on it: B13's
// `step4_lane_r`, B15's `step_lane_r`, B11's `winacc_lane_r`, B10's
// `madd_lane_r`, B16's `selmadd_lane_r` and `dblw_lane_r` and B19's
// `fold_lane_r` (csrc/fold.cu, one level of the pairwise fold); its field
// product, square and subtraction also carry B1 and B2 (csrc/mont.cu) and
// B14 (csrc/fr.cuh), in Fq and Fr, and its Fq field (`fp_mul`, `fp_add`,
// `fp_sub`, `fp_neg`, `fp_small`) B3's test entry `engine_lane_r`
// (csrc/fq12.cu), in place of fq.cuh's `__noinline__` engine.
//
// Replaces, for kernels B13 and B15 (csrc/ladder.cu `step4_kernel`,
// `step_kernel`), B11 and B10 (csrc/msm.cu `winacc_kernel`, `madd_kernel`)
// and B16 (csrc/shared.cu `selmadd_kernel`, `dblw_kernel`), the formulas of
// threshold_crypto_tpu/device/pallas_curve.py `_msm_step_w4` (:355; kernel
// `_mk_step4_kernel` :385): per lane and base-16 digit d, T <- 16T, then
// T + table[d − 1] with the complete Jacobian add where d != 0; of
// `_msm_step` (:143; kernel `_mk_step_kernel` :373): per lane and bit,
// T <- 2T, then 2T + Q with the complete mixed add where the bit is set;
// of `_mk_winacc_kernel` (:534): per window w doublings, then the complete
// add of table[d − 1] for each lane an accumulator owns; and of
// `_mk_madd_kernel` (:397): per lane T + Q with `_jac_madd` (:305), the
// complete mixed add, Q affine; and of `_mk_selmadd_kernel` (:410) and
// `_mk_dblw_kernel` (:433): per accumulator lane one gated complete add,
// or w doublings.
//
// What bounds it. Per digit 4 doublings (7 Fq products each in G1, 16 in
// G2) and, for d != 0, the general path of the complete add (16 / 44),
// against 288 (576) bytes of table entry a digit: the 32-bit multiply
// issue rate bounds it by far, as long as the operands stay in registers.
// B10 needs 11 / 30 products a lane (the mixed add's general path)
// against 8k·96 bytes, B15 a doubling a bit and 11 / 30 a set bit against
// 8k·96 bytes a lane: the multiply rate again. curve.cuh's engine passes
// every operand and result of every field op through a per-thread
// local-memory frame (__noinline__ over struct references; 1,296 bytes for
// G1 B13), and its complete adds compute the doubling branch on every lane
// and select it (23 Fq products where the general path needs 16; the mixed
// add of B15's bit 18 where it needs 11).
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
//   exact, so q = t_0·n0 is CIOS's. One carry chain folds h in at the end
//   and one conditional subtract gives the canonical product, the value
//   fq.cuh's mont_mul gives. Add and sub are carry chains with one
//   conditional subtract or add of p.
// * The product is a template over a field descriptor (`FqField`, S = 12
//   words; `FrField`, S = 8, for B1 and B2 in csrc/mont.cu): its words,
//   modulus words, n0 = −m⁻¹ mod 2^32 and R mod m. The bound, for a
//   modulus m of S words: a round starts from a sum V < 2m (V_0 = 0) and
//   adds a·b_i < 2^32·m, then q·m < 2^32·m, so the running sum stays below
//   (2^33 + 2)·m, and (V + a·b_i + q·m)/2^32 < 2m again. It must fit S + 1
//   words, and the top word t_S + h_S ≤ V / 2^(32 S) with it: for p <
//   0.82·2^381 that is < 2^414 (13 words hold 2^416); for r < 0.91·2^255
//   it is < 0.91·2^288 (9 words hold 2^288). Each multiply-add
//   x_j·y + t_j + h_j ≤ (2^32 − 1)² + 2(2^32 − 1) < 2^64. The final sum
//   < 2m fits S words in both (2p < 2^382, 2r < 2^256), so the carry chain
//   that folds h in has no carry out. Fq's instance is the code B10, B11
//   and B13 ran before the template: the same steps in the same order.
// * One copy of the product: inlined at the ladder's 23 product sites (the
//   doubling's 7, the add's 16), the unrolled product makes ~22 k SASS
//   instructions of G1 kernel, and instruction fetch rather than the
//   multiply rate sets the pace; out of line it is ~3.3 k, about half the
//   time at the DKG's launch shape (NVIDIA H100 80GB HBM3, 700 W;
//   tools/b13_variants.py).
// * The doubling case of the complete adds (T == Q) is a branch, taken only
//   where h == 0 and r == 0 with neither point at infinity: T is left as it
//   is and one more doubling runs before the next digit's four (or bit's
//   one, or after the last), through the same doubling code. That doubling
//   is `jac_dbl`'s, whose formulas are those of the add's Xd, Yd, Zd, so the
//   result is the same, bit for bit, as the select of curve.cuh. The
//   T == −Q case and the infinity cases stay data selects, in curve.cuh's
//   order (T == −Q, then Q at infinity, then T at infinity).
// * The formulas are curve.cuh's (the JAX ones): the same products, small
//   multiples by curve.cuh's addition trees, squares as squares (Fq2: two
//   products). Every value is canonical, so every coordinate equals the
//   plain versions' limbs. They are scheduled so that few temporaries are
//   live at once; Q is read from the table (B15's and B10's affine Q from
//   its tensor) where it is first used.
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
__host__ __device__ __forceinline__ constexpr uint32_t p_word(int j) {
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
__host__ __device__ __forceinline__ constexpr uint32_t one_word(int j) {
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

// The fields of the engine's product: words S, modulus word j, −m⁻¹ mod
// 2^32 and R mod m (R = 2^(32 S)) word j.
struct FqField {
  static constexpr int kWords = reg::kWords;
  static constexpr uint32_t kN0 = reg::kN0;
  static __host__ __device__ __forceinline__ constexpr uint32_t p(int j) {
    return p_word(j);
  }
  static __host__ __device__ __forceinline__ constexpr uint32_t one(int j) {
    return one_word(j);
  }
};

// The BLS12-381 scalar field modulus r and R mod r (R = 2^256).
struct FrField {
  static constexpr int kWords = 8;
  static constexpr uint32_t kN0 = 0xffffffffu;
  static __host__ __device__ __forceinline__ constexpr uint32_t p(int j) {
    switch (j) {
      case 0: return 0x00000001u;
      case 1: return 0xffffffffu;
      case 2: return 0xfffe5bfeu;
      case 3: return 0x53bda402u;
      case 4: return 0x09a1d805u;
      case 5: return 0x3339d808u;
      case 6: return 0x299d7d48u;
      default: return 0x73eda753u;
    }
  }
  static __host__ __device__ __forceinline__ constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0xfffffffeu;
      case 1: return 0x00000001u;
      case 2: return 0x00034802u;
      case 3: return 0x5884b7fau;
      case 4: return 0xecbc4ff5u;
      case 5: return 0x998c4fefu;
      case 6: return 0xacc5056fu;
      default: return 0x1824b159u;
    }
  }
};

// One step of a carry-save round: for every word j at once,
// s_j = x_j·y + t_j + h_j < 2^64, t_j <- lo s_j, h_{j+1} <- hi s_j; the top
// word t_S takes h_S (the sum stays below 2^(32(S+1)), so it cannot carry).
template <int S>
__device__ __forceinline__ void cs_step(uint32_t (&t)[S + 1],
                                        uint32_t (&h)[S + 1],
                                        const uint32_t (&x)[S], uint32_t y) {
  uint32_t hn[S + 1];
  hn[0] = 0;
#pragma unroll
  for (int j = 0; j < S; ++j)
    mad_wide(t[j], hn[j + 1], x[j], y, t[j], h[j]);
  t[S] += h[S];
#pragma unroll
  for (int j = 0; j <= S; ++j) h[j] = hn[j];
}

// One reduction round of the carry-save sum: t += q·m with q = t_0·n0
// (word 0 becomes 0), then the shift by one word. After a step of a·b_i,
// h_0 is 0 and t_0 is word 0; with kPending, word 0 is t_0 + h_0 mod 2^32.
template <class Fd, bool kPending = false>
__device__ __forceinline__ void cs_reduce_round(
    uint32_t (&t)[Fd::kWords + 1], uint32_t (&h)[Fd::kWords + 1],
    const uint32_t (&pw)[Fd::kWords]) {
  constexpr int S = Fd::kWords;
  const uint32_t w0 = kPending ? t[0] + h[0] : t[0];
  cs_step<S>(t, h, pw, w0 * Fd::kN0);       // word 0 becomes 0
#pragma unroll
  for (int j = 0; j < S; ++j) {
    t[j] = t[j + 1];
    h[j] = h[j + 1];
  }
  t[S] = h[S] = 0;
}

// r = t + h − m if that is ≥ 0, else t + h, for a carry-save sum < 2m.
template <class Fd>
__device__ __forceinline__ void cs_finish(
    uint32_t (&r)[Fd::kWords], uint32_t (&t)[Fd::kWords + 1],
    const uint32_t (&h)[Fd::kWords + 1]) {
  constexpr int S = Fd::kWords;
  Chain c;
  uint32_t d[S];
  t[0] = c.add_cc(t[0], h[0]);
#pragma unroll
  for (int j = 1; j < S; ++j) t[j] = c.addc_cc(t[j], h[j]);
  d[0] = c.sub_cc(t[0], Fd::p(0));
#pragma unroll
  for (int j = 1; j < S; ++j) d[j] = c.subc_cc(t[j], Fd::p(j));
  const uint32_t borrow = c.subc(0u, 0u);  // 0 or all ones
#pragma unroll
  for (int j = 0; j < S; ++j) r[j] = borrow ? t[j] : d[j];
}

// r = a·b·R^-1 mod m, canonical, for canonical a, b: CIOS in carry-save
// rounds. t + h is the running sum, word j worth t_j + h_j (each < 2^32).
// r may alias a or b: it is written last.
template <class Fd>
__device__ __forceinline__ void mont_mul_words(
    uint32_t (&r)[Fd::kWords], const uint32_t (&a)[Fd::kWords],
    const uint32_t (&b)[Fd::kWords]) {
  constexpr int S = Fd::kWords;
  uint32_t t[S + 1], h[S + 1], pw[S];
#pragma unroll
  for (int j = 0; j <= S; ++j) t[j] = h[j] = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) pw[j] = Fd::p(j);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    cs_step<S>(t, h, a, b[i]);
    cs_reduce_round<Fd>(t, h, pw);
  }
  cs_finish<Fd>(r, t, h);
}

// r = a²·R^-1 mod m, canonical, for canonical a, the value of
// mont_mul_words(r, a, a) with S(S + 1)/2 word products in place of S²:
// the cross products a_i·a_j (i < j) in carry-save rows, the sum made
// exact, doubled and given the squares a_i² (T = a², 2S words); then S
// reduction rounds on T's low half, V = (T_lo + M·m)/R ≤ m, and
// V + T_hi = (T + M·m)/R < (m² + R·m)/R < 2m, one conditional subtract.
// The rounds' running sum stays below R + 2^32·m, which fits S + 1 words
// (2^384 + 2^413 for p, 2^256 + 0.91·2^287 for r). r may alias a.
template <class Fd>
__device__ __forceinline__ void mont_sqr_words(
    uint32_t (&r)[Fd::kWords], const uint32_t (&a)[Fd::kWords]) {
  constexpr int S = Fd::kWords;
  // Cross products: row i adds a_i·a_j at word i + j for j > i; word k
  // takes the pending high word h_k and leaves its own high word at k + 1.
  uint32_t t[2 * S], h[2 * S];
#pragma unroll
  for (int k = 0; k < 2 * S; ++k) t[k] = h[k] = 0;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    uint32_t up = 0;
#pragma unroll
    for (int j = i + 1; j < S; ++j) {
      uint32_t hi;
      mad_wide(t[i + j], hi, a[i], a[j], t[i + j], h[i + j]);
      h[i + j] = up;
      up = hi;
    }
    h[i + S] = up;
  }
  // The exact sum of the cross products (< 2^(64S − 1)), doubled.
  Chain c;
  uint32_t u[2 * S];
  u[0] = c.add_cc(t[0], h[0]);
#pragma unroll
  for (int k = 1; k < 2 * S - 1; ++k) u[k] = c.addc_cc(t[k], h[k]);
  u[2 * S - 1] = c.addc(t[2 * S - 1], h[2 * S - 1]);
#pragma unroll
  for (int k = 2 * S - 1; k > 0; --k) u[k] = (u[k] << 1) | (u[k - 1] >> 31);
  u[0] <<= 1;
  // + a_i² at words 2i, 2i + 1: T = a² < 2^(64 S). The squares first:
  // mad_wide's own carry chain must not fall inside this one.
  uint32_t sq[2 * S];
#pragma unroll
  for (int i = 0; i < S; ++i) mad_wide(sq[2 * i], sq[2 * i + 1], a[i], a[i],
                                       0u, 0u);
  u[0] = c.add_cc(u[0], sq[0]);
#pragma unroll
  for (int k = 1; k < 2 * S - 1; ++k) u[k] = c.addc_cc(u[k], sq[k]);
  u[2 * S - 1] = c.addc(u[2 * S - 1], sq[2 * S - 1]);
  // Reduction rounds on T_lo, in carry-save form.
  uint32_t v[S + 1], g[S + 1], pw[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    v[j] = u[j];
    g[j] = 0;
    pw[j] = Fd::p(j);
  }
  v[S] = g[S] = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) cs_reduce_round<Fd, true>(v, g, pw);
  // + T_hi, then the canonical value.
  v[0] = c.add_cc(v[0], u[S]);
#pragma unroll
  for (int j = 1; j < S; ++j) v[j] = c.addc_cc(v[j], u[S + j]);
  cs_finish<Fd>(r, v, g);
}

// r = (a − b) mod m for canonical a, b: on a borrow, m is added back (the
// carry out of that add is the 2^(32 S) the borrow lent). r may alias a or
// b: it is written last.
template <class Fd>
__device__ __forceinline__ void mod_sub_words(
    uint32_t (&r)[Fd::kWords], const uint32_t (&a)[Fd::kWords],
    const uint32_t (&b)[Fd::kWords]) {
  constexpr int S = Fd::kWords;
  uint32_t d[S];
  Chain c;
  d[0] = c.sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < S; ++j) d[j] = c.subc_cc(a[j], b[j]);
  const uint32_t mask = c.subc(0u, 0u);
  r[0] = c.add_cc(d[0], Fd::p(0) & mask);
#pragma unroll
  for (int j = 1; j < S - 1; ++j) r[j] = c.addc_cc(d[j], Fd::p(j) & mask);
  r[S - 1] = c.addc(d[S - 1], Fd::p(S - 1) & mask);
}

// r = a·b·R^-1 mod p for Fq: the product B10, B11 and B13 call.
// r may alias a or b: it is written last.
__device__ __forceinline__ void fp_mul_body(Fp& r, const Fp& a,
                                            const Fp& b) {
  mont_mul_words<FqField>(r.w, a.w, b.w);
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

// r = (a − b) mod p for canonical a, b.
__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  mod_sub_words<FqField>(r.w, a.w, b.w);
}

// r = −a mod p for canonical a: 0 − a, p added back on the borrow (0 for
// a = 0).
__device__ __forceinline__ void fp_neg(Fp& r, const Fp& a) {
  Fp z;
#pragma unroll
  for (int j = 0; j < kWords; ++j) z.w[j] = 0;
  mod_sub_words<FqField>(r.w, z.w, a.w);
}

// r = k·a mod p for canonical a and k ≥ 1: a short add chain from k's top
// bit (per lower bit a doubling, and an add of a where the bit is set),
// every step canonical. k is the same in every thread, so the chain does
// not diverge. r may alias a.
__device__ __forceinline__ void fp_small(Fp& r, const Fp& a, int k) {
  const Fp x = a;
  int top = 30;
#pragma unroll 1
  while (top > 0 && ((k >> top) & 1) == 0) --top;
  r = x;
#pragma unroll 1
  for (int i = top - 1; i >= 0; --i) {
    fp_add(r, r, r);
    if ((k >> i) & 1) fp_add(r, r, x);
  }
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

// Q affine at components 0 (x) and kc (y) of a packed [2k·24, n] tensor,
// read where each is first used.
template <class R>
struct AffineAt {
  const int32_t* q;
  int kc, n, lane;
  __device__ __forceinline__ void x(R& r) const { f_load(r, q, 0, n, lane); }
  __device__ __forceinline__ void y(R& r) const { f_load(r, q, kc, n, lane); }
};

// T <- T + Q for Q affine (`q.x`, `q.y` give its coordinates), with
// `_jac_madd`'s general path (u1 = X1 and s1 = Y1, Q's Z being 1: 8
// products and 3 squares, G1 11 Fq products, G2 30) and its cases. Where
// T == Q (h == 0, r == 0, T not at infinity) T is left as it is and `dbl`
// is set: the caller's next doubling of T is the add's result 2T, since
// `jac_dbl`'s formulas are `_jac_madd`'s Xd, Yd, Zd (the same limbs as its
// select). T == −Q (infinity) and T at infinity (Q, with Z = 1) stay data
// selects, in that order, as in `_jac_madd`.
template <class R, class Q>
__device__ __forceinline__ void jac_madd(Jac<R>& T, const Q& q, int& dbl) {
  R z1, h, r;
  f_sqr(z1, T.Z);             // Z1²
  q.x(h);
  f_mul(h, h, z1);            // u2 = x2·Z1²
  f_sub(h, h, T.X);           // h = u2 − X1
  f_mul(z1, z1, T.Z);         // Z1³
  q.y(r);
  f_mul(r, r, z1);            // s2 = y2·Z1³
  f_sub(r, r, T.Y);           // r = s2 − Y1
  const bool h0 = f_is_zero(h);
  const bool r0 = f_is_zero(r);
  const bool inf = f_is_zero(T.Z);
  if (h0 && r0 && !inf) {     // T == Q: 2T, by the caller's next doubling
    dbl = 1;
  } else {
    R Xo, Yo, Zo;
    f_mul(Zo, T.Z, h);        // Zo = Z1·h
    f_sqr(z1, h);             // hh
    f_mul(h, h, z1);          // hhh
    f_mul(z1, T.X, z1);       // v = X1·hh
    f_sqr(Xo, r);             // r²
    f_sub(Xo, Xo, h);
    f_add(Yo, z1, z1);
    f_sub(Xo, Xo, Yo);        // Xo = r² − hhh − 2v
    f_sub(z1, z1, Xo);
    f_mul(z1, r, z1);         // r(v − Xo)
    f_mul(Yo, T.Y, h);        // Y1·hhh
    f_sub(Yo, z1, Yo);        // Yo
    if (h0) {                 // T == −Q -> infinity
      f_set(Xo, true);
      f_set(Yo, true);
      f_set(Zo, false);
    }
    if (inf) {                // 0 + Q -> Q
      q.x(Xo);
      q.y(Yo);
      f_set(Zo, true);
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

// B16 selmadd (`_mk_selmadd_kernel`, through `_selmadd_impl`) on the
// register engine, one accumulator lane j of `accs`: acc + table[d − 1] of
// lane start + j of the n, with the complete add, where
// d = digits[start + j] is not 0; the accumulator unchanged where it is. A
// lane start + j ≥ n (the padding of the last block) has digit 0, and a
// digit outside 1..nent reads entry 0, as the TPU's select chain does.
// table: entries 1P..(nent)P of 3k components each, [nent·3k·24, n];
// digits [n] (one window); acc and out [3k·24, accs]. Where T == Q
// `jac_add` leaves T and sets `dbl`, and one `jac_dbl` gives 2T: the add's
// Xd, Yd, Zd, the limbs of curve.cuh's select.
template <class F>
__device__ __forceinline__ void selmadd_lane_r(const int32_t* acc_in,
                                               const int32_t* table,
                                               const int32_t* digits,
                                               int32_t* out, int accs, int n,
                                               int nent, int start, int j) {
  using R = typename reg::Field<F>::type;
  constexpr int kc = reg::Field<F>::k;
  reg::Jac<R> T;
  reg::f_load(T.X, acc_in, 0, accs, j);
  reg::f_load(T.Y, acc_in, kc, accs, j);
  reg::f_load(T.Z, acc_in, 2 * kc, accs, j);
  const int lane = start + j;
  const int d = lane < n ? digits[lane] : 0;
  if (d != 0) {
    const int e = (d >= 1 && d <= nent) ? d - 1 : 0;
    int dbl = 0;
    reg::jac_add(T, table, e * 3 * kc, kc, n, lane, dbl);
    if (dbl) reg::jac_dbl(T);
  }
  reg::f_store(out, T.X, 0, accs, j);
  reg::f_store(out, T.Y, kc, accs, j);
  reg::f_store(out, T.Z, 2 * kc, accs, j);
}

// B16 dblw (`_mk_dblw_kernel`, through `_dblw_impl`) on the register
// engine: acc <- 2^window·acc, `window` doublings of each lane of acc
// [3k·24, n].
template <class F>
__device__ __forceinline__ void dblw_lane_r(const int32_t* acc_in,
                                            int32_t* out, int n, int window,
                                            int lane) {
  using R = typename reg::Field<F>::type;
  constexpr int kc = reg::Field<F>::k;
  reg::Jac<R> T;
  reg::f_load(T.X, acc_in, 0, n, lane);
  reg::f_load(T.Y, acc_in, kc, n, lane);
  reg::f_load(T.Z, acc_in, 2 * kc, n, lane);
#pragma unroll 1
  for (int i = 0; i < window; ++i) reg::jac_dbl(T);
  reg::f_store(out, T.X, 0, n, lane);
  reg::f_store(out, T.Y, kc, n, lane);
  reg::f_store(out, T.Z, 2 * kc, n, lane);
}

// B19 (csrc/fold.cu `fold_level_kernel`), one level of the pairwise tree of
// `DeviceCurve.fold_axis` on the register engine: `in` holds n Jacobian
// lanes [3k·24, n], and output lane i of the `half` ([3k·24, half]) is
// lane i plus lane i + half, with `jac_add` (its T == Q case one
// `jac_dbl`: the add's Xd, Yd, Zd, the limbs of the plain tree's select).
// Where i + half ≥ n (an odd level's last entries) the partner is the
// infinity (1, 1, 0) the plain tree pads with: T + ∞ is T, and a T at
// infinity becomes the padding itself, as `jac_add`'s last select (0 + Q)
// gives.
template <class F>
__device__ __forceinline__ void fold_lane_r(const int32_t* in, int32_t* out,
                                            int n, int half, int lane) {
  using R = typename reg::Field<F>::type;
  constexpr int kc = reg::Field<F>::k;
  reg::Jac<R> T;
  reg::f_load(T.X, in, 0, n, lane);
  reg::f_load(T.Y, in, kc, n, lane);
  reg::f_load(T.Z, in, 2 * kc, n, lane);
  if (lane + half < n) {
    int dbl = 0;
    reg::jac_add(T, in, 0, kc, n, lane + half, dbl);
    if (dbl) reg::jac_dbl(T);
  } else if (reg::f_is_zero(T.Z)) {
    reg::f_set(T.X, true);
    reg::f_set(T.Y, true);
  }
  reg::f_store(out, T.X, 0, half, lane);
  reg::f_store(out, T.Y, kc, half, lane);
  reg::f_store(out, T.Z, 2 * kc, half, lane);
}

// B10 (`_k_g1_madd` / `_k_g2_madd`) on the register engine: acc [3k·24, n]
// Jacobian + q [2k·24, n] affine, per lane, with `jac_madd`. Its T == Q
// case is `jac_dbl` right after the add. The table build
// (device/cuda_curve.py) starts from acc = Q with Z = 1, so its first
// launch takes the doubling branch on every lane and the others never do.
template <class F>
__device__ __forceinline__ void madd_lane_r(const int32_t* acc_in,
                                            const int32_t* q_in,
                                            int32_t* out, int n, int lane) {
  using R = typename reg::Field<F>::type;
  constexpr int kc = reg::Field<F>::k;
  reg::Jac<R> T;
  reg::f_load(T.X, acc_in, 0, n, lane);
  reg::f_load(T.Y, acc_in, kc, n, lane);
  reg::f_load(T.Z, acc_in, 2 * kc, n, lane);
  int dbl = 0;
  reg::jac_madd(T, reg::AffineAt<R>{q_in, kc, n, lane}, dbl);
  if (dbl) reg::jac_dbl(T);
  reg::f_store(out, T.X, 0, n, lane);
  reg::f_store(out, T.Y, kc, n, lane);
  reg::f_store(out, T.Z, 2 * kc, n, lane);
}

// B15 (`_k_g1_msm_step` / `_k_g2_msm_step`, body `_msm_step`) with the
// ladder inside the thread, on the register engine: acc [3k·24, n]
// Jacobian, q [2k·24, n] affine, bits [nbits, n] MSB first; per bit
// T <- 2T, then 2T + Q with `jac_madd` where the bit is set. `_msm_step`'s
// add starts from 2T, whose Z is 2S, so its cases are those of `jac_madd`
// on 2T: 2T == Q gives 4T, 2T == −Q infinity, T at infinity Q with Z = 1,
// in the JAX select order. The 4T of 2T == Q is one more doubling: it
// joins the next bit's (or a last pass after the bits), so one copy of the
// doubling code serves both, as in `step4_lane_r`. nbits = 1 is the TPU
// kernel.
template <class F>
__device__ __forceinline__ void step_lane_r(const int32_t* acc_in,
                                            const int32_t* q_in,
                                            const int32_t* bits,
                                            int32_t* out, int n, int nbits,
                                            int lane) {
  using R = typename reg::Field<F>::type;
  constexpr int kc = reg::Field<F>::k;
  reg::Jac<R> T;
  reg::f_load(T.X, acc_in, 0, n, lane);
  reg::f_load(T.Y, acc_in, kc, n, lane);
  reg::f_load(T.Z, acc_in, 2 * kc, n, lane);
  const reg::AffineAt<R> q{q_in, kc, n, lane};
  int dbl = 0;
#pragma unroll 1
  for (int b = 0; b <= nbits; ++b) {
    const int doublings = (b < nbits ? 1 : 0) + dbl;
    dbl = 0;
#pragma unroll 1
    for (int i = 0; i < doublings; ++i) reg::jac_dbl(T);
    if (b < nbits && bits[static_cast<size_t>(b) * n + lane] != 0)
      reg::jac_madd(T, q, dbl);
  }
  reg::f_store(out, T.X, 0, n, lane);
  reg::f_store(out, T.Y, kc, n, lane);
  reg::f_store(out, T.Z, 2 * kc, n, lane);
}

// B3's test entry (csrc/fq12.cu `engine_kernel`): for component c of the
// m stacked Fq values of a and b ([m·24, n]), a·b, a + b, a − b, −a and
// k·a into the five [m·24, n] blocks of out ([5·m·24, n]), on the field
// every redesigned kernel runs on; one thread a (component, lane), so a
// warp reads and writes neighbouring columns of each limb row.
__device__ __forceinline__ void engine_lane_r(const int32_t* a_in,
                                              const int32_t* b_in,
                                              int32_t* out, int c, int m,
                                              int k, int n, int lane) {
  const size_t block = static_cast<size_t>(m) * reg::kLimbs * n;
  reg::Fp a, b, r;
  reg::fp_load(a, a_in, c, n, lane);
  reg::fp_load(b, b_in, c, n, lane);
  reg::fp_mul_body(r, a, b);
  reg::fp_store(out, r, c, n, lane);
  reg::fp_add(r, a, b);
  reg::fp_store(out + block, r, c, n, lane);
  reg::fp_sub(r, a, b);
  reg::fp_store(out + 2 * block, r, c, n, lane);
  reg::fp_neg(r, a);
  reg::fp_store(out + 3 * block, r, c, n, lane);
  reg::fp_small(r, a, k);
  reg::fp_store(out + 4 * block, r, c, n, lane);
}

}  // namespace tc
