// Jacobian G1/G2 point formulas of the curve kernels as per-lane device
// functions, and the per-lane body of B15 (step). B10 (madd), B11
// (winacc), B13 (step4) and B16 (selmadd, dblw) run on ladder_engine.cuh.
//
// Replaces the in-kernel formulas of threshold_crypto_tpu/device/
// pallas_curve.py (:143-370) that B15 runs: `_jac_dbl` (7 products) and
// `_msm_step` (a doubling and a gated complete mixed add with its own
// doubling of 2T, 25 products, 18 of them on the general path), written
// for G1 over Fq and G2 over Fq2 as one template over the field. The
// formulas are the JAX ones value for value: the same products, the same small multiples (2·x as x + x, 3·x,
// 8·x by fq_small's addition tree) and the same select order (T == Q, then
// T == −Q, then the infinity cases). Every coordinate is canonical, so the
// limbs equal the TPU kernels' and the plain versions' (device/curve.py).
// Squares run as squares (Fq2: 2 products instead of 3); the value is the
// same. The selects are data selects, not branches: a lane computes both
// the general and the doubling branch, as on the TPU.
//
// Every function is __noinline__ over structs of field values (as in
// tower.cuh), writes its result last and may take its output as an input.

#pragma once

#include "tower.cuh"

namespace tc {

// ---------------------------------------------------------------------------
// The field vocabulary, overloaded for Fq (G1) and Fq2 (G2)
// ---------------------------------------------------------------------------

// Fq components of a field value.
template <class F>
struct Comps {
  static constexpr int k = 1;
};
template <>
struct Comps<Fq2> {
  static constexpr int k = 2;
};

__device__ __forceinline__ void f_mul(Fq& r, const Fq& a, const Fq& b) {
  fq_mul(r, a, b);
}
__device__ __forceinline__ void f_mul(Fq2& r, const Fq2& a, const Fq2& b) {
  fq2_mul(r, a, b);
}
__device__ __forceinline__ void f_sqr(Fq& r, const Fq& a) { fq_mul(r, a, a); }
__device__ __forceinline__ void f_sqr(Fq2& r, const Fq2& a) { fq2_sqr(r, a); }
__device__ __forceinline__ void f_add(Fq& r, const Fq& a, const Fq& b) {
  fq_add(r, a, b);
}
__device__ __forceinline__ void f_add(Fq2& r, const Fq2& a, const Fq2& b) {
  fq2_add(r, a, b);
}
__device__ __forceinline__ void f_sub(Fq& r, const Fq& a, const Fq& b) {
  fq_sub(r, a, b);
}
__device__ __forceinline__ void f_sub(Fq2& r, const Fq2& a, const Fq2& b) {
  fq2_sub(r, a, b);
}
__device__ __forceinline__ void f_small(Fq& r, const Fq& a, int k) {
  fq_small(r, a, k);
}
__device__ __forceinline__ void f_small(Fq2& r, const Fq2& a, int k) {
  fq2_small(r, a, k);
}

__device__ __forceinline__ bool f_is_zero(const Fq& a) {
  uint32_t any = 0;
  for (int j = 0; j < kFqWords; ++j) any |= a.w[j];
  return any == 0;
}
__device__ __forceinline__ bool f_is_zero(const Fq2& a) {
  return f_is_zero(a.c[0]) && f_is_zero(a.c[1]);
}

__device__ __forceinline__ void f_set(Fq& r, bool one) {
  for (int j = 0; j < kFqWords; ++j) r.w[j] = one ? kFq.one[j] : 0u;
}
__device__ __forceinline__ void f_set(Fq2& r, bool one) {
  f_set(r.c[0], one);
  f_set(r.c[1], false);
}

__device__ __forceinline__ void f_load(Fq& x, const int32_t* src, int c,
                                       int n, int lane) {
  load_fq(x, src, c, n, lane);
}
__device__ __forceinline__ void f_load(Fq2& x, const int32_t* src, int c,
                                       int n, int lane) {
  load_fq2(x, src, c, n, lane);
}
__device__ __forceinline__ void f_store(int32_t* dst, const Fq& x, int c,
                                        int n, int lane) {
  store_fq(dst, x, c, n, lane);
}
__device__ __forceinline__ void f_store(int32_t* dst, const Fq2& x, int c,
                                        int n, int lane) {
  store_fq2(dst, x, c, n, lane);
}

template <class F>
struct Jac {
  F X, Y, Z;  // infinity iff Z == 0
};

template <class F>
__device__ __forceinline__ void select3(Jac<F>& out, bool c, const F& x,
                                        const F& y, const F& z) {
  if (c) {
    out.X = x;
    out.Y = y;
    out.Z = z;
  }
}

// Component c0 onwards of a packed [k·24, n] tensor: X, Y, Z (3·Comps<F>::k
// Fq components), or x, y for an affine point.
template <class F>
__device__ __forceinline__ void load_jac(Jac<F>& p, const int32_t* src, int c0,
                                         int n, int lane) {
  f_load(p.X, src, c0, n, lane);
  f_load(p.Y, src, c0 + Comps<F>::k, n, lane);
  f_load(p.Z, src, c0 + 2 * Comps<F>::k, n, lane);
}

template <class F>
__device__ __forceinline__ void store_jac(int32_t* dst, const Jac<F>& p,
                                          int n, int lane) {
  f_store(dst, p.X, 0, n, lane);
  f_store(dst, p.Y, Comps<F>::k, n, lane);
  f_store(dst, p.Z, 2 * Comps<F>::k, n, lane);
}

// ---------------------------------------------------------------------------
// The formulas (pallas_curve.py `_jac_dbl`, `_msm_step`)
// ---------------------------------------------------------------------------

// A = X², B = Y², S = Y·Z, E = 3A, C = B², D = 2((X + B)² − A − C);
// X' = E² − 2D, Y' = E(D − X') − 8C, Z' = 2S. Z = 0 stays 0.
template <class F>
__device__ __noinline__ void jac_dbl(Jac<F>& r, const Jac<F>& T) {
  F A, B, S, XpB, E, C, XB2, E2, D, t, u;
  f_sqr(A, T.X);
  f_sqr(B, T.Y);
  f_mul(S, T.Y, T.Z);
  f_add(XpB, T.X, B);
  f_small(E, A, 3);
  f_sqr(C, B);
  f_sqr(XB2, XpB);
  f_sqr(E2, E);
  f_sub(t, XB2, A);
  f_sub(t, t, C);
  f_small(D, t, 2);
  f_small(t, D, 2);
  f_sub(r.X, E2, t);                     // Xd = E² − 2D
  f_sub(t, D, r.X);
  f_mul(t, E, t);                        // E(D − Xd)
  f_small(u, C, 8);
  f_sub(r.Y, t, u);                      // Yd = E(D − Xd) − 8C
  f_small(r.Z, S, 2);                    // Zd = 2S
}

// One set bit of the per-lane ladder (`_msm_step` with do_add): r = 2T + Q
// (Q affine). The doubling of T runs as in jac_dbl; the mixed add starts
// from 2T with Zd² = 4S² and Zd³ = Zd²·Zd, and the doubling of 2T (Xdd,
// Ydd, Zdd) covers the 2T == Q case. The selects, in the JAX order:
// 2T == Q -> 4T, 2T == -Q -> infinity, T at infinity -> Q. The JAX gate
// (a clear bit gives 2T = (Xd, Yd, Zd)) is a branch in step_lane, which runs
// jac_dbl for a clear bit: the same bits. The gate is not an early return
// here: nvcc 12.9 miscompiled an early return from this function for Fq on
// sm_90a (wrong values, and an illegal address where r did not alias T).
template <class F>
__device__ __noinline__ void msm_step(Jac<F>& r, const Jac<F>& T,
                                      const F& x2, const F& y2) {
  F A, B, S, XpB, E, C, XB2, E2, SS, D, Xd, z1z, Zd, EDX, u2, z1cu, Yd, h;
  F s2, hh, A2, B2, S2, rr_, XpB2, E2_, hhh, v, rr, C2, XB2b, E2sq, Xn, D2;
  F Xdd, Yn, Zn, Ydd, Zdd, t, u;
  // L1
  f_sqr(A, T.X);
  f_sqr(B, T.Y);
  f_mul(S, T.Y, T.Z);
  f_add(XpB, T.X, B);
  f_small(E, A, 3);
  // L2
  f_sqr(C, B);
  f_sqr(XB2, XpB);
  f_sqr(E2, E);
  f_sqr(SS, S);
  f_sub(t, XB2, A);
  f_sub(t, t, C);
  f_small(D, t, 2);
  f_small(t, D, 2);
  f_sub(Xd, E2, t);                      // Xd = E² − 2D
  f_small(z1z, SS, 4);                   // Zd² = 4S²
  f_small(Zd, S, 2);                     // Zd = 2S
  // L3
  f_sub(t, D, Xd);
  f_mul(EDX, E, t);
  f_small(u, C, 8);
  f_sub(Yd, EDX, u);                     // Yd = E(D − Xd) − 8C
  f_mul(u2, x2, z1z);
  f_mul(z1cu, z1z, Zd);
  f_sub(h, u2, Xd);
  // L4
  f_mul(s2, y2, z1cu);
  f_sqr(hh, h);
  f_sqr(A2, Xd);
  f_sqr(B2, Yd);
  f_mul(S2, Yd, Zd);
  f_sub(rr_, s2, Yd);                    // r
  f_add(XpB2, Xd, B2);
  f_small(E2_, A2, 3);
  // L5
  f_mul(hhh, h, hh);
  f_mul(v, Xd, hh);
  f_sqr(rr, rr_);
  f_sqr(C2, B2);
  f_sqr(XB2b, XpB2);
  f_sqr(E2sq, E2_);
  f_sub(t, rr, hhh);
  f_small(u, v, 2);
  f_sub(Xn, t, u);                       // Xn = r² − hhh − 2v
  f_sub(t, XB2b, A2);
  f_sub(t, t, C2);
  f_small(D2, t, 2);
  f_small(t, D2, 2);
  f_sub(Xdd, E2sq, t);
  // L6
  f_sub(t, v, Xn);
  f_mul(t, rr_, t);                      // r(v − Xn)
  f_mul(u, Yd, hhh);
  f_sub(Yn, t, u);
  f_mul(Zn, Zd, h);
  f_sub(t, D2, Xdd);
  f_mul(t, E2_, t);
  f_small(u, C2, 8);
  f_sub(Ydd, t, u);
  f_small(Zdd, S2, 2);

  const bool h0 = f_is_zero(h);
  const bool r0 = f_is_zero(rr_);
  const bool t_inf = f_is_zero(Zd);
  Jac<F> out;
  out.X = Xn;
  out.Y = Yn;
  out.Z = Zn;
  select3(out, h0 && r0, Xdd, Ydd, Zdd);  // 2T == Q  -> 4T
  F one, zero;
  f_set(one, true);
  f_set(zero, false);
  select3(out, h0 && !r0, one, one, zero);  // 2T == -Q -> infinity
  select3(out, t_inf, x2, y2, one);      // T at infinity -> Q
  r = out;
}

// ---------------------------------------------------------------------------
// Per-lane bodies
// ---------------------------------------------------------------------------

// B15 (`_k_g1_msm_step` / `_k_g2_msm_step`) with the ladder inside the
// thread: acc [3k·24, n] Jacobian, q [2k·24, n] affine, bits [nbits, n]
// MSB first; per bit T <- 2T (+ Q where the bit is set). nbits = 1 is the
// TPU kernel.
template <class F>
__device__ __forceinline__ void step_lane(const int32_t* acc_in,
                                          const int32_t* q_in,
                                          const int32_t* bits, int32_t* out,
                                          int n, int nbits, int lane) {
  Jac<F> T;
  F x2, y2;
  load_jac(T, acc_in, 0, n, lane);
  f_load(x2, q_in, 0, n, lane);
  f_load(y2, q_in, Comps<F>::k, n, lane);
  for (int b = 0; b < nbits; ++b) {
    if (bits[static_cast<size_t>(b) * n + lane] != 0)
      msm_step(T, T, x2, y2);
    else
      jac_dbl(T, T);
  }
  store_jac(out, T, n, lane);
}

}  // namespace tc
