// Jacobian G1/G2 point formulas over the engine of fq.cuh and tower.cuh:
// the field vocabulary, overloaded for Fq (G1) and Fq2 (G2), the packed
// loads and stores, and the doubling `jac_dbl`. No kernel runs them: every
// curve kernel (B10, B11, B13, B15, B16) runs on ladder_engine.cuh.
// tools/b10_variants.py, b11_variants.py, b15_variants.py and
// b16_variants.py splice the kernels' old lane bodies (kept as text there)
// onto this header to time them against the register engine's; msm.cu
// includes it for kThreads.
//
// `jac_dbl` is threshold_crypto_tpu/device/pallas_curve.py's `_jac_dbl` (7
// products), value for value: the same products, the same small multiples
// (2·x as x + x, 3·x, 8·x by fq_small's addition tree). Every coordinate is
// canonical, so the limbs equal the TPU kernels' and the plain versions'
// (device/curve.py). Squares run as squares (Fq2: 2 products instead of
// 3); the value is the same.
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
// The doubling (pallas_curve.py `_jac_dbl`)
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

}  // namespace tc
