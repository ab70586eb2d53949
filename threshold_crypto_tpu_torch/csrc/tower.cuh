// The BLS12-381 tower Fq2/Fq6/Fq12 and the Miller-loop step formulas as
// per-lane device functions over the engine of fq.cuh, and the per-lane
// bodies of the tower kernels B4-B9 and B17.
//
// Replaces the in-kernel tower of threshold_crypto_tpu/device/
// pallas_tower.py (:376-697): Karatsuba Fq2 products, the Toom/Karatsuba
// Fq6 product (`_fq6_mul_parts` / `_fq6_mul_fin`), `fq12_mul`, `fq12_sqr`
// (complex squaring), `fq12_mul_by_014`, the Granger-Scott `fq12_cyclo_sqr`
// and the homogeneous projective `dbl_step` / `add_step` with their fused
// folds. Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³−ξ) with ξ = 1+u,
// Fq12 = Fq6[w]/(w²−v).
//
// Every Fq value is canonical, so any correct Fq12 product gives the TPU
// kernels' limbs. Three outputs depend on the formula, and use the JAX
// package's: the projective T and the line (c0, c1, c4) of the doubling
// and addition steps (the line scaled by w³·2YZ² resp. w³·v), and the
// cyclotomic squaring (Granger-Scott; off the cyclotomic subgroup another
// squaring gives other limbs). No function divides or branches on data, so
// a zero lane runs like any other.
//
// The TPU kernels stacked the independent products of a formula layer into
// one engine pass over the vector lanes; here one thread owns one lane and
// issues its products one after another. Each tower function is a
// __noinline__ call over structs of Fq values, so ptxas sees loops of calls,
// not tens of thousands of unrolled instructions. Every function writes its
// result last and may take its output as an input.

#pragma once

#include "fq.cuh"

namespace tc {

struct Fq2 {
  Fq c[2];  // c0 + c1·u
};
struct Fq6 {
  Fq2 c[3];  // c0 + c1·v + c2·v²
};
struct Fq12 {
  Fq6 c[2];  // c0 + c1·w
};

// Component i of an Fq12 in the flat order c[i/6].c[(i/2)%3].c[i%2] of the
// packed layout (`pallas_tower.flat12`).
__device__ __forceinline__ Fq& fq12_at(Fq12& f, int i) {
  return f.c[i / 6].c[(i / 2) % 3].c[i % 2];
}

// ---------------------------------------------------------------------------
// Fq2
// ---------------------------------------------------------------------------

__device__ __noinline__ void fq2_add(Fq2& r, const Fq2& a, const Fq2& b) {
  fq_add(r.c[0], a.c[0], b.c[0]);
  fq_add(r.c[1], a.c[1], b.c[1]);
}

__device__ __noinline__ void fq2_sub(Fq2& r, const Fq2& a, const Fq2& b) {
  fq_sub(r.c[0], a.c[0], b.c[0]);
  fq_sub(r.c[1], a.c[1], b.c[1]);
}

__device__ __forceinline__ void fq2_neg(Fq2& r, const Fq2& a) {
  fq_neg(r.c[0], a.c[0]);
  fq_neg(r.c[1], a.c[1]);
}

__device__ __forceinline__ void fq2_small(Fq2& r, const Fq2& a, int k) {
  fq_small(r.c[0], a.c[0], k);
  fq_small(r.c[1], a.c[1], k);
}

// ξ·a = (1+u)·a = (c0 − c1, c0 + c1).
__device__ __noinline__ void fq2_mul_by_xi(Fq2& r, const Fq2& a) {
  Fq d, s;
  fq_sub(d, a.c[0], a.c[1]);
  fq_add(s, a.c[0], a.c[1]);
  r.c[0] = d;
  r.c[1] = s;
}

// Karatsuba: t0 = a0·b0, t1 = a1·b1, t2 = (a0+a1)(b0+b1);
// (t0 − t1, t2 − t0 − t1).
__device__ __noinline__ void fq2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
  Fq t0, t1, t2, sa, sb;
  fq_add(sa, a.c[0], a.c[1]);
  fq_add(sb, b.c[0], b.c[1]);
  fq_mul(t0, a.c[0], b.c[0]);
  fq_mul(t1, a.c[1], b.c[1]);
  fq_mul(t2, sa, sb);
  fq_sub(r.c[0], t0, t1);
  fq_sub(t2, t2, t0);
  fq_sub(r.c[1], t2, t1);
}

// a² = ((a0+a1)(a0−a1), 2·a0·a1).
__device__ __noinline__ void fq2_sqr(Fq2& r, const Fq2& a) {
  Fq s, d, m;
  fq_add(s, a.c[0], a.c[1]);
  fq_sub(d, a.c[0], a.c[1]);
  fq_mul(m, a.c[0], a.c[1]);
  fq_mul(r.c[0], s, d);
  fq_add(r.c[1], m, m);
}

// a·k for an Fq scalar k.
__device__ __forceinline__ void fq2_scale(Fq2& r, const Fq2& a, const Fq& k) {
  fq_mul(r.c[0], a.c[0], k);
  fq_mul(r.c[1], a.c[1], k);
}

// ---------------------------------------------------------------------------
// Fq6
// ---------------------------------------------------------------------------

__device__ __noinline__ void fq6_add(Fq6& r, const Fq6& a, const Fq6& b) {
  for (int i = 0; i < 3; ++i) fq2_add(r.c[i], a.c[i], b.c[i]);
}

__device__ __noinline__ void fq6_sub(Fq6& r, const Fq6& a, const Fq6& b) {
  for (int i = 0; i < 3; ++i) fq2_sub(r.c[i], a.c[i], b.c[i]);
}

// v·a = (ξ·a2, a0, a1).
__device__ __noinline__ void fq6_mul_by_v(Fq6& r, const Fq6& a) {
  Fq2 x;
  fq2_mul_by_xi(x, a.c[2]);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = x;
}

// t0 = a0b0, t1 = a1b1, t2 = a2b2, m12 = (a1+a2)(b1+b2),
// m01 = (a0+a1)(b0+b1), m02 = (a0+a2)(b0+b2);
// c0 = t0 + ξ(m12 − (t1+t2)), c1 = (m01 − (t0+t1)) + ξt2,
// c2 = (m02 − (t0+t2)) + t1.
__device__ __noinline__ void fq6_mul(Fq6& r, const Fq6& a, const Fq6& b) {
  Fq2 t[3], m[3], sa, sb, x;
  for (int i = 0; i < 3; ++i) fq2_mul(t[i], a.c[i], b.c[i]);
  // m[0] = m12, m[1] = m01, m[2] = m02
  const int lo[3] = {1, 0, 0};
  const int hi[3] = {2, 1, 2};
  for (int i = 0; i < 3; ++i) {
    fq2_add(sa, a.c[lo[i]], a.c[hi[i]]);
    fq2_add(sb, b.c[lo[i]], b.c[hi[i]]);
    fq2_mul(m[i], sa, sb);
    fq2_add(x, t[lo[i]], t[hi[i]]);
    fq2_sub(m[i], m[i], x);
  }
  fq2_mul_by_xi(x, m[0]);
  fq2_add(r.c[0], t[0], x);
  fq2_mul_by_xi(x, t[2]);
  fq2_add(r.c[1], m[1], x);
  fq2_add(r.c[2], m[2], t[1]);
}

// a · (b0 + b1·v): t0 = a0b0, t1 = a1b1, t2b1 = a2b1,
// tss = (a0+a1)(b0+b1), t2b0 = a2b0;
// c0 = t0 + ξ·t2b1, c1 = tss − (t0+t1), c2 = t2b0 + t1.
__device__ __noinline__ void fq6_mul_sparse01(Fq6& r, const Fq6& a,
                                              const Fq2& b0, const Fq2& b1) {
  Fq2 t0, t1, t2b1, tss, t2b0, sa, sb;
  fq2_mul(t0, a.c[0], b0);
  fq2_mul(t1, a.c[1], b1);
  fq2_mul(t2b1, a.c[2], b1);
  fq2_add(sa, a.c[0], a.c[1]);
  fq2_add(sb, b0, b1);
  fq2_mul(tss, sa, sb);
  fq2_mul(t2b0, a.c[2], b0);
  fq2_mul_by_xi(t2b1, t2b1);
  fq2_add(r.c[0], t0, t2b1);
  fq2_add(sa, t0, t1);
  fq2_sub(r.c[1], tss, sa);
  fq2_add(r.c[2], t2b0, t1);
}

// ---------------------------------------------------------------------------
// Fq12
// ---------------------------------------------------------------------------

// t0 = a0b0, t1 = a1b1, t3 = (a0+a1)(b0+b1); (t0 + v·t1, t3 − (t0+t1)).
__device__ __noinline__ void fq12_mul(Fq12& r, const Fq12& a, const Fq12& b) {
  Fq6 t0, t1, t3, sa, sb;
  fq6_add(sa, a.c[0], a.c[1]);
  fq6_add(sb, b.c[0], b.c[1]);
  fq6_mul(t0, a.c[0], b.c[0]);
  fq6_mul(t1, a.c[1], b.c[1]);
  fq6_mul(t3, sa, sb);
  fq6_add(sa, t0, t1);
  fq6_sub(r.c[1], t3, sa);
  fq6_mul_by_v(t1, t1);
  fq6_add(r.c[0], t0, t1);
}

// Complex squaring: tt = a0·a1, ss = (a0+a1)(a0 + v·a1);
// (ss − tt − v·tt, 2·tt).
__device__ __noinline__ void fq12_sqr(Fq12& r, const Fq12& a) {
  Fq6 tt, ss, s, sv;
  fq6_add(s, a.c[0], a.c[1]);
  fq6_mul_by_v(sv, a.c[1]);
  fq6_add(sv, a.c[0], sv);
  fq6_mul(tt, a.c[0], a.c[1]);
  fq6_mul(ss, s, sv);
  fq6_sub(ss, ss, tt);
  fq6_mul_by_v(s, tt);
  fq6_sub(r.c[0], ss, s);
  fq6_add(r.c[1], tt, tt);
}

// f · (c0 + c1·v + c4·v·w), the sparse line product:
// t0 = f0·(c0 + c1 v), t1 = f1·c4 v, t3 = (f0+f1)·(c0 + (c1+c4) v);
// (t0 + v·t1, t3 − (t0+t1)).
__device__ __noinline__ void fq12_mul_by_014(Fq12& r, const Fq12& f,
                                             const Fq2& c0, const Fq2& c1,
                                             const Fq2& c4) {
  Fq6 t0, t1, t3, sf;
  Fq2 o;
  fq2_add(o, c1, c4);
  fq6_add(sf, f.c[0], f.c[1]);
  fq6_mul_sparse01(t0, f.c[0], c0, c1);
  fq2_mul(t1.c[0], f.c[1].c[2], c4);
  fq2_mul_by_xi(t1.c[0], t1.c[0]);
  fq2_mul(t1.c[1], f.c[1].c[0], c4);
  fq2_mul(t1.c[2], f.c[1].c[1], c4);
  fq6_mul_sparse01(t3, sf, c0, o);
  fq6_add(sf, t0, t1);
  fq6_sub(r.c[1], t3, sf);
  fq6_mul_by_v(t1, t1);
  fq6_add(r.c[0], t0, t1);
}

// Granger-Scott cyclotomic squaring (`pallas_tower.fq12_cyclo_sqr`).
// With a = ((z0, z4, z3), (z2, z1, z5)), the Fq4 pieces (x, y) are
// (z0, z1), (z2, z3), (z4, z5); each squares to
// t0 = x² + ξy², t1 = (x+y)² − x² − y². The outputs are 3t − 2z, computed
// as 2(t − z) + t, for (t0a, z0), (t0b, z4), (t0c, z3), and 3t + 2z, as
// 2(t + z) + t, for (t1a, z1), (t1b, z5), (ξ·t1c, z2).
__device__ __noinline__ void fq12_cyclo_sqr(Fq12& r, const Fq12& a) {
  const Fq2* z[6] = {&a.c[0].c[0], &a.c[1].c[1], &a.c[1].c[0],
                     &a.c[0].c[2], &a.c[0].c[1], &a.c[1].c[2]};
  Fq2 t0[3], t1[3];
  for (int k = 0; k < 3; ++k) {
    const Fq2& x = *z[2 * k];
    const Fq2& y = *z[2 * k + 1];
    Fq2 xx, yy, ss;
    fq2_add(ss, x, y);
    fq2_sqr(ss, ss);
    fq2_sqr(xx, x);
    fq2_sqr(yy, y);
    fq2_sub(ss, ss, xx);
    fq2_sub(t1[k], ss, yy);
    fq2_mul_by_xi(yy, yy);
    fq2_add(t0[k], yy, xx);
  }
  fq2_mul_by_xi(t1[2], t1[2]);
  // out[i] = 2(t ∓ z_i) + t with z[i] = z_i and its t and sign from above.
  const Fq2* ts[6] = {&t0[0], &t1[0], &t1[2], &t0[2], &t0[1], &t1[1]};
  const bool plus[6] = {false, true, true, false, false, true};
  Fq2 out[6];
  for (int i = 0; i < 6; ++i) {
    Fq2 d;
    if (plus[i]) {
      fq2_add(d, *ts[i], *z[i]);
    } else {
      fq2_sub(d, *ts[i], *z[i]);
    }
    fq2_add(d, d, d);
    fq2_add(out[i], d, *ts[i]);
  }
  // c0 = (z0o, z4o, z3o), c1 = (z2o, z1o, z5o).
  r.c[0].c[0] = out[0];
  r.c[1].c[1] = out[1];
  r.c[1].c[0] = out[2];
  r.c[0].c[2] = out[3];
  r.c[0].c[1] = out[4];
  r.c[1].c[2] = out[5];
}

// ---------------------------------------------------------------------------
// Miller-loop steps: T = (X, Y, Z) homogeneous projective over Fq2,
// P = (xp, yp) affine over Fq.
// ---------------------------------------------------------------------------

struct G2Proj {
  Fq2 X, Y, Z;
};

struct Line {
  Fq2 c0, c1, c4;
};

// T ← 2T and the tangent line at T evaluated at P (`pallas_tower.dbl_step`):
// XX = X², YY = Y², S = YZ, XY, ZZ = Z², W = 3XX, B = XY·S, H = W² − 8B;
// X' = 2H·S, Y' = W(4B − H) − 8·YY·S², Z' = 8S³;
// c0 = 3·XX·X − 2·YY·Z, c1 = −3·XX·Z·xp, c4 = 2·Y·ZZ·yp.
__device__ __noinline__ void dbl_step(G2Proj& T, Line& l, const Fq& xp,
                                      const Fq& yp) {
  Fq2 XX, YY, S, XY, ZZ, W, B, SS, t, u;
  fq2_sqr(XX, T.X);
  fq2_sqr(YY, T.Y);
  fq2_mul(S, T.Y, T.Z);
  fq2_mul(XY, T.X, T.Y);
  fq2_sqr(ZZ, T.Z);
  fq2_small(W, XX, 3);
  fq2_mul(B, XY, S);
  fq2_sqr(SS, S);
  // line
  fq2_mul(t, XX, T.X);
  fq2_small(t, t, 3);
  fq2_mul(u, YY, T.Z);
  fq2_small(u, u, 2);
  fq2_sub(l.c0, t, u);
  fq2_mul(t, XX, T.Z);
  fq2_small(t, t, 3);
  fq2_neg(t, t);
  fq2_scale(l.c1, t, xp);
  fq2_mul(t, T.Y, ZZ);
  fq2_small(t, t, 2);
  fq2_scale(l.c4, t, yp);
  // point
  Fq2 H;
  fq2_sqr(H, W);
  fq2_small(t, B, 8);
  fq2_sub(H, H, t);                      // H = W² − 8B
  fq2_small(t, H, 2);
  fq2_mul(T.X, t, S);                    // X' = 2H·S
  fq2_small(t, B, 4);
  fq2_sub(t, t, H);
  fq2_mul(t, W, t);                      // W(4B − H)
  fq2_mul(u, YY, SS);
  fq2_small(u, u, 8);
  fq2_sub(T.Y, t, u);                    // Y' = W(4B − H) − 8·YY·SS
  fq2_mul(t, S, SS);
  fq2_small(T.Z, t, 8);                  // Z' = 8S³
}

// T ← T + Q (Q affine) and the chord line through T, Q at P
// (`pallas_tower.add_step`): u = y2·Z − Y, v = x2·Z − X;
// c0 = u·x2 − v·y2, c1 = −u·xp, c4 = v·yp;
// A = u²Z − v³ − 2v²X, X' = vA, Y' = u(v²X − A) − v³Y, Z' = v³Z.
__device__ __noinline__ void add_step(G2Proj& T, Line& l, const Fq2& x2,
                                      const Fq2& y2, const Fq& xp,
                                      const Fq& yp) {
  Fq2 u, v, vv, vvv, R, A, t, s;
  fq2_mul(u, y2, T.Z);
  fq2_sub(u, u, T.Y);
  fq2_mul(v, x2, T.Z);
  fq2_sub(v, v, T.X);
  // line
  fq2_mul(t, u, x2);
  fq2_mul(s, v, y2);
  fq2_sub(l.c0, t, s);
  fq2_neg(t, u);
  fq2_scale(l.c1, t, xp);
  fq2_scale(l.c4, v, yp);
  // point
  fq2_sqr(vv, v);
  fq2_mul(vvv, v, vv);
  fq2_mul(R, vv, T.X);
  fq2_sqr(t, u);
  fq2_mul(A, t, T.Z);
  fq2_sub(A, A, vvv);
  fq2_small(t, R, 2);
  fq2_sub(A, A, t);                      // A = u²Z − v³ − 2R
  fq2_mul(T.X, v, A);
  fq2_sub(t, R, A);
  fq2_mul(t, u, t);
  fq2_mul(s, vvv, T.Y);
  fq2_sub(T.Y, t, s);
  fq2_mul(T.Z, vvv, T.Z);
}

// ---------------------------------------------------------------------------
// Packed loads and stores, and the per-lane bodies of the kernels. A packed
// tensor is int32[k·24, n]: Fq12 k = 12 (flat order), T k = 6 (X, Y, Z),
// Q k = 4 (x, y), P k = 2 (xp, yp), a line k = 6 (c0, c1, c4).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_fq12(Fq12& f, const int32_t* src, int n,
                                          int lane) {
  for (int i = 0; i < 12; ++i) load_fq(fq12_at(f, i), src, i, n, lane);
}

__device__ __forceinline__ void store_fq12(int32_t* dst, Fq12& f, int n,
                                           int lane) {
  for (int i = 0; i < 12; ++i) store_fq(dst, fq12_at(f, i), i, n, lane);
}

__device__ __forceinline__ void load_fq2(Fq2& x, const int32_t* src, int c,
                                         int n, int lane) {
  load_fq(x.c[0], src, c, n, lane);
  load_fq(x.c[1], src, c + 1, n, lane);
}

__device__ __forceinline__ void store_fq2(int32_t* dst, const Fq2& x, int c,
                                          int n, int lane) {
  store_fq(dst, x.c[0], c, n, lane);
  store_fq(dst, x.c[1], c + 1, n, lane);
}

__device__ __forceinline__ void load_g2(G2Proj& T, const int32_t* src, int n,
                                        int lane) {
  load_fq2(T.X, src, 0, n, lane);
  load_fq2(T.Y, src, 2, n, lane);
  load_fq2(T.Z, src, 4, n, lane);
}

__device__ __forceinline__ void store_g2(int32_t* dst, const G2Proj& T, int n,
                                         int lane) {
  store_fq2(dst, T.X, 0, n, lane);
  store_fq2(dst, T.Y, 2, n, lane);
  store_fq2(dst, T.Z, 4, n, lane);
}

// B4 (`_k_dbl_fold`): T ← 2T, f ← f²·l_tangent(P).
__device__ __forceinline__ void dbl_fold_lane(
    const int32_t* f_in, const int32_t* T_in, const int32_t* P_in,
    int32_t* f_out, int32_t* T_out, int n, int lane) {
  Fq12 f;
  G2Proj T;
  Fq xp, yp;
  Line l;
  load_fq12(f, f_in, n, lane);
  load_g2(T, T_in, n, lane);
  load_fq(xp, P_in, 0, n, lane);
  load_fq(yp, P_in, 1, n, lane);
  dbl_step(T, l, xp, yp);
  fq12_sqr(f, f);
  fq12_mul_by_014(f, f, l.c0, l.c1, l.c4);
  store_fq12(f_out, f, n, lane);
  store_g2(T_out, T, n, lane);
}

// B5 (`_k_add_fold`): T ← T + Q, f ← f·l_chord(P).
__device__ __forceinline__ void add_fold_lane(
    const int32_t* f_in, const int32_t* T_in, const int32_t* Q_in,
    const int32_t* P_in, int32_t* f_out, int32_t* T_out, int n, int lane) {
  Fq12 f;
  G2Proj T;
  Fq2 x2, y2;
  Fq xp, yp;
  Line l;
  load_fq12(f, f_in, n, lane);
  load_g2(T, T_in, n, lane);
  load_fq2(x2, Q_in, 0, n, lane);
  load_fq2(y2, Q_in, 2, n, lane);
  load_fq(xp, P_in, 0, n, lane);
  load_fq(yp, P_in, 1, n, lane);
  add_step(T, l, x2, y2, xp, yp);
  fq12_mul_by_014(f, f, l.c0, l.c1, l.c4);
  store_fq12(f_out, f, n, lane);
  store_g2(T_out, T, n, lane);
}

// The line (c0, c1, c4) as a packed [6·24, n] tensor: c0.re, c0.im, c1.re,
// c1.im, c4.re, c4.im, the plane order `_k_dbl_step` writes.
__device__ __forceinline__ void load_line(Line& l, const int32_t* src, int n,
                                          int lane) {
  load_fq2(l.c0, src, 0, n, lane);
  load_fq2(l.c1, src, 2, n, lane);
  load_fq2(l.c4, src, 4, n, lane);
}

__device__ __forceinline__ void store_line(int32_t* dst, const Line& l, int n,
                                           int lane) {
  store_fq2(dst, l.c0, 0, n, lane);
  store_fq2(dst, l.c1, 2, n, lane);
  store_fq2(dst, l.c4, 4, n, lane);
}

// B17, the unfused Miller pieces: B4 and B5 cut at the line, which goes
// through device memory in between. `dbl_step_lane` then `f_sqr_fold_lane`
// computes what `dbl_fold_lane` does, and `add_step_lane` then
// `f_fold_lane` what `add_fold_lane` does, bit for bit.

// `_k_dbl_step`: T ← 2T and the tangent line at P.
__device__ __forceinline__ void dbl_step_lane(const int32_t* T_in,
                                              const int32_t* P_in,
                                              int32_t* T_out,
                                              int32_t* line_out, int n,
                                              int lane) {
  G2Proj T;
  Fq xp, yp;
  Line l;
  load_g2(T, T_in, n, lane);
  load_fq(xp, P_in, 0, n, lane);
  load_fq(yp, P_in, 1, n, lane);
  dbl_step(T, l, xp, yp);
  store_g2(T_out, T, n, lane);
  store_line(line_out, l, n, lane);
}

// `_k_add_step`: T ← T + Q (Q affine) and the chord line at P.
__device__ __forceinline__ void add_step_lane(const int32_t* T_in,
                                              const int32_t* Q_in,
                                              const int32_t* P_in,
                                              int32_t* T_out,
                                              int32_t* line_out, int n,
                                              int lane) {
  G2Proj T;
  Fq2 x2, y2;
  Fq xp, yp;
  Line l;
  load_g2(T, T_in, n, lane);
  load_fq2(x2, Q_in, 0, n, lane);
  load_fq2(y2, Q_in, 2, n, lane);
  load_fq(xp, P_in, 0, n, lane);
  load_fq(yp, P_in, 1, n, lane);
  add_step(T, l, x2, y2, xp, yp);
  store_g2(T_out, T, n, lane);
  store_line(line_out, l, n, lane);
}

// `_k_f_sqr_fold`: f ← f²·line, the square first as in B4.
__device__ __forceinline__ void f_sqr_fold_lane(const int32_t* f_in,
                                                const int32_t* line_in,
                                                int32_t* f_out, int n,
                                                int lane) {
  Fq12 f;
  Line l;
  load_fq12(f, f_in, n, lane);
  load_line(l, line_in, n, lane);
  fq12_sqr(f, f);
  fq12_mul_by_014(f, f, l.c0, l.c1, l.c4);
  store_fq12(f_out, f, n, lane);
}

// `_k_f_fold`: f ← f·line.
__device__ __forceinline__ void f_fold_lane(const int32_t* f_in,
                                            const int32_t* line_in,
                                            int32_t* f_out, int n, int lane) {
  Fq12 f;
  Line l;
  load_fq12(f, f_in, n, lane);
  load_line(l, line_in, n, lane);
  fq12_mul_by_014(f, f, l.c0, l.c1, l.c4);
  store_fq12(f_out, f, n, lane);
}

// B6 (`_k_cyclo_sqr`) and B7 (`_k_cyclo_sqr_mul`: acc²·g).
__device__ __forceinline__ void cyclo_sqr_lane(const int32_t* f_in,
                                               const int32_t* g_in,
                                               int32_t* f_out, int n,
                                               int lane) {
  Fq12 f;
  load_fq12(f, f_in, n, lane);
  fq12_cyclo_sqr(f, f);
  if (g_in != nullptr) {
    Fq12 g;
    load_fq12(g, g_in, n, lane);
    fq12_mul(f, f, g);
  }
  store_fq12(f_out, f, n, lane);
}

// B8 (`_k_fq12_mul`) and B9 (`_k_fq12_sqr`, b == nullptr).
__device__ __forceinline__ void fq12_mul_lane(const int32_t* a_in,
                                              const int32_t* b_in,
                                              int32_t* f_out, int n,
                                              int lane) {
  Fq12 a;
  load_fq12(a, a_in, n, lane);
  if (b_in != nullptr) {
    Fq12 b;
    load_fq12(b, b_in, n, lane);
    fq12_mul(a, a, b);
  } else {
    fq12_sqr(a, a);
  }
  store_fq12(f_out, a, n, lane);
}

// The B3 test entry: for each of m stacked Fq values of a and b
// ([m·24, n]), write a·b, a + b, a − b, −a and k·a to the five
// [m·24, n] blocks of out ([5·m·24, n]).
__device__ __forceinline__ void engine_lane(const int32_t* a_in,
                                            const int32_t* b_in,
                                            int32_t* out, int m, int k,
                                            int n, int lane) {
  const size_t block = static_cast<size_t>(m) * kFqLimbs * n;
  for (int c = 0; c < m; ++c) {
    Fq a, b, r;
    load_fq(a, a_in, c, n, lane);
    load_fq(b, b_in, c, n, lane);
    fq_mul(r, a, b);
    store_fq(out, r, c, n, lane);
    fq_add(r, a, b);
    store_fq(out + block, r, c, n, lane);
    fq_sub(r, a, b);
    store_fq(out + 2 * block, r, c, n, lane);
    fq_neg(r, a);
    store_fq(out + 3 * block, r, c, n, lane);
    fq_small(r, a, k);
    store_fq(out + 4 * block, r, c, n, lane);
  }
}

}  // namespace tc
