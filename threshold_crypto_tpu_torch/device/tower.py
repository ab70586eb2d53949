"""Batched extension-field tower Fq2/Fq6/Fq12 on torch limb tensors.

The counterpart of ``threshold_crypto_tpu/device/tower.py``, with its
formulas: Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³-ξ) with ξ = 1+u,
Fq12 = Fq6[w]/(w²-v). Elements are tuples of int32[..., 24] Montgomery limb
tensors: Fq2 = (c0, c1), Fq6 = (fq2, fq2, fq2), Fq12 = (fq6, fq6).

As in the JAX package, every composite product first collects all its
independent base-field products and issues them as ONE stacked
``mont.mul`` (one kernel launch on the card): a full Fq12 multiply is one
launch over 54× the batch. Additions are stacked the same way, further
than in the JAX package (``*_many``): PyTorch pays a host dispatch per op,
where XLA fuses them. Every value is the same field element as the JAX
package's, so the limbs are identical.
"""

from __future__ import annotations

import functools

import torch

from ..host import tower as htw
from . import mont
from .mont import FQ

# ---------------------------------------------------------------------------
# Stacking utilities
# ---------------------------------------------------------------------------

def _stack(arrs):
    return torch.stack(torch.broadcast_tensors(*arrs), dim=0)


def _mul_many(pairs):
    """k independent Fq products as one stacked Montgomery multiply."""
    out = mont.mul(FQ, _stack([p[0] for p in pairs]),
                   _stack([p[1] for p in pairs]))
    return list(out.unbind(0))


def _add_many(pairs):
    out = mont.add(FQ, _stack([p[0] for p in pairs]),
                   _stack([p[1] for p in pairs]))
    return list(out.unbind(0))


def _sub_many(pairs):
    out = mont.sub(FQ, _stack([p[0] for p in pairs]),
                   _stack([p[1] for p in pairs]))
    return list(out.unbind(0))


def fq2_mul_many(pairs):
    """k independent Fq2 products (Karatsuba) via one 3k-stacked Fq multiply."""
    k = len(pairs)
    sums = _add_many(
        [(x[0], x[1]) for x, _ in pairs] + [(y[0], y[1]) for _, y in pairs]
    )
    sa, sb = sums[:k], sums[k:]
    A = _stack([x[0] for x, _ in pairs] + [x[1] for x, _ in pairs] + sa)
    B = _stack([y[0] for _, y in pairs] + [y[1] for _, y in pairs] + sb)
    t = mont.mul(FQ, A, B)
    t0, t1, t2 = t[:k], t[k: 2 * k], t[2 * k:]
    d = mont.sub(FQ, torch.cat([t0, t2]), torch.cat([t1, t0]))
    c0 = d[:k]                                  # t0 − t1
    c1 = mont.sub(FQ, d[k:], t1)                # t2 − t0 − t1
    return [(c0[i], c1[i]) for i in range(k)]


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

def fq2_zero(shape, device):
    return (mont.zero(FQ, shape, device), mont.zero(FQ, shape, device))


def fq2_one(shape, device):
    return (mont.one(FQ, shape, device), mont.zero(FQ, shape, device))


def fq2_add(a, b):
    s = _add_many([(a[0], b[0]), (a[1], b[1])])
    return (s[0], s[1])


def fq2_sub(a, b):
    s = _sub_many([(a[0], b[0]), (a[1], b[1])])
    return (s[0], s[1])


def fq2_neg(a):
    n = mont.neg(FQ, _stack([a[0], a[1]]))
    return (n[0], n[1])


def fq2_conj(a):
    return (a[0], mont.neg(FQ, a[1]))


def fq2_mul(a, b):
    return fq2_mul_many([(a, b)])[0]


def fq2_sqr(a):
    a0, a1 = a
    s = mont.add(FQ, a0, a1)
    d = mont.sub(FQ, a0, a1)
    t = _mul_many([(s, d), (a0, a1)])
    return (t[0], mont.add(FQ, t[1], t[1]))


def fq2_scale_fq(a, k):
    t = mont.mul(FQ, _stack([a[0], a[1]]), k)
    return (t[0], t[1])


def fq2_mul_small(a, k: int):
    return fq2_mul_small_many([a], k)[0]


def fq2_mul_small_many(xs, k: int):
    """k·x for each Fq2 x of a list, as one stacked ``mont.mul_small``."""
    t = mont.mul_small(FQ, _stack([c for x in xs for c in x]), k)
    return [(t[2 * i], t[2 * i + 1]) for i in range(len(xs))]


def fq2_norm(a):
    """a0² + a1² = a·conj(a), in Fq."""
    sq = _mul_many([(a[0], a[0]), (a[1], a[1])])
    return mont.add(FQ, sq[0], sq[1])


def fq2_inv(a):
    a0, a1 = a
    ninv = mont.inv(FQ, fq2_norm(a))
    t = mont.mul(FQ, _stack([a0, a1]), ninv)
    return (t[0], mont.neg(FQ, t[1]))


def fq2_select(cond, a, b):
    return (mont.select(cond, a[0], b[0]), mont.select(cond, a[1], b[1]))


def fq2_is_zero(a):
    return mont.is_zero(FQ, a[0]) & mont.is_zero(FQ, a[1])


def fq2_eq(a, b):
    return mont.eq(FQ, a[0], b[0]) & mont.eq(FQ, a[1], b[1])


def mul_by_xi(a):
    """Multiply by ξ = 1 + u: (c0 - c1, c0 + c1)."""
    return mul_by_xi_many([a])[0]


# The same Fq2 operation on k independent operands as one stacked call.

def fq2_add_many(pairs):
    s = _add_many([(x[c], y[c]) for x, y in pairs for c in range(2)])
    return [(s[2 * i], s[2 * i + 1]) for i in range(len(pairs))]


def fq2_sub_many(pairs):
    s = _sub_many([(x[c], y[c]) for x, y in pairs for c in range(2)])
    return [(s[2 * i], s[2 * i + 1]) for i in range(len(pairs))]


def mul_by_xi_many(xs):
    d = _sub_many([(x[0], x[1]) for x in xs])
    s = _add_many([(x[0], x[1]) for x in xs])
    return list(zip(d, s))


# ---------------------------------------------------------------------------
# Fq6 — decomposed into (operand prep, stacked Fq2 multiply, combine) so the
# Fq12 level can merge three Fq6 products into one stacked call.
# ---------------------------------------------------------------------------

def fq6_zero(shape, device):
    return tuple(fq2_zero(shape, device) for _ in range(3))


def fq6_one(shape, device):
    return (fq2_one(shape, device), fq2_zero(shape, device),
            fq2_zero(shape, device))


def fq6_add(a, b):
    s = _add_many([(a[i][c], b[i][c]) for i in range(3) for c in range(2)])
    return ((s[0], s[1]), (s[2], s[3]), (s[4], s[5]))


def fq6_sub(a, b):
    s = _sub_many([(a[i][c], b[i][c]) for i in range(3) for c in range(2)])
    return ((s[0], s[1]), (s[2], s[3]), (s[4], s[5]))


def fq6_neg(a):
    n = mont.neg(FQ, _stack([a[i][c] for i in range(3) for c in range(2)]))
    return ((n[0], n[1]), (n[2], n[3]), (n[4], n[5]))


def _fq6_mul_parts(a, b):
    """The 6 Fq2 operand pairs of a Toom/Karatsuba Fq6 product."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    s = _add_many(
        [
            (a1[0], a2[0]), (a1[1], a2[1]),
            (a0[0], a1[0]), (a0[1], a1[1]),
            (a0[0], a2[0]), (a0[1], a2[1]),
            (b1[0], b2[0]), (b1[1], b2[1]),
            (b0[0], b1[0]), (b0[1], b1[1]),
            (b0[0], b2[0]), (b0[1], b2[1]),
        ]
    )
    a12, a01, a02 = (s[0], s[1]), (s[2], s[3]), (s[4], s[5])
    b12, b01, b02 = (s[6], s[7]), (s[8], s[9]), (s[10], s[11])
    return [(a0, b0), (a1, b1), (a2, b2), (a12, b12), (a01, b01), (a02, b02)]


def _fq6_mul_fin_many(ts):
    """Combine the 6 Fq2 products of each of k Fq6 products into
    (c0, c1, c2), each step one stacked call over all k:
    c0 = t0 + ξ(m12 − (t1+t2)), c1 = (m01 − (t0+t1)) + ξt2,
    c2 = (m02 − (t0+t2)) + t1."""
    k = len(ts)
    sums = fq2_add_many([p for t0, t1, t2, *_ in ts
                         for p in ((t1, t2), (t0, t1), (t0, t2))])
    difs = fq2_sub_many([(t[3 + j], sums[3 * i + j])
                         for i, t in enumerate(ts) for j in range(3)])
    xis = mul_by_xi_many([difs[3 * i] for i in range(k)]
                         + [t[2] for t in ts])
    out = fq2_add_many([p for i, t in enumerate(ts)
                        for p in ((t[0], xis[i]), (difs[3 * i + 1], xis[k + i]),
                                  (difs[3 * i + 2], t[1]))])
    return [tuple(out[3 * i: 3 * i + 3]) for i in range(k)]


def fq6_mul(a, b):
    return _fq6_mul_fin_many([fq2_mul_many(_fq6_mul_parts(a, b))])[0]


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    return (mul_by_xi(a[2]), a[0], a[1])


def fq6_mul_by_01(a, b0, b1):
    """a · (b0 + b1·v): the sparse product, 5 Fq2 products in one stacked
    call."""
    return _sparse01_fin(fq2_mul_many(_sparse01_parts(a, b0, b1)))


def fq6_mul_by_1(a, b1):
    """a · (b1·v): 3 Fq2 products in one stacked call."""
    return _by1_fin(fq2_mul_many(_by1_parts(a, b1)))


def _by1_parts(a, b1):
    return [(a[2], b1), (a[0], b1), (a[1], b1)]


def _by1_fin(t):
    return (mul_by_xi(t[0]), t[1], t[2])


def _sparse01_parts(a, b0, b1):
    a0, a1, a2 = a
    sa = fq2_add(a0, a1)
    sb = fq2_add(b0, b1)
    return [(a0, b0), (a1, b1), (a2, b1), (sa, sb), (a2, b0)]


def _sparse01_fin(t):
    t0, t1, t2b1, tss, t2b0 = t
    c0 = fq2_add(t0, mul_by_xi(t2b1))
    c1 = fq2_sub(tss, fq2_add(t0, t1))
    c2 = fq2_add(t2b0, t1)
    return (c0, c1, c2)


def fq6_inv_parts(a):
    """``fq6_inv`` before its Fq2 inverse: the cofactors (c0, c1, c2) and
    tt = a·(c0, c1, c2), the norm of a to Fq2; a⁻¹ = (c0, c1, c2)·tt⁻¹."""
    a0, a1, a2 = a
    t = fq2_mul_many(
        [(a0, a0), (a2, a2), (a1, a1), (a1, a2), (a0, a1), (a0, a2)]
    )
    sq0, sq2, sq1, m12, m01, m02 = t
    c0 = fq2_sub(sq0, mul_by_xi(m12))
    c1 = fq2_sub(mul_by_xi(sq2), m01)
    c2 = fq2_sub(sq1, m02)
    u = fq2_mul_many([(a2, c1), (a1, c2), (a0, c0)])
    tt = fq2_add(mul_by_xi(fq2_add(u[0], u[1])), u[2])
    return (c0, c1, c2), tt


def fq6_inv(a):
    (c0, c1, c2), tt = fq6_inv_parts(a)
    tinv = fq2_inv(tt)
    r = fq2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)])
    return (r[0], r[1], r[2])


def fq6_select(cond, a, b):
    return tuple(fq2_select(cond, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Fq12
# ---------------------------------------------------------------------------

def fq12_zero(shape, device):
    return (fq6_zero(shape, device), fq6_zero(shape, device))


def fq12_one(shape, device):
    return (fq6_one(shape, device), fq6_zero(shape, device))


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a, b):
    """One 18-wide stacked Fq2 multiply (= 54 Fq products in one launch)."""
    a0, a1 = a
    b0, b1 = b
    sa = fq6_add(a0, a1)
    sb = fq6_add(b0, b1)
    parts = (
        _fq6_mul_parts(a0, b0)
        + _fq6_mul_parts(a1, b1)
        + _fq6_mul_parts(sa, sb)
    )
    t = fq2_mul_many(parts)
    t0, t1, t3 = _fq6_mul_fin_many([t[0:6], t[6:12], t[12:18]])
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(t3, fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(a):
    """Complex squaring via two merged Fq6 products."""
    a0, a1 = a
    s = fq6_add(a0, a1)
    sv = fq6_add(a0, fq6_mul_by_v(a1))
    parts = _fq6_mul_parts(a0, a1) + _fq6_mul_parts(s, sv)
    t = fq2_mul_many(parts)
    tt, ss = _fq6_mul_fin_many([t[0:6], t[6:12]])
    c0 = fq6_sub(fq6_sub(ss, tt), fq6_mul_by_v(tt))
    c1 = fq6_add(tt, tt)
    return (c0, c1)


def fq12_cyclo_sqr(a):
    """Granger–Scott cyclotomic squaring: 18 Fq products in ONE stacked call.

    Valid only for elements of the cyclotomic subgroup (anything after the
    easy part of the final exponentiation). Fq12 splits into three
    Fq4 = Fq2[w']/(w'²−γ) pieces (x, y) = (z0,z1), (z2,z3), (z4,z5) with
    c0 = (z0, z4, z3) and c1 = (z2, z1, z5). Each Fq4 square is
    (x² + ξy², (x+y)² − x² − y²); the outputs are 3t − 2z or 3t + 2z.
    The three pieces go through every step together, as stacked calls.
    """
    (z0, z4, z3), (z2, z1, z5) = a
    xs, ys = (z0, z2, z4), (z1, z3, z5)
    xy = fq2_add_many(list(zip(xs, ys)))

    # The 9 Fq2 squarings of (x, y, x+y) per piece as 18 Fq products:
    # (x0+x1)(x0−x1) and x0·x1, doubled.
    sq_in = [e for k in range(3) for e in (xs[k], ys[k], xy[k])]
    sums = _add_many([(e[0], e[1]) for e in sq_in])
    difs = _sub_many([(e[0], e[1]) for e in sq_in])
    t = mont.mul(FQ, _stack(sums + [e[0] for e in sq_in]),
                 _stack(difs + [e[1] for e in sq_in]))
    dbl = mont.add(FQ, t[9:], t[9:])
    sqs = [(t[i], dbl[i]) for i in range(9)]
    x_sq, y_sq, xy_sq = sqs[0::3], sqs[1::3], sqs[2::3]

    xi_y_sq = mul_by_xi_many(y_sq)
    t0 = fq2_add_many(list(zip(xi_y_sq, x_sq)))         # x² + ξy²
    t1 = fq2_sub_many(list(zip(fq2_sub_many(list(zip(xy_sq, x_sq))), y_sq)))
    xi_t1c = mul_by_xi(t1[2])

    # 3t − 2z for (t0a, z0), (t0b, z4), (t0c, z3); 3t + 2z for
    # (t1a, z1), (t1b, z5), (ξ·t1c, z2): d = t ∓ z, out = 2d + t.
    minus = [(t0[0], z0), (t0[1], z4), (t0[2], z3)]
    plus = [(t1[0], z1), (t1[1], z5), (xi_t1c, z2)]
    d = fq2_sub_many(minus) + fq2_add_many(plus)
    d2 = fq2_add_many(list(zip(d, d)))
    z0o, z4o, z3o, z1o, z5o, z2o = fq2_add_many(
        list(zip(d2, [m[0] for m in minus + plus])))
    return ((z0o, z4o, z3o), (z2o, z1o, z5o))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    parts = _fq6_mul_parts(a0, a0) + _fq6_mul_parts(a1, a1)
    t = fq2_mul_many(parts)
    s0, s1 = _fq6_mul_fin_many([t[0:6], t[6:12]])
    tmp = fq6_inv(fq6_sub(s0, fq6_mul_by_v(s1)))
    parts = _fq6_mul_parts(a0, tmp) + _fq6_mul_parts(a1, tmp)
    t = fq2_mul_many(parts)
    c0, c1 = _fq6_mul_fin_many([t[0:6], t[6:12]])
    return (c0, fq6_neg(c1))


def fq12_easy_part(f):
    """f^((p^6 − 1)(p² + 1)), the final exponentiation's easy part:
    x = conj(f)·f⁻¹, then frob₂(x)·x."""
    f = fq12_mul(fq12_conj(f), fq12_inv(f))
    return fq12_mul(fq12_frob(f, 2), f)


def fq12_select(cond, a, b):
    return (fq6_select(cond, a[0], b[0]), fq6_select(cond, a[1], b[1]))


def fq12_flat(a):
    """The 12 Fq coefficients of an Fq12 element, in tuple order."""
    return [a[i][j][k] for i in range(2) for j in range(3) for k in range(2)]


def fq12_is_one(a):
    flat = fq12_flat(a)
    one = fq12_flat(fq12_one(flat[0].shape[:-1], flat[0].device))
    ok = None
    for got, want in zip(flat, one):
        e = mont.eq(FQ, got, want)
        ok = e if ok is None else ok & e
    return ok


def fq12_mul_by_014(f, c0, c1, c4):
    """f · (c0 + c1·v + c4·v·w) — the sparse Miller-loop line product.

    13 Fq2 multiplies, all in one stacked call.
    """
    f0, f1 = f
    o = fq2_add(c1, c4)
    sf = fq6_add(f0, f1)
    parts = (
        _sparse01_parts(f0, c0, c1)
        + _by1_parts(f1, c4)
        + _sparse01_parts(sf, c0, o)
    )
    t = fq2_mul_many(parts)
    t0 = _sparse01_fin(t[0:5])
    t1 = _by1_fin(t[5:8])
    t3 = _sparse01_fin(t[8:13])
    c1out = fq6_sub(t3, fq6_add(t0, t1))
    c0out = fq6_add(t0, fq6_mul_by_v(t1))
    return (c0out, c1out)


# ---------------------------------------------------------------------------
# Miller loop steps (used by device/pairing.py and the plain versions of the
# fused Miller kernels). T = (X, Y, Z) homogeneous projective over Fq2.
# ---------------------------------------------------------------------------

def dbl_step(T, xp, yp):
    """Double T and return (T', line coeffs (c0, c1, c4)).

    Line (tangent at T, untwisted, evaluated at P=(xp,yp), scaled by
    w³·2YZ²):  c0 = 3X³ − 2Y²Z,  c1 = −3X²Z·xp,  c4 = 2YZ²·yp.
    Doubling: W=3X², S=YZ, B=XYS, H=W²−8B → X'=2HS, Y'=W(4B−H)−8Y²S²,
    Z'=8S³  (homogeneous a=0 formulas).

    The JAX package's formulas, with the independent products of each
    layer issued as one stacked multiply (4 launches per step); every value
    is the same field element, so the limbs are identical.
    """
    X, Y, Z = T
    XX, YY, S, XY, ZZ = fq2_mul_many(
        [(X, X), (Y, Y), (Y, Z), (X, Y), (Z, Z)])
    W = fq2_mul_small(XX, 3)
    WW, B, SS, XXX, ZYY, WZ, YZZ = fq2_mul_many(
        [(W, W), (XY, S), (S, S), (XX, X), (YY, Z), (W, Z), (Y, ZZ)])
    B4 = fq2_mul_small(B, 4)
    H = fq2_sub(WW, fq2_add(B4, B4))                       # W² − 8B
    H2, ZYY2, YZZ2 = fq2_mul_small_many([H, ZYY, YZZ], 2)
    XXX3 = fq2_mul_small(XXX, 3)
    Xo, WBH, YYSS, SSS = fq2_mul_many(
        [(H2, S), (W, fq2_sub(B4, H)), (YY, SS), (S, SS)])
    YYSS8, Zo = fq2_mul_small_many([YYSS, SSS], 8)
    Yo, c0 = fq2_sub_many([(WBH, YYSS8), (XXX3, ZYY2)])
    c1, c4 = fq2_scale_fq_many([(fq2_neg(WZ), xp), (YZZ2, yp)])
    return (Xo, Yo, Zo), (c0, c1, c4)


def fq2_scale_fq_many(pairs):
    """Fq2 × Fq products (x·k) of a list, as one stacked multiply."""
    t = mont.mul(FQ, _stack([c for x, _ in pairs for c in x]),
                 _stack([k for _, k in pairs for _ in range(2)]))
    return [(t[2 * i], t[2 * i + 1]) for i in range(len(pairs))]


def add_step(T, Q, xp, yp):
    """Mixed addition T += Q (Q affine) and the line through T, Q at P.

    u = y₂Z − Y, v = x₂Z − X;  line (scaled by w³·v):
      c0 = u·x₂ − v·y₂,  c1 = −u·xp,  c4 = v·yp.
    Addition: A = u²Z − v³ − 2v²X → X'=vA, Y'=u(v²X−A)−v³Y, Z'=v³Z.
    """
    X, Y, Z = T
    x2, y2 = Q
    u = fq2_sub(fq2_mul(y2, Z), Y)
    v = fq2_sub(fq2_mul(x2, Z), X)
    vv = fq2_sqr(v)
    vvv = fq2_mul(v, vv)
    R = fq2_mul(vv, X)
    A = fq2_sub(
        fq2_sub(fq2_mul(fq2_sqr(u), Z), vvv), fq2_mul_small(R, 2)
    )
    Xo = fq2_mul(v, A)
    Yo = fq2_sub(fq2_mul(u, fq2_sub(R, A)), fq2_mul(vvv, Y))
    Zo = fq2_mul(vvv, Z)

    c0 = fq2_sub(fq2_mul(u, x2), fq2_mul(v, y2))
    c1 = fq2_scale_fq(fq2_neg(u), xp)
    c4 = fq2_scale_fq(v, yp)
    return (Xo, Yo, Zo), (c0, c1, c4)


# ---------------------------------------------------------------------------
# Frobenius — coefficients derived by the host tower, as the JAX package's
# numpy Montgomery limbs, and cached on each device at first use.
# ---------------------------------------------------------------------------

def _emb_fq2_const(c):
    return (mont.to_mont(FQ, c[0]), mont.to_mont(FQ, c[1]))


FROB12_C1 = [_emb_fq2_const(c) for c in htw.FROB12_C1]
FROB6_C1 = [_emb_fq2_const(c) for c in htw.FROB6_C1]
FROB6_C2 = [_emb_fq2_const(c) for c in htw.FROB6_C2]
# FROB6_Cx · FROB12_C1, precomputed on the host (used by fq12_frob).
FROB6_C1_X_12 = [_emb_fq2_const(htw.fq2_mul(a, b))
                 for a, b in zip(htw.FROB6_C1, htw.FROB12_C1)]
FROB6_C2_X_12 = [_emb_fq2_const(htw.fq2_mul(a, b))
                 for a, b in zip(htw.FROB6_C2, htw.FROB12_C1)]
_FROB = {"c12": FROB12_C1, "c6_1": FROB6_C1, "c6_2": FROB6_C2,
         "c6_1x12": FROB6_C1_X_12, "c6_2x12": FROB6_C2_X_12}


@functools.lru_cache(maxsize=None)
def _frob_const(name: str, k: int, device: torch.device):
    return tuple(torch.from_numpy(x).to(device) for x in _FROB[name][k])


def fq2_frob(a, power: int):
    return a if power % 2 == 0 else fq2_conj(a)


def fq12_frob(a, power: int):
    """(a)^(p^power): conjugate components, multiply by tower constants —
    5 constant Fq2 multiplies in one stacked call."""
    c0 = tuple(fq2_frob(x, power) for x in a[0])
    c1 = tuple(fq2_frob(x, power) for x in a[1])
    k = power % 12
    dev = a[0][0][0].device
    t = fq2_mul_many(
        [
            (c0[1], _frob_const("c6_1", k, dev)),
            (c0[2], _frob_const("c6_2", k, dev)),
            (c1[0], _frob_const("c12", k, dev)),
            (c1[1], _frob_const("c6_1x12", k, dev)),
            (c1[2], _frob_const("c6_2x12", k, dev)),
        ]
    )
    return ((c0[0], t[0], t[1]), (t[2], t[3], t[4]))


def fq6_frob(a, power: int):
    """(a)^(p^power) in Fq6: 2 constant Fq2 multiplies in one stacked
    call."""
    k = power % 12
    dev = a[0][0].device
    t = fq2_mul_many([(fq2_frob(a[1], power), _frob_const("c6_1", k, dev)),
                      (fq2_frob(a[2], power), _frob_const("c6_2", k, dev))])
    return (fq2_frob(a[0], power), t[0], t[1])


# ---------------------------------------------------------------------------
# Host <-> device conversions (tests / API boundary)
# ---------------------------------------------------------------------------

def fq2_from_host(vals, device):
    """[N] host Fq2 pairs -> batched Fq2 of int32[N, 24] tensors."""
    return tuple(
        torch.from_numpy(mont.stack_mont(FQ, [v[c] for v in vals])).to(device)
        for c in range(2)
    )


def fq2_to_host(a):
    c0, c1 = (mont.unstack_mont(FQ, x) for x in a)
    return list(zip(c0, c1))


def fq6_from_host(vals, device):
    """[N] host Fq6 triples -> batched Fq6 of int32[N, 24] tensors. The
    JAX ``fq6_from_host(c, shape)`` broadcasts one value: pass [c] * N."""
    return tuple(fq2_from_host([v[i] for v in vals], device)
                 for i in range(3))


def fq12_from_host(vals, device):
    """[N] host Fq12 pairs of Fq6 -> batched Fq12 of int32[N, 24] tensors
    (as ``fq6_from_host``, one value per lane)."""
    return tuple(fq6_from_host([v[i] for v in vals], device)
                 for i in range(2))


def fq6_to_host(a):
    return list(zip(*(fq2_to_host(x) for x in a)))


def fq12_to_host(a):
    """Batched Fq12 [N] -> N host values (nested tuples)."""
    return list(zip(*(fq6_to_host(x) for x in a)))


def fq12_to_host_batch(a):
    """Batched Fq12 of any batch shape (leading dims flattened) -> host
    values, as the JAX ``fq12_to_host_batch``."""
    return fq12_to_host(tuple(tuple(tuple(c.reshape(-1, FQ.L) for c in x)
                                    for x in f6) for f6 in a))
