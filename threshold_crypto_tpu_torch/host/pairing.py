"""Host-side BLS12-381 pairing (correctness oracle).

A copy of ``threshold_crypto_tpu/host/pairing.py``, the pairing of the
backend's scalar-path protocol objects. The reference only ever *compares*
pairing outputs for equality (``src/lib.rs:109,185,511``), so any fixed bilinear,
non-degenerate map works as long as every implementation in this framework
computes the same one.  We use the ate pairing with the final exponentiation
raised to 3·(p¹²−1)/r (see ``params.HARD_EXP`` notes): 3 is invertible mod r,
so equality semantics and non-degeneracy are untouched, and the hard part
becomes the cheap lattice chain (X−1)²·(X+p)·(X²+p²−1)+3.

Algorithm: textbook affine Miller loop entirely in Fq12 (Q untwisted into
E(Fq12) via w-powers), which is deliberately the most transparent correct
formulation — the batched device pairing (``device/pairing.py``) computes
the same map.
"""

from __future__ import annotations

from . import tower as tw
from .params import P, X, X_BITS

# ---------------------------------------------------------------------------
# Untwist: E'(Fq2) -> E(Fq12), (x, y) -> (x / w^2, y / w^3) where w^2 = v.
# An Fq2 element c embeds into Fq12 as ((c,0,0),(0,0,0)).
# 1/w^2 = w^10 / xi^2... we simply build w and invert generically once.
# ---------------------------------------------------------------------------

def _embed_fq2(c):
    return ((c, tw.FQ2_ZERO, tw.FQ2_ZERO), tw.FQ6_ZERO)


# w = (0, 1·v^0) in the Fq6[w] representation: (c0=0, c1=(1,0,0))
_W = (tw.FQ6_ZERO, tw.FQ6_ONE)
_W2 = tw.fq12_mul(_W, _W)
_W3 = tw.fq12_mul(_W2, _W)
_W2_INV = tw.fq12_inv(_W2)
_W3_INV = tw.fq12_inv(_W3)


def untwist(q):
    """Map affine E'(Fq2) point to affine E(Fq12) point."""
    if q is None:
        return None
    x, y = q
    return (
        tw.fq12_mul(_embed_fq2(x), _W2_INV),
        tw.fq12_mul(_embed_fq2(y), _W3_INV),
    )


# ---------------------------------------------------------------------------
# Affine Miller loop in Fq12
# ---------------------------------------------------------------------------

def _line(t, q, p_xy):
    """Evaluate the line through T and Q (or tangent at T if T==Q) at P.

    All points affine in E(Fq12); returns an Fq12 value.  Textbook:
      l(P) = y_P − y_T − λ (x_P − x_T), vertical: l(P) = x_P − x_T.
    """
    xt, yt = t
    xq, yq = q
    xp, yp = p_xy
    f = tw
    if xt == xq and yt == yq:
        # tangent: λ = 3 x_T² / (2 y_T)
        num = f.fq12_mul(f.fq12_sqr(xt), _THREE)
        den = f.fq12_mul(yt, _TWO)
    elif xt == xq:
        # vertical line
        return f.fq12_sub(xp, xt)
    else:
        num = f.fq12_sub(yq, yt)
        den = f.fq12_sub(xq, xt)
    lam = f.fq12_mul(num, f.fq12_inv(den))
    return f.fq12_sub(f.fq12_sub(yp, yt), f.fq12_mul(lam, f.fq12_sub(xp, xt)))


def _const(n: int):
    return (((n % P, 0), tw.FQ2_ZERO, tw.FQ2_ZERO), tw.FQ6_ZERO)


_TWO = _const(2)
_THREE = _const(3)


def _ec_add_fq12(a, b):
    """Affine addition on E(Fq12) (distinct, non-inverse points assumed
    handled by caller for the structured Miller loop)."""
    if a is None:
        return b
    if b is None:
        return a
    xa, ya = a
    xb, yb = b
    if xa == xb:
        if ya == yb:
            lam = tw.fq12_mul(
                tw.fq12_mul(tw.fq12_sqr(xa), _THREE),
                tw.fq12_inv(tw.fq12_mul(ya, _TWO)),
            )
        else:
            return None
    else:
        lam = tw.fq12_mul(tw.fq12_sub(yb, ya), tw.fq12_inv(tw.fq12_sub(xb, xa)))
    x3 = tw.fq12_sub(tw.fq12_sub(tw.fq12_sqr(lam), xa), xb)
    y3 = tw.fq12_sub(tw.fq12_mul(lam, tw.fq12_sub(xa, x3)), ya)
    return (x3, y3)


def miller_loop(p, q) -> tuple:
    """f_{|X|, Q}(P) with conjugation for X < 0.  p ∈ E(Fq), q ∈ E'(Fq2)."""
    if p is None or q is None:
        return tw.FQ12_ONE
    qq = untwist(q)
    pp = (_const(p[0]), _const(p[1]))
    f = tw.FQ12_ONE
    t = qq
    for bit in X_BITS[1:]:
        f = tw.fq12_mul(tw.fq12_sqr(f), _line(t, t, pp))
        t = _ec_add_fq12(t, t)
        if bit:
            f = tw.fq12_mul(f, _line(t, qq, pp))
            t = _ec_add_fq12(t, qq)
    if X < 0:
        f = tw.fq12_conj(f)
    return f


# ---------------------------------------------------------------------------
# Final exponentiation: easy part, then lattice hard part (3x exponent).
# ---------------------------------------------------------------------------

def _exp_by_x(f):
    """f^X in the cyclotomic subgroup (X negative: conjugate at the end)."""
    result = tw.FQ12_ONE
    for bit in X_BITS:
        result = tw.fq12_sqr(result)
        if bit:
            result = tw.fq12_mul(result, f)
    return tw.fq12_conj(result)  # X < 0; inverse == conjugate in cyclotomic


def final_exponentiation(f):
    # NOTE: the lattice hard-part chain below equals 3·(p^4-p^2+1)/r, so
    # this returns the CUBE of the definitional reduced pairing
    # f^((p^12-1)/r) (asserted in tests/test_vectors.py).  gcd(3, r) = 1,
    # so every equality-based use — both reference verify paths compare
    # pairings only for equality (src/lib.rs:109,185,511) —
    # is unaffected, and GT elements never serialize.
    # Easy part: f^((p^6 - 1)(p^2 + 1))
    f = tw.fq12_mul(tw.fq12_conj(f), tw.fq12_inv(f))       # f^(p^6 - 1)
    f = tw.fq12_mul(tw.fq12_frob(f, 2), f)                 # ^(p^2 + 1)
    # Hard part exponent: (X-1)^2 (X+p) (X^2+p^2-1) + 3   == 3*(p^4-p^2+1)/r
    inv = tw.fq12_conj  # cyclotomic inverse

    def exp_x_minus_1(g):
        return tw.fq12_mul(_exp_by_x(g), inv(g))

    t = exp_x_minus_1(exp_x_minus_1(f))                    # f^((X-1)^2)
    t = tw.fq12_mul(_exp_by_x(t), tw.fq12_frob(t, 1))      # ^(X+p)
    t = tw.fq12_mul(
        tw.fq12_mul(_exp_by_x(_exp_by_x(t)), tw.fq12_frob(t, 2)),
        inv(t),
    )                                                      # ^(X^2+p^2-1)
    return tw.fq12_mul(t, tw.fq12_mul(tw.fq12_sqr(f), f))  # * f^3


def pairing(p, q):
    """Full pairing e(P, Q)^3-normalized; P ∈ G1 affine, Q ∈ G2 affine."""
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs):
    """∏ e(P_i, Q_i): one final exponentiation over the product of Miller
    loops — the primitive both verify paths reduce to
    (cf. ``src/lib.rs:109,185,511``)."""
    f = tw.FQ12_ONE
    for p, q in pairs:
        f = tw.fq12_mul(f, miller_loop(p, q))
    return final_exponentiation(f)


def pairing_check(pairs) -> bool:
    """True iff ∏ e(P_i, Q_i) == 1."""
    return tw.fq12_is_one(multi_pairing(pairs))
