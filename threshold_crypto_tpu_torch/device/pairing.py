"""Batched BLS12-381 ate pairing check on torch tensors.

The counterpart of the XLA path of ``threshold_crypto_tpu/device/pairing.py``
(``pairing_check_fused``): the Miller loop with Q in homogeneous projective
Fq2 coordinates and sparse line values folded into f by
``fq12_mul_by_014``, then the final exponentiation as the host oracle's
lattice chain (X−1)²·(X+p)·(X²+p²−1)+3, so the GT elements are identical to
the JAX package's and the host oracle's.

PyTorch runs eagerly, so both loops are plain Python over the static bits
of |X| (the JAX package's static-bit forms ``miller_loop`` / ``_exp_by_x``):
no add on zero bits, no select per bit.

Points are affine tuples with a free leading batch shape:
  G1: (x, y, inf) — x, y int32[..., 24] Montgomery limbs, inf bool[...]
  G2: (x, y, inf) — x, y Fq2 pairs of the same,           inf bool[...]
"""

from __future__ import annotations

import torch

from ..host.params import X_BITS
from . import mont
from . import tower as tw
from .mont import FQ


def g1_affine_from_host(pts, device="cuda"):
    """List of host affine G1 points (None = infinity) -> batched tuple."""
    device = mont.device_of(device)
    xs = [0 if pt is None else pt[0] for pt in pts]
    ys = [0 if pt is None else pt[1] for pt in pts]
    infs = [pt is None for pt in pts]
    return (
        torch.from_numpy(mont.stack_mont(FQ, xs)).to(device),
        torch.from_numpy(mont.stack_mont(FQ, ys)).to(device),
        torch.tensor(infs, dtype=torch.bool, device=device),
    )


def g2_affine_from_host(pts, device="cuda"):
    """List of host affine G2 points (None = infinity) -> batched tuple."""
    device = mont.device_of(device)
    zero = ((0, 0), (0, 0))
    pts2 = [zero if pt is None else pt for pt in pts]
    x = tw.fq2_from_host([pt[0] for pt in pts2], device)
    y = tw.fq2_from_host([pt[1] for pt in pts2], device)
    infs = torch.tensor([pt is None for pt in pts], dtype=torch.bool,
                        device=device)
    return (x, y, infs)


# ---------------------------------------------------------------------------
# Miller loop steps. T = (X, Y, Z) homogeneous projective over Fq2.
# ---------------------------------------------------------------------------

def _dbl_step(T, xp, yp):
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
    XX, YY, S, XY, ZZ = tw.fq2_mul_many(
        [(X, X), (Y, Y), (Y, Z), (X, Y), (Z, Z)])
    W = tw.fq2_mul_small(XX, 3)
    WW, B, SS, XXX, ZYY, WZ, YZZ = tw.fq2_mul_many(
        [(W, W), (XY, S), (S, S), (XX, X), (YY, Z), (W, Z), (Y, ZZ)])
    B4 = tw.fq2_mul_small(B, 4)
    H = tw.fq2_sub(WW, tw.fq2_add(B4, B4))                       # W² − 8B
    H2, ZYY2, YZZ2 = tw.fq2_mul_small_many([H, ZYY, YZZ], 2)
    XXX3 = tw.fq2_mul_small(XXX, 3)
    Xo, WBH, YYSS, SSS = tw.fq2_mul_many(
        [(H2, S), (W, tw.fq2_sub(B4, H)), (YY, SS), (S, SS)])
    YYSS8, Zo = tw.fq2_mul_small_many([YYSS, SSS], 8)
    Yo, c0 = tw.fq2_sub_many([(WBH, YYSS8), (XXX3, ZYY2)])
    c1, c4 = _scale_many([(tw.fq2_neg(WZ), xp), (YZZ2, yp)])
    return (Xo, Yo, Zo), (c0, c1, c4)


def _scale_many(pairs):
    """Fq2 × Fq products (x·k) of a list, as one stacked multiply."""
    t = mont.mul(FQ, tw._stack([c for x, _ in pairs for c in x]),
                 tw._stack([k for _, k in pairs for _ in range(2)]))
    return [(t[2 * i], t[2 * i + 1]) for i in range(len(pairs))]


def _add_step(T, Q, xp, yp):
    """Mixed addition T += Q (Q affine) and the line through T, Q at P.

    u = y₂Z − Y, v = x₂Z − X;  line (scaled by w³·v):
      c0 = u·x₂ − v·y₂,  c1 = −u·xp,  c4 = v·yp.
    Addition: A = u²Z − v³ − 2v²X → X'=vA, Y'=u(v²X−A)−v³Y, Z'=v³Z.
    """
    X, Y, Z = T
    x2, y2 = Q
    u = tw.fq2_sub(tw.fq2_mul(y2, Z), Y)
    v = tw.fq2_sub(tw.fq2_mul(x2, Z), X)
    vv = tw.fq2_sqr(v)
    vvv = tw.fq2_mul(v, vv)
    R = tw.fq2_mul(vv, X)
    A = tw.fq2_sub(
        tw.fq2_sub(tw.fq2_mul(tw.fq2_sqr(u), Z), vvv), tw.fq2_mul_small(R, 2)
    )
    Xo = tw.fq2_mul(v, A)
    Yo = tw.fq2_sub(tw.fq2_mul(u, tw.fq2_sub(R, A)), tw.fq2_mul(vvv, Y))
    Zo = tw.fq2_mul(vvv, Z)

    c0 = tw.fq2_sub(tw.fq2_mul(u, x2), tw.fq2_mul(v, y2))
    c1 = tw.fq2_scale_fq(tw.fq2_neg(u), xp)
    c4 = tw.fq2_scale_fq(v, yp)
    return (Xo, Yo, Zo), (c0, c1, c4)


def miller_loop(p_aff, q_aff):
    """f_{|X|,Q}(P), conjugated for X < 0; batched Fq12.

    Lanes with an infinite P or Q give exactly 1.
    """
    xp, yp, p_inf = p_aff
    xq, yq, q_inf = q_aff
    shape, dev = xp.shape[:-1], xp.device

    T = (xq, yq, tw.fq2_one(shape, dev))
    f = tw.fq12_one(shape, dev)
    for bit in X_BITS[1:]:
        f = tw.fq12_sqr(f)
        T, line = _dbl_step(T, xp, yp)
        f = tw.fq12_mul_by_014(f, *line)
        if bit:
            T, line = _add_step(T, (xq, yq), xp, yp)
            f = tw.fq12_mul_by_014(f, *line)
    f = tw.fq12_conj(f)  # X < 0
    return tw.fq12_select(p_inf | q_inf, tw.fq12_one(shape, dev), f)


# ---------------------------------------------------------------------------
# Final exponentiation (the host oracle's chain).
# ---------------------------------------------------------------------------

def _exp_by_x(f):
    """f^X in the cyclotomic subgroup (X < 0: conjugate at the end).

    MSB-first square-and-multiply over the static |X| bits (63 cyclotomic
    squarings, 5 multiplies); the leading 1-bit is f itself."""
    result = f
    for bit in X_BITS[1:]:
        result = tw.fq12_cyclo_sqr(result)
        if bit:
            result = tw.fq12_mul(result, f)
    return tw.fq12_conj(result)


def _easy_part(f):
    f = tw.fq12_mul(tw.fq12_conj(f), tw.fq12_inv(f))
    return tw.fq12_mul(tw.fq12_frob(f, 2), f)


def final_exponentiation(f):
    """Easy part, then the lattice hard part (X−1)²(X+p)(X²+p²−1) + 3."""
    f = _easy_part(f)
    t = tw.fq12_mul(_exp_by_x(f), tw.fq12_conj(f))       # f^(X-1)
    t = tw.fq12_mul(_exp_by_x(t), tw.fq12_conj(t))       # f^((X-1)^2)
    t = tw.fq12_mul(_exp_by_x(t), tw.fq12_frob(t, 1))    # ^(X+p)
    tx2 = _exp_by_x(_exp_by_x(t))
    t = tw.fq12_mul(tw.fq12_mul(tx2, tw.fq12_frob(t, 2)), tw.fq12_conj(t))
    return tw.fq12_mul(t, tw.fq12_mul(tw.fq12_sqr(f), f))  # * f^3


def _fq12_prod_leading(f, k: int):
    """Product of a [k, ...]-batched Fq12 over the leading axis (static k)."""
    def lane(i):
        return tuple(tuple((c[0][i], c[1][i]) for c in f6) for f6 in f)

    acc = lane(0)
    for i in range(1, k):
        acc = tw.fq12_mul(acc, lane(i))
    return acc


def pairing(p_aff, q_aff):
    """Reduced pairing per batch lane; equals the host oracle's exactly."""
    return final_exponentiation(miller_loop(p_aff, q_aff))


def pairing_check(p_aff, q_aff):
    """bool[...]: ∏ e(P_i, Q_i) == 1 over the leading pair axis, with one
    shared final exponentiation per lane."""
    f = miller_loop(p_aff, q_aff)
    acc = _fq12_prod_leading(f, p_aff[0].shape[0])
    return tw.fq12_is_one(final_exponentiation(acc))
