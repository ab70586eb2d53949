"""Batched, branch-free G1/G2 curve operations on torch tensors.

The counterpart of ``threshold_crypto_tpu/device/curve.py`` (``DeviceCurve``:
``infinity``, ``generator``, ``from_host_affine``, ``to_host_affine``,
``double``, ``add``, ``neg``, ``eq``, ``is_infinity``, ``scalar_mul``,
``scalar_mul_naive``, ``msm``, ``msm_naive``, ``msm_scalarwise``;
``scalar_bits``, ``scalar_digits``, ``fold_sum``, whose ``fold_axis`` also
stands for ``_tree_sum``; ``fr_limbs_from_ints``) and of the
point formulas of ``threshold_crypto_tpu/device/pallas_curve.py:143-370``
(``_msm_step``, ``_jac_dbl``, ``_jac_add``, ``_jac_madd``, ``_msm_step_w4``)
and its ``dcv_select_z``, which are the plain versions of the curve kernels
B10, B11, B13, B15 and B16 (``device/cuda_curve.py``;
``csrc/ladder_engine.cuh``).

Points are Jacobian tuples ``(X, Y, Z)`` (infinity ⇔ Z == 0) of batched field
values: int32[..., 24] Montgomery limb tensors for G1 (Fq), pairs of them
for G2 (Fq2). Every case (infinity, T == Q, T == −Q) is a select, never a
branch. The formulas are the JAX kernels' value for value: the same
products in the same layers (each layer one stacked product, so one B1
launch on the card), the same small multiples and the same select order,
so every coordinate is the same canonical field value as the TPU kernels'.
``DeviceCurve.double``/``add`` are ``jac_dbl``/``jac_add``: the JAX
``curve.double``/``curve.add`` compute the same values (the same
X, Y, Z for every input), with one product per call instead of one per
layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import curve as hcv
from ..host.params import G1_GEN, G2_GEN
from . import mont
from . import tower as tw
from .mont import FQ


def tree_map(fn, *trees):
    """fn over the leaves of equally shaped nested tuples."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def leaves(tree):
    """The leaves of nested tuples and lists, depth first, in the order of
    ``jax.tree_util.tree_leaves``."""
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


class FqOps:
    """Fq as the field vocabulary of the point formulas."""

    mul_many = staticmethod(tw._mul_many)

    @staticmethod
    def mul(a, b):
        return mont.mul(FQ, a, b)

    @staticmethod
    def sqr(a):
        return mont.mul(FQ, a, a)

    @staticmethod
    def add(a, b):
        return mont.add(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return mont.sub(FQ, a, b)

    @staticmethod
    def neg(a):
        return mont.neg(FQ, a)

    @staticmethod
    def small(a, k):
        return mont.mul_small(FQ, a, k)

    mul_small = small

    @staticmethod
    def eq(a, b):
        return mont.eq(FQ, a, b)

    @staticmethod
    def inv(a):
        return mont.inv(FQ, a)

    @staticmethod
    def select(cond, a, b):
        return mont.select(cond, a, b)

    @staticmethod
    def is_zero(a):
        return mont.is_zero(FQ, a)

    @staticmethod
    def shape(a):
        return a.shape[:-1]

    @staticmethod
    def one(shape, device):
        return mont.one(FQ, shape, device)

    @staticmethod
    def zero(shape, device):
        return mont.zero(FQ, shape, device)

    @staticmethod
    def one_like(a):
        return mont.one(FQ, a.shape[:-1], a.device)

    zero_like = staticmethod(mont.zeros_like_el)

    @staticmethod
    def from_host(vals, device):
        return torch.from_numpy(mont.stack_mont(FQ, vals)).to(device)

    @staticmethod
    def to_host(a):
        return mont.unstack_mont(FQ, a)


class Fq2Ops:
    """Fq2 pairs (c0, c1) as the field vocabulary of the point formulas."""

    mul_many = staticmethod(tw.fq2_mul_many)
    mul = staticmethod(tw.fq2_mul)
    sqr = staticmethod(tw.fq2_sqr)
    add = staticmethod(tw.fq2_add)
    sub = staticmethod(tw.fq2_sub)
    neg = staticmethod(tw.fq2_neg)
    small = staticmethod(tw.fq2_mul_small)
    inv = staticmethod(tw.fq2_inv)
    select = staticmethod(tw.fq2_select)
    one = staticmethod(tw.fq2_one)
    zero = staticmethod(tw.fq2_zero)
    from_host = staticmethod(tw.fq2_from_host)
    to_host = staticmethod(tw.fq2_to_host)
    is_zero = staticmethod(tw.fq2_is_zero)

    @staticmethod
    def shape(a):
        return a[0].shape[:-1]

    @staticmethod
    def one_like(a):
        return tw.fq2_one(a[0].shape[:-1], a[0].device)

    @staticmethod
    def zero_like(a):
        return (torch.zeros_like(a[0]), torch.zeros_like(a[1]))


# ---------------------------------------------------------------------------
# The point formulas of the MSM kernels (pallas_curve.py:234-353)
# ---------------------------------------------------------------------------

def _sel3(F, c, a, b):
    return tuple(F.select(c, a[i], b[i]) for i in range(3))


def msm_step(F, T, Q, do_add):
    """One bit of the per-lane ladder (B15): 2T, then + Q (affine) where
    ``do_add``; complete: T at infinity, 2T == Q (a second doubling) and
    2T == −Q (infinity) by selects. 25 products in 6 layers, the doubling
    of T and of 2T interleaved with the mixed add as in the JAX body."""
    X, Y, Z = T
    x2, y2 = Q
    # L1: doubling squares and products
    A, B, S = F.mul_many([(X, X), (Y, Y), (Y, Z)])
    XpB = F.add(X, B)
    E = F.small(A, 3)
    # L2: finish the doubling, start the add's Z chain: Zd² = 4S²
    C, XB2, E2, SS = F.mul_many([(B, B), (XpB, XpB), (E, E), (S, S)])
    D = F.small(F.sub(F.sub(XB2, A), C), 2)
    Xd = F.sub(E2, F.small(D, 2))
    z1z = F.small(SS, 4)
    Zd = F.small(S, 2)
    # L3: the doubling's Y, the add's u2 and Zd³
    EDX, u2, z1cu = F.mul_many([(E, F.sub(D, Xd)), (x2, z1z), (z1z, Zd)])
    Yd = F.sub(EDX, F.small(C, 8))
    h = F.sub(u2, Xd)
    # L4: s2, h², and the doubling of 2T for the 2T == Q case
    s2, hh, A2, B2, S2 = F.mul_many([(y2, z1cu), (h, h), (Xd, Xd),
                                     (Yd, Yd), (Yd, Zd)])
    r = F.sub(s2, Yd)
    XpB2 = F.add(Xd, B2)
    E2_ = F.small(A2, 3)
    # L5
    hhh, v, rr, C2, XB2b, E2sq = F.mul_many(
        [(h, hh), (Xd, hh), (r, r), (B2, B2), (XpB2, XpB2), (E2_, E2_)])
    Xn = F.sub(F.sub(rr, hhh), F.small(v, 2))
    D2 = F.small(F.sub(F.sub(XB2b, A2), C2), 2)
    Xdd = F.sub(E2sq, F.small(D2, 2))
    # L6
    rvx, Yhhh, Zn, EDX2 = F.mul_many(
        [(r, F.sub(v, Xn)), (Yd, hhh), (Zd, h), (E2_, F.sub(D2, Xdd))])
    Yn = F.sub(rvx, Yhhh)
    Ydd = F.sub(EDX2, F.small(C2, 8))
    Zdd = F.small(S2, 2)

    one, zero = F.one_like(X), F.zero_like(X)
    h0, r0, t_inf = F.is_zero(h), F.is_zero(r), F.is_zero(Zd)
    out = (Xn, Yn, Zn)
    out = _sel3(F, h0 & r0, (Xdd, Ydd, Zdd), out)     # 2T == Q  -> 4T
    out = _sel3(F, h0 & ~r0, (one, one, zero), out)   # 2T == -Q -> infinity
    out = _sel3(F, t_inf, (x2, y2, one), out)         # T at infinity -> Q
    return _sel3(F, do_add, out, (Xd, Yd, Zd))        # bit clear -> 2T


def jac_dbl(F, T):
    """Jacobian doubling (a = 0): 7 products in 3 layers; Z = 0 stays 0."""
    X, Y, Z = T
    A, B, S = F.mul_many([(X, X), (Y, Y), (Y, Z)])
    XpB = F.add(X, B)
    E = F.small(A, 3)
    C, XB2, E2 = F.mul_many([(B, B), (XpB, XpB), (E, E)])
    D = F.small(F.sub(F.sub(XB2, A), C), 2)
    Xd = F.sub(E2, F.small(D, 2))
    (EDX,) = F.mul_many([(E, F.sub(D, Xd))])
    Yd = F.sub(EDX, F.small(C, 8))
    Zd = F.small(S, 2)
    return (Xd, Yd, Zd)


def jac_add(F, T, Q):
    """Complete Jacobian + Jacobian add: T or Q at infinity, T == Q
    (doubles) and T == −Q (infinity) by selects; 23 products in 5 layers."""
    X1, Y1, Z1 = T
    X2, Y2, Z2 = Q
    z1z, z2z, Z1Z2 = F.mul_many([(Z1, Z1), (Z2, Z2), (Z1, Z2)])
    u1, u2, z2c, z1c = F.mul_many([(X1, z2z), (X2, z1z), (z2z, Z2),
                                   (z1z, Z1)])
    h = F.sub(u2, u1)
    s1, s2, hh, A_, B_, S_ = F.mul_many(
        [(Y1, z2c), (Y2, z1c), (h, h), (X1, X1), (Y1, Y1), (Y1, Z1)])
    r = F.sub(s2, s1)
    XpB = F.add(X1, B_)
    E_ = F.small(A_, 3)
    hhh, v, rr, Zo, C_, XB2, E2 = F.mul_many(
        [(h, hh), (u1, hh), (r, r), (Z1Z2, h), (B_, B_), (XpB, XpB),
         (E_, E_)])
    Xo = F.sub(F.sub(rr, hhh), F.small(v, 2))
    D_ = F.small(F.sub(F.sub(XB2, A_), C_), 2)
    Xd = F.sub(E2, F.small(D_, 2))
    rvx, s1hhh, EDX = F.mul_many(
        [(r, F.sub(v, Xo)), (s1, hhh), (E_, F.sub(D_, Xd))])
    Yo = F.sub(rvx, s1hhh)
    Yd = F.sub(EDX, F.small(C_, 8))
    Zd = F.small(S_, 2)

    one, zero = F.one_like(X1), F.zero_like(X1)
    inf1, inf2 = F.is_zero(Z1), F.is_zero(Z2)
    h0, r0 = F.is_zero(h), F.is_zero(r)
    out = (Xo, Yo, Zo)
    out = _sel3(F, h0 & r0, (Xd, Yd, Zd), out)        # T == Q  -> 2T
    out = _sel3(F, h0 & ~r0, (one, one, zero), out)   # T == -Q -> infinity
    out = _sel3(F, inf2, T, out)                      # T + 0
    out = _sel3(F, inf1, Q, out)                      # 0 + Q
    return out


def jac_madd(F, T, Q):
    """Complete mixed add T (Jacobian) + Q (affine, not at infinity): T at
    infinity, T == Q and T == −Q by selects; 18 products in 5 layers."""
    X, Y, Z = T
    x2, y2 = Q
    z1z, A, B, S = F.mul_many([(Z, Z), (X, X), (Y, Y), (Y, Z)])
    XpB = F.add(X, B)
    E = F.small(A, 3)
    u2, z1cu, C, XB2, E2 = F.mul_many(
        [(x2, z1z), (z1z, Z), (B, B), (XpB, XpB), (E, E)])
    h = F.sub(u2, X)
    D = F.small(F.sub(F.sub(XB2, A), C), 2)
    Xd = F.sub(E2, F.small(D, 2))
    s2, hh, EDX = F.mul_many([(y2, z1cu), (h, h), (E, F.sub(D, Xd))])
    r = F.sub(s2, Y)
    Yd = F.sub(EDX, F.small(C, 8))
    Zd = F.small(S, 2)
    hhh, v, rr, Zn = F.mul_many([(h, hh), (X, hh), (r, r), (Z, h)])
    Xn = F.sub(F.sub(rr, hhh), F.small(v, 2))
    m = F.mul_many([(r, F.sub(v, Xn)), (Y, hhh)])
    Yn = F.sub(m[0], m[1])

    one, zero = F.one_like(X), F.zero_like(X)
    h0, r0, t_inf = F.is_zero(h), F.is_zero(r), F.is_zero(Z)
    out = (Xn, Yn, Zn)
    out = _sel3(F, h0 & r0, (Xd, Yd, Zd), out)        # T == Q  -> 2T
    out = _sel3(F, h0 & ~r0, (one, one, zero), out)   # T == -Q -> infinity
    out = _sel3(F, t_inf, (x2, y2, one), out)         # 0 + Q -> Q
    return out


def msm_step_w4(F, T, Q, digit):
    """One base-16 digit of the per-lane ladder (B13): 16T, then + Q with
    the complete add where ``digit`` ≠ 0. Q is table[digit − 1], the one
    entry the lane needs (the JAX body selects it over all 15 entries; the
    value is the same)."""
    for _ in range(4):
        T = jac_dbl(F, T)
    return _sel3(F, digit != 0, jac_add(F, T, Q), T)


# ---------------------------------------------------------------------------
# The curve groups
# ---------------------------------------------------------------------------

class DeviceCurve:
    """One batched curve group (E(Fq) for G1, E'(Fq2) for G2)."""

    def __init__(self, f, gen_affine, host, name):
        self.f = f
        self.gen_affine_host = gen_affine
        self.host = host
        self.name = name

    def infinity(self, shape, device):
        f = self.f
        return (f.one(shape, device), f.one(shape, device),
                f.zero(shape, device))

    def generator(self, shape, device):
        """The group's generator, Z = 1, broadcast to ``shape``."""
        f = self.f
        x, y = self.gen_affine_host
        return tree_map(lambda a: a[0].expand(tuple(shape) + a.shape[1:]),
                        (f.from_host([x], device), f.from_host([y], device),
                         f.one((1,), device)))

    def from_host_affine(self, pts, device="cuda"):
        """Host affine points (None = infinity) -> batched Jacobian tuple,
        Z ∈ {0, 1}; an infinity lane carries the generator's coordinates."""
        device = mont.device_of(device)
        f = self.f
        pts2 = [self.gen_affine_host if p is None else p for p in pts]
        live = torch.tensor([p is not None for p in pts], device=device)
        n = len(pts)
        return (f.from_host([p[0] for p in pts2], device),
                f.from_host([p[1] for p in pts2], device),
                f.select(live, f.one((n,), device), f.zero((n,), device)))

    def to_host_affine(self, pt):
        """Batched Jacobian tuple [N] -> host affine points (None = inf)."""
        f = self.f
        cols = [f.to_host(c) for c in pt]
        return [self.host._to_affine(j) for j in zip(*cols)]

    def is_infinity(self, p):
        return self.f.is_zero(p[2])

    def double(self, p):
        return jac_dbl(self.f, p)

    def add(self, p1, p2):
        return jac_add(self.f, p1, p2)

    def neg(self, p):
        X, Y, Z = p
        return (X, self.f.neg(Y), Z)

    def eq(self, p1, p2):
        """bool[...]: the points are equal (as affine points; infinity
        equals infinity only): X1·Z2² == X2·Z1² and Y1·Z2³ == Y2·Z1³ on
        canonical values, the JAX ``eq``."""
        f = self.f
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        z1z, z2z = f.mul_many([(Z1, Z1), (Z2, Z2)])
        x1, x2, z2c, z1c = f.mul_many([(X1, z2z), (X2, z1z), (z2z, Z2),
                                       (z1z, Z1)])
        y1, y2 = f.mul_many([(Y1, z2c), (Y2, z1c)])
        ex = f.is_zero(f.sub(x1, x2))
        ey = f.is_zero(f.sub(y1, y2))
        inf1, inf2 = f.is_zero(Z1), f.is_zero(Z2)
        return (inf1 & inf2) | (~inf1 & ~inf2 & ex & ey)

    def scalar_mul(self, p, k_plain, nbits: int = 255, window: int = 4):
        """p·k per lane, for Jacobian points p and canonical Fr limbs
        k_plain (int32[..., 16]) of one batch shape. The points are lifted
        to affine (``ops.threshold.jacobian_to_affine``: on the card one
        B2), then the ladder ``cuda_curve.scalar_mul_pallas`` runs: window
        4, the 1P..15P table (14 B10) and one B13 over ⌈nbits/4⌉ digits;
        window 1, one B15 over the bits. Infinity lanes give infinity.
        The values equal the JAX window-4 ladder's as affine points; the
        Jacobian coordinates may differ. Returns a Jacobian tuple of the
        batch shape."""
        from ..ops.threshold import jacobian_to_affine  # imports this
        from . import cuda_curve

        shape = self.f.shape(p[2])
        flat = tree_map(lambda a: a.reshape((-1,) + a.shape[len(shape):]),
                        p)
        aff = jacobian_to_affine(self, flat)
        out = cuda_curve.scalar_mul_pallas(
            self, aff, k_plain.reshape(-1, k_plain.shape[-1]), nbits=nbits,
            window=window)
        return tree_map(lambda a: a.reshape(tuple(shape) + a.shape[1:]), out)

    def scalar_mul_naive(self, p, k_limbs, nbits: int = 255):
        """p·k per lane by the plain double-and-add bit scan, MSB first (a
        doubling and a complete add a bit, the add kept where the bit is
        set): the JAX package's cross-check form of ``scalar_mul``, in
        torch ops. Returns a Jacobian tuple of the batch shape."""
        acc = self.infinity(self.f.shape(p[2]), leaves(p)[0].device)
        for bit in scalar_bits(k_limbs, nbits):
            acc = self.double(acc)
            acc = _sel3(self.f, bit != 0, self.add(acc, p), acc)
        return acc

    def msm_naive(self, points, scalars, nbits: int = 255):
        """Σ points_i·scalars_i over the leading axis by the shared bit
        scan: per bit, MSB first, the running total doubles, then adds the
        fold of the points whose bit is set (the JAX package's cross-check
        form of ``msm``, in torch ops). Returns an unbatched point."""
        shape = self.f.shape(points[2])
        dev = leaves(points)[0].device
        inf = self.infinity(shape, dev)
        acc = self.infinity(shape[1:], dev)
        for bit in scalar_bits(scalars, nbits):
            acc = self.add(self.double(acc),
                           self.fold_sum(_sel3(self.f, bit != 0, points,
                                               inf)))
        return acc

    def msm(self, points, scalars, nbits: int = 255, window: int = 4):
        """Σ points_i·scalars_i over Jacobian points [N] (infinity lanes
        allowed), any ``nbits`` and ``window``: the points are lifted to
        affine (``ops.threshold.jacobian_to_affine``: one B2), then one
        shared block of accumulators runs the windows
        (``cuda_curve.msm_pallas_shared(fused=False)``: the table 1P ..
        (2^w − 1)P in 2^w − 2 B10, per window one B16 dblw and one B16
        selmadd per block of lanes, dead lanes at digit 0), then the fold.
        The JAX ``msm``'s sum as an affine point. Returns an unbatched
        point."""
        from ..ops.threshold import jacobian_to_affine  # imports this
        from . import cuda_curve

        return cuda_curve.msm_pallas_shared(
            self, jacobian_to_affine(self, points), scalars, nbits=nbits,
            window=window, fused=False)

    def msm_scalarwise(self, points, scalars, nbits: int = 255,
                       window: int = 1):
        """Σ points_i·scalars_i over Jacobian points [N]: N per-lane
        ladders (``scalar_mul``, by default window 1: one B15), then one
        ``fold_sum``. Returns an unbatched point."""
        return self.fold_sum(self.scalar_mul(points, scalars, nbits=nbits,
                                             window=window))

    def fold_axis(self, pts, axis: int = 0):
        """Σ over one batch axis by a pairwise tree of complete adds:
        ⌈log₂ n⌉ levels, each one stacked add of the first half of the
        entries to the second; an odd level is padded with infinity. The
        other batch axes stay. The JAX ``_tree_sum`` pairs neighbours
        instead: the same sums as affine points."""
        pts = tree_map(lambda a: a.movedim(axis, 0), pts)
        n = self.f.shape(pts[2])[0]
        while n > 1:
            if n % 2:
                rest = self.f.shape(pts[2])[1:]
                pad = self.infinity((1,) + tuple(rest),
                                    leaves(pts)[0].device)
                pts = tree_map(lambda a, b: torch.cat([a, b]), pts, pad)
                n += 1
            half = n // 2
            pts = self.add(tree_map(lambda a: a[:half], pts),
                           tree_map(lambda a: a[half:], pts))
            n = half
        return tree_map(lambda a: a[0], pts)

    def fold_sum(self, pts):
        """Σ over the leading axis (``fold_axis`` 0). Returns an
        unbatched point for a batch [N]."""
        return self.fold_axis(pts, 0)


def fold_sum(curve, pts, widths=None):
    """Σ over the leading axis: ``curve.fold_sum``. ``widths`` (the JAX
    function's scan tiling of XLA adds) is accepted and unused: the port's
    fold is a pairwise tree, the same sum as an affine point."""
    return curve.fold_sum(pts)


G1 = DeviceCurve(FqOps, G1_GEN, hcv.G1, "G1")
G2 = DeviceCurve(Fq2Ops, G2_GEN, hcv.G2, "G2")


def select_z(curve, inf):
    """Z ∈ {0, 1} of an affine tuple's lift to Jacobian: 0 on the infinity
    lanes (``pallas_curve.dcv_select_z``)."""
    f = curve.f
    shape, dev = inf.shape, inf.device
    return f.select(inf, f.zero(shape, dev), f.one(shape, dev))


def fr_limbs_from_ints(ks, device="cuda"):
    """Host scalars -> canonical (plain, not Montgomery) Fr limbs
    int32[N, 16] on ``device``."""
    raw = b"".join((int(k) % mont.FR.p).to_bytes(32, "little") for k in ks)
    limbs = np.frombuffer(raw, dtype="<u2").astype(np.int32)
    return torch.from_numpy(limbs.reshape(len(ks), mont.FR.L)).to(
        mont.device_of(device))


def scalar_bits(k_limbs, nbits: int):
    """int32[..., L] canonical limbs -> int32[nbits, ...] bits, MSB first."""
    return torch.stack([(k_limbs[..., k // 16] >> (k % 16)) & 1
                        for k in range(nbits - 1, -1, -1)])


def scalar_digits(k_limbs, nbits: int, window: int):
    """int32[..., L] canonical limbs -> int32[D, ...] base-2^window digits,
    MSB first, D = ⌈nbits/window⌉. Digit d covers bits [d·w, (d+1)·w),
    read from one limb or, where the window straddles a 16-bit boundary,
    two adjacent limbs."""
    assert 1 <= window <= 16
    L = k_limbs.shape[-1]
    mask = (1 << window) - 1
    chunks = []
    for d in range(-(-nbits // window) - 1, -1, -1):
        limb, shift = divmod(d * window, 16)
        v = k_limbs[..., limb] >> shift
        if shift + window > 16 and limb + 1 < L:
            v = v | (k_limbs[..., limb + 1] << (16 - shift))
        chunks.append(v & mask)
    return torch.stack(chunks)
