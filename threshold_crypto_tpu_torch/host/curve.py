"""Host-side G1/G2 group operations (Python ints).

The parts of ``threshold_crypto_tpu/host/curve.py`` that the port uses: the
generators and cofactors, affine add / neg / double / scalar multiplication
with a Jacobian core, and ``get_point_from_x`` with its root order ``_cmp``
(the sampling chain of ``host/sampling.py``). Points are affine tuples
``(x, y)``; ``None`` is the point at infinity. The input builders of the
tests and of ``chip_smoke.py`` make their points here.
"""

from __future__ import annotations

from . import tower as tw
from .params import B_G1, B_G2, G1_GEN, G2_GEN, H1, H2, P


class _FqOps:
    zero = 0
    one = 1
    add = staticmethod(tw.fq_add)
    sub = staticmethod(tw.fq_sub)
    mul = staticmethod(tw.fq_mul)
    neg = staticmethod(tw.fq_neg)
    inv = staticmethod(tw.fq_inv)
    sqrt = staticmethod(tw.fq_sqrt)

    @staticmethod
    def sqr(a):
        return a * a % P

    @staticmethod
    def is_zero(a):
        return a % P == 0

    @staticmethod
    def scale(a, k):
        return a * k % P


class _Fq2Ops:
    zero = tw.FQ2_ZERO
    one = tw.FQ2_ONE
    add = staticmethod(tw.fq2_add)
    sub = staticmethod(tw.fq2_sub)
    mul = staticmethod(tw.fq2_mul)
    neg = staticmethod(tw.fq2_neg)
    inv = staticmethod(tw.fq2_inv)
    sqrt = staticmethod(tw.fq2_sqrt)
    sqr = staticmethod(tw.fq2_sqr)
    is_zero = staticmethod(tw.fq2_is_zero)
    scale = staticmethod(tw.fq2_scale)


class CurveGroup:
    """One curve group (E(Fq) or E'(Fq2)) with affine API, Jacobian core."""

    def __init__(self, ops, b, generator, cofactor, name):
        self.f = ops
        self.b = b
        self.generator = generator
        self.cofactor = cofactor
        self.name = name

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        f = self.f
        return f.is_zero(f.sub(f.sqr(y), f.add(f.mul(f.sqr(x), x), self.b)))

    def _to_jac(self, pt):
        if pt is None:
            return (self.f.one, self.f.one, self.f.zero)
        return (pt[0], pt[1], self.f.one)

    def _to_affine(self, J):
        x, y, z = J
        f = self.f
        if f.is_zero(z):
            return None
        zi = f.inv(z)
        zi2 = f.sqr(zi)
        return (f.mul(x, zi2), f.mul(y, f.mul(zi2, zi)))

    def _jac_double(self, J):
        x, y, z = J
        f = self.f
        if f.is_zero(z) or f.is_zero(y):
            return (f.one, f.one, f.zero)
        a = f.sqr(x)
        b = f.sqr(y)
        c = f.sqr(b)
        d = f.scale(f.sub(f.sqr(f.add(x, b)), f.add(a, c)), 2)
        e = f.scale(a, 3)
        x3 = f.sub(f.sqr(e), f.scale(d, 2))
        y3 = f.sub(f.mul(e, f.sub(d, x3)), f.scale(c, 8))
        z3 = f.scale(f.mul(y, z), 2)
        return (x3, y3, z3)

    def _jac_add(self, J1, J2):
        f = self.f
        x1, y1, z1 = J1
        x2, y2, z2 = J2
        if f.is_zero(z1):
            return J2
        if f.is_zero(z2):
            return J1
        z1z1 = f.sqr(z1)
        z2z2 = f.sqr(z2)
        u1 = f.mul(x1, z2z2)
        u2 = f.mul(x2, z1z1)
        s1 = f.mul(y1, f.mul(z2z2, z2))
        s2 = f.mul(y2, f.mul(z1z1, z1))
        if u1 == u2:
            if s1 == s2:
                return self._jac_double(J1)
            return (f.one, f.one, f.zero)
        h = f.sub(u2, u1)
        i = f.sqr(f.scale(h, 2))
        j = f.mul(h, i)
        rr = f.scale(f.sub(s2, s1), 2)
        v = f.mul(u1, i)
        x3 = f.sub(f.sqr(rr), f.add(j, f.scale(v, 2)))
        y3 = f.sub(f.mul(rr, f.sub(v, x3)), f.scale(f.mul(s1, j), 2))
        z3 = f.mul(f.sub(f.sqr(f.add(z1, z2)), f.add(z1z1, z2z2)), h)
        return (x3, y3, z3)

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        return self._to_affine(self._jac_add(self._to_jac(p1), self._to_jac(p2)))

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.f.neg(pt[1]))

    def double(self, pt):
        if pt is None:
            return None
        return self._to_affine(self._jac_double(self._to_jac(pt)))

    def mul(self, pt, k: int):
        """Scalar multiplication by any int k (double-and-add, MSB first)."""
        if pt is None or k == 0:
            return None
        if k < 0:
            return self.mul(self.neg(pt), -k)
        acc = (self.f.one, self.f.one, self.f.zero)
        base = self._to_jac(pt)
        for bit in bin(k)[2:]:
            acc = self._jac_double(acc)
            if bit == "1":
                acc = self._jac_add(acc, base)
        return self._to_affine(acc)

    def get_point_from_x(self, x, greatest: bool):
        """pairing 0.16 semantics: y = sqrt(x³+b), pick the lexicographically
        greatest root iff ``greatest``; None if x³+b is a non-residue."""
        f = self.f
        rhs = f.add(f.mul(f.sqr(x), x), self.b)
        y = f.sqrt(rhs)
        if y is None:
            return None
        ny = f.neg(y)
        y_is_greatest = self._cmp(y, ny) > 0
        return (x, y if y_is_greatest == greatest else ny)

    def _cmp(self, a, b):
        if self.f is G1.f:
            return -1 if a < b else (0 if a == b else 1)
        return tw.fq2_cmp(a, b)


G1 = CurveGroup(_FqOps, B_G1, G1_GEN, H1, "G1")
G2 = CurveGroup(_Fq2Ops, B_G2, G2_GEN, H2, "G2")
