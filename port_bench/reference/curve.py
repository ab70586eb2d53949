"""Host-side G1/G2 group operations and ZCash-format point codecs.

Frozen for the benchmark: a verbatim copy of the port's
``threshold_crypto_tpu_torch/host/curve.py``, kept here so that the
benchmark's reference imports nothing of the program and stays fixed
when the program changes.

A copy of ``threshold_crypto_tpu/host/curve.py``. Points are affine tuples
``(x, y)`` with ``None`` for the point at infinity; scalar multiplication
runs internally in Jacobian coordinates. The generic code is parameterized
over a field-ops namespace so G1 (Fq) and G2 (Fq2) share one
implementation. The backend's group elements, the input builders of the
tests and of ``chip_smoke.py`` make their points here.

Compressed encodings are bit-compatible with what the reference emits via
``into_compressed`` (``src/lib.rs:149-153,255-259``,
``src/serde_impl.rs:174-185``): big-endian x with three flag bits in the
top byte (compression 0x80, infinity 0x40, y-is-lexicographically-largest
0x20); decoding validates curve membership AND r-order subgroup
membership, as ``EncodedPoint::into_affine`` does
(``src/serde_impl.rs:205-213``).
"""

from __future__ import annotations

from . import tower as tw
from .params import B_G1, B_G2, G1_GEN, G2_GEN, H1, H2, P, R


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

    # -- affine predicates ---------------------------------------------------
    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        f = self.f
        return f.is_zero(f.sub(f.sqr(y), f.add(f.mul(f.sqr(x), x), self.b)))

    def in_subgroup(self, pt) -> bool:
        return self.mul(pt, R) is None

    # -- Jacobian core -------------------------------------------------------
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

    # -- affine-facing group ops ----------------------------------------------
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
        """Scalar multiplication; k any int (reduced mod r only by group order)."""
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

    def msm(self, points, scalars):
        """Multi-scalar multiplication (host path: simple sum of muls)."""
        acc = (self.f.one, self.f.one, self.f.zero)
        for pt, k in zip(points, scalars):
            if pt is None or k % R == 0:
                continue
            kk = k % R
            base = self._to_jac(pt)
            part = (self.f.one, self.f.one, self.f.zero)
            for bit in bin(kk)[2:]:
                part = self._jac_double(part)
                if bit == "1":
                    part = self._jac_add(part, base)
            acc = self._jac_add(acc, part)
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


# ---------------------------------------------------------------------------
# ZCash-format codecs
# ---------------------------------------------------------------------------
_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SORT = 0x20


def _fq_to_be(x: int) -> bytes:
    return x.to_bytes(48, "big")


def _y_is_greatest_fq(y: int) -> bool:
    return y > P - y


def _y_is_greatest_fq2(y) -> bool:
    return tw.fq2_cmp(y, tw.fq2_neg(y)) > 0


def g1_to_compressed(pt) -> bytes:
    if pt is None:
        out = bytearray(48)
        out[0] = _FLAG_COMPRESSED | _FLAG_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(_fq_to_be(x))
    out[0] |= _FLAG_COMPRESSED
    if _y_is_greatest_fq(y):
        out[0] |= _FLAG_SORT
    return bytes(out)


def g1_to_uncompressed(pt) -> bytes:
    if pt is None:
        out = bytearray(96)
        out[0] = _FLAG_INFINITY
        return bytes(out)
    return _fq_to_be(pt[0]) + _fq_to_be(pt[1])


def g2_to_compressed(pt) -> bytes:
    if pt is None:
        out = bytearray(96)
        out[0] = _FLAG_COMPRESSED | _FLAG_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(_fq_to_be(x[1]) + _fq_to_be(x[0]))
    out[0] |= _FLAG_COMPRESSED
    if _y_is_greatest_fq2(y):
        out[0] |= _FLAG_SORT
    return bytes(out)


def g2_to_uncompressed(pt) -> bytes:
    if pt is None:
        out = bytearray(192)
        out[0] = _FLAG_INFINITY
        return bytes(out)
    x, y = pt
    return _fq_to_be(x[1]) + _fq_to_be(x[0]) + _fq_to_be(y[1]) + _fq_to_be(y[0])


class DecodeError(ValueError):
    pass


def _check_flags(first: int, compressed: bool):
    if compressed and not (first & _FLAG_COMPRESSED):
        raise DecodeError("compression flag not set")
    if not compressed and (first & _FLAG_COMPRESSED):
        raise DecodeError("compression flag set on uncompressed encoding")


def g1_from_compressed(data: bytes, check_subgroup: bool = True):
    if len(data) != 48:
        raise DecodeError("G1 compressed encoding must be 48 bytes")
    first = data[0]
    _check_flags(first, True)
    if first & _FLAG_INFINITY:
        if first & ~(_FLAG_COMPRESSED | _FLAG_INFINITY) or any(data[1:]):
            raise DecodeError("malformed infinity encoding")
        return None
    greatest = bool(first & _FLAG_SORT)
    x = int.from_bytes(bytes([first & 0x1F]) + data[1:], "big")
    if x >= P:
        raise DecodeError("x coordinate not in field")
    rhs = (x * x % P * x + B_G1) % P
    y = tw.fq_sqrt(rhs)
    if y is None:
        raise DecodeError("x is not on the curve")
    if _y_is_greatest_fq(y) != greatest:
        y = P - y
    pt = (x, y)
    if check_subgroup and not G1.in_subgroup(pt):
        raise DecodeError("point not in the r-order subgroup")
    return pt


def g2_from_compressed(data: bytes, check_subgroup: bool = True):
    if len(data) != 96:
        raise DecodeError("G2 compressed encoding must be 96 bytes")
    first = data[0]
    _check_flags(first, True)
    if first & _FLAG_INFINITY:
        if first & ~(_FLAG_COMPRESSED | _FLAG_INFINITY) or any(data[1:]):
            raise DecodeError("malformed infinity encoding")
        return None
    greatest = bool(first & _FLAG_SORT)
    x1 = int.from_bytes(bytes([first & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise DecodeError("x coordinate not in field")
    x = (x0, x1)
    rhs = tw.fq2_add(tw.fq2_mul(tw.fq2_sqr(x), x), B_G2)
    y = tw.fq2_sqrt(rhs)
    if y is None:
        raise DecodeError("x is not on the curve")
    if _y_is_greatest_fq2(y) != greatest:
        y = tw.fq2_neg(y)
    pt = (x, y)
    if check_subgroup and not G2.in_subgroup(pt):
        raise DecodeError("point not in the r-order subgroup")
    return pt
