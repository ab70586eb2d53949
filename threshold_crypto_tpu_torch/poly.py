"""Uni- and bivariate polynomials and commitments for secret sharing / DKG.

A copy of ``threshold_crypto_tpu/poly.py``, mirroring the reference's
``src/poly.rs`` semantics exactly:

* ``Poly`` — univariate over Fr with full ring ops (``src/poly.rs:67-268``),
  Horner evaluation (``:358-369``), Feldman commitment (``:372-377``),
  Lagrange interpolation (``:388-417``), trailing-zero trimming on add/sub
  (``:380-384``).
* ``Commitment`` — the same polynomial mapped coefficient-wise into G1
  (``src/poly.rs:429-516``).
* ``BivarPoly`` / ``BivarCommitment`` — symmetric bivariate polynomials with
  triangular coefficient storage for DKG (``src/poly.rs:518-753``);
  ``coeff_pos`` is the position of a coefficient in that layout.

Fr coefficients are plain ints mod ``backend.r``; commitments hold backend
G1 elements. The scalar-path math here is host-side; the batched device
forms of the same objects are the DKG ops of ``ops`` (``commit_batch``,
``bivar_commit_batch``, ``bivar_row_batch``, ...), which use
``coeff_pos``'s layout.
"""

from __future__ import annotations

from .backend import get_backend
from .error import DegreeTooHigh
from .into_fr import into_fr

_USIZE_MAX = (1 << 64) - 1


def coeff_pos(i: int, j: int):
    """Position of coefficient (i, j) in the symmetric triangular layout;
    None if it overflows usize (``src/poly.rs:749-753``)."""
    if j < i:
        i, j = j, i
    # The reference's checked usize arithmetic: j + 1, j·(j + 1) and the
    # final sum must each fit in 64 bits.
    if j + 1 > _USIZE_MAX or j * (j + 1) > _USIZE_MAX:
        return None
    pos = i + j * (j + 1) // 2
    if pos > _USIZE_MAX:
        return None
    return pos


class Poly:
    """A univariate polynomial over Fr."""

    __slots__ = ("coeff",)

    def __init__(self, coeff):
        self.coeff = [c % get_backend().r for c in coeff]

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_coeffs(cls, coeff):
        return cls(coeff)

    @classmethod
    def zero(cls):
        return cls([])

    @classmethod
    def one(cls):
        return cls.constant(1)

    @classmethod
    def constant(cls, c) -> "Poly":
        return cls([into_fr(c)])

    @classmethod
    def identity(cls):
        return cls.monomial(1)

    @classmethod
    def monomial(cls, degree: int):
        return cls([0] * degree + [1])

    @classmethod
    def random(cls, degree: int, rng=None):
        from .utils.rng import default_rng

        return cls.try_random(degree, rng or default_rng())

    @classmethod
    def try_random(cls, degree: int, rng):
        if degree >= _USIZE_MAX:
            raise DegreeTooHigh()
        b = get_backend()
        return cls([b.fr_random(rng) for _ in range(degree + 1)])

    @classmethod
    def interpolate(cls, samples) -> "Poly":
        """Unique polynomial of degree len(samples)-1 through the given
        (x, f(x)) pairs (``src/poly.rs:341-350,388-417``)."""
        pts = [(into_fr(x), into_fr(y)) for x, y in _iter_pairs(samples)]
        return cls._compute_interpolation(pts)

    @classmethod
    def _compute_interpolation(cls, samples) -> "Poly":
        r = get_backend().r
        if not samples:
            return cls.zero()
        poly = cls.constant(samples[0][1])
        base = cls([-samples[0][0] % r, 1])
        for x, y in samples[1:]:
            diff = (y - poly.evaluate(x)) % r
            base_val = base.evaluate(x)
            inv = get_backend().fr_inv(base_val)
            if inv is None:
                raise ValueError("sample points must be distinct")
            diff = diff * inv % r
            base = base * diff
            poly += base
            base = base * cls([-x % r, 1])
        return poly

    # -- basic queries ---------------------------------------------------------
    def degree(self) -> int:
        return max(len(self.coeff) - 1, 0)

    def is_zero(self) -> bool:
        return all(c == 0 for c in self.coeff)

    def evaluate(self, i) -> int:
        """Horner evaluation at into_fr(i) (``src/poly.rs:358-369``)."""
        if not self.coeff:
            return 0
        r = get_backend().r
        x = into_fr(i)
        result = self.coeff[-1]
        for c in reversed(self.coeff[:-1]):
            result = (result * x + c) % r
        return result

    def commitment(self) -> "Commitment":
        g1 = get_backend().G1.one()
        return Commitment([g1.mul(c) for c in self.coeff])

    def _remove_zeros(self) -> None:
        while self.coeff and self.coeff[-1] == 0:
            self.coeff.pop()

    # -- secret hygiene ---------------------------------------------------------
    def zeroize(self) -> None:
        """Drop every coefficient reference (``src/poly.rs:46-58``).

        Residual exposure, documented: CPython ints are immutable, so the
        coefficient *objects* cannot be overwritten — this clears the
        polynomial's references and its observable value; the freed int
        memory is erased only when the allocator reuses it.  Long-lived
        secrets that need physical erasure belong in `SecretKey`, whose
        backing store is a zeroizable bytearray.
        """
        for i in range(len(self.coeff)):
            self.coeff[i] = 0

    def reveal(self) -> str:
        return f"Poly {{ coeff: {self.coeff} }}"

    def __repr__(self):
        return 'Poly { coeff: "..." }'

    # -- ring ops ---------------------------------------------------------------
    def __eq__(self, other):
        return isinstance(other, Poly) and self.coeff == other.coeff

    def __iadd__(self, rhs):
        r = get_backend().r
        if isinstance(rhs, Poly):
            if len(rhs.coeff) > len(self.coeff):
                self.coeff += [0] * (len(rhs.coeff) - len(self.coeff))
            for i, c in enumerate(rhs.coeff):
                self.coeff[i] = (self.coeff[i] + c) % r
            self._remove_zeros()
            return self
        # Fr / u64 constant
        c = into_fr(rhs)
        if self.is_zero():
            if c != 0:
                self.coeff = [c]
        else:
            self.coeff[0] = (self.coeff[0] + c) % r
            self._remove_zeros()
        return self

    def __add__(self, rhs):
        out = Poly(list(self.coeff))
        out += rhs
        return out

    def __isub__(self, rhs):
        r = get_backend().r
        if isinstance(rhs, Poly):
            if len(rhs.coeff) > len(self.coeff):
                self.coeff += [0] * (len(rhs.coeff) - len(self.coeff))
            for i, c in enumerate(rhs.coeff):
                self.coeff[i] = (self.coeff[i] - c) % r
            self._remove_zeros()
            return self
        self += -into_fr(rhs) % r
        return self

    def __sub__(self, rhs):
        out = Poly(list(self.coeff))
        out -= rhs
        return out

    def __mul__(self, rhs):
        r = get_backend().r
        if isinstance(rhs, Poly):
            if self.is_zero() or rhs.is_zero():
                return Poly.zero()
            coeffs = [0] * (len(self.coeff) + len(rhs.coeff) - 1)
            for i, ca in enumerate(self.coeff):
                for j, cb in enumerate(rhs.coeff):
                    coeffs[i + j] = (coeffs[i + j] + ca * cb) % r
            return Poly(coeffs)
        c = into_fr(rhs)
        if c == 0:
            return Poly.zero()
        return Poly([x * c % r for x in self.coeff])

    __rmul__ = __mul__


def _iter_pairs(samples):
    if hasattr(samples, "items"):
        return list(samples.items())
    return list(samples)


class Commitment:
    """Commitment to a univariate polynomial (coefficients in G1)."""

    __slots__ = ("coeff",)

    def __init__(self, coeff):
        self.coeff = list(coeff)

    def degree(self) -> int:
        if not self.coeff:
            raise ValueError("empty commitment has no degree")
        return len(self.coeff) - 1

    def evaluate(self, i):
        b = get_backend()
        if not self.coeff:
            return b.G1.zero()
        x = into_fr(i)
        result = self.coeff[-1]
        for c in reversed(self.coeff[:-1]):
            result = result.mul(x).add(c)
        return result

    def _remove_zeros(self) -> None:
        while self.coeff and self.coeff[-1].is_zero():
            self.coeff.pop()

    def __iadd__(self, rhs: "Commitment"):
        b = get_backend()
        if len(rhs.coeff) > len(self.coeff):
            self.coeff += [b.G1.zero()] * (len(rhs.coeff) - len(self.coeff))
        for i, c in enumerate(rhs.coeff):
            self.coeff[i] = self.coeff[i].add(c)
        self._remove_zeros()
        return self

    def __add__(self, rhs: "Commitment"):
        out = Commitment(list(self.coeff))
        out += rhs
        return out

    def __eq__(self, other):
        return isinstance(other, Commitment) and self.coeff == other.coeff

    def __hash__(self):
        return hash((len(self.coeff), tuple(c.to_compressed() for c in self.coeff)))

    def _cmp_key(self):
        return (len(self.coeff), [c.to_compressed() for c in self.coeff])

    def __lt__(self, other):
        return self._cmp_key() < other._cmp_key()

    def __repr__(self):
        return f"Commitment {{ coeff: {self.coeff} }}"


class BivarPoly:
    """Symmetric bivariate polynomial (DKG dealing, ``src/poly.rs:518-648``)."""

    __slots__ = ("_degree", "coeff")

    def __init__(self, degree: int, coeff):
        self._degree = degree
        self.coeff = list(coeff)

    @classmethod
    def random(cls, degree: int, rng=None):
        from .utils.rng import default_rng

        return cls.try_random(degree, rng or default_rng())

    @classmethod
    def try_random(cls, degree: int, rng):
        pos = coeff_pos(degree, degree)
        if pos is None or pos + 1 > _USIZE_MAX:
            raise DegreeTooHigh()
        b = get_backend()
        return cls(degree, [b.fr_random(rng) for _ in range(pos + 1)])

    def degree(self) -> int:
        return self._degree

    def _powers(self, x):
        return _powers(x, self._degree)

    def evaluate(self, x, y) -> int:
        r = get_backend().r
        x_pow = self._powers(x)
        y_pow = self._powers(y)
        result = 0
        for i, xp in enumerate(x_pow):
            for j, yp in enumerate(y_pow):
                idx = coeff_pos(i, j)
                result = (result + self.coeff[idx] * xp % r * yp) % r
        return result

    def row(self, x) -> Poly:
        """The x-th row as a univariate polynomial (``src/poly.rs:607-623``)."""
        r = get_backend().r
        x_pow = self._powers(x)
        coeff = []
        for i in range(self._degree + 1):
            result = 0
            for j, xp in enumerate(x_pow):
                result = (result + self.coeff[coeff_pos(i, j)] * xp) % r
            coeff.append(result)
        return Poly(coeff)

    def commitment(self) -> "BivarCommitment":
        g1 = get_backend().G1.one()
        return BivarCommitment(self._degree, [g1.mul(c) for c in self.coeff])

    def zeroize(self) -> None:
        for i in range(len(self.coeff)):
            self.coeff[i] = 0

    def reveal(self) -> str:
        return f"BivarPoly {{ degree: {self._degree}, coeff: {self.coeff} }}"

    def __repr__(self):
        return f'BivarPoly {{ degree: {self._degree}, coeff: "..." }}'


class BivarCommitment:
    """Commitment to a symmetric bivariate polynomial (``src/poly.rs:650-732``)."""

    __slots__ = ("_degree", "coeff")

    def __init__(self, degree: int, coeff):
        self._degree = degree
        self.coeff = list(coeff)

    def degree(self) -> int:
        return self._degree

    def _powers(self, x):
        return _powers(x, self._degree)

    def evaluate(self, x, y):
        b = get_backend()
        x_pow = self._powers(x)
        y_pow = self._powers(y)
        result = b.G1.zero()
        for i, xp in enumerate(x_pow):
            for j, yp in enumerate(y_pow):
                result = result.add(self.coeff[coeff_pos(i, j)].mul(xp * yp % b.r))
        return result

    def row(self, x) -> Commitment:
        b = get_backend()
        x_pow = self._powers(x)
        coeff = []
        for i in range(self._degree + 1):
            result = b.G1.zero()
            for j, xp in enumerate(x_pow):
                result = result.add(self.coeff[coeff_pos(i, j)].mul(xp))
            coeff.append(result)
        return Commitment(coeff)

    def __eq__(self, other):
        return (
            isinstance(other, BivarCommitment)
            and self._degree == other._degree
            and self.coeff == other.coeff
        )

    def __hash__(self):
        return hash((self._degree, tuple(c.to_compressed() for c in self.coeff)))

    def _cmp_key(self):
        return (self._degree, [c.to_compressed() for c in self.coeff])

    def __lt__(self, other):
        return self._cmp_key() < other._cmp_key()

    def __repr__(self):
        return f"BivarCommitment {{ degree: {self._degree}, coeff: {self.coeff} }}"


def _powers(x, degree: int):
    """[x^0 .. x^degree] (``src/poly.rs:735-744``)."""
    r = get_backend().r
    xv = into_fr(x)
    out = [1]
    for _ in range(degree):
        out.append(out[-1] * xv % r)
    return out
