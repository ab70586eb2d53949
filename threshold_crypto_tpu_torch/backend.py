"""Backend registry: the BLS12-381 engine and the insecure mock engine.

A copy of ``threshold_crypto_tpu/backend.py`` with its own state:
switching the port's backend leaves the JAX package's as it is, and the
other way round. Mirrors the reference's compile-time backend switch
(``src/lib.rs:57-67``) as a runtime registry. Each backend exposes the
exact surface the protocol layer consumes: scalar-field helpers on plain
ints, two group-element wrapper classes, and a pairing comparable for
equality. The BLS group elements hold host affine points (``.v``), which
``device.pairing.g1_affine_from_host`` / ``g2_affine_from_host`` lift to
the card.

Group elements are small immutable wrappers; scalars (Fr) are plain Python
ints in ``[0, backend.r)``.
"""

from __future__ import annotations

from .host import curve as _cv
from .host import pairing as _pr
from .host import sampling as _smp
from .host.params import R as _BLS_R
from .mock import engine as _mock


class FromBytesError(ValueError):
    """Invalid byte representation (``src/error.rs:36-44``)."""


class GroupElement:
    """Immutable group element; ordering/hash by compressed bytes
    (``src/cmp_pairing.rs:6-10``)."""

    __slots__ = ("v",)

    # subclasses set these
    SIZE = None

    def __init__(self, v):
        object.__setattr__(self, "v", v)

    def __setattr__(self, *a):
        raise AttributeError("group elements are immutable")

    # -- subclass hooks -----------------------------------------------------
    @classmethod
    def _add(cls, a, b):
        raise NotImplementedError

    # -- shared API ----------------------------------------------------------
    def add(self, other):
        return type(self)(self._add(self.v, other.v))

    def __add__(self, other):
        return self.add(other)

    def __eq__(self, other):
        return type(self) is type(other) and self._eq(self.v, other.v)

    def __hash__(self):
        return hash((type(self).__name__, self.to_compressed()))

    def _cmp_key(self):
        return self.to_compressed()

    def __lt__(self, other):
        return self._cmp_key() < other._cmp_key()

    def __le__(self, other):
        return self._cmp_key() <= other._cmp_key()

    def __repr__(self):
        return f"{type(self).__name__}({self.to_compressed().hex()[:10]})"


def _bls_group(group, to_comp, from_comp, to_uncomp, size, rand):
    class _El(GroupElement):
        SIZE = size
        _group = group

        @classmethod
        def zero(cls):
            return cls(None)

        @classmethod
        def one(cls):
            return cls(group.generator)

        @classmethod
        def random(cls, rng):
            return cls(rand(rng))

        @staticmethod
        def _add(a, b):
            return group.add(a, b)

        @staticmethod
        def _eq(a, b):
            return a == b

        def is_zero(self):
            return self.v is None

        def neg(self):
            return type(self)(group.neg(self.v))

        def mul(self, k: int):
            return type(self)(group.mul(self.v, k % _BLS_R))

        def to_compressed(self) -> bytes:
            return to_comp(self.v)

        def to_uncompressed(self) -> bytes:
            return to_uncomp(self.v)

        @classmethod
        def from_compressed(cls, data: bytes):
            try:
                return cls(from_comp(bytes(data)))
            except (_cv.DecodeError, ValueError) as e:
                raise FromBytesError(str(e)) from e

    return _El


class _Bls12381Backend:
    name = "bls12_381"
    PK_SIZE = 48
    SIG_SIZE = 96
    FR_BYTES = 32
    r = _BLS_R

    G1 = _bls_group(
        _cv.G1, _cv.g1_to_compressed, _cv.g1_from_compressed,
        _cv.g1_to_uncompressed, 48, _smp.g1_random,
    )
    G2 = _bls_group(
        _cv.G2, _cv.g2_to_compressed, _cv.g2_from_compressed,
        _cv.g2_to_uncompressed, 96, _smp.g2_random,
    )
    G1.__name__, G2.__name__ = "G1", "G2"

    @staticmethod
    def pairing(g1el, g2el):
        """e(P, Q) ∈ Fq12 — compared only for equality."""
        return _pr.pairing(g1el.v, g2el.v)

    @staticmethod
    def pairing_check(pairs) -> bool:
        """True iff prod e(P_i, Q_i) == 1 (single multi-Miller + final exp)."""
        return _pr.pairing_check([(p.v, q.v) for p, q in pairs])

    @staticmethod
    def pairing_eq(p1, q1, p2, q2) -> bool:
        """e(p1, q1) == e(p2, q2), computed as one two-pair product check
        (the standard e(p1,q1)·e(−p2,q2) == 1 trick; cf. the reference's
        two full pairings at ``src/lib.rs:109,185,511``)."""
        return _pr.pairing_check([(p1.v, q1.v), (_cv.G1.neg(p2.v), q2.v)])

    @staticmethod
    def fr_random(rng) -> int:
        return _smp.fr_random(rng)

    @staticmethod
    def fr_inv(a: int):
        a %= _BLS_R
        if a == 0:
            return None
        return pow(a, -1, _BLS_R)

    @staticmethod
    def fr_serialize(v: int) -> bytes:
        # SecretKey serde = FrRepr [u64;4] limbs, bincode little-endian
        # (``src/serde_impl.rs:105-111``) => 32 bytes LE.
        return int(v % _BLS_R).to_bytes(32, "little")

    @staticmethod
    def fr_deserialize(b: bytes) -> int:
        if len(b) != 32:
            raise FromBytesError("Fr encoding must be 32 bytes")
        v = int.from_bytes(b, "little")
        if v >= _BLS_R:
            raise FromBytesError("number outside of prime field")
        return v


class _MockGroupElement(GroupElement):
    SIZE = 4

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def random(cls, rng):
        return cls(_mock.g_random(rng))

    @staticmethod
    def _add(a, b):
        return (a + b) % _mock.MS8

    @staticmethod
    def _eq(a, b):
        return a % _mock.MS8 == b % _mock.MS8

    def is_zero(self):
        return self.v % _mock.MS8 == 0

    def neg(self):
        return type(self)(-self.v % _mock.MS8)

    def mul(self, k: int):
        return type(self)(self.v * (k % _mock.MS8) % _mock.MS8)

    def to_compressed(self) -> bytes:
        return _mock.point_to_compressed(self.v)

    def to_uncompressed(self) -> bytes:
        return _mock.point_to_uncompressed(self.v)

    @classmethod
    def from_compressed(cls, data: bytes):
        try:
            return cls(_mock.point_from_compressed(bytes(data)))
        except ValueError as e:
            raise FromBytesError(str(e)) from e


class _MockBackend:
    name = "mock"
    PK_SIZE = 4
    SIG_SIZE = 4
    FR_BYTES = 4
    r = _mock.MS8

    G1 = _MockGroupElement
    G2 = _MockGroupElement

    @staticmethod
    def pairing(g1el, g2el):
        return _mock.pairing(g1el.v, g2el.v)

    @staticmethod
    def pairing_check(pairs) -> bool:
        """True iff the product of pairings is the GT identity.  Mock GT is
        additive (e(P,Q) = P·Q over Z/MS8), so the product check becomes a
        sum check, and code written against ``pairing_check`` runs under
        both backends."""
        return sum(_mock.pairing(p.v, q.v) for p, q in pairs) % _mock.MS8 == 0

    @staticmethod
    def pairing_eq(p1, q1, p2, q2) -> bool:
        # Mock GT is additive (e(P,Q) = P·Q over Z/MS8): plain equality.
        return _mock.pairing(p1.v, q1.v) == _mock.pairing(p2.v, q2.v)

    @staticmethod
    def fr_random(rng) -> int:
        return _mock.fr_random(rng)

    @staticmethod
    def fr_inv(a: int):
        return _mock.fr_inv(a)

    fr_serialize = staticmethod(_mock.fr_serialize)
    fr_deserialize = staticmethod(_mock.fr_deserialize)


BACKENDS = {
    "bls12_381": _Bls12381Backend,
    "mock": _MockBackend,
}

_current = _Bls12381Backend


def set_backend(name: str) -> None:
    """Select the active backend ('bls12_381' or 'mock'); mirrors the
    reference's `use-insecure-test-only-mock-crypto` feature switch."""
    global _current
    if name not in BACKENDS:
        raise KeyError(f"unknown backend {name!r}; options: {sorted(BACKENDS)}")
    _current = BACKENDS[name]


def get_backend():
    return _current


def using(name: str):
    """Context manager to temporarily switch backends (tests)."""
    import contextlib

    @contextlib.contextmanager
    def _cm():
        global _current
        prev = _current
        set_backend(name)
        try:
            yield _current
        finally:
            _current = prev

    return _cm()
