"""Bincode-compatible (de)serialization for every public type.

A copy of ``threshold_crypto_tpu/serde_impl.py``. Byte formats match what
the reference emits through serde + bincode 1.x
(little-endian, fixed-width integers, u64 ``Vec`` length prefixes):

* group elements — fixed-size tuples of compressed bytes
  (``src/serde_impl.rs:164-219``): 48 (G1) / 96 (G2) bytes.
* ``Vec<G>`` — 8-byte LE length + elements (`serde_impl.rs:222-272`).
* Fr — ``FrRepr`` ``[u64; 4]`` canonical limbs, i.e. 32 bytes LE
  (`serde_impl.rs:105-111,275-318`).
* ``SecretKey``/``SecretKeyShare`` implement deserialize only; serializing
  requires the explicit ``SerdeSecret`` wrapper (`serde_impl.rs:37-80`).
* ``BivarCommitment`` — u64 degree + Vec<G1>, with a degree/len validation
  on deserialize (`serde_impl.rs:130-161`).

These fixed encodings double as the bit-parity test vectors
(``tests/fixtures/golden.json``).
"""

from __future__ import annotations

import struct

from .backend import FromBytesError, get_backend
from .lib import (
    Ciphertext,
    DecryptionShare,
    PublicKey,
    PublicKeySet,
    PublicKeyShare,
    SecretKey,
    SecretKeySet,
    SecretKeyShare,
    Signature,
    SignatureShare,
)
from .poly import BivarCommitment, Commitment, Poly, coeff_pos


class SerdeSecret:
    """Opt-in wrapper enabling serialization of secret types."""

    __slots__ = ("inner_value",)

    def __init__(self, inner):
        self.inner_value = inner

    def inner(self):
        return self.inner_value

    def into_inner(self):
        return self.inner_value

    def __eq__(self, other):
        return isinstance(other, SerdeSecret) and self.inner_value == other.inner_value

    def __repr__(self):
        return f"SerdeSecret({self.inner_value!r})"


class _Reader:
    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FromBytesError("unexpected end of input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise FromBytesError("trailing bytes after value")


# -- element-level codecs ------------------------------------------------------

def _ser_g1(el) -> bytes:
    return el.to_compressed()


def _de_g1(r: _Reader):
    return get_backend().G1.from_compressed(r.take(get_backend().PK_SIZE))


def _ser_g2(el) -> bytes:
    return el.to_compressed()


def _de_g2(r: _Reader):
    return get_backend().G2.from_compressed(r.take(get_backend().SIG_SIZE))


def _ser_fr(v: int) -> bytes:
    return get_backend().fr_serialize(v)


def _de_fr(r: _Reader) -> int:
    return get_backend().fr_deserialize(r.take(get_backend().FR_BYTES))


def _ser_vec(items, ser) -> bytes:
    return struct.pack("<Q", len(items)) + b"".join(ser(i) for i in items)


def _de_vec(r: _Reader, de):
    n = r.u64()
    return [de(r) for _ in range(n)]


# -- public (de)serialization --------------------------------------------------

def serialize(obj) -> bytes:
    """bincode::serialize equivalent for all public types."""
    b = get_backend()
    if isinstance(obj, SerdeSecret):
        inner = obj.inner_value
        if isinstance(inner, SecretKey):
            return _ser_fr(inner.fr)
        if isinstance(inner, SecretKeyShare):
            return _ser_fr(inner.sk.fr)
        if isinstance(inner, Poly):
            return _ser_vec(inner.coeff, _ser_fr)
        if isinstance(inner, SecretKeySet):
            return _ser_vec(inner.poly.coeff, _ser_fr)
        raise TypeError(f"SerdeSecret cannot wrap {type(inner).__name__}")
    if isinstance(obj, (SecretKey, SecretKeyShare, SecretKeySet)):
        raise TypeError(
            "secret types serialize only through SerdeSecret "
            "(mirrors the reference's SerializeSecret opt-in)"
        )
    if isinstance(obj, PublicKey):
        return _ser_g1(obj.el)
    if isinstance(obj, PublicKeyShare):
        return _ser_g1(obj.pk.el)
    if isinstance(obj, Signature):
        return _ser_g2(obj.el)
    if isinstance(obj, SignatureShare):
        return _ser_g2(obj.sig.el)
    if isinstance(obj, DecryptionShare):
        return _ser_g1(obj.el)
    if isinstance(obj, Ciphertext):
        return (
            _ser_g1(obj.u)
            + struct.pack("<Q", len(obj.v))
            + obj.v
            + _ser_g2(obj.w)
        )
    if isinstance(obj, PublicKeySet):
        return _ser_vec(obj.commit.coeff, _ser_g1)
    if isinstance(obj, Commitment):
        return _ser_vec(obj.coeff, _ser_g1)
    if isinstance(obj, Poly):
        # The reference serializes Poly directly (its field_vec codec,
        # ``src/poly.rs:39-43``) — downstream DKG protocols
        # put serialized rows on the wire.  Same bytes as the SerdeSecret
        # form; prefer SerdeSecret(poly) to make the secret flow explicit.
        # Earlier versions raised TypeError here as a secret-leak guard;
        # warn once so callers relying on that guard notice.
        import warnings

        warnings.warn(
            "serialize(Poly) emits SECRET coefficients (reference-"
            "compatible); wrap in SerdeSecret(poly) to make the secret "
            "flow explicit",
            stacklevel=2,
        )
        return _ser_vec(obj.coeff, _ser_fr)
    if isinstance(obj, BivarCommitment):
        return struct.pack("<Q", obj.degree()) + _ser_vec(obj.coeff, _ser_g1)
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def deserialize(cls, data: bytes):
    """bincode::deserialize equivalent; validates points/fields like the
    reference (invalid-point rejection on every deserialize)."""
    r = _Reader(data)
    out = _read(cls, r)
    r.done()
    return out


def _read(cls, r: _Reader):
    if cls is PublicKey:
        return PublicKey(_de_g1(r))
    if cls is PublicKeyShare:
        return PublicKeyShare(PublicKey(_de_g1(r)))
    if cls is Signature:
        return Signature(_de_g2(r))
    if cls is SignatureShare:
        return SignatureShare(Signature(_de_g2(r)))
    if cls is DecryptionShare:
        return DecryptionShare(_de_g1(r))
    if cls is SecretKey:
        return SecretKey(_de_fr(r))
    if cls is SecretKeyShare:
        return SecretKeyShare(SecretKey(_de_fr(r)))
    if cls is Ciphertext:
        u = _de_g1(r)
        v = r.take(r.u64())
        w = _de_g2(r)
        return Ciphertext(u, v, w)
    if cls is PublicKeySet:
        return PublicKeySet(Commitment(_de_vec(r, _de_g1)))
    if cls is Commitment:
        return Commitment(_de_vec(r, _de_g1))
    if cls is Poly:
        return Poly(_de_vec(r, _de_fr))
    if cls is SecretKeySet:
        return SecretKeySet(Poly(_de_vec(r, _de_fr)))
    if cls is BivarCommitment:
        degree = r.u64()
        coeff = _de_vec(r, _de_g1)
        expected = coeff_pos(degree, degree)
        if expected is None or expected + 1 != len(coeff):
            raise FromBytesError("commitment degree does not match coefficients")
        return BivarCommitment(degree, coeff)
    raise TypeError(f"cannot deserialize {cls.__name__}")
