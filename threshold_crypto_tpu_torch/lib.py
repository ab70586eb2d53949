"""Threshold cryptosystem layer: keys, shares, signatures, ciphertexts.

A copy of ``threshold_crypto_tpu/lib.py``, mirroring the public surface of
the reference's ``src/lib.rs:77-773``:
``SecretKey``, ``PublicKey``, ``Signature``, ``SecretKeyShare``,
``PublicKeyShare``, ``SignatureShare``, ``Ciphertext``, ``DecryptionShare``,
``SecretKeySet``, ``PublicKeySet``, plus ``hash_g2`` and the in-exponent
Lagrange ``interpolate``.

BLS (Boneh–Lynn–Shacham) signatures with Boldyreva threshold combination and
Baek–Zhang threshold encryption.  Public keys live in G1, signatures/hashes
in G2.  Scalar-path operations run on the host engine (the native hash and
the Python-int curves and pairing); the batched device paths for the hot
loops (sign/verify/combine over thousands of items) are the port's ``ops``:
``sign_batch``, ``verify_sig_shares_rlc_pallas``, ``combine_batch``,
``decrypt_share_batch``, ``ciphertext_verify_batch``, ... on the same
values.
"""

from __future__ import annotations

import logging

from .backend import FromBytesError, get_backend
from .error import DuplicateEntry, NotEnoughShares
from .hashing import hash_g1_g2, hash_g2, xor_with_hash
from .into_fr import into_fr_plus_1
from .poly import Commitment, Poly
from .utils.rng import OsRng, default_rng


def PK_SIZE() -> int:
    return get_backend().PK_SIZE


def SIG_SIZE() -> int:
    return get_backend().SIG_SIZE


def _parity(uncompressed: bytes) -> bool:
    """Odd number of one-bits in the xor of all bytes (`src/lib.rs:237-243`)."""
    x = 0
    for byte in uncompressed:
        x ^= byte
    parity = bin(x).count("1") % 2 != 0
    # the reference's `log::debug!("parity of {:?}: {}", ...)`
    # (`src/lib.rs:241`); stdlib logging is the no-op-by-default analog
    logging.getLogger(__name__).debug("parity of %s: %s", uncompressed,
                                      parity)
    return parity


class PublicKey:
    """A public key (G1 element)."""

    __slots__ = ("el",)

    def __init__(self, el):
        self.el = el

    def verify_g2(self, sig: "Signature", hash_pt) -> bool:
        """True iff the signature matches the G2 element (`src/lib.rs:108-110`)."""
        b = get_backend()
        return b.pairing_eq(self.el, hash_pt, b.G1.one(), sig.el)

    def verify(self, sig: "Signature", msg: bytes) -> bool:
        return self.verify_g2(sig, hash_g2(msg))

    def encrypt(self, msg: bytes, rng=None) -> "Ciphertext":
        """Baek–Zhang encryption (`src/lib.rs:123-137`)."""
        return self.encrypt_with_rng(rng if rng is not None else OsRng(), msg)

    def encrypt_with_rng(self, rng, msg: bytes) -> "Ciphertext":
        b = get_backend()
        r = b.fr_random(rng)
        u = b.G1.one().mul(r)
        g = self.el.mul(r)
        v = xor_with_hash(g, bytes(msg))
        w = hash_g1_g2(u, v).mul(r)
        return Ciphertext(u, v, w)

    def to_bytes(self) -> bytes:
        return self.el.to_compressed()

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        return cls(get_backend().G1.from_compressed(data))

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self.el == other.el

    def __hash__(self):
        return hash(self.el)

    def __lt__(self, other):
        return self.el < other.el

    def __repr__(self):
        return f"PublicKey({self.el.to_uncompressed().hex()[:10]})"


class PublicKeyShare:
    """A public key share (`src/lib.rs:156-197`)."""

    __slots__ = ("pk",)

    def __init__(self, pk: PublicKey):
        self.pk = pk

    def verify_g2(self, sig: "SignatureShare", hash_pt) -> bool:
        return self.pk.verify_g2(sig.sig, hash_pt)

    def verify(self, sig: "SignatureShare", msg: bytes) -> bool:
        return self.pk.verify(sig.sig, msg)

    def verify_decryption_share(self, share: "DecryptionShare", ct: "Ciphertext") -> bool:
        """e(share, H(u,v)) == e(pk_i, w) (`src/lib.rs:182-186`)."""
        b = get_backend()
        hash_pt = hash_g1_g2(ct.u, ct.v)
        return b.pairing_eq(share.el, hash_pt, self.pk.el, ct.w)

    def to_bytes(self) -> bytes:
        return self.pk.to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKeyShare":
        return cls(PublicKey.from_bytes(data))

    def __eq__(self, other):
        return isinstance(other, PublicKeyShare) and self.pk == other.pk

    def __hash__(self):
        return hash(self.pk)

    def __lt__(self, other):
        return self.pk < other.pk

    def __repr__(self):
        return f"PublicKeyShare({self.pk.el.to_uncompressed().hex()[:10]})"


class Signature:
    """A signature (G2 element)."""

    __slots__ = ("el",)

    def __init__(self, el):
        self.el = el

    @classmethod
    def random(cls, rng=None) -> "Signature":
        """Random signature for testing (Distribution impl, `src/lib.rs:216-220`)."""
        return cls(get_backend().G2.random(rng or default_rng()))

    def parity(self) -> bool:
        return _parity(self.el.to_uncompressed())

    def to_bytes(self) -> bytes:
        return self.el.to_compressed()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(get_backend().G2.from_compressed(data))

    def __eq__(self, other):
        return isinstance(other, Signature) and self.el == other.el

    def __hash__(self):
        return hash(self.el)

    def __lt__(self, other):
        return self.el < other.el

    def __repr__(self):
        return f"Signature({self.el.to_uncompressed().hex()[:10]})"


class SignatureShare:
    """A signature share (`src/lib.rs:262-291`)."""

    __slots__ = ("sig",)

    def __init__(self, sig: Signature):
        self.sig = sig

    @classmethod
    def random(cls, rng=None) -> "SignatureShare":
        return cls(Signature.random(rng))

    def to_bytes(self) -> bytes:
        return self.sig.to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "SignatureShare":
        return cls(Signature.from_bytes(data))

    def __eq__(self, other):
        return isinstance(other, SignatureShare) and self.sig == other.sig

    def __hash__(self):
        return hash(self.sig)

    def __lt__(self, other):
        return self.sig < other.sig

    def __repr__(self):
        return f"SignatureShare({self.sig.el.to_uncompressed().hex()[:10]})"


class SecretKey:
    """A secret key (Fr scalar).

    The authoritative copy of the scalar lives in a mutable ``bytearray``
    (little-endian), so ``zeroize()`` physically overwrites that memory —
    the closest CPython analog of the reference's volatile clear
    (``src/secret.rs:9-13``).  Residual exposure, documented:
    transient ``int`` objects created while *using* the key (scalar-mul
    arguments, serde) are immutable and cannot be erased; Python may also
    intern/copy them.  Treat zeroize as clearing the long-lived storage,
    not every register/heap ghost — the same caveat the reference's
    `zeroize` crate documents for registers and copies.
    """

    __slots__ = ("_buf",)

    def __init__(self, fr: int = 0):
        object.__setattr__(self, "_buf", bytearray(32))
        self.fr = fr

    @property
    def fr(self) -> int:
        return int.from_bytes(bytes(self._buf), "little")

    @fr.setter
    def fr(self, v: int) -> None:
        self._buf[:] = int(v % get_backend().r).to_bytes(32, "little")

    @classmethod
    def random(cls, rng=None) -> "SecretKey":
        return cls(get_backend().fr_random(rng or default_rng()))

    @classmethod
    def from_mut(cls, holder) -> "SecretKey":
        """Take the Fr out of a single-element list, zeroing the source
        (mirrors `SecretKey::from_mut`, `src/lib.rs:349-353`)."""
        sk = cls(holder[0])
        holder[0] = 0
        return sk

    def zeroize(self) -> None:
        """Overwrite the backing buffer in place (see class docstring)."""
        for i in range(len(self._buf)):
            self._buf[i] = 0

    def public_key(self) -> PublicKey:
        return PublicKey(get_backend().G1.one().mul(self.fr))

    def sign_g2(self, hash_pt) -> Signature:
        return Signature(hash_pt.mul(self.fr))

    def sign(self, msg: bytes) -> Signature:
        return self.sign_g2(hash_g2(msg))

    def decrypt(self, ct: "Ciphertext"):
        """Decrypted plaintext, or None if the ciphertext is invalid
        (`src/lib.rs:384-391`)."""
        if not ct.verify():
            return None
        g = ct.u.mul(self.fr)
        return xor_with_hash(g, ct.v)

    def reveal(self) -> str:
        return f"SecretKey({self.fr})"

    def __eq__(self, other):
        return isinstance(other, SecretKey) and self.fr == other.fr

    def __repr__(self):
        return "SecretKey(...)"


class SecretKeyShare:
    """A secret key share (`src/lib.rs:401-470`)."""

    __slots__ = ("sk",)

    def __init__(self, sk: SecretKey):
        self.sk = sk

    @classmethod
    def random(cls, rng=None) -> "SecretKeyShare":
        return cls(SecretKey.random(rng))

    @classmethod
    def from_mut(cls, holder) -> "SecretKeyShare":
        return cls(SecretKey.from_mut(holder))

    def public_key_share(self) -> PublicKeyShare:
        return PublicKeyShare(self.sk.public_key())

    def sign_g2(self, hash_pt) -> SignatureShare:
        return SignatureShare(self.sk.sign_g2(hash_pt))

    def sign(self, msg: bytes) -> SignatureShare:
        return SignatureShare(self.sk.sign(msg))

    def decrypt_share(self, ct: "Ciphertext"):
        """DecryptionShare, or None if the ciphertext is invalid
        (`src/lib.rs:452-457`)."""
        if not ct.verify():
            return None
        return self.decrypt_share_no_verify(ct)

    def decrypt_share_no_verify(self, ct: "Ciphertext") -> "DecryptionShare":
        return DecryptionShare(ct.u.mul(self.sk.fr))

    def reveal(self) -> str:
        return f"SecretKeyShare({self.sk.fr})"

    def __eq__(self, other):
        return isinstance(other, SecretKeyShare) and self.sk == other.sk

    def __repr__(self):
        return "SecretKeyShare(...)"


class Ciphertext:
    """An encrypted message (u ∈ G1, v bytes, w ∈ G2) (`src/lib.rs:472-513`)."""

    __slots__ = ("u", "v", "w")

    def __init__(self, u, v: bytes, w):
        self.u = u
        self.v = bytes(v)
        self.w = w

    def verify(self) -> bool:
        """CCA validity: e(G1, w) == e(u, H(u, v)) (`src/lib.rs:508-513`)."""
        b = get_backend()
        hash_pt = hash_g1_g2(self.u, self.v)
        return b.pairing_eq(b.G1.one(), self.w, self.u, hash_pt)

    def __eq__(self, other):
        return (
            isinstance(other, Ciphertext)
            and self.u == other.u
            and self.v == other.v
            and self.w == other.w
        )

    def __hash__(self):
        return hash((self.u, self.v, self.w))

    def _cmp_key(self):
        return (self.u.to_compressed(), self.v, self.w.to_compressed())

    def __lt__(self, other):
        return self._cmp_key() < other._cmp_key()

    def __repr__(self):
        return f"Ciphertext(u={self.u!r}, v={self.v.hex()}, w={self.w!r})"


class DecryptionShare:
    """A decryption share (G1 element) (`src/lib.rs:515-535`)."""

    __slots__ = ("el",)

    def __init__(self, el):
        self.el = el

    @classmethod
    def random(cls, rng=None) -> "DecryptionShare":
        return cls(get_backend().G1.random(rng or default_rng()))

    def to_bytes(self) -> bytes:
        return self.el.to_compressed()

    @classmethod
    def from_bytes(cls, data: bytes) -> "DecryptionShare":
        return cls(get_backend().G1.from_compressed(data))

    def __eq__(self, other):
        return isinstance(other, DecryptionShare) and self.el == other.el

    def __hash__(self):
        return hash(self.el)

    def __repr__(self):
        return "DecryptionShare(...)"


class PublicKeySet:
    """A public key and associated public key shares (`src/lib.rs:537-627`)."""

    __slots__ = ("commit",)

    def __init__(self, commit: Commitment):
        self.commit = commit

    @classmethod
    def from_commitment(cls, commit: Commitment) -> "PublicKeySet":
        return cls(commit)

    def threshold(self) -> int:
        """t: any t+1 shares can combine (`src/lib.rs:560-562`)."""
        return self.commit.degree()

    def public_key(self) -> PublicKey:
        return PublicKey(self.commit.coeff[0])

    def public_key_share(self, i) -> PublicKeyShare:
        return PublicKeyShare(PublicKey(self.commit.evaluate(into_fr_plus_1(i))))

    def combine_signatures(self, shares) -> Signature:
        """Interpolate t+1 signature shares into the unique master signature
        (`src/lib.rs:608-615`).  Share validity is not checked."""
        samples = [(i, s.sig.el) for i, s in _iter_share_items(shares)]
        return Signature(interpolate(self.commit.degree(), samples))

    def decrypt(self, shares, ct: Ciphertext) -> bytes:
        """Combine decryption shares and decrypt (`src/lib.rs:618-626`)."""
        samples = [(i, s.el) for i, s in _iter_share_items(shares)]
        g = interpolate(self.commit.degree(), samples)
        return xor_with_hash(g, ct.v)

    def verify_signature_shares(self, shares, msg: bytes, rng=None) -> bool:
        """Probabilistic batch verification of N signature shares on ONE
        message: e(Σ rᵢ·pkᵢ, H(m)) == e(G1, Σ rᵢ·sigᵢ) with independent
        64-bit exponents rᵢ — two pairings total instead of the 2N of
        per-share `PublicKeyShare.verify` in a loop (the reference's hot
        pattern, ``src/lib.rs:177-179`` called per share).

        If any share is invalid the check fails except with probability
        2⁻⁶⁴.  The exponents are drawn from a PRF over fresh randomness
        AND the full verification transcript (every pkᵢ, sigᵢ and H(m)),
        so a share-holder can never predict them.  On failure,
        fall back to per-share `verify` to identify the cheater.

        `shares`: {i: SignatureShare} or iterable of (i, SignatureShare).
        Empty input raises ValueError — a vacuous True would let an
        upstream filtering bug masquerade as a passed verification.
        The batched device form of the same check is the port's
        ``ops.rlc_exponents`` then ``ops.verify_sig_shares_rlc_pallas``
        (affine tuples on the card in, two MSMs and one two-pair check).
        """
        b = get_backend()
        items = list(_iter_share_items(shares))
        if not items:
            raise ValueError(
                "verify_signature_shares: no shares supplied (refusing the "
                "vacuous-truth result)"
            )
        hash_pt = hash_g2(msg)
        pks = [self.public_key_share(i).pk.el for i, _ in items]
        sigs = [s.sig.el for _, s in items]
        exps = _batch_exponents(
            pks, sigs, hash_pt,
            (rng if rng is not None else OsRng()),
        )
        agg_pk = b.G1.zero()
        agg_sig = b.G2.zero()
        for r, pk, sig in zip(exps, pks, sigs):
            agg_pk = agg_pk.add(pk.mul(r))
            agg_sig = agg_sig.add(sig.mul(r))
        return b.pairing_eq(agg_pk, hash_pt, b.G1.one(), agg_sig)

    def __eq__(self, other):
        return isinstance(other, PublicKeySet) and self.commit == other.commit

    def __hash__(self):
        return hash(self.commit)

    def __lt__(self, other):
        return self.commit < other.commit

    def __repr__(self):
        return f"PublicKeySet({self.commit!r})"


class SecretKeySet:
    """A secret key and associated shares (trusted dealer)
    (`src/lib.rs:629-688`)."""

    __slots__ = ("poly",)

    def __init__(self, poly: Poly):
        self.poly = poly

    @classmethod
    def from_poly(cls, poly: Poly) -> "SecretKeySet":
        return cls(poly)

    @classmethod
    def random(cls, threshold: int, rng=None) -> "SecretKeySet":
        return cls(Poly.random(threshold, rng))

    @classmethod
    def try_random(cls, threshold: int, rng) -> "SecretKeySet":
        return cls(Poly.try_random(threshold, rng))

    def threshold(self) -> int:
        return self.poly.degree()

    def secret_key_share(self, i) -> SecretKeyShare:
        fr = self.poly.evaluate(into_fr_plus_1(i))
        return SecretKeyShare(SecretKey(fr))

    def public_keys(self) -> PublicKeySet:
        return PublicKeySet(self.poly.commitment())

    def secret_key(self) -> SecretKey:
        """The master secret key.  Test/DKG use only in the reference
        (`src/lib.rs:683-687`)."""
        return SecretKey(self.poly.evaluate(0))

    def __eq__(self, other):
        return isinstance(other, SecretKeySet) and self.poly == other.poly


def _iter_share_items(shares):
    if hasattr(shares, "items"):
        return sorted(shares.items())
    return list(shares)


def _batch_exponents(pks, sigs, hash_pt, rng):
    """Nonzero 64-bit RLC exponents bound to the verification transcript.

    ChaCha20 keyed by SHA3-256(fresh-randomness ‖ n ‖ every compressed pkᵢ,
    sigᵢ and H(m)): unpredictable to the share provider both by the fresh
    seed and by the transcript binding (changing any point reshuffles every
    exponent)."""
    from .hashing import sha3_256
    from .utils.rng import ChaChaRng

    seed = bytes(rng.next_u32() & 0xFF for _ in range(32))
    material = seed + len(pks).to_bytes(8, "little")
    for el in list(pks) + list(sigs) + [hash_pt]:
        material += el.to_compressed()
    prf = ChaChaRng.from_seed(sha3_256(material))
    out = []
    for _ in pks:
        v = 0
        while v == 0:
            v = prf.next_u64()
        out.append(v)
    return out


def interpolate(t: int, items):
    """Lagrange interpolation at x=0 of t+1 group-element samples
    (i, f(i+1)·g), with the reference's prefix/suffix-product optimization
    and duplicate detection via failed inverse (`src/lib.rs:719-767`)."""
    b = get_backend()
    r = b.r
    samples = [(into_fr_plus_1(i), el) for i, el in list(items)[: t + 1]]
    if len(samples) <= t:
        raise NotEnoughShares()
    if t == 0:
        return samples[0][1]

    # prefix products of the x-es (all but the i-th entry)
    x_prod = [1]
    tmp = 1
    for x, _ in samples[:t]:
        tmp = tmp * x % r
        x_prod.append(tmp)
    tmp = 1
    for i in range(len(samples) - 2, -1, -1):
        x = samples[i + 1][0]
        tmp = tmp * x % r
        x_prod[i] = x_prod[i] * tmp % r

    result = None
    for i, (l0, (x, sample)) in enumerate(zip(x_prod, samples)):
        # Skip by index, not value: a duplicated x must drive the denominator
        # to zero so the failed inverse surfaces as DuplicateEntry.
        denom = 1
        for j, (x0, _) in enumerate(samples):
            if j != i:
                denom = denom * (x0 - x) % r
        denom_inv = b.fr_inv(denom)
        if denom_inv is None:
            raise DuplicateEntry()
        lam = l0 * denom_inv % r
        term = sample.mul(lam)
        result = term if result is None else result.add(term)
    return result
