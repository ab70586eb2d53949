"""Mock cryptography backend ("mocktography") over the Mersenne-31 field.

A copy of ``threshold_crypto_tpu/mock/engine.py``: a drop-in replacement
for the BLS12-381 backend, mirroring the reference's feature-gated mock
engine (``src/mock/mod.rs``, ``src/mock/ms8.rs``): the scalar field, G1,
G2 and GT all collapse to Z/(2³¹−1), the pairing is plain field
multiplication (``src/mock/mod.rs:94-100``), and encoded points are the 4
little-endian bytes of the u32 (``src/mock/mod.rs:128-133``). Trivially
breakable — test use only. Gives the same 10-200x protocol-test speedup
the reference documents (its ``README.md:119-121``).
"""

from __future__ import annotations

MS8 = 0x7FFF_FFFF  # eighth Mersenne prime, 2^31 - 1

PK_SIZE = 4
SIG_SIZE = 4
FR_BYTES = 4


def fr_add(a, b):
    return (a + b) % MS8


def fr_sub(a, b):
    return (a - b) % MS8


def fr_mul(a, b):
    return a * b % MS8


def fr_neg(a):
    return -a % MS8


def fr_inv(a):
    """None for 0 (mirrors ff's Option; drives DuplicateEntry detection)."""
    if a % MS8 == 0:
        return None
    return pow(a, -1, MS8)


def fr_random(rng) -> int:
    # Mersenne8::random = Mersenne8::from(rng.next_u32()) = next_u32() % MS8
    # (`src/mock/ms8.rs:194-196`).
    return rng.next_u32() % MS8


def fr_from_int(n: int) -> int:
    return n % MS8


def fr_serialize(v: int) -> bytes:
    # SecretKey serde: into_repr().0 == the u32 itself, bincode LE.
    return int(v % MS8).to_bytes(4, "little")


def fr_deserialize(b: bytes) -> int:
    if len(b) != 4:
        raise ValueError("mock Fr encoding must be 4 bytes")
    return int.from_bytes(b, "little")  # from_repr is identity (ms8.rs:276-279)


def point_to_compressed(v) -> bytes:
    return int(v % MS8).to_bytes(4, "little")


def point_to_uncompressed(v) -> bytes:
    return point_to_compressed(v)


def point_from_compressed(b: bytes):
    if len(b) != 4:
        raise ValueError("mock point encoding must be 4 bytes")
    return int.from_bytes(b, "little")


def g_random(rng) -> int:
    return fr_random(rng)


def pairing(p, q):
    return p * q % MS8
