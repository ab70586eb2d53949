"""parity-scale-codec support, mirroring the reference's
``src/codec_impl.rs``; a copy of ``threshold_crypto_tpu/codec_impl.py``.

The reference wraps bincode output in a SCALE ``Vec<u8>`` (compact length
prefix + bytes) for `PublicKey`, `Signature`, `DecryptionShare`,
`PublicKeySet` and `Ciphertext`.
"""

from __future__ import annotations

from .backend import FromBytesError
from .lib import Ciphertext, DecryptionShare, PublicKey, PublicKeySet, Signature
from .serde_impl import deserialize, serialize

CODEC_TYPES = (PublicKey, Signature, DecryptionShare, PublicKeySet, Ciphertext)


def scale_compact_encode(n: int) -> bytes:
    """SCALE compact integer encoding."""
    if n < 1 << 6:
        return bytes([n << 2])
    if n < 1 << 14:
        return ((n << 2) | 0b01).to_bytes(2, "little")
    if n < 1 << 30:
        return ((n << 2) | 0b10).to_bytes(4, "little")
    nbytes = (n.bit_length() + 7) // 8
    return bytes([((nbytes - 4) << 2) | 0b11]) + n.to_bytes(nbytes, "little")


def scale_compact_decode(data: bytes) -> tuple:
    """Returns (value, bytes_consumed)."""
    if not data:
        raise FromBytesError("empty SCALE input")
    mode = data[0] & 0b11
    if mode == 0b00:
        return data[0] >> 2, 1
    if mode == 0b01:
        return int.from_bytes(data[:2], "little") >> 2, 2
    if mode == 0b10:
        return int.from_bytes(data[:4], "little") >> 2, 4
    nbytes = (data[0] >> 2) + 4
    return int.from_bytes(data[1 : 1 + nbytes], "little"), 1 + nbytes


def encode(obj) -> bytes:
    """SCALE ``Encode``: compact-length-prefixed bincode bytes."""
    if not isinstance(obj, CODEC_TYPES):
        raise TypeError(f"{type(obj).__name__} has no codec impl")
    inner = serialize(obj)
    return scale_compact_encode(len(inner)) + inner


def decode(cls, data: bytes):
    """SCALE ``Decode``."""
    if cls not in CODEC_TYPES:
        raise TypeError(f"{cls.__name__} has no codec impl")
    n, consumed = scale_compact_decode(data)
    payload = data[consumed : consumed + n]
    if len(payload) != n:
        raise FromBytesError("SCALE payload truncated")
    return deserialize(cls, payload)
