"""The port's native (C++) host runtime.

The counterpart of ``threshold_crypto_tpu/native``: ``csrc/tc_native.cpp``
(SHA3-256, the ChaCha20 word stream, ``xor_with_hash`` and one message's
whole ``hash_g2`` chain) compiled by g++ into the package's ``_build/``
cache at first use (``_build.native_library``) and called through ctypes.
Unlike the JAX loader it has no switch and no fallback: a failed build
raises with g++'s output. The pure-Python chains (``utils.rng.ChaChaRng``,
``host.sampling.g2_random``) are the oracles the tests hold it to.
"""

from __future__ import annotations

import ctypes

from .. import _build


def sha3_256(data: bytes) -> bytes:
    data = bytes(data)
    out = ctypes.create_string_buffer(32)
    _build.native_library().tc_sha3_256(data, len(data), out)
    return out.raw


def _check_seed(seed: bytes) -> bytes:
    # the C side copies exactly 32 bytes; mirror ChaChaRng's check
    seed = bytes(seed)
    if len(seed) != 32:
        raise ValueError("ChaCha20 seed must be 32 bytes")
    return seed


def chacha20_words(seed: bytes, word_off: int, n_words: int) -> list:
    """Words [word_off, word_off + n_words) of the ChaCha20Rng u32 stream."""
    seed = _check_seed(seed)
    buf = (ctypes.c_uint32 * n_words)()
    _build.native_library().tc_chacha20_words(seed, word_off, buf, n_words)
    return list(buf)


def chacha20_low_bytes(seed: bytes, word_off: int, n: int) -> bytes:
    """rand 0.7 Standard-u8 keystream (low byte of each u32 word)."""
    seed = _check_seed(seed)
    out = ctypes.create_string_buffer(n)
    _build.native_library().tc_chacha20_low_bytes(seed, word_off, out, n)
    return out.raw


def _unpack_g2(raw: bytes):
    x0 = int.from_bytes(raw[0:48], "big")
    x1 = int.from_bytes(raw[48:96], "big")
    y0 = int.from_bytes(raw[96:144], "big")
    y1 = int.from_bytes(raw[144:192], "big")
    return ((x0, x1), (y0, y1))


def hash_g2(msg: bytes):
    """The reference's whole hash_g2 chain (sha3 → ChaCha → G2 rejection
    sampling → cofactor) in one native call: a host affine G2 point
    ((x0, x1), (y0, y1))."""
    msg = bytes(msg)
    out = ctypes.create_string_buffer(192)
    _build.native_library().tc_hash_g2(msg, len(msg), out)
    return _unpack_g2(out.raw)


def g2_random_from_seed(seed: bytes):
    """G2::random(ChaChaRng::from_seed(seed)), the sampling half of
    hash_g2, for the tests against ``host.sampling.g2_random``."""
    seed = _check_seed(seed)
    out = ctypes.create_string_buffer(192)
    _build.native_library().tc_g2_random_from_seed(seed, out)
    return _unpack_g2(out.raw)


def xor_with_hash(key_material: bytes, data: bytes) -> bytes:
    """data ⊕ ChaCha20(SHA3-256(key_material)) low-byte keystream, fused."""
    key_material, data = bytes(key_material), bytes(data)
    out = ctypes.create_string_buffer(len(data))
    _build.native_library().tc_xor_with_hash(
        key_material, len(key_material), data, len(data), out)
    return out.raw
