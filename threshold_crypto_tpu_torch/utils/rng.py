"""Random number generators mirroring the Rust ``rand`` 0.7 / ``rand_chacha``
0.2 APIs.

A copy of ``threshold_crypto_tpu/utils/rng.py``. The reference threads
``RngCore`` objects through every random constructor (``src/lib.rs:41-43``).
Deterministic key generation and the whole ``hash_g2`` chain depend on the
exact word stream of ``rand_chacha 0.2``'s ``ChaCha20Rng``
(``src/lib.rs:691-694, 710-715``), which this module computes bit-exactly:

* 64-bit block counter in state words 12-13, 64-bit stream id (0) in 14-15.
* ``from_seed`` = 32-byte key, counter 0.
* ``next_u32`` consumes successive output words; ``next_u64`` is two
  consecutive words, low word first (rand_core's ``next_u64_via_u32``).
* ``rand 0.7`` samples a ``u8`` from ``Standard`` as ``next_u32() as u8``
  (one full word consumed per byte), which ``xor_with_hash`` uses.

``host/chacha.py`` adds the same stream for many blocks at once (numpy),
and ``native`` the g++-built one; the tests hold both against this one.
"""

from __future__ import annotations

import secrets
import struct

_MASK32 = 0xFFFFFFFF
CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
# The column and diagonal quarter-rounds of one double round.
QUARTER_ROUNDS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                  (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                  (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK32


def chacha20_block(key_words, counter: int, nonce_words=(0, 0)) -> list:
    """One ChaCha20 block (20 rounds): 16 output words (u32).

    ``key_words``: 8 u32; ``counter``: 64-bit block counter occupying words
    12 (low) and 13 (high); ``nonce_words``: 2 u32 stream id.
    """
    state = [*CONSTANTS, *key_words, counter & _MASK32,
             (counter >> 32) & _MASK32, nonce_words[0], nonce_words[1]]
    x = list(state)
    for _ in range(10):
        for a, b, c, d in QUARTER_ROUNDS:
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl32(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl32(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl32(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl32(x[b] ^ x[c], 7)
    return [(x[i] + state[i]) & _MASK32 for i in range(16)]


class RngCore:
    """Minimal RngCore interface (mirrors rand_core 0.5)."""

    def next_u32(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return (hi << 32) | lo

    def fill_bytes(self, n: int) -> bytes:
        """Return ``n`` pseudorandom bytes (whole little-endian words)."""
        out = bytearray()
        while len(out) < n:
            out += struct.pack("<I", self.next_u32())
        return bytes(out[:n])

    def gen_u8(self) -> int:
        """rand 0.7 ``Standard`` u8 sampling: ``rng.next_u32() as u8``."""
        return self.next_u32() & 0xFF


class ChaChaRng(RngCore):
    """Bit-exact ``rand_chacha 0.2`` ``ChaCha20Rng`` word stream."""

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("ChaChaRng seed must be 32 bytes")
        self._key = struct.unpack("<8I", seed)
        self._counter = 0
        self._buf: list = []
        self._pos = 0

    @classmethod
    def from_seed(cls, seed: bytes) -> "ChaChaRng":
        return cls(seed)

    def _refill(self) -> None:
        self._buf = chacha20_block(self._key, self._counter)
        self._counter += 1
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= len(self._buf):
            self._refill()
        w = self._buf[self._pos]
        self._pos += 1
        return w

    def keystream_bytes(self, n: int) -> bytes:
        """``n`` bytes where byte i = low byte of word i (rand 0.7 u8
        stream): the keystream of the reference's ``xor_with_hash``
        (``src/lib.rs:710-715``), whose ``sample_iter(&Standard)`` over
        ``u8`` takes one u32 per byte."""
        return bytes(self.gen_u8() for _ in range(n))


class OsRng(RngCore):
    """OS-entropy RNG (mirrors rand 0.7 ``OsRng``, the default for
    encrypt)."""

    def next_u32(self) -> int:
        return secrets.randbits(32)

    def next_u64(self) -> int:
        return secrets.randbits(64)


class XorShiftRng(RngCore):
    """xorshift128 RNG, bit-exact with ``rand_xorshift 0.2`` (the
    reference's bench seeding, ``benches/bench.rs:8,17``)."""

    def __init__(self, seed: bytes):
        if len(seed) != 16:
            raise ValueError("XorShiftRng seed must be 16 bytes")
        x, y, z, w = struct.unpack("<4I", seed)
        if x == y == z == w == 0:
            x, y, z, w = 0xBAD_5EED, 0xBAD_5EED & _MASK32, 0xBAD_5EED, 0xBAD_5EED
        self._s = [x, y, z, w]

    def next_u32(self) -> int:
        x, y, z, w = self._s
        t = (x ^ ((x << 11) & _MASK32)) & _MASK32
        x, y, z = y, z, w
        w = (w ^ (w >> 19)) ^ (t ^ (t >> 8))
        w &= _MASK32
        self._s = [x, y, z, w]
        return w


def default_rng() -> RngCore:
    """thread_rng()/OsRng stand-in used by no-arg random constructors."""
    return OsRng()
