"""The host ChaCha20 stream (``rand_chacha 0.2`` ``ChaCha20Rng``).

A copy of the parts of ``threshold_crypto_tpu/utils/rng.py`` that the RLC
exponents need: ``chacha20_block`` and ``ChaChaRng`` (64-bit block counter
in state words 12-13, stream id 0 in 14-15; ``next_u64`` is two consecutive
words, low word first). ``chacha20_words`` is the same stream computed for
many blocks at once with numpy, the port's counterpart of the JAX package's
native bulk stream (``native.chacha20_words``); the tests hold it against
``ChaChaRng``.
"""

from __future__ import annotations

import struct

import numpy as np

_MASK32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
# The column and diagonal quarter-rounds of one double round.
_QUARTER_ROUNDS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                   (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                   (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK32


def chacha20_block(key_words, counter: int, nonce_words=(0, 0)) -> list:
    """One ChaCha20 block (20 rounds): 16 output words (u32)."""
    state = [*_CONSTANTS, *key_words, counter & _MASK32,
             (counter >> 32) & _MASK32, nonce_words[0], nonce_words[1]]
    x = list(state)
    for _ in range(10):
        for a, b, c, d in _QUARTER_ROUNDS:
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl32(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl32(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl32(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl32(x[b] ^ x[c], 7)
    return [(x[i] + state[i]) & _MASK32 for i in range(16)]


class ChaChaRng:
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

    def next_u32(self) -> int:
        if self._pos >= len(self._buf):
            self._buf = chacha20_block(self._key, self._counter)
            self._counter += 1
            self._pos = 0
        w = self._buf[self._pos]
        self._pos += 1
        return w

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return (hi << 32) | lo


def chacha20_words(seed: bytes, n_words: int) -> np.ndarray:
    """Words [0, n_words) of ``ChaChaRng(seed)``'s stream, as uint32[n_words]:
    every block at once, one numpy vector per state word."""
    nblocks = -(-n_words // 16)
    key = np.frombuffer(bytes(seed), dtype="<u4")
    if key.size != 8:
        raise ValueError("the ChaCha seed must be 32 bytes")
    ctr = np.arange(nblocks, dtype=np.uint64)
    state = ([np.full(nblocks, c, np.uint32) for c in _CONSTANTS]
             + [np.full(nblocks, k, np.uint32) for k in key]
             + [(ctr & 0xFFFFFFFF).astype(np.uint32),
                (ctr >> np.uint64(32)).astype(np.uint32),
                np.zeros(nblocks, np.uint32), np.zeros(nblocks, np.uint32)])
    x = [s.copy() for s in state]

    def rotl(v, c):
        return (v << np.uint32(c)) | (v >> np.uint32(32 - c))

    for _ in range(10):
        for a, b, c, d in _QUARTER_ROUNDS:
            x[a] += x[b]
            x[d] = rotl(x[d] ^ x[a], 16)
            x[c] += x[d]
            x[b] = rotl(x[b] ^ x[c], 12)
            x[a] += x[b]
            x[d] = rotl(x[d] ^ x[a], 8)
            x[c] += x[d]
            x[b] = rotl(x[b] ^ x[c], 7)
    out = np.stack([x[i] + state[i] for i in range(16)], axis=1)
    return out.reshape(-1)[:n_words]
