"""ChaCha20 (RFC 8439's block function) in NumPy, and the word stream of
``rand_chacha``'s ``ChaCha20Rng``: a 64-bit block counter in state words
12-13 and stream id 0 in words 14-15, blocks one after the other."""

from __future__ import annotations

import numpy as np

CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
# The column and diagonal quarter-rounds of one double round.
QUARTER_ROUNDS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                  (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                  (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl(v, c):
    return (v << np.uint32(c)) | (v >> np.uint32(32 - c))


def blocks(key: bytes, words_12_15) -> np.ndarray:
    """uint32[B, 16]: the ChaCha20 block of each row of ``words_12_15``
    (uint32[B, 4], the state's last four words) under the 32-byte key."""
    kw = np.frombuffer(bytes(key), dtype="<u4")
    if kw.size != 8:
        raise ValueError("the ChaCha key must be 32 bytes")
    tail = np.asarray(words_12_15, dtype=np.uint32).reshape(-1, 4)
    nb = tail.shape[0]
    state = ([np.full(nb, c, np.uint32) for c in CONSTANTS]
             + [np.full(nb, k, np.uint32) for k in kw]
             + [tail[:, i].copy() for i in range(4)])
    x = [s.copy() for s in state]
    for _ in range(10):
        for a, b, c, d in QUARTER_ROUNDS:
            x[a] += x[b]
            x[d] = _rotl(x[d] ^ x[a], 16)
            x[c] += x[d]
            x[b] = _rotl(x[b] ^ x[c], 12)
            x[a] += x[b]
            x[d] = _rotl(x[d] ^ x[a], 8)
            x[c] += x[d]
            x[b] = _rotl(x[b] ^ x[c], 7)
    return np.stack([x[i] + state[i] for i in range(16)], axis=1)


def stream_words(seed: bytes, n_words: int) -> np.ndarray:
    """Words [0, n_words) of ``ChaCha20Rng::from_seed(seed)``'s stream."""
    nb = -(-n_words // 16)
    ctr = np.arange(nb, dtype=np.uint64)
    tail = np.zeros((nb, 4), np.uint32)
    tail[:, 0] = (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tail[:, 1] = (ctr >> np.uint64(32)).astype(np.uint32)
    return blocks(seed, tail).reshape(-1)[:n_words]
