"""The host ChaCha20 stream (``rand_chacha 0.2`` ``ChaCha20Rng``) in bulk.

``ChaChaRng`` and ``chacha20_block`` live in ``utils/rng.py`` and are
re-exported here for the modules that draw from this one.
``chacha20_words`` is the same stream computed for many blocks at once
with numpy, which the RLC exponents read on the host; the tests hold it
against ``ChaChaRng`` and the native library's ``chacha20_words``.
"""

from __future__ import annotations

import numpy as np

from ..utils.rng import CONSTANTS, QUARTER_ROUNDS
from ..utils.rng import ChaChaRng, chacha20_block  # noqa: F401


def chacha20_words(seed: bytes, n_words: int) -> np.ndarray:
    """Words [0, n_words) of ``ChaChaRng(seed)``'s stream, as uint32[n_words]:
    every block at once, one numpy vector per state word."""
    nblocks = -(-n_words // 16)
    key = np.frombuffer(bytes(seed), dtype="<u4")
    if key.size != 8:
        raise ValueError("the ChaCha seed must be 32 bytes")
    ctr = np.arange(nblocks, dtype=np.uint64)
    state = ([np.full(nblocks, c, np.uint32) for c in CONSTANTS]
             + [np.full(nblocks, k, np.uint32) for k in key]
             + [(ctr & 0xFFFFFFFF).astype(np.uint32),
                (ctr >> np.uint64(32)).astype(np.uint32),
                np.zeros(nblocks, np.uint32), np.zeros(nblocks, np.uint32)])
    x = [s.copy() for s in state]

    def rotl(v, c):
        return (v << np.uint32(c)) | (v >> np.uint32(32 - c))

    for _ in range(10):
        for a, b, c, d in QUARTER_ROUNDS:
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
