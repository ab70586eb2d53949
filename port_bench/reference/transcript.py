"""The RLC verification transcript and its 64-bit exponents, from the
bytes of the inputs: SHA3-256 from ``hashlib``, ChaCha20 from
:mod:`.chacha`.

The transcript hashes each leaf of the absorbed points (NumPy arrays with
the bytes of the tensors handed to the program, in the order of the
points' nested tuples): a 32-bit word leaf of at least one 2176-byte chunk
contributes its whole chunks to the main stream and its tail to the host
stream; a bool mask or a small leaf goes to the host stream whole. With 64
main-stream chunks or more their digests, zero-padded to whole chunks,
are hashed once more (level 2). A header digest binds the counts of both
streams and the level. The exponents are ChaCha20's stream keyed by
SHA3-256(seed ‖ n ‖ number of digests ‖ digests): a u64 draw per share,
low word first, a zero draw replaced by 1.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import chacha

CHUNK_BYTES = 2176
L2_MIN = 64
DIGESTS_PER_CHUNK = CHUNK_BYTES // 32


def _sha3(b) -> bytes:
    return hashlib.sha3_256(b).digest()


def _main_digests(chunks):
    """Digests of 2176-byte chunks given as one bytes object."""
    view = memoryview(chunks)
    return [_sha3(view[i:i + CHUNK_BYTES])
            for i in range(0, len(view), CHUNK_BYTES)]


def digests(leaves) -> list:
    """The digest list of a transcript of NumPy leaves."""
    main, host_stream = [], []
    for leaf in leaves:
        flat = np.ascontiguousarray(leaf).reshape(-1)
        words = flat.dtype in (np.int32, np.uint32)
        if words and flat.size * 4 >= CHUNK_BYTES:
            nfull = flat.size * 4 // CHUNK_BYTES
            raw = flat.tobytes()
            main.append(raw[:nfull * CHUNK_BYTES])
            if len(raw) > nfull * CHUNK_BYTES:
                host_stream.append(raw[nfull * CHUNK_BYTES:])
        else:
            host_stream.append(flat.tobytes())
    main_d = [d for m in main for d in _main_digests(m)]
    k, level = len(main_d), 1
    if k >= L2_MIN:
        level = 2
        pad = (-k) % DIGESTS_PER_CHUNK
        main_d = _main_digests(b"".join(main_d) + bytes(32 * pad))
    host_d = []
    for raw in host_stream:
        for off in range(0, max(len(raw), 1), CHUNK_BYTES):
            host_d.append(_sha3(raw[off:off + CHUNK_BYTES]))
    header = _sha3(b"TC-TRANSCRIPT-v2" + k.to_bytes(8, "little")
                   + len(host_d).to_bytes(8, "little") + bytes([level]))
    return [header] + main_d + host_d


def exponents(n: int, seed: bytes, leaf_digests) -> np.ndarray:
    """uint64[n]: the RLC exponents of a transcript's digest list."""
    material = (bytes(seed) + n.to_bytes(8, "little")
                + len(leaf_digests).to_bytes(8, "little")
                + b"".join(leaf_digests))
    w = chacha.stream_words(_sha3(material), 2 * n).astype(np.uint64)
    v = w[0::2] | (w[1::2] << np.uint64(32))
    return np.where(v == 0, np.uint64(1), v)
