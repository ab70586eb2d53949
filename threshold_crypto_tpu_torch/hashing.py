"""Message hashing to G2: SHA3-256 → ChaCha20 → rejection sampling.

The counterpart of ``threshold_crypto_tpu/hashing.py`` (``sha3_256``,
``hash_g2``, ``hash_g2_batch``): ``hash_g2(msg)`` is
G2::random(ChaChaRng::from_seed(sha3_256(msg))), the reference's hash, not a
standards-track hash-to-curve.

``hash_g2`` is the pure-Python host oracle (``host/sampling.py``); the JAX
package runs the same chain through a g++-built native library, which the
port does not copy. ``hash_g2_batch`` runs the chain for a batch of
distinct messages on the device (``device/hash2g2.py``) and recomputes on
the host oracle the few lanes (≈2⁻ᴬ) that the device's fixed attempt and
word budget left unresolved.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .device import mont
from .host.chacha import ChaChaRng
from .host.sampling import g2_random


def sha3_256(data: bytes) -> bytes:
    return hashlib.sha3_256(bytes(data)).digest()


def hash_g2(msg: bytes):
    """Hash of the message in G2 as a host affine point (the reference's
    ``hash_g2``, ``src/lib.rs:691-694``)."""
    return g2_random(ChaChaRng.from_seed(sha3_256(msg)))


def digest_words(msgs, device):
    """int64[N, 8] tensor on ``device``: the little-endian u32 words of each
    message's SHA3-256 digest, the keys of the device ChaCha streams."""
    words = np.stack([np.frombuffer(sha3_256(m), dtype="<u4") for m in msgs])
    return torch.from_numpy(words.astype(np.int64)).to(device)


def hash_g2_batch(msgs, attempts: int = 8, device="cuda"):
    """``hash_g2`` for a batch of distinct messages with the sampling chain on
    the device; equal to ``hash_g2`` message for message. Returns a list of
    host affine points."""
    from .device import curve as dcv
    from .device import hash2g2

    if len(msgs) == 0:
        return []
    device = mont.device_of(device)
    jac, ok = hash2g2.hash_g2_device(digest_words(msgs, device),
                                     attempts=attempts)
    pts = dcv.G2.to_host_affine(jac)
    ok = ok.cpu().tolist()
    return [pt if k else hash_g2(m) for pt, k, m in zip(pts, ok, msgs)]
