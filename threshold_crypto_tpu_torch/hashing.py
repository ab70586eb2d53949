"""Hashing / KDF stack: SHA3-256 → ChaCha20 → group-element sampling.

The counterpart of ``threshold_crypto_tpu/hashing.py``, replicating the
reference's ``src/lib.rs:690-715`` and ``src/util.rs:3-9``:

* ``hash_g2(msg)`` = G2::random(ChaChaRng::from_seed(sha3_256(msg))), the
  reference's hash, not a standards-track hash-to-curve; on the BLS
  backend the whole chain runs in the native library (``native``), whose
  oracle is the pure-Python ``host.sampling.g2_random``.
* ``hash_g1_g2(g1, msg)`` pre-hashes messages longer than 64 bytes,
  appends the compressed g1, then ``hash_g2``.
* ``xor_with_hash(g1, bytes)`` XORs with the ChaCha20-derived u8 stream
  keyed by sha3_256(compressed g1) (one u32 word per byte; rand 0.7
  ``Standard`` u8 semantics).
* ``hash_g2_batch`` runs the chain for a batch of distinct messages on the
  device (``device/hash2g2.py``) and recomputes with ``hash_g2`` the few
  lanes (≈2⁻ᴬ) that the device's fixed attempt and word budget left
  unresolved.

``hash_g2`` and ``hash_g2_batch`` return the backend's G2 elements; their
host affine points are ``.v``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .backend import get_backend
from .device import mont
from .utils import trace
from .utils.rng import ChaChaRng


def sha3_256(data: bytes) -> bytes:
    return native.sha3_256(data)


def hash_g2(msg: bytes):
    """Hash of the message in G2 (``src/lib.rs:691-694``)."""
    b = get_backend()
    if b.name == "bls12_381":
        return b.G2(native.hash_g2(msg))
    return b.G2.random(ChaChaRng.from_seed(sha3_256(msg)))


@trace.traced("hash.digests")
def digest_words(msgs, device):
    """int64[N, 8] tensor on ``device``: the little-endian u32 words of each
    message's SHA3-256 digest, the keys of the device ChaCha streams."""
    words = np.stack([np.frombuffer(sha3_256(m), dtype="<u4") for m in msgs])
    return torch.from_numpy(words.astype(np.int64)).to(device)


def hash_g2_batch(msgs, attempts: int = 8, device="cuda"):
    """``hash_g2`` for a batch of distinct messages with the sampling chain on
    the device; equal to ``hash_g2`` message for message. Returns a list of
    backend G2 elements (on the mock backend ``hash_g2`` of each)."""
    from .device import curve as dcv
    from .device import hash2g2

    b = get_backend()
    if b.name != "bls12_381" or len(msgs) == 0:
        return [hash_g2(m) for m in msgs]
    device = mont.device_of(device)
    jac, ok = hash2g2.hash_g2_device(digest_words(msgs, device),
                                     attempts=attempts)
    pts = dcv.G2.to_host_affine(jac)
    ok = ok.cpu().tolist()
    return [b.G2(pt) if k else hash_g2(m) for pt, k, m in zip(pts, ok, msgs)]


def hash_g1_g2(g1, msg: bytes):
    """Hash of (group element, message) in G2 (``src/lib.rs:697-707``)."""
    m = bytes(msg)
    if len(m) > 64:
        m = sha3_256(m)
    return hash_g2(m + g1.to_compressed())


def xor_with_hash(g1, data: bytes) -> bytes:
    """XOR ``data`` with the pseudorandom stream keyed by g1
    (``src/lib.rs:710-715``), fused in the native library."""
    return native.xor_with_hash(g1.to_compressed(), data)
