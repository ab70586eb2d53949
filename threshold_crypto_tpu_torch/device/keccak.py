"""SHA3-256 of 2176-byte chunks on a torch device, and the RLC transcript.

The counterpart of ``threshold_crypto_tpu/device/keccak.py``:

* ``sha3_chunks`` is kernel B12 (``csrc/keccak.cu``), replacing the Pallas
  kernel ``_k_sha3`` (:197): one thread per chunk, the state in 64-bit
  registers;
* ``sha3_256_chunks`` is its plain PyTorch version (the JAX package's XLA
  form, :144), the 25 lanes as one int64[25, K] tensor, each round a few
  whole-state tensor ops;
* ``hash_chunks`` sends a CUDA tensor to the kernel and a CPU tensor to the
  plain version;
* ``keccak_f1600`` is the JAX permutation (:117) on [25, ...] half-lanes,
  on the plain version's rounds;
* ``transcript_digests`` is the JAX function (:300) with tensors in the
  place of device arrays: the port's int32 limb tensors are the JAX
  package's uint32 leaves (the same little-endian bytes), numpy arrays its
  host leaves, and the digest list is the same for both.

A chunk is a row of int32[K, 544]: its bytes as little-endian 32-bit words;
a digest is a row of int32[K, 8], the same way. Each digest equals
``hashlib.sha3_256`` of the chunk's bytes.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import mont
from .cuda_mont import Kernel, KernelCount, launch

CHUNK_BYTES = 2176  # 16 SHA3-256 rate blocks (16 × 136 B); +1 padding perm
_WPC = CHUNK_BYTES // 4
_RATE_LANES = 17
# Compress the main-stream digest list once it has this many entries.
_L2_MIN = 64
_DIGESTS_PER_CHUNK = CHUNK_BYTES // 32  # 68

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rho offsets indexed x + 5y, and pi: B[y + 5((2x + 3y) % 5)] = A[x + 5y].
_RHO = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15,
        21, 8, 18, 2, 61, 56, 14]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y

SHA3 = KernelCount()


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def _consts(device):
    rho = torch.tensor(_RHO, dtype=torch.int64, device=device)[:, None]
    low = torch.tensor([(1 << r) - 1 for r in _RHO], dtype=torch.int64,
                       device=device)[:, None]
    rc = [_signed64(c) for c in _RC]
    pi = torch.tensor(_PI_SRC, dtype=torch.int64, device=device)
    return rho, low, rc, pi


def _rotl(v, r: int):
    return (v << r) | ((v >> (64 - r)) & ((1 << r) - 1))


def _keccak_f1600(s, consts):
    """The 24 rounds on the int64[25, K] state (lane x + 5y, 64-bit lanes in
    int64 bit patterns: shifts left wrap, right shifts are masked)."""
    rho, low, rc, pi = consts
    for c_round in rc:
        a = s.reshape(5, 5, -1)                                  # [y, x, K]
        c = a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4]                    # [x, K]
        d = c.roll(1, 0) ^ _rotl(c.roll(-1, 0), 1)
        a = (a ^ d[None]).reshape(25, -1)
        rot = (a << rho) | ((a >> (64 - rho)) & low)             # rho
        b = rot[pi].reshape(5, 5, -1)                            # pi
        s = (b ^ (~b.roll(-1, 1) & b.roll(-2, 1))).reshape(25, -1)  # chi
        s[0] ^= c_round                                          # iota
    return s


def keccak_f1600(lo, hi):
    """One Keccak-f[1600] permutation on [25, ...] half-lanes, the JAX
    signature: ``lo`` and ``hi`` hold the low and high 32 bits of each
    lane (lane x + 5y), as int32 tensors of one shape [25, ...] or as
    sequences of 25 tensors. Returns two lists of 25 int32 tensors, the
    permuted halves, on the plain version's whole-state rounds."""
    lo, hi = torch.stack(list(lo)), torch.stack(list(hi))
    shape = lo.shape
    s = ((lo.to(torch.int64) & 0xFFFFFFFF)
         | (hi.to(torch.int64) << 32)).reshape(25, -1)
    s = _keccak_f1600(s, _consts(s.device))
    out_lo = (s & 0xFFFFFFFF).to(torch.int32).reshape(shape)
    out_hi = ((s >> 32) & 0xFFFFFFFF).to(torch.int32).reshape(shape)
    return list(out_lo.unbind(0)), list(out_hi.unbind(0))


def sha3_256_chunks(words):
    """Plain PyTorch B12: int32[K, 544] chunks -> int32[K, 8] digests."""
    k = words.shape[0]
    consts = _consts(words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    lanes = (w[:, 0::2] | (w[:, 1::2] << 32)).reshape(k, 16, _RATE_LANES)
    s = torch.zeros((25, k), dtype=torch.int64, device=words.device)
    for blk in range(16):
        s[:_RATE_LANES] ^= lanes[:, blk].T
        s = _keccak_f1600(s, consts)
    s[0] ^= 0x06
    s[16] ^= _signed64(0x80 << 56)
    s = _keccak_f1600(s, consts)
    dig = s[:4].T                                                # [K, 4]
    out = torch.stack([dig & 0xFFFFFFFF, (dig >> 32) & 0xFFFFFFFF], 2)
    return out.reshape(k, 8).to(torch.int32)


def sha3_chunks(words):
    """Kernel B12: SHA3-256 of each row of a contiguous int32[K, 544] CUDA
    tensor -> int32[K, 8]."""
    if words.device.type != "cuda":
        raise ValueError(f"words must be a CUDA tensor, got {words.device}")
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != _WPC or not words.is_contiguous():
        raise ValueError(f"words must be a contiguous int32[K, {_WPC}], got "
                         f"{words.dtype}{tuple(words.shape)}")
    k = words.shape[0]
    out = torch.empty((k, 8), dtype=torch.int32, device=words.device)
    if k:
        launch("keccak", "tc_sha3_chunks", SHA3, (words, out), k, lanes=k)
    return out


def hash_chunks(words):
    """Kernel on the card, plain version on the CPU (identical digests)."""
    return (sha3_chunks if mont.on_card(words) else sha3_256_chunks)(words)


def _np_sha3_chunks(words_np):
    """Host form of ``sha3_256_chunks`` (hashlib per chunk)."""
    out = np.zeros((words_np.shape[0], 8), np.uint32)
    for i in range(words_np.shape[0]):
        out[i] = np.frombuffer(
            hashlib.sha3_256(words_np[i].tobytes()).digest(), "<u4")
    return out


def _is_limbs(leaf) -> bool:
    """A 32-bit word leaf: the port's int32 limb tensors, or uint32 numpy
    arrays (the JAX package's uint32 leaves)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype == torch.int32
    return np.asarray(leaf).dtype == np.uint32


def _l2_compress(dig):
    """[K, 8] digests (tensor or numpy) -> [⌈K/68⌉, 8] level-2 digests."""
    k = dig.shape[0]
    k2 = -(-k // _DIGESTS_PER_CHUNK)
    pad = k2 * _DIGESTS_PER_CHUNK - k
    if isinstance(dig, torch.Tensor):
        dig = torch.nn.functional.pad(dig, (0, 0, 0, pad))
        return hash_chunks(dig.reshape(k2, _WPC))
    dig = np.concatenate([dig, np.zeros((pad, 8), np.uint32)])
    return _np_sha3_chunks(dig.reshape(k2, _WPC))


def transcript_digests(leaves):
    """The digest list of a transcript of tensor (or numpy) leaves.

    * The main stream is the full 2176-byte chunks of every 32-bit word
      leaf of at least one chunk, in leaf order; hashed where the leaf
      lives (B12 on the card). With 64 chunk digests or more, the digest
      array is zero-padded to a chunk multiple and hashed again (level 2).
    * The host stream is the leaves' tails, the bool masks and the small
      leaves, hashed on the host per 2176-byte chunk.
    * A header digest binds the counts of both streams and the level.

    Tensor and numpy leaves with the same bytes give the same list.
    """
    main, host_stream = [], []       # 2-d chunks; flat tails and leaves
    for leaf in leaves:
        is_tensor = isinstance(leaf, torch.Tensor)
        flat = leaf.reshape(-1) if is_tensor else \
            np.ascontiguousarray(leaf).reshape(-1)
        if _is_limbs(leaf) and flat.shape[0] * 4 >= CHUNK_BYTES:
            nfull = flat.shape[0] // _WPC
            main.append(flat[:nfull * _WPC].reshape(nfull, _WPC))
            tail = flat[nfull * _WPC:]
            if tail.shape[0]:
                host_stream.append(tail)
        else:
            host_stream.append(flat)

    k = sum(m.shape[0] for m in main)
    main_digests, level = [], 1
    if k:
        tensors = [m for m in main if isinstance(m, torch.Tensor)]
        if tensors:
            dev = tensors[0].device
            dig = hash_chunks(torch.cat([
                m if isinstance(m, torch.Tensor)
                else torch.from_numpy(m.view(np.int32)).to(dev)
                for m in main]).contiguous())
        else:
            dig = _np_sha3_chunks(np.concatenate(main))
        if k >= _L2_MIN:
            level = 2
            dig = _l2_compress(dig)
        if isinstance(dig, torch.Tensor):
            dig = dig.cpu().numpy()
        main_digests = [d.tobytes() for d in dig]

    host_digests = []
    for item in host_stream:
        raw = (item.cpu().numpy() if isinstance(item, torch.Tensor)
               else item).tobytes()
        for off in range(0, max(len(raw), 1), CHUNK_BYTES):
            host_digests.append(
                hashlib.sha3_256(raw[off:off + CHUNK_BYTES]).digest())

    header = hashlib.sha3_256(
        b"TC-TRANSCRIPT-v2" + k.to_bytes(8, "little")
        + len(host_digests).to_bytes(8, "little") + bytes([level])).digest()
    return [header] + main_digests + host_digests


KERNELS = (
    Kernel("sha3_chunks", sha3_chunks, sha3_256_chunks, SHA3,
           "threshold_crypto_tpu_torch/csrc/keccak.cu",
           "threshold_crypto_tpu/device/keccak.py:197"),
)
