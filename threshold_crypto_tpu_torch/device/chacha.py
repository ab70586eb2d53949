"""The ChaCha20 word stream on a torch device, and the RLC exponents from it.

The counterpart of ``threshold_crypto_tpu/device/chacha.py``
(``chacha20_words``, ``rlc_exponent_limbs``): only the 32-byte transcript
digest is needed to expand the whole exponent stream where the points live.
``chacha20_words`` also takes a batch of keys, one stream each: the
per-message streams of ``hash2g2`` (the JAX ``_chacha_words_multikey``).
It is plain tensor code, as the JAX module is XLA code, not a kernel.

Bit-exact with ``host.chacha.ChaChaRng`` (``rand_chacha 0.2``: 64-bit block
counter in state words 12-13, stream id 0 in 14-15, block-major word order).
Torch's ``uint32`` has no add, shift or compare on the CPU, so each 32-bit
word lives in an ``int64`` tensor and every sum and shift is masked back to
32 bits. The state is a [4, 4, ..., blocks] tensor of rows (words 4r..4r+3): a
column round works on the four rows as they are, a diagonal round on the
rows turned by 1, 2 and 3 words, so the 16 quarter-rounds of a double round
are 8 vector steps.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(v, c: int):
    return ((v << c) & _MASK32) | (v >> (32 - c))


def _quarter_rounds(a, b, c, d):
    a = (a + b) & _MASK32
    d = _rotl(d ^ a, 16)
    c = (c + d) & _MASK32
    b = _rotl(b ^ c, 12)
    a = (a + b) & _MASK32
    d = _rotl(d ^ a, 8)
    c = (c + d) & _MASK32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def chacha20_words(key_words, n_words: int):
    """Words [0, n_words) of the ChaCha20Rng stream keyed by ``key_words``
    (int64[..., 8] on the device: the little-endian words of each 32-byte
    seed; a batch of keys gives a batch of streams). Returns
    int64[..., n_words], each word in [0, 2³²)."""
    dev = key_words.device
    batch = key_words.shape[:-1]
    nblocks = -(-n_words // 16)
    shape = (*batch, nblocks)
    ctr = torch.arange(nblocks, dtype=torch.int64, device=dev).expand(shape)
    consts = torch.tensor(_CONSTANTS, dtype=torch.int64, device=dev)
    keys = key_words.to(torch.int64).movedim(-1, 0)[..., None]
    state = torch.stack([
        *(c.expand(shape) for c in consts),
        *(k.expand(shape) for k in keys),
        ctr & _MASK32, ctr >> 32, torch.zeros_like(ctr), torch.zeros_like(ctr),
    ]).reshape(4, 4, *shape)
    a, b, c, d = state.unbind(0)
    for _ in range(10):
        a, b, c, d = _quarter_rounds(a, b, c, d)
        b, c, d = (b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0))
        a, b, c, d = _quarter_rounds(a, b, c, d)
        b, c, d = (b.roll(1, 0), c.roll(2, 0), d.roll(3, 0))
    out = (torch.stack([a, b, c, d]) + state) & _MASK32   # [4, 4, ..., B]
    out = out.reshape(16, *shape).movedim(0, -1)           # [..., B, 16]
    return out.reshape(*batch, nblocks * 16)[..., :n_words]


def rlc_exponent_limbs(key_words, n: int):
    """The int32[n, 16] RLC exponent batch from a transcript digest: u64
    draws (low word first), a zero draw replaced by 1, the low 4 limbs
    populated (canonical Fr limbs)."""
    words = chacha20_words(key_words, 2 * n)
    lo, hi = words[0::2], words[1::2]
    lo = torch.where((lo == 0) & (hi == 0), torch.ones_like(lo), lo)
    limbs = torch.stack([lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16], 1)
    return torch.nn.functional.pad(limbs, (0, 12)).to(torch.int32)
