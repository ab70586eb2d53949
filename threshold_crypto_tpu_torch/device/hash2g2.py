"""The reference's message → G2 sampling chain on the device, batched over
distinct messages.

The counterpart of ``threshold_crypto_tpu/device/hash2g2.py``
(``_chacha_words_multikey``, ``extract_candidates``, ``_words_to_limbs``,
``fq2_pow_fixed``, ``_canonical_gt``, ``_fq2_is_greatest``,
``hash_g2_device`` on its Pallas branch). The reference hash
(``src/lib.rs:691-694`` → ``util.rs:3-9``) is G2::random(ChaChaRng(
sha3_256(msg))), a rejection-sampling chain (``host/sampling.py``):

    loop:
        x  = Fq2::random(rng)        # per Fq draw: 6 × u64, shave 3 top
                                     # bits, retry while ≥ p
        g  = rng.next_u32() odd      # the `greatest` bit
        y² = x³ + 4(1+u); retry if a non-residue
        P  = (x, ±y) · cofactor

The stream a lane consumes per attempt does not depend on the residue
test, so the first A (x, greatest) candidates are a function of the word
stream alone. Pipeline:

1. per-lane ChaCha20 streams (``device/chacha.chacha20_words`` over a batch
   of keys);
2. candidate extraction (``extract_candidates``): the host walk as a
   sequence of draws; each step reads a lane's next 12-word draw (or its
   one `greatest` word) at the lane's own stream position, so the loop
   runs over draws (about 30 for A = 8) where the JAX scan runs over every
   word (512);
3. residue tests of all A candidates at once: a ∈ Fq2 is a square iff its
   norm c0² + c1² is a square in Fq, one Fq Euler power per candidate
   (``mont.pow_fixed``: kernel B2 on the card);
4. the Fq2 square root of the first accepted candidate (Adj–Rodríguez
   alg. 9 as selects, mirroring ``host/tower.fq2_sqrt``), the root chosen
   by the `greatest` draw as ``host/curve.get_point_from_x`` chooses it;
5. the cofactor: one ladder over the 127 static base-16 digits of H2
   (``cuda_curve.scalar_mul_fixed_pallas``: kernel B13);
6. lanes whose A attempts all failed (≈2⁻ᴬ) or whose word budget ran out
   report ``ok = False``; ``hashing.hash_g2_batch`` and
   ``ops.verify_with_hash_batch`` recompute those with ``hashing.hash_g2``
   (the native chain).

Words live in int64 tensors (values < 2³²): torch's ``uint32`` has no
arithmetic on the CPU. The accepted draw is the Montgomery form of the
field value, since R = 2^384 for the draw and the limbs alike.
"""

from __future__ import annotations

import functools

import torch

from ..host.params import B_G2, H2, P
from . import chacha as dchacha
from . import cuda_curve as ccv
from . import curve as dcv
from . import mont
from . import tower as tw
from .mont import FQ

DEFAULT_ATTEMPTS = 8
# words per outer attempt: 2 × (12 words / 0.813 acceptance) + 1 ≈ 30.5
DEFAULT_WORDS = 512
# FQ_SHAVE_MASK = 2^381 − 1: the top u32 word keeps 381 − 352 = 29 bits.
_TOP_MASK = (1 << 29) - 1
_P_WORDS = tuple((P >> (32 * i)) & 0xFFFFFFFF for i in range(12))


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """p's 12 words and the bit weights 2^0..2^23 on ``device``."""
    return (torch.tensor(_P_WORDS, dtype=torch.int64, device=device),
            torch.ones(24, dtype=torch.int64, device=device)
            << torch.arange(24, device=device))


def _lex_gt(a, b, weight):
    """a > b for little-endian word or limb vectors: the most significant
    differing position decides, as the larger of two bit masks."""
    return ((a > b).long() * weight).sum(-1) > ((a < b).long() * weight
                                                ).sum(-1)


# ---------------------------------------------------------------------------
# Per-lane ChaCha20 word streams and candidate extraction
# ---------------------------------------------------------------------------

def _chacha_words_multikey(keys, n_words: int):
    """int64[N, 8] keys -> int64[N, n_words] ChaCha20Rng word streams, each
    the stream of ``host.chacha.ChaChaRng`` with that key."""
    return dchacha.chacha20_words(keys, n_words)


def extract_candidates(words, attempts: int = DEFAULT_ATTEMPTS):
    """Walk each lane's word stream exactly like the host sampler.

    words: int64[N, S]. Returns (xc0, xc1, greatest, nvalid):
      xc0/xc1  int64[N, A, 12]: accepted Fq draws (the Montgomery form as
               u32 words, < p) for the two Fq2 components, zero where none
               was accepted,
      greatest bool[N, A]: the per-attempt parity draw,
      nvalid   int32[N]: complete candidate tuples extracted
               (min(attempts finished, A)); a lane whose words run out
               mid-attempt counts fewer, and keeps the c0 it accepted.

    Each step moves every lane one draw on: in phase 0 or 1 the 12 words
    at its position (kept, top word masked, if < p, which moves it to the
    next phase), in phase 2 the one `greatest` word (which ends the
    attempt). A lane stops once it has A attempts or too few words left;
    the loop ends when every lane has stopped.
    """
    n, s = words.shape
    dev = words.device
    A = attempts
    p_words, weight = _consts(dev)
    weight = weight[:12]
    iota12 = torch.arange(12, device=dev)
    slots = torch.arange(A, device=dev)
    top = torch.tensor([0xFFFFFFFF] * 11 + [_TOP_MASK], dtype=torch.int64,
                       device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    phase = torch.zeros_like(pos)
    aidx = torch.zeros_like(pos)
    xc = torch.zeros((2, n, A, 12), dtype=torch.int64, device=dev)
    grt = torch.zeros((n, A), dtype=torch.bool, device=dev)
    for step in range(s):
        drawing = phase < 2
        need = torch.where(drawing, 12, 1)
        active = (aidx < A) & (pos + need <= s)
        if step % 8 == 7 and not bool(active.any()):
            break
        at = (pos[:, None] + iota12).clamp(max=s - 1)
        cand = words.gather(1, at) & top                     # [N, 12]
        accept = active & drawing & _lex_gt(p_words, cand, weight)
        slot = (slots[None] == aidx[:, None])                # [N, A]
        put = (accept[None] & (phase[None] == torch.arange(2, device=dev)[
            :, None]))[:, :, None] & slot[None]              # [2, N, A]
        xc = torch.where(put[..., None], cand[None, :, None, :], xc)
        gstep = active & (phase == 2)
        grt = torch.where(gstep[:, None] & slot, (cand[:, :1] & 1) != 0, grt)
        phase = torch.where(gstep, 0, torch.where(accept, phase + 1, phase))
        aidx = aidx + gstep.long()
        pos = torch.where(active, pos + need, pos)
    return xc[0], xc[1], grt, aidx.to(torch.int32)


def _words_to_limbs(w):
    """int64[..., 12] u32 draw words -> int32[..., 24] 16-bit limbs (the
    draw is the Montgomery form already)."""
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1)
    return limbs.reshape(*w.shape[:-1], 24).to(torch.int32)


# ---------------------------------------------------------------------------
# Field helpers
# ---------------------------------------------------------------------------

def fq2_pow_fixed(a, e: int):
    """a^e in Fq2 for a fixed public exponent: MSB-first square and
    multiply, the multiply only where the (static) bit is set."""
    if e == 0:
        return tw.fq2_one(a[0].shape[:-1], a[0].device)
    acc = a
    for bit in bin(e)[3:]:
        acc = tw.fq2_sqr(acc)
        if bit == "1":
            acc = tw.fq2_mul(acc, a)
    return acc


def _canonical_gt(a_plain, b_plain):
    """a > b on canonical 24 × 16-bit limbs (limb 0 least significant)."""
    return _lex_gt(a_plain, b_plain, _consts(a_plain.device)[1])


def _fq2_is_greatest(y):
    """fq2_cmp(y, −y) > 0: pairing 0.16's order, c1 first, then c0, on the
    canonical values (``host/tower.fq2_cmp``)."""
    ny = tw.fq2_neg(y)
    plain = mont.mul(FQ, torch.stack([y[0], y[1], ny[0], ny[1]]),
                     mont.const_limbs(FQ, 1, y[0].device))
    y0, y1, n0, n1 = plain.unbind(0)
    return _canonical_gt(y1, n1) | (mont.eq(FQ, y1, n1)
                                    & _canonical_gt(y0, n0))


# ---------------------------------------------------------------------------
# The batched sampler
# ---------------------------------------------------------------------------

def residue_test(x, nvalid):
    """rhs = x³ + b for every candidate x (an Fq2 pair of [N, A, 24]) and
    which candidates are usable: a square (its norm c0² + c1² a square in
    Fq: one Euler power per candidate) among the first ``nvalid``."""
    n, A = x[0].shape[:2]
    dev = x[0].device
    b = tuple(c.expand(n, A, FQ.L) for c in tw.fq2_from_host([B_G2], dev))
    rhs = tw.fq2_add(tw.fq2_mul(tw.fq2_sqr(x), x), b)
    sq = mont.mul(FQ, torch.stack(rhs), torch.stack(rhs))
    norm = mont.add(FQ, sq[0], sq[1])
    euler = mont.pow_fixed(FQ, norm, (P - 1) // 2)
    is_qr = mont.eq(FQ, euler, mont.one(FQ, euler.shape[:-1], dev)) | \
        mont.is_zero(FQ, norm)                   # norm == 0 iff rhs == 0
    return rhs, is_qr & (torch.arange(A, device=dev)[None]
                         < nvalid[:, None].long())


def fq2_sqrt(a):
    """A square root of each square a (an Fq2 pair of [N, 24]):
    Adj–Rodríguez alg. 9 as ``host/tower.fq2_sqrt`` runs it, its two
    branches as selects."""
    n, dev = a[0].shape[0], a[0].device
    a1 = fq2_pow_fixed(a, (P - 3) // 4)
    x0 = tw.fq2_mul(a1, a)
    alpha = tw.fq2_mul(a1, x0)
    minus_one = (mont.neg(FQ, mont.one(FQ, (n,), dev)),
                 mont.zero(FQ, (n,), dev))
    y_u = (mont.neg(FQ, x0[1]), x0[0])                    # u · x0
    b_exp = fq2_pow_fixed(tw.fq2_add(tw.fq2_one((n,), dev), alpha),
                          (P - 1) // 2)
    return tw.fq2_select(tw.fq2_eq(alpha, minus_one), y_u,
                         tw.fq2_mul(b_exp, x0))


def hash_g2_device(digests, attempts: int = DEFAULT_ATTEMPTS,
                   n_words: int = DEFAULT_WORDS):
    """Batched G2::random(ChaChaRng(digest)) on the digests' device.

    digests: int64[N, 8], the little-endian u32 words of the 32-byte
    SHA3-256 digests (``hashing.digest_words``). Returns (jac, ok):
      jac: a G2 Jacobian tuple [N] (junk coordinates where not ok),
      ok:  bool[N], True where the chain gave the host's answer; False
           lanes (≈2⁻ᴬ: every candidate a non-residue, or the word budget
           spent) need the host oracle.
    """
    n = digests.shape[0]
    dev = digests.device
    A = attempts
    rows = torch.arange(n, device=dev)

    words = _chacha_words_multikey(digests, n_words)
    xc0_w, xc1_w, grt, nvalid = extract_candidates(words, A)
    x = (_words_to_limbs(xc0_w), _words_to_limbs(xc1_w))     # [N, A, 24]
    rhs, ok_k = residue_test(x, nvalid)

    # the first usable candidate per lane (slot A − 1 where none is)
    found = ok_k.any(1)
    chosen = torch.where(found, ok_k.to(torch.int32).argmax(1),
                         torch.full_like(rows, A - 1))
    xs = (x[0][rows, chosen], x[1][rows, chosen])
    g = grt[rows, chosen]
    y = fq2_sqrt((rhs[0][rows, chosen], rhs[1][rows, chosen]))

    # the root the `greatest` draw asks for (host get_point_from_x)
    y = tw.fq2_select(_fq2_is_greatest(y) == g, y, tw.fq2_neg(y))

    # the cofactor H2: one ladder over its 127 static base-16 digits
    aff = (xs, y, torch.zeros(n, dtype=torch.bool, device=dev))
    out = ccv.scalar_mul_fixed_pallas(dcv.G2, aff, H2)
    ok = found & ~dcv.G2.is_infinity(out)        # identity: the host retries
    return out, ok
