"""The packed layout of the tower kernels B4-B9.

The counterpart of the packing helpers of
``threshold_crypto_tpu/device/pallas_tower.py`` (``pack``, ``unpack``,
``packed_one12``, ``packed_one2``, ``packed_is_one12``, ``packed_conj12``).
A packed value is ``int32[k·24, N]``: k Fq components in the flat order of
their tuple (an Fq12 in ``pallas_tower.flat12`` order), each as 24 rows of
16-bit limbs, least significant first, with the N lanes last. It is the
TPU's ``[k·L, R, 128]`` with ``R·128`` flattened, in the public Montgomery
form R = 2^384: the kernels' engine works in that form already, so there is
no engine-form conversion (``pallas_tower.to_engine``/``from_engine``), and
no padding either (the kernels mask the ragged edge, so ``pack_rows`` has no
counterpart).
"""

from __future__ import annotations

import torch

from . import mont
from .mont import FQ

L = FQ.L


def pack(comps):
    """List of k int32[N, 24] components -> packed int32[k·24, N]."""
    return torch.cat([c.reshape(-1, L).T for c in comps], dim=0).contiguous()


def unpack(packed, k: int):
    """Packed int32[k·24, N] -> list of k int32[N, 24] components."""
    return [packed[i * L:(i + 1) * L].T.contiguous() for i in range(k)]


def pack12(f):
    """Nested Fq12 tuple of int32[N, 24] -> packed int32[288, N]."""
    return pack([f[i][j][k] for i in range(2) for j in range(3)
                 for k in range(2)])


def unpack12(packed):
    """Packed int32[288, N] -> nested Fq12 tuple of int32[N, 24]."""
    it = iter(unpack(packed, 12))
    return tuple(tuple((next(it), next(it)) for _ in range(3))
                 for _ in range(2))


def pack_fq2s(xs):
    """Fq2 pairs (x0, x1), ... -> packed int32[2·len(xs)·24, N]."""
    return pack([c for x in xs for c in x])


def unpack_fq2s(packed, k: int):
    """Packed int32[2k·24, N] -> k Fq2 pairs."""
    comps = unpack(packed, 2 * k)
    return [(comps[2 * i], comps[2 * i + 1]) for i in range(k)]


def _one_rows(k: int, n: int, device):
    """Packed value of k components: the first is 1, the rest 0."""
    out = torch.zeros((k * L, n), dtype=torch.int32, device=device)
    out[:L] = mont.const_limbs(FQ, FQ.one_mont, torch.device(device))[:, None]
    return out


def packed_one12(n: int, device):
    """Packed Fq12 one over n lanes."""
    return _one_rows(12, n, device)


def packed_one2(n: int, device):
    """Packed Fq2 one over n lanes."""
    return _one_rows(2, n, device)


def packed_is_one12(f):
    """bool[N]: packed Fq12 == 1 per lane."""
    return (f == packed_one12(f.shape[1], f.device)).all(0)


def packed_conj12(f):
    """Conjugate (negate the c1 Fq6 half) on the packed layout, by the
    port's plain field negation over the 6 components at once."""
    n = f.shape[1]
    c1 = f[6 * L:].reshape(6, L, n).permute(0, 2, 1)           # [6, N, 24]
    neg = mont.neg(FQ, c1).permute(0, 2, 1).reshape(6 * L, n)
    return torch.cat([f[:6 * L], neg], dim=0)
