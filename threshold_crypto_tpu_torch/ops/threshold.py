"""Batched threshold-protocol checks on the device stack.

The counterpart of ``threshold_crypto_tpu/ops/threshold.py``; so far
``verify_batch`` and ``verify_batch_pallas``, the strict per-pair BLS check
that every protocol verify reduces to, on the XLA-form path and on the
megakernel path. The JAX package's ``verify_batch_pallas_jit`` (a jit and
AOT-cache wrapper) has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import torch

from ..device import mont
from ..device import pairing as dpr
from ..device.mont import FQ
from ..host.params import G1_GEN, P


def _pair2(a_aff, b_aff):
    """Stack two equally-batched affine tuples along a new leading axis."""
    def stack(x, y):
        if isinstance(x, tuple):
            return tuple(stack(u, v) for u, v in zip(x, y))
        return torch.stack([x, y], dim=0)

    return stack(a_aff, b_aff)


def _neg_gen_g1(shape, device):
    """−G1 in affine form, broadcast to ``shape``."""
    gx, gy = G1_GEN

    def limbs(v):  # Montgomery form v·R mod p, broadcast
        return mont.const_limbs(FQ, v * FQ.r_mont % FQ.p, device).expand(
            tuple(shape) + (FQ.L,))

    return (limbs(gx), limbs(P - gy),
            torch.zeros(shape, dtype=torch.bool, device=device))


def verify_batch(pk_aff, h_aff, sig_aff):
    """bool[N]: e(pk_i, H_i) == e(G1, sig_i) per lane.

    pk_aff is a G1 affine tuple [N], h_aff / sig_aff G2 affine tuples [N],
    all on one device (see ``device.pairing.g1_affine_from_host``). One
    multi-Miller loop over the pair axis (2 pairs per lane) and one final
    exponentiation: e(pk, H)·e(−G1, sig) == 1.
    """
    n = pk_aff[2].shape[0]
    neg_gen = _neg_gen_g1((n,), pk_aff[2].device)
    p = _pair2(pk_aff, neg_gen)
    q = _pair2(h_aff, sig_aff)
    return dpr.pairing_check(p, q)


def verify_batch_pallas(pk_aff, h_aff, sig_aff):
    """``verify_batch`` on the megakernel path
    (``device.pairing.pairing_check_pallas``): the same bool[N], with each
    Miller iteration and each Fq12 step of the final exponentiation one
    kernel launch."""
    n = pk_aff[2].shape[0]
    neg_gen = _neg_gen_g1((n,), pk_aff[2].device)
    return dpr.pairing_check_pallas(_pair2(pk_aff, neg_gen),
                                    _pair2(h_aff, sig_aff))
