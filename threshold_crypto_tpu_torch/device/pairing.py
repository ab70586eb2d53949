"""Batched BLS12-381 ate pairing check on torch tensors.

Two paths, each the counterpart of one of ``threshold_crypto_tpu/device/
pairing.py``: ``pairing_check_pallas`` (below, the megakernel path) and
``pairing_check``, the XLA path (``pairing_check_fused``): the Miller loop
with Q in homogeneous projective Fq2 coordinates and sparse line values
folded into f by ``fq12_mul_by_014``, then the final exponentiation as the
host oracle's lattice chain (X−1)²·(X+p)·(X²+p²−1)+3, so the GT elements
are identical to the JAX package's and the host oracle's.

PyTorch runs eagerly, so both loops are plain Python over the static bits
of |X| (the JAX package's static-bit forms ``miller_loop`` / ``_exp_by_x``):
no add on zero bits, no select per bit.

Points are affine tuples with a free leading batch shape:
  G1: (x, y, inf) — x, y int32[..., 24] Montgomery limbs, inf bool[...]
  G2: (x, y, inf) — x, y Fq2 pairs of the same,           inf bool[...]
"""

from __future__ import annotations

import torch

from ..host.params import X_BITS
from ..utils import trace
from . import cuda_tower as ctw
from . import mont
from . import packed as pk
from . import tower as tw
from .mont import FQ


def g1_affine_from_host(pts, device="cuda"):
    """List of host affine G1 points (None = infinity) -> batched tuple."""
    device = mont.device_of(device)
    xs = [0 if pt is None else pt[0] for pt in pts]
    ys = [0 if pt is None else pt[1] for pt in pts]
    infs = [pt is None for pt in pts]
    return (
        torch.from_numpy(mont.stack_mont(FQ, xs)).to(device),
        torch.from_numpy(mont.stack_mont(FQ, ys)).to(device),
        torch.tensor(infs, dtype=torch.bool, device=device),
    )


def g2_affine_from_host(pts, device="cuda"):
    """List of host affine G2 points (None = infinity) -> batched tuple."""
    device = mont.device_of(device)
    zero = ((0, 0), (0, 0))
    pts2 = [zero if pt is None else pt for pt in pts]
    x = tw.fq2_from_host([pt[0] for pt in pts2], device)
    y = tw.fq2_from_host([pt[1] for pt in pts2], device)
    infs = torch.tensor([pt is None for pt in pts], dtype=torch.bool,
                        device=device)
    return (x, y, infs)


def miller_loop(p_aff, q_aff):
    """f_{|X|,Q}(P), conjugated for X < 0; batched Fq12.

    Lanes with an infinite P or Q give exactly 1.
    """
    xp, yp, p_inf = p_aff
    xq, yq, q_inf = q_aff
    shape, dev = xp.shape[:-1], xp.device

    T = (xq, yq, tw.fq2_one(shape, dev))
    f = tw.fq12_one(shape, dev)
    for bit in X_BITS[1:]:
        f = tw.fq12_sqr(f)
        T, line = tw.dbl_step(T, xp, yp)
        f = tw.fq12_mul_by_014(f, *line)
        if bit:
            T, line = tw.add_step(T, (xq, yq), xp, yp)
            f = tw.fq12_mul_by_014(f, *line)
    f = tw.fq12_conj(f)  # X < 0
    return tw.fq12_select(p_inf | q_inf, tw.fq12_one(shape, dev), f)


# ---------------------------------------------------------------------------
# Final exponentiation (the host oracle's chain).
# ---------------------------------------------------------------------------

def _exp_by_x(f):
    """f^X in the cyclotomic subgroup (X < 0: conjugate at the end).

    MSB-first square-and-multiply over the static |X| bits (63 cyclotomic
    squarings, 5 multiplies); the leading 1-bit is f itself."""
    result = f
    for bit in X_BITS[1:]:
        result = tw.fq12_cyclo_sqr(result)
        if bit:
            result = tw.fq12_mul(result, f)
    return tw.fq12_conj(result)


def final_exponentiation(f):
    """Easy part, then the lattice hard part (X−1)²(X+p)(X²+p²−1) + 3."""
    f = tw.fq12_easy_part(f)
    t = tw.fq12_mul(_exp_by_x(f), tw.fq12_conj(f))       # f^(X-1)
    t = tw.fq12_mul(_exp_by_x(t), tw.fq12_conj(t))       # f^((X-1)^2)
    t = tw.fq12_mul(_exp_by_x(t), tw.fq12_frob(t, 1))    # ^(X+p)
    tx2 = _exp_by_x(_exp_by_x(t))
    t = tw.fq12_mul(tw.fq12_mul(tx2, tw.fq12_frob(t, 2)), tw.fq12_conj(t))
    return tw.fq12_mul(t, tw.fq12_mul(tw.fq12_sqr(f), f))  # * f^3


def _fq12_prod_leading(f, k: int):
    """Product of a [k, ...]-batched Fq12 over the leading axis (static k)."""
    def lane(i):
        return tuple(tuple((c[0][i], c[1][i]) for c in f6) for f6 in f)

    acc = lane(0)
    for i in range(1, k):
        acc = tw.fq12_mul(acc, lane(i))
    return acc


def pairing(p_aff, q_aff):
    """Reduced pairing per batch lane; equals the host oracle's exactly."""
    return final_exponentiation(miller_loop(p_aff, q_aff))


def multi_pairing(p_aff, q_aff):
    """∏ over the leading pair axis of e(P_i, Q_i), per remaining batch
    lane: the Miller values' product, then one shared final
    exponentiation. Inputs [k, ...]-batched; the reduced value equals the
    JAX ``multi_pairing``'s limb for limb."""
    f = miller_loop(p_aff, q_aff)
    return final_exponentiation(_fq12_prod_leading(f, p_aff[0].shape[0]))


def pairing_check(p_aff, q_aff):
    """bool[...]: ∏ e(P_i, Q_i) == 1 over the leading pair axis."""
    return tw.fq12_is_one(multi_pairing(p_aff, q_aff))


# ---------------------------------------------------------------------------
# The megakernel path (``pairing_check_pallas``): whole Miller iterations and
# whole Fq12 steps of the final exponentiation as one kernel launch each, on
# the packed layout of device/packed.py. The JAX package's DIRECT-mode
# driver: Python loops over the static bits of |X|.
# ---------------------------------------------------------------------------

def _flatten_aff(aff):
    """Affine tuple of any batch shape -> (flat [N, 24] components, inf[N])."""
    x, y, inf = aff
    coords = (*x, *y) if isinstance(x, tuple) else (x, y)
    return [c.reshape(-1, FQ.L) for c in coords], inf.reshape(-1)


def miller_loop_packed(p_packed, q_packed):
    """f_{|X|,Q}(P) before the conjugation, every lane live.

    p_packed: [48, N] (xp, yp); q_packed: [96, N] (x0, x1, y0, y1). One
    B4 launch on each of the 63 bits of |X| after the first, and one B5 on
    each of its five 1-bits. Returns the packed Fq12 [288, N]."""
    n, dev = p_packed.shape[1], p_packed.device
    T = torch.cat([q_packed, pk.packed_one2(n, dev)])      # (X, Y, Z = 1)
    f = pk.packed_one12(n, dev)
    for bit in X_BITS[1:]:
        f, T = ctw.p_dbl_fold(f, T, p_packed)
        if bit:
            f, T = ctw.p_add_fold(f, T, q_packed, p_packed)
    return f


def _expx_packed(f):
    """f^X (X < 0) in the cyclotomic subgroup: B6 on the 58 zero bits of
    |X| after the first, B7 (square, then ·f) on its five 1-bits, then the
    conjugation."""
    acc = f
    for bit in X_BITS[1:]:
        acc = ctw.p_cyclo_sqr_mul(acc, f) if bit else ctw.p_cyclo_sqr(acc)
    return pk.packed_conj12(acc)


@trace.traced("pairing.final_exp")
def final_exponentiation_packed(f):
    """The final exponentiation on the packed layout; the same GT limbs as
    ``final_exponentiation``. The easy part is B18's ``easy_down``, one
    Fermat inversion (B2) and ``easy_up``; the hard part is the lattice
    chain t1 = x^X·conj(x), t2 = t1^X·conj(t1), t3 = t2^X·frob1(t2),
    t5 = t3^X^X·frob2(t3)·conj(t3), result t5·x²·x, in B6-B9 launches and
    B18's ``frob_mul`` for the two Frobenius products."""
    with trace.span("final_exp.easy"):
        f = ctw.p_easy_part(f)
    with trace.span("final_exp.hard"):
        t = ctw.p_fq12_mul(_expx_packed(f), pk.packed_conj12(f))
        t = ctw.p_fq12_mul(_expx_packed(t), pk.packed_conj12(t))
        t = ctw.p_frob_mul(_expx_packed(t), t, 1)
        tx2 = _expx_packed(_expx_packed(t))
        t = ctw.p_fq12_mul(ctw.p_frob_mul(tx2, t, 2), pk.packed_conj12(t))
        f3 = ctw.p_fq12_mul(ctw.p_fq12_sqr(f), f)
        return ctw.p_fq12_mul(t, f3)


@trace.traced("pairing.miller")
def _miller_packed(p_aff, q_aff):
    """Conjugated Miller values of every (P, Q) lane, flattened; lanes with
    an infinite P or Q are exactly 1."""
    pc, p_inf = _flatten_aff(p_aff)
    qc, q_inf = _flatten_aff(q_aff)
    f = pk.packed_conj12(miller_loop_packed(pk.pack(pc), pk.pack(qc)))
    one = pk.packed_one12(f.shape[1], f.device)
    return torch.where((p_inf | q_inf)[None, :], one, f)


@trace.traced("pairing.check")
def pairing_check_pallas(p_aff, q_aff):
    """bool[...]: ∏ e(P_i, Q_i) == 1 over the leading pair axis, on the
    megakernel path. The k pairs of a lane sit in k bands of the lane axis
    and are folded by k − 1 B8 launches before one shared final
    exponentiation."""
    k = p_aff[2].shape[0]
    f = _miller_packed(p_aff, q_aff)
    with trace.span("pairing.fold_pairs"):
        n = f.shape[1] // k
        acc = f[:, :n].contiguous()
        for i in range(1, k):
            acc = ctw.p_fq12_mul(acc, f[:, i * n:(i + 1) * n].contiguous())
    gt = final_exponentiation_packed(acc)
    with trace.span("pairing.is_one"):
        return pk.packed_is_one12(gt).reshape(p_aff[2].shape[1:])


def pairing_pallas(p_aff, q_aff):
    """Reduced pairing per batch lane on the megakernel path: the same
    limbs-last Fq12 tuple as ``pairing``."""
    shape = p_aff[2].shape
    gt = pk.unpack12(final_exponentiation_packed(_miller_packed(p_aff, q_aff)))
    return tuple(tuple(tuple(c.reshape(shape + (FQ.L,)) for c in x2)
                       for x2 in x6) for x6 in gt)
