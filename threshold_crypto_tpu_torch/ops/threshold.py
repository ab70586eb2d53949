"""Batched threshold-protocol checks on the device stack.

The counterpart of ``threshold_crypto_tpu/ops/threshold.py``; so far:

* the coordinate plumbing ``batch_inv_field``, ``jacobian_to_affine`` and
  ``affine_to_jacobian``;
* ``verify_batch`` and ``verify_batch_pallas``, the strict per-pair BLS
  check that every protocol verify reduces to, on the XLA-form path and on
  the megakernel path;
* the RLC batch verification of N shares on one message, the system's main
  path: ``rlc_exponents`` (transcript SHA3, then ChaCha20), then
  ``verify_sig_shares_rlc_pallas`` (two 64-bit MSMs, shared-window or
  ladder, and one 2-pair check through ``verify_batch_pallas``);
* ``verify_with_hash_batch``, N signatures on N distinct messages with the
  message hash on the device (``device/hash2g2.py``), the reference's
  per-share ``verify``;
* ``encrypt_batch_pallas``, the three per-lane scalar-muls of batched
  Baek–Zhang encryption on the ladder kernel, and the batch ops of the two
  threshold flows around it: ``sign_batch``, ``decrypt_share_batch``,
  ``encrypt_begin_batch`` / ``encrypt_finish_batch`` / ``encrypt_batch``
  (per-lane ladders, B10 tables and B13), ``verify_dec_share_batch`` and
  ``ciphertext_verify_batch`` (2-pair checks on the megakernel pairing);
* ``combine_batch``, the threshold combine: λ from the shares' x
  (``ops.fr.lagrange_coeffs_at_zero``, B14 above 1024 shares), then one
  255-bit MSM on one of three paths (B11, B15 or B16);
* ``derive_shares``, the keygen's share derivation (``ops.fr.poly_eval``);
* the DKG batch ops: ``commit_batch`` (Feldman commitments on the
  generator), ``powers_batch``, ``bivar_commit_batch`` (a dealer's
  triangular commitment), ``bivar_row_batch`` (its rows for every node),
  ``bivar_commit_row_batch`` (the row commitments every node checks its row
  against) and ``bivar_commit_eval_batch`` (the per-value check
  C(x, y) == f(x, y)·G1), on the 255-bit ladders (B10 tables, B13) and B1;
* ``verify_sig_shares_rlc``, the RLC check with its two 64-bit MSMs as
  per-lane bit ladders (``DeviceCurve.msm_scalarwise``: B15 and the fold).

The JAX package's jit and AOT-cache wrappers (``verify_batch_pallas_jit``,
the jitted aggregate of ``verify_sig_shares_rlc_pallas``, and
``set_aot_cache``, which points them at a compile cache) have no
counterpart: PyTorch runs eagerly. Nor have ``combine_batch_stepwise``,
``verify_batch_stepwise`` and ``verify_sig_shares_rlc_stepwise``, which
drive the same math over small jitted steps only to escape XLA's compile
latency.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import hashing
from ..device import chacha as dchacha
from ..device import cuda_curve as ccv
from ..device import curve as dcv
from ..device import hash2g2
from ..device import keccak as dkeccak
from ..device import mont
from ..device import pairing as dpr
from ..device.curve import leaves, tree_map
from ..device.mont import FQ, FR
from ..host import chacha as hchacha
from ..host.params import G1_GEN, P
from ..poly import coeff_pos
from ..utils import trace
from . import fr as frops


# ---------------------------------------------------------------------------
# Coordinate plumbing
# ---------------------------------------------------------------------------

def batch_inv_field(f, a):
    """Batched inversion over a field namespace (``curve.FqOps`` arrays,
    ``curve.Fq2Ops`` pairs) of any batch shape; zero maps to zero.

    On the card it is ``f.inv``: one Fermat chain in one B2 launch, as the
    JAX package defers to ``f.inv`` on its Pallas path. On the CPU it is the
    JAX package's product tree: pairwise products up, one inversion at the
    root, the tree walked down.
    """
    if mont.on_card(leaves(a)[0]):
        return f.inv(a)
    bs = f.shape(a)
    n = int(np.prod(bs, dtype=np.int64))
    if n <= 1:
        return f.inv(a)
    k = len(bs)
    dev = leaves(a)[0].device
    flat = tree_map(lambda x: x.reshape((n,) + x.shape[k:]), a)
    zm = f.is_zero(flat)
    safe = f.select(zm, f.one((n,), dev), flat)
    m = 1 << (n - 1).bit_length()
    if m != n:
        safe = tree_map(lambda x, q: torch.cat([x, q]), safe,
                        f.one((m - n,), dev))
    levels = [safe]
    while leaves(levels[-1])[0].shape[0] > 1:
        cur = levels[-1]
        levels.append(f.mul(tree_map(lambda x: x[0::2], cur),
                            tree_map(lambda x: x[1::2], cur)))
    inv_cur = f.inv(levels[-1])
    for lev in levels[-2::-1]:
        il = f.mul(inv_cur, tree_map(lambda x: x[1::2], lev))
        ir = f.mul(inv_cur, tree_map(lambda x: x[0::2], lev))
        inv_cur = tree_map(
            lambda l, r: torch.stack([l, r], 1).reshape(
                (2 * l.shape[0],) + l.shape[1:]), il, ir)
    out = f.select(zm, f.zero((n,), dev),
                   tree_map(lambda x: x[:n], inv_cur))
    return tree_map(lambda x: x.reshape(tuple(bs) + x.shape[1:]), out)


@trace.traced("affine")
def jacobian_to_affine(curve, p):
    """Batched Jacobian -> affine tuple (x, y, inf) for the pairing: one
    batched inversion of Z. Infinity lanes (Z = 0) get inf = True and
    coordinates 0 (Z⁻¹ = 0)."""
    f = curve.f
    X, Y, Z = p
    zinv = batch_inv_field(f, Z)
    zinv2 = f.sqr(zinv)
    return (f.mul(X, zinv2), f.mul(Y, f.mul(zinv2, zinv)), f.is_zero(Z))


def affine_to_jacobian(curve, aff):
    """Affine tuple (x, y, inf) -> Jacobian (X, Y, Z) with Z ∈ {0, 1}."""
    f = curve.f
    x, y, inf = aff
    shape, dev = f.shape(x), leaves(x)[0].device
    return (x, y, f.select(~inf, f.one(shape, dev), f.zero(shape, dev)))


def _pair2(a_aff, b_aff):
    """Stack two equally-batched affine tuples along a new leading axis."""
    def stack(x, y):
        if isinstance(x, tuple):
            return tuple(stack(u, v) for u, v in zip(x, y))
        return torch.stack([x, y], dim=0)

    return stack(a_aff, b_aff)


def _g1_const(x, y, shape, device):
    """The affine G1 point (x, y), broadcast to ``shape``."""
    def limbs(v):  # Montgomery form v·R mod p, broadcast
        return mont.const_limbs(FQ, v * FQ.r_mont % FQ.p, device).expand(
            tuple(shape) + (FQ.L,))

    return (limbs(x), limbs(y),
            torch.zeros(shape, dtype=torch.bool, device=device))


def _gen_g1(shape, device):
    """G1's generator in affine form, broadcast to ``shape``."""
    return _g1_const(G1_GEN[0], G1_GEN[1], shape, device)


def _neg_gen_g1(shape, device):
    """−G1 in affine form, broadcast to ``shape``."""
    return _g1_const(G1_GEN[0], P - G1_GEN[1], shape, device)


def _neg_aff(curve, aff):
    """−P of an affine tuple (x, y, inf): (x, −y, inf)."""
    x, y, inf = aff
    return (x, curve.f.neg(y), inf)


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


@trace.traced("ops.verify_batch_pallas")
def verify_batch_pallas(pk_aff, h_aff, sig_aff):
    """``verify_batch`` on the megakernel path
    (``device.pairing.pairing_check_pallas``): the same bool[N], with each
    Miller iteration and each Fq12 step of the final exponentiation one
    kernel launch."""
    n = pk_aff[2].shape[0]
    neg_gen = _neg_gen_g1((n,), pk_aff[2].device)
    return dpr.pairing_check_pallas(_pair2(pk_aff, neg_gen),
                                    _pair2(h_aff, sig_aff))


@trace.traced("ops.verify_with_hash_batch")
def verify_with_hash_batch(pk_aff, msgs, sig_aff, attempts: int = 8):
    """N signatures over N distinct messages, the message hash included:
    e(pk_i, H(m_i)) == e(G1, sig_i) per lane, the reference's per-share
    ``verify`` (``src/lib.rs:177-179`` → ``:691-694``).

    pk_aff: G1 affine tuple [N]; msgs: N byte strings; sig_aff: G2 affine
    tuple [N]. The digests are taken on the host, the hash chain runs on
    the points' device (``hash2g2.hash_g2_device``), the lanes it leaves
    unresolved (≈2⁻ᴬ) get the point of ``hashing.hash_g2`` (the native
    chain), and the check runs through ``verify_batch_pallas``. Returns bool[N] as a numpy array.
    """
    n = len(msgs)
    if not pk_aff[2].shape[0] == n == sig_aff[2].shape[0]:
        raise ValueError("pk_aff, msgs and sig_aff need one length")
    dev = pk_aff[2].device
    jac, ok = hash2g2.hash_g2_device(hashing.digest_words(msgs, dev),
                                     attempts=attempts)
    h_aff = splice_host_hashes(jacobian_to_affine(dcv.G2, jac), ok, msgs)
    return verify_batch_pallas(pk_aff, h_aff, sig_aff).cpu().numpy()


@trace.traced("ops.splice_host_hashes")
def splice_host_hashes(h_aff, ok, msgs):
    """The G2 affine tuple h_aff with each lane that is not ``ok`` replaced
    by ``hashing.hash_g2`` of its message (the native library's chain)."""
    okh = ok.cpu().numpy()
    if okh.all():
        return h_aff
    bad = np.nonzero(~okh)[0]
    dev = ok.device
    fb = dpr.g2_affine_from_host([hashing.hash_g2(msgs[i]).v for i in bad],
                                 device=dev)
    idx = torch.from_numpy(bad).to(dev)
    return tree_map(lambda a, b: a.index_put((idx,), b), h_aff, fb)


@trace.traced("ops.verify_dec_share_batch")
def verify_dec_share_batch(share_aff, huv_aff, pk_aff, w_aff):
    """bool[N]: e(share_i, H(u, v)_i) == e(pk_i, w_i) per lane
    (``src/lib.rs:182-186``), as e(share, H)·e(−pk, w) == 1 through
    ``pairing_check_pallas``. share_aff / pk_aff: G1 affine tuples [N],
    huv_aff / w_aff: G2 affine tuples [N]."""
    return dpr.pairing_check_pallas(
        _pair2(share_aff, _neg_aff(dcv.G1, pk_aff)), _pair2(huv_aff, w_aff))


@trace.traced("ops.ciphertext_verify_batch")
def ciphertext_verify_batch(u_aff, w_aff, huv_aff):
    """bool[N]: e(G1, w_i) == e(u_i, H(u, v)_i) per lane, the ciphertext
    check (``src/lib.rs:508-513``), as e(G1, w)·e(−u, H) == 1 through
    ``pairing_check_pallas``."""
    n = u_aff[2].shape[0]
    gen = _gen_g1((n,), u_aff[2].device)
    return dpr.pairing_check_pallas(
        _pair2(gen, _neg_aff(dcv.G1, u_aff)), _pair2(w_aff, huv_aff))


# ---------------------------------------------------------------------------
# Sign, decrypt share, encrypt: per-lane scalar-muls on the ladder
# ---------------------------------------------------------------------------

@trace.traced("ops.sign_batch")
def sign_batch(h_jac, sk_plain):
    """sig_i = H_i·sk_i (``src/lib.rs:372-374``): h_jac a G2 Jacobian tuple
    [N] (a shared hash point broadcast to the batch), sk_plain int32[N, 16]
    canonical Fr limbs. The points are lifted to affine
    (``jacobian_to_affine``), then ``cuda_curve.scalar_mul_pallas`` runs the
    ladder (B10 table, one B13 launch). Returns a G2 Jacobian tuple [N]."""
    return ccv.scalar_mul_pallas(dcv.G2, jacobian_to_affine(dcv.G2, h_jac),
                                 sk_plain)


@trace.traced("ops.decrypt_share_batch")
def decrypt_share_batch(u_jac, sk_plain):
    """d_i = u_i·sk_i (G1), the decryption share (``src/lib.rs:460-462``),
    as ``sign_batch`` is in G2. Returns a G1 Jacobian tuple [N]."""
    return ccv.scalar_mul_pallas(dcv.G1, jacobian_to_affine(dcv.G1, u_jac),
                                 sk_plain)


def _encrypt_begin(pk_aff, r_plain):
    gen = _gen_g1((r_plain.shape[0],), r_plain.device)
    return (ccv.scalar_mul_pallas(dcv.G1, gen, r_plain),
            ccv.scalar_mul_pallas(dcv.G1, pk_aff, r_plain))


def encrypt_begin_batch(pk_jac, r_plain):
    """The first half of batched encryption (``src/lib.rs:128-137``):
    u_i = r_i·G1 and g_i = r_i·pk_i. pk_jac: a G1 Jacobian tuple [N] (a
    shared key broadcast to the batch); r_plain: int32[N, 16] canonical Fr
    limbs. The host derives v and H(u, v) from them; returns (u [N],
    g [N]) as Jacobian tuples."""
    return _encrypt_begin(jacobian_to_affine(dcv.G1, pk_jac), r_plain)


def encrypt_finish_batch(huv_jac, r_plain):
    """The second half: w_i = r_i·H(u_i, v_i) (G2). Returns a G2 Jacobian
    tuple [N]."""
    return ccv.scalar_mul_pallas(
        dcv.G2, jacobian_to_affine(dcv.G2, huv_jac), r_plain)


def encrypt_batch(pk_jac, r_plain, huv_jac):
    """The three scalar-muls of batched encryption in one call, for callers
    that hold the H(u, v) points already: (u [N], g [N], w [N])."""
    u, g = encrypt_begin_batch(pk_jac, r_plain)
    return u, g, encrypt_finish_batch(huv_jac, r_plain)


@trace.traced("ops.encrypt_batch_pallas")
def encrypt_batch_pallas(pk_aff, r_plain, huv_aff):
    """The three scalar-muls of batched encryption (``src/lib.rs:128-137``)
    on the per-lane ladder (``cuda_curve.scalar_mul_pallas``: B10 tables,
    one B13 launch each, 64 base-16 digits of the 255-bit r): u = r·G1,
    g = r·pk and w = r·H(u, v).

    pk_aff / huv_aff: G1 / G2 affine tuples [N] (a shared key broadcast to
    the batch); r_plain: int32[N, 16] canonical Fr limbs. Returns the
    Jacobian tuples (u [N], g [N], w [N]).
    """
    u, g = _encrypt_begin(pk_aff, r_plain)
    return u, g, ccv.scalar_mul_pallas(dcv.G2, huv_aff, r_plain)


# ---------------------------------------------------------------------------
# Combine (in-exponent Lagrange at x = 0) and share derivation
# ---------------------------------------------------------------------------

COMBINE_PATHS = ("pallas", "scalarwise", "bitscan")


@trace.traced("ops.combine_batch")
def combine_batch(curve, shares_jac, xs_mont, path: str = "scalarwise"):
    """Σᵢ λᵢ·shareᵢ with λ from the batch's x (``src/lib.rs:719-767``).

    curve: ``curve.G2`` for signature shares, ``curve.G1`` for decryption
    shares; shares_jac: a Jacobian tuple [N]; xs_mont: int32[N, 16]
    Montgomery Fr limbs (the reference's x = i + 1). λ comes from
    ``ops.fr.lagrange_coeffs_at_zero`` (B14 above 1024 shares) in canonical
    form (one B1); the shares are lifted to affine (``jacobian_to_affine``)
    and the 255-bit MSM runs on the path named:

    * "pallas": ``msm_pallas_shared`` at window 3 (85 windows; B10 table,
      one B11 launch, the fold);
    * "scalarwise" (the JAX default): N bit ladders, one B15 launch
      (``msm_pallas(window=1)``), and one fold of N lanes;
    * "bitscan": ``DeviceCurve.msm`` at window 1, one shared accumulator
      block over the bits (``msm_pallas_shared(window=1, fused=False)``):
      per bit one B16 dblw and one B16 selmadd per 1024 lanes, then the
      fold.

    Returns (unbatched Jacobian point, ok bool[]): ok is False on a
    duplicate or a zero x, the reference's DuplicateEntry.
    """
    if path not in COMBINE_PATHS:
        raise ValueError(f"unknown combine path {path!r}")
    lam_mont, ok = frops.lagrange_coeffs_at_zero(xs_mont)
    lam_plain = frops.fr_to_plain(lam_mont)
    if path == "bitscan":
        return curve.msm(shares_jac, lam_plain, nbits=255, window=1), ok
    aff = jacobian_to_affine(curve, shares_jac)
    if path == "pallas":
        out = ccv.msm_pallas_shared(curve, aff, lam_plain, nbits=255,
                                    window=3)
    else:
        out = ccv.msm_pallas(curve, aff, lam_plain, nbits=255, window=1)
    return out, ok


def derive_shares(coeffs_mont, xs_mont):
    """Keygen: f(x_i) for the whole share batch, one batched Horner
    (``src/lib.rs:670-673``). coeffs_mont: int32[D+1, 16], xs_mont:
    int32[N, 16], both Montgomery Fr limbs; returns int32[N, 16]."""
    return frops.poly_eval(coeffs_mont, xs_mont)


# ---------------------------------------------------------------------------
# Commitments and the DKG (``src/poly.rs:372-377, 589-632, 693-744``)
# ---------------------------------------------------------------------------

@trace.traced("ops.commit_batch")
def commit_batch(coeffs_plain):
    """Feldman commitment G1·c_k of every coefficient: coeffs_plain
    int32[D+1, 16] canonical Fr limbs -> a G1 Jacobian tuple [D+1]
    (``G1.scalar_mul`` of the generator: one B2, 14 B10, one B13)."""
    gen = dcv.G1.generator((coeffs_plain.shape[0],), coeffs_plain.device)
    return dcv.G1.scalar_mul(gen, coeffs_plain)


@trace.traced("fr.powers")
def powers_batch(xs_mont, degree: int):
    """[x⁰ .. x^degree] per lane: int32[M, 16] -> [M, degree+1, 16]
    Montgomery limbs, by ``degree`` products (B1) one after another."""
    pw = [mont.one(FR, xs_mont.shape[:1], xs_mont.device)]
    for _ in range(degree):
        pw.append(mont.mul(FR, pw[-1], xs_mont))
    return torch.stack(pw, 1)


def bivar_commit_batch(coeffs_plain):
    """A dealer's ``BivarPoly.commitment``: one batched fixed-base G1
    scalar-mul over the triangular coefficients (int32[npos, 16] canonical
    limbs in ``coeff_pos`` order) -> G1 Jacobian tuple [npos]."""
    return commit_batch(coeffs_plain)


def _pos_grid(degree: int, device):
    """int64[d+1, d+1]: coeff_pos(i, j)."""
    return torch.tensor([[coeff_pos(i, j) for j in range(degree + 1)]
                         for i in range(degree + 1)], device=device)


@trace.traced("ops.bivar_row_batch")
def bivar_row_batch(coeffs_mont, xs_mont, degree: int):
    """The dealer's rows for a batch of nodes: out[m, i] =
    Σ_j c[pos(i, j)]·x_m^j (``src/poly.rs:607-623``). coeffs_mont:
    int32[npos, 16], xs_mont: int32[M, 16], both Montgomery limbs; returns
    int32[M, d+1, 16] Montgomery limbs. The M(d+1)² products are one B1
    over the gathered coefficient × power grid, the sum over j a tree of
    additions (``ops.fr.sum_leading``)."""
    xpow = powers_batch(xs_mont, degree)                        # [M, d+1]
    grid = coeffs_mont[_pos_grid(degree, coeffs_mont.device)]   # [d+1, d+1]
    terms = mont.mul(FR, grid[None], xpow[:, None])        # [M, i, j]
    return frops.sum_leading(terms.movedim(2, 0))


@trace.traced("ops.bivar_commit_row_batch")
def bivar_commit_row_batch(commit_jac, xs_mont, degree: int):
    """The row commitments from a ``BivarCommitment`` for a batch of
    nodes: out[m, i] = Σ_j C[pos(i, j)]·x_m^j (``src/poly.rs:693-726``),
    which every node holds its dealt row against.

    commit_jac: G1 Jacobian tuple [npos]; xs_mont: int32[M, 16]. The
    commitment is lifted to affine once (one B2), the M(d+1)² products
    run as per-lane ladders over it (``scalar_mul_gathered``: one table of
    14 B10 over the npos points, B13 per chunk of lanes), then one fold
    over j (⌈log₂(d+1)⌉ levels). Returns a G1 Jacobian tuple [M, d+1].
    """
    m, d1 = xs_mont.shape[0], degree + 1
    xpow = frops.fr_to_plain(powers_batch(xs_mont, degree))     # [M, d+1]
    index = _pos_grid(degree, xs_mont.device)[None].expand(m, d1, d1)
    scal = xpow[:, None].expand(m, d1, d1, FR.L)
    prods = ccv.scalar_mul_gathered(dcv.G1,
                                    jacobian_to_affine(dcv.G1, commit_jac),
                                    index.reshape(-1),
                                    scal.reshape(-1, FR.L))
    prods = tree_map(lambda a: a.reshape(m, d1, d1, FQ.L), prods)
    return dcv.G1.fold_axis(prods, 2)


@trace.traced("ops.bivar_commit_eval_batch")
def bivar_commit_eval_batch(commit_jac, xs_mont, ys_mont, degree: int):
    """``BivarCommitment.evaluate(x_m, y_m)`` for a batch of pairs:
    Σ_{i ≤ j} C[pos(i, j)]·(x^i·y^j + x^j·y^i) (the second term for i ≠ j;
    ``src/poly.rs:589-604`` in the exponent), the per-value DKG check
    C(m, s) == f(m, s)·G1. The M·npos scalars are one stacked B1 and one
    addition, their canonical form one B1; the products run as per-lane
    ladders over the commitment (``scalar_mul_gathered``), then one fold
    over the npos positions. Returns a G1 Jacobian tuple [M]."""
    m = xs_mont.shape[0]
    ij = [(i, j) for j in range(degree + 1) for i in range(j + 1)]  # by pos
    dev = xs_mont.device
    ii = torch.tensor([i for i, _ in ij], device=dev)
    jj = torch.tensor([j for _, j in ij], device=dev)
    xpow = powers_batch(xs_mont, degree)
    ypow = powers_batch(ys_mont, degree)
    both = mont.mul(FR, torch.stack([xpow[:, ii], xpow[:, jj]]),
                    torch.stack([ypow[:, jj], ypow[:, ii]]))    # [2, M, npos]
    scal = mont.select((ii != jj)[None], mont.add(FR, both[0], both[1]),
                       both[0])
    npos = len(ij)
    prods = ccv.scalar_mul_gathered(
        dcv.G1, jacobian_to_affine(dcv.G1, commit_jac),
        torch.arange(npos, device=dev).repeat(m),
        frops.fr_to_plain(scal).reshape(-1, FR.L))
    prods = tree_map(lambda a: a.reshape(m, npos, FQ.L), prods)
    return dcv.G1.fold_axis(prods, 1)


# ---------------------------------------------------------------------------
# RLC batch verification: N shares on one message
# ---------------------------------------------------------------------------

def _rlc_aggregate_pairs(pk_aff, h_jac, sig_aff, r_plain):
    """(Σ rᵢ·pkᵢ, −G1) × (H, Σ rᵢ·sigᵢ) as [2]-pair affine tuples of one
    lane; both sums by ``msm_scalarwise`` (64-bit bit ladders, the fold)."""
    def one(p):
        return tree_map(lambda a: a[None], p)

    agg_pk = dcv.G1.msm_scalarwise(affine_to_jacobian(dcv.G1, pk_aff),
                                   r_plain, nbits=64)
    agg_sig = dcv.G2.msm_scalarwise(affine_to_jacobian(dcv.G2, sig_aff),
                                    r_plain, nbits=64)
    pk_a = jacobian_to_affine(dcv.G1, one(agg_pk))
    sig_a = jacobian_to_affine(dcv.G2, one(agg_sig))
    h_a = jacobian_to_affine(
        dcv.G2, tree_map(lambda a: a if a.dim() == 2 else a[None], h_jac))
    return (_pair2(pk_a, _neg_gen_g1((1,), r_plain.device)),
            _pair2(h_a, sig_a))


def verify_sig_shares_rlc(pk_aff, h_jac, sig_aff, r_plain):
    """The RLC check e(Σ rᵢ·pkᵢ, H) == e(G1, Σ rᵢ·sigᵢ) of
    ``verify_sig_shares_rlc_pallas`` in the JAX package's other form: both
    64-bit MSMs as per-lane bit ladders and a fold
    (``DeviceCurve.msm_scalarwise``), then one 2-pair check, through
    ``pairing_check_pallas`` on the card and ``pairing_check`` on the CPU
    (the JAX form picks by its Pallas switch). Same arguments; returns a
    bool scalar tensor."""
    p, q = _rlc_aggregate_pairs(pk_aff, h_jac, sig_aff, r_plain)
    check = (dpr.pairing_check_pallas if mont.on_card(r_plain)
             else dpr.pairing_check)
    return check(p, q)[0]

def rlc_aggregate_pallas(pk_aff, sig_aff, r_plain, nbits: int = 64,
                         msm: str = "shared"):
    """(Σ rᵢ·pkᵢ, Σ rᵢ·sigᵢ) as affine tuples batched [1]: the two MSMs and
    ``jacobian_to_affine``. msm="shared": ``msm_pallas_shared`` (B10, B11,
    the fold); msm="ladder": the per-lane ladder ``msm_pallas`` at window 4
    (B10 tables, B13, the fold)."""
    def one(p):
        return tree_map(lambda a: a[None], p)

    if msm == "shared":
        apk = ccv.msm_pallas_shared(dcv.G1, pk_aff, r_plain, nbits=nbits)
        asg = ccv.msm_pallas_shared(dcv.G2, sig_aff, r_plain, nbits=nbits)
    elif msm == "ladder":
        apk = ccv.msm_pallas(dcv.G1, pk_aff, r_plain, nbits=nbits, window=4)
        asg = ccv.msm_pallas(dcv.G2, sig_aff, r_plain, nbits=nbits, window=4)
    else:
        raise ValueError(f"msm must be 'shared' or 'ladder', got {msm!r}")
    return (jacobian_to_affine(dcv.G1, one(apk)),
            jacobian_to_affine(dcv.G2, one(asg)))


@trace.traced("ops.verify_sig_shares_rlc_pallas")
def verify_sig_shares_rlc_pallas(pk_aff, h_jac, sig_aff, r_plain,
                                 check_batch: int = 512,
                                 msm: str = "shared"):
    """Probabilistic batch verification of N signature shares on ONE
    message: e(Σ rᵢ·pkᵢ, H) == e(G1, Σ rᵢ·sigᵢ) with 64-bit exponents rᵢ.

    pk_aff: G1 affine tuple [N]; h_jac: the shared hash point as a G2
    Jacobian tuple (leaves [24] or [1, 24]); sig_aff: G2 affine tuple [N];
    r_plain: int32[N, 16] canonical Fr limbs, low 64 bits set (from
    ``rlc_exponents``). Both MSMs run as ``cuda_curve.msm_pallas_shared``
    (msm="shared", the default) or as the ladder ``cuda_curve.msm_pallas``
    at window 4 (msm="ladder"); the one aggregate check runs through
    ``verify_batch_pallas`` on ``check_batch`` replicated lanes, the per-pair
    path's own shape. Returns a bool scalar tensor: True iff the check
    passes.
    """
    pk_a, sg_a = rlc_aggregate_pallas(pk_aff, sig_aff, r_plain, msm=msm)
    h1 = tree_map(lambda a: a if a.dim() == 2 else a[None], h_jac)
    h_a = jacobian_to_affine(dcv.G2, h1)

    def bc(tree):
        return tree_map(
            lambda a: a.expand((check_batch,) + a.shape[1:]), tree)

    return verify_batch_pallas(bc(pk_a), bc(h_a), bc(sg_a))[0]


@trace.traced("rlc.exponents")
def rlc_exponents(n: int, seed: bytes, *trees, pk_aff=None, sig_aff=None,
                  h_jac=None, on_device: bool = True, device=None):
    """Deterministic 64-bit batch-verification exponents, bound to the
    verification transcript: ChaCha20 keyed by SHA3-256(seed ‖ n ‖
    transcript digests), where the transcript absorbs, in this order, every
    leaf of the positional ``trees``, then of ``pk_aff``, ``sig_aff`` and
    ``h_jac`` (those given; ``device.keccak.transcript_digests``), in the
    leaf order of the JAX package's ``jax.tree_util.tree_leaves``.

    Returns int32[n, 16] canonical Fr limbs with the low 64 bits set and
    never zero (a zero draw becomes 1), on ``device``: by default the device
    of the first tensor absorbed, else the card. ``on_device=True`` expands
    the ChaCha stream there (``device.chacha``); ``on_device=False`` on the
    host (``host.chacha``); both give the same limbs.
    """
    absorb = [t for t in (*trees, pk_aff, sig_aff, h_jac) if t is not None]
    leaf_list = leaves(absorb)
    if device is None:
        device = next((x.device for x in leaf_list
                       if isinstance(x, torch.Tensor)), "cuda")
    device = mont.device_of(device)
    with trace.span("rlc.transcript"):
        digests = dkeccak.transcript_digests(leaf_list) if absorb else []
        material = (bytes(seed) + n.to_bytes(8, "little")
                    + len(digests).to_bytes(8, "little") + b"".join(digests))
        digest = hashlib.sha3_256(material).digest()

    with trace.span("rlc.chacha"):
        if on_device:
            key = torch.from_numpy(
                np.frombuffer(digest, dtype="<u4").astype(np.int64)).to(device)
            return dchacha.rlc_exponent_limbs(key, n)
        w = hchacha.chacha20_words(digest, 2 * n).astype(np.uint64)
        v = w[0::2] | (w[1::2] << np.uint64(32))
        v = np.where(v == 0, np.uint64(1), v)
        out = np.zeros((n, 16), np.int32)
        for limb in range(4):
            out[:, limb] = (v >> np.uint64(16 * limb)) & np.uint64(0xFFFF)
        return torch.from_numpy(out).to(device)
