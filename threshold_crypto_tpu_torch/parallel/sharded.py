"""The batched protocol ops with the share batch split over a mesh.

The counterparts of ``threshold_crypto_tpu/parallel/sharded.py``, with its
signatures. Each rank passes its own block of the batch (``shard_batch``)
and the replicated values whole (``replicate``):

* ``sharded_sign`` / ``sharded_verify``: data parallel, no collective; each
  rank gets its block of the result (``gather_batch`` reads it whole).
* ``sharded_combine``: λ of the whole batch from the replicated x (on the
  card B14 above 1024 shares), one partial 255-bit MSM per rank over its λ
  block (``DeviceCurve.msm_scalarwise``: B15 bit ladders and the fold),
  then the world's partial points gathered and folded
  (``DeviceCurve.fold_axis``, complete adds): the same point on every rank.
* ``sharded_rlc_aggregate``: the two 64-bit MSMs of the RLC check as
  per-rank partials (B15 ladders, or B10 + B11 through
  ``msm_pallas_shared``), gathered and folded the same way, then made
  affine; ``sharded_verify_rlc`` adds the one replicated 2-pair check.

The exponents of the RLC check must come from the whole batch
(``ops.rlc_exponents`` over the global pk and sig, before
``shard_batch``): exponents drawn from one rank's lanes differ from the
single-device call's, and a check over them binds only that rank's shares.
The partials fold in another order than the single-device tree, so the
Jacobian coordinates differ; the affine values are the same.
"""

from __future__ import annotations

from ..device import cuda_curve as ccv
from ..device import curve as dcv
from ..ops import fr as frops
from ..ops import threshold as tops
from .mesh import SHARE_AXIS, gather_batch, shard_block


def sharded_sign(mesh, h_jac, sk_plain, axis: str = SHARE_AXIS):
    """sig_i = H_i·sk_i over this rank's block (``ops.sign_batch``)."""
    return tops.sign_batch(h_jac, sk_plain)


def sharded_verify(mesh, pk_aff, h_aff, sig_aff, axis: str = SHARE_AXIS):
    """The per-share 2-pair checks over this rank's block
    (``ops.verify_batch``)."""
    return tops.verify_batch(pk_aff, h_aff, sig_aff)


def fold_partials(mesh, curve, partial):
    """Σ of one unbatched Jacobian point per rank: the points gathered in
    rank order, then one fold of complete adds (an infinite partial, equal
    partials and opposite ones included). The same point on every rank."""
    pts = gather_batch(mesh, dcv.tree_map(lambda a: a[None], partial))
    return curve.fold_axis(pts, 0)


def sharded_combine(mesh, curve, shares_jac, xs_mont,
                    axis: str = SHARE_AXIS):
    """Σ λ_i·share_i across the whole mesh; the result on every rank.

    shares_jac: this rank's block of the Jacobian shares; xs_mont: all N x
    (replicated, int32[N, 16] Montgomery Fr limbs): every rank needs them
    all for its λ. Returns (unbatched Jacobian point, ok bool[]) as
    ``ops.combine_batch``: ok is False on a duplicate or a zero x."""
    n = xs_mont.shape[0]
    if n % mesh.world:
        raise ValueError(
            f"combine batch ({n}) must divide the mesh ({mesh.world} "
            "devices); pad shares with λ=0 lanes to align")
    lam_mont, ok = frops.lagrange_coeffs_at_zero(xs_mont)
    lam = frops.fr_to_plain(lam_mont[shard_block(mesh, n)])
    partial = curve.msm_scalarwise(shares_jac, lam, window=1)
    return fold_partials(mesh, curve, partial), ok


def sharded_rlc_aggregate(mesh, pk_aff, sig_aff, r_plain,
                          axis: str = SHARE_AXIS, msm: str = "scalarwise"):
    """(Σ rᵢ·pkᵢ, Σ rᵢ·sigᵢ) over the whole mesh as affine tuples batched
    [1], on every rank. pk_aff, sig_aff, r_plain: this rank's blocks (r of
    the whole batch, ``ops.rlc_exponents`` before ``shard_batch``).

    msm="scalarwise": per-lane 64-bit bit ladders and the fold
    (``DeviceCurve.msm_scalarwise``: B15); msm="shared": the shared-window
    MSM ``cuda_curve.msm_pallas_shared`` (B10 table, B11, the fold). Then
    the partials of every rank are gathered and folded, and made affine
    (``jacobian_to_affine``)."""
    if msm == "scalarwise":
        part_pk = dcv.G1.msm_scalarwise(
            tops.affine_to_jacobian(dcv.G1, pk_aff), r_plain, nbits=64)
        part_sig = dcv.G2.msm_scalarwise(
            tops.affine_to_jacobian(dcv.G2, sig_aff), r_plain, nbits=64)
    elif msm == "shared":
        part_pk = ccv.msm_pallas_shared(dcv.G1, pk_aff, r_plain, nbits=64)
        part_sig = ccv.msm_pallas_shared(dcv.G2, sig_aff, r_plain, nbits=64)
    else:
        raise ValueError(f"msm must be 'scalarwise' or 'shared', got {msm!r}")

    def affine(curve, partial):
        pt = fold_partials(mesh, curve, partial)
        return tops.jacobian_to_affine(curve, dcv.tree_map(
            lambda a: a[None], pt))

    return affine(dcv.G1, part_pk), affine(dcv.G2, part_sig)


def sharded_verify_rlc(mesh, pk_aff, h_jac, sig_aff, r_plain,
                       axis: str = SHARE_AXIS, check_batch: int = 1,
                       msm: str = "scalarwise"):
    """RLC batch verification of N shares on one message with the batch
    split over the mesh: ``sharded_rlc_aggregate``, then ONE replicated
    2-pair check e(Σ rᵢ·pkᵢ, H) == e(G1, Σ rᵢ·sigᵢ) through
    ``ops.verify_batch`` (the JAX function's ``verify_batch_stepwise``) on
    ``check_batch`` copies of the pair. h_jac: the shared hash point as a
    G2 Jacobian tuple (leaves [L] or [1, L]), replicated. Returns a bool
    scalar tensor, the same on every rank."""
    pk_a, sg_a = sharded_rlc_aggregate(mesh, pk_aff, sig_aff, r_plain,
                                       axis=axis, msm=msm)
    h1 = dcv.tree_map(lambda a: a if a.dim() == 2 else a[None], h_jac)
    h_a = tops.jacobian_to_affine(dcv.G2, h1)

    def bc(tree):
        return dcv.tree_map(
            lambda a: a.expand((check_batch,) + a.shape[1:]).contiguous(),
            tree)

    ok = tops.verify_batch(bc(pk_a), bc(h_a), bc(sg_a))
    return ok[0]


