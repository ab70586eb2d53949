"""The DKG batch ops of the port against the JAX package's and against the
host DKG, on the CPU.

One dealer's symmetric bivariate polynomial of degree t = 2 is drawn with
the JAX package's host ``BivarPoly`` from a seeded ChaCha stream, with one
coefficient set to zero (its commitment is the point at infinity), and 5
nodes x = 1..5. The same limbs go through the JAX ops
(``threshold_crypto_tpu.ops.threshold``: ``powers_batch``,
``commit_batch``, ``bivar_commit_batch``, ``bivar_row_batch``,
``bivar_commit_row_batch``, ``bivar_commit_eval_batch``, run once on
XLA:CPU) and through the port's, where the kernels' plain versions run.
Points are compared as affine host points, Fr values as limbs, exactly; the
host ``BivarPoly`` / ``BivarCommitment`` give the protocol's values (the
scenario of ``tests/test_ops.py``'s ``test_device_dkg_scenario``). Also:
``coeff_pos`` against the JAX package's, the overflow edge included, and
the curve methods the ops use (``fold_axis``, ``eq``, ``neg``,
``scalar_mul``, ``msm_scalarwise``) against host arithmetic.
"""

import random

import numpy as np
import pytest
import torch

from threshold_crypto_tpu import poly as jpoly
from threshold_crypto_tpu.device import curve as jcv
from threshold_crypto_tpu.ops import fr as jfr
from threshold_crypto_tpu.ops import threshold as jops
from threshold_crypto_tpu.utils.rng import ChaChaRng
from threshold_crypto_tpu_torch import ops
from threshold_crypto_tpu_torch import poly
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R
from threshold_crypto_tpu_torch.ops import fr as frops

DEGREE = 2
XS = [1, 2, 3, 4, 5]
# (x, y) of the value checks: node y checks the value node x sent it; one
# pair with x == y.
PAIRS = [(1, 1), (2, 1), (3, 4), (4, 5), (5, 2)]
ZERO_POS = 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dealer():
    bp = jpoly.BivarPoly.random(DEGREE, ChaChaRng(b"\x09" * 32))
    bp.coeff[ZERO_POS] = 0
    return bp


def _jax_points(curve, jac):
    return curve.to_host_affine(jac)


@pytest.fixture(scope="module")
def jax_run(dealer):
    """The JAX package's DKG ops on the dealer's limbs, as host values."""
    coeffs = dealer.coeff
    xs = jfr.fr_to_device(XS)
    commit = jops.bivar_commit_batch(jcv.fr_limbs_from_ints(coeffs))
    rows = jops.bivar_row_batch(jfr.fr_to_device(coeffs), xs, DEGREE)
    rowc = jops.bivar_commit_row_batch(commit, xs, DEGREE)
    ev = jops.bivar_commit_eval_batch(
        commit, jfr.fr_to_device([p[0] for p in PAIRS]),
        jfr.fr_to_device([p[1] for p in PAIRS]), DEGREE)
    uni = [0, 1, R - 1, coeffs[2]]
    return {
        "commit": _jax_points(jcv.G1, commit),
        "rows": np.asarray(rows),
        "rowc": _jax_points(jcv.G1, rowc),
        "eval": _jax_points(jcv.G1, ev),
        "powers": np.asarray(jops.powers_batch(xs, 4)),
        "uni": uni,
        "uni_commit": _jax_points(
            jcv.G1, jops.commit_batch(jcv.fr_limbs_from_ints(uni))),
    }


@pytest.fixture(scope="module")
def port_run(dealer):
    coeffs = dealer.coeff
    xs = frops.fr_to_device(XS, "cpu")
    commit = ops.bivar_commit_batch(dcv.fr_limbs_from_ints(coeffs, "cpu"))
    rows = ops.bivar_row_batch(frops.fr_to_device(coeffs, "cpu"), xs, DEGREE)
    rowc = ops.bivar_commit_row_batch(commit, xs, DEGREE)
    ev = ops.bivar_commit_eval_batch(
        commit, frops.fr_to_device([p[0] for p in PAIRS], "cpu"),
        frops.fr_to_device([p[1] for p in PAIRS], "cpu"), DEGREE)
    return {"commit": commit, "rows": rows, "rowc": rowc, "eval": ev}


def _host(pts):
    return dcv.G1.to_host_affine(pts)


# ---------------------------------------------------------------------------
# coeff_pos
# ---------------------------------------------------------------------------

def test_coeff_pos_matches_jax_including_overflow():
    big = [(1 << 32) - 2, (1 << 32) - 1, 1 << 32, (1 << 33), (1 << 64) - 2,
           (1 << 64) - 1, 1 << 64]
    pairs = [(i, j) for i in range(6) for j in range(6)]
    pairs += [(i, j) for i in (0, 5, (1 << 32) - 1) for j in big]
    pairs += [(j, i) for i, j in pairs]
    got = [poly.coeff_pos(i, j) for i, j in pairs]
    assert got == [jpoly.coeff_pos(i, j) for i, j in pairs]
    assert poly.coeff_pos(3, 5) == poly.coeff_pos(5, 3) == 18
    assert poly.coeff_pos(0, (1 << 32) - 1) == ((1 << 32) - 1) << 31
    assert poly.coeff_pos(0, 1 << 32) is None           # j·(j + 1) > 2⁶⁴ − 1
    assert poly.coeff_pos(0, (1 << 64) - 1) is None     # j + 1 > 2⁶⁴ − 1
    assert poly.coeff_pos(85, 85) + 1 == 3741


# ---------------------------------------------------------------------------
# The ops against the JAX package and the host DKG
# ---------------------------------------------------------------------------

def test_powers_batch_matches_jax(jax_run):
    got = ops.powers_batch(frops.fr_to_device(XS, "cpu"), 4)
    assert got.shape == (len(XS), 5, 16)
    assert np.array_equal(got.numpy().astype(np.uint32), jax_run["powers"])
    assert frops.fr_from_device(got[2]) == [pow(3, k, R) for k in range(5)]
    assert ops.powers_batch(frops.fr_to_device(XS, "cpu"), 0).shape == (
        len(XS), 1, 16)


def test_commit_batch_matches_jax_and_host(jax_run):
    """Coefficients 0 (infinity), 1, r − 1 and a random one."""
    uni = jax_run["uni"]
    got = _host(ops.commit_batch(dcv.fr_limbs_from_ints(uni, "cpu")))
    assert got == jax_run["uni_commit"]
    assert got == [hcv.G1.mul(hcv.G1.generator, c) for c in uni]
    assert got[0] is None


def test_bivar_commitment_matches_jax_and_host(dealer, jax_run, port_run):
    got = _host(port_run["commit"])
    assert got == jax_run["commit"]
    assert got == [c.v for c in dealer.commitment().coeff]
    assert got[ZERO_POS] is None


def test_bivar_rows_match_jax_and_host(dealer, jax_run, port_run):
    rows = port_run["rows"]
    assert rows.shape == (len(XS), DEGREE + 1, 16)
    assert np.array_equal(rows.numpy().astype(np.uint32), jax_run["rows"])
    for m, x in enumerate(XS):
        assert frops.fr_from_device(rows[m]) == dealer.row(x).coeff


def test_bivar_row_commitments_match_jax_and_host(dealer, jax_run, port_run):
    """Every node's row commitment: the JAX op's, the host
    ``BivarCommitment.row``'s, and ``commit_batch`` of the node's own row
    (the protocol's check ``commit.row(m) == row.commitment()``)."""
    rowc = port_run["rowc"]
    assert rowc[2].shape == (len(XS), DEGREE + 1, 24)
    got = _host(rowc)
    assert got == jax_run["rowc"]
    bc = dealer.commitment()
    assert got == [p.v for x in XS for p in bc.row(x).coeff]
    rows_plain = frops.fr_to_plain(port_run["rows"]).reshape(-1, 16)
    own = dcv.tree_map(lambda a: a.reshape(len(XS), DEGREE + 1, 24),
                       ops.commit_batch(rows_plain))
    assert bool(dcv.G1.eq(rowc, own).all())


def test_bivar_value_checks_match_jax_and_host(dealer, jax_run, port_run):
    """C(x, y) for each pair: the JAX op's, the host
    ``BivarCommitment.evaluate``'s, equal to f(x, y)·G1 on every lane, and
    unequal on the one lane whose value was tampered with."""
    ev = port_run["eval"]
    got = _host(ev)
    assert got == jax_run["eval"]
    bc = dealer.commitment()
    assert got == [bc.evaluate(x, y).v for x, y in PAIRS]
    vals = [dealer.evaluate(x, y) for x, y in PAIRS]
    assert dcv.G1.eq(ev, ops.commit_batch(
        dcv.fr_limbs_from_ints(vals, "cpu"))).tolist() == [True] * len(PAIRS)
    vals[3] = (vals[3] + 1) % R
    assert dcv.G1.eq(ev, ops.commit_batch(
        dcv.fr_limbs_from_ints(vals, "cpu"))).tolist() == [
        True, True, True, False, True]


def test_host_dkg_tail_accepts_the_batched_shares(dealer, port_run):
    """The protocol's tail on the host: node m interpolates its row from
    the t + 1 values it received, as the batched values give them."""
    rows = port_run["rows"]
    for m, x in enumerate(XS):
        received = {i: dealer.evaluate(x, i) for i in range(1, DEGREE + 2)}
        row = jpoly.Poly.interpolate(received)
        assert row.coeff == frops.fr_from_device(rows[m])


# ---------------------------------------------------------------------------
# The curve methods under the ops
# ---------------------------------------------------------------------------

def _host_pts(curve, k, rnd, none_at=()):
    return [None if i in none_at else curve.mul(curve.generator,
                                                rnd.randrange(1, R))
            for i in range(k)]


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_fold_axis_matches_host_sums(group):
    """Σ over the middle axis of a [2, 5, 3] batch (odd length, an
    infinity entry, a point and its negative in one sum)."""
    curve, host = (dcv.G1, hcv.G1) if group == "G1" else (dcv.G2, hcv.G2)
    rnd = random.Random(11)
    pts = _host_pts(host, 30, rnd, none_at=(4,))
    pts[7] = host.neg(pts[1])                # lanes 1 and 7: one column
    jac = curve.from_host_affine(pts, device="cpu")
    jac = dcv.tree_map(lambda a: a.reshape((2, 5, 3) + a.shape[1:]), jac)
    got = curve.to_host_affine(curve.fold_axis(jac, 1))
    grid = np.array(pts, dtype=object).reshape(2, 5, 3)
    want = []
    for a in range(2):
        for c in range(3):
            acc = None
            for b in range(5):
                acc = host.add(acc, grid[a, b, c])
            want.append(acc)
    assert got == want


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_eq_neg_and_generator(group):
    curve, host = (dcv.G1, hcv.G1) if group == "G1" else (dcv.G2, hcv.G2)
    rnd = random.Random(12)
    pts = _host_pts(host, 4, rnd, none_at=(3,))
    a = curve.from_host_affine(pts, device="cpu")
    b = curve.double(curve.from_host_affine(
        [None if p is None else host.mul(p, (R + 1) // 2) for p in pts],
        device="cpu"))                      # the same points, Z ≠ 1
    assert curve.eq(a, b).tolist() == [True] * 4
    assert curve.eq(a, curve.neg(b)).tolist() == [False, False, False, True]
    shifted = dcv.tree_map(lambda x: x.roll(1, 0), b)
    assert curve.eq(a, shifted).tolist() == [False] * 4
    assert curve.to_host_affine(curve.neg(a)) == [
        None if p is None else host.neg(p) for p in pts]
    gen = curve.generator((2, 3), "cpu")
    assert dcv.leaves(gen)[0].shape == (2, 3, 24)
    assert curve.to_host_affine(gen) == [host.generator] * 6


@pytest.mark.parametrize("window", [1, 4])
def test_scalar_mul_and_msm_scalarwise_match_host(window):
    """A [2, 3] batch of G1 points (one at infinity) times scalars 0, 1,
    r − 1 and random ones; and their sum by ``msm_scalarwise``."""
    rnd = random.Random(13 + window)
    pts = _host_pts(hcv.G1, 6, rnd, none_at=(5,))
    ks = [0, 1, R - 1] + [rnd.randrange(R) for _ in range(3)]
    jac = dcv.tree_map(lambda a: a.reshape((2, 3) + a.shape[1:]),
                       dcv.G1.from_host_affine(pts, device="cpu"))
    k = dcv.fr_limbs_from_ints(ks, "cpu").reshape(2, 3, 16)
    got = dcv.G1.scalar_mul(jac, k, window=window)
    assert got[2].shape == (2, 3, 24)
    want = [hcv.G1.mul(p, s) if p is not None else None
            for p, s in zip(pts, ks)]
    assert dcv.G1.to_host_affine(got) == want
    flat = dcv.G1.from_host_affine(pts, device="cpu")
    total = dcv.G1.msm_scalarwise(flat, dcv.fr_limbs_from_ints(ks, "cpu"),
                                  window=window)
    acc = None
    for w in want:
        acc = hcv.G1.add(acc, w)
    assert dcv.G1.to_host_affine(dcv.tree_map(lambda a: a[None], total)) \
        == [acc]


def test_fr_limbs_from_ints_matches_jax():
    ks = [0, 1, R - 1, R, 1 << 200, 12345]
    got = dcv.fr_limbs_from_ints(ks, "cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.uint32),
                          np.asarray(jcv.fr_limbs_from_ints(
                              [k % R for k in ks])))
