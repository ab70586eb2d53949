"""The port's curve groups and coordinate plumbing against the JAX package and
the host groups.

``threshold_crypto_tpu_torch.device.curve`` (``double``/``add`` with their
complete-formula selects, ``scalar_digits``, ``fold_sum``) and
``ops.batch_inv_field`` / ``jacobian_to_affine`` / ``affine_to_jacobian``
run on the CPU. The same seeded points and scalars go through the JAX
package's ``device/curve.py`` and ``ops/threshold.py`` as numpy arrays, and
through the port's host groups (``host/curve.py``); Jacobian coordinates
and affine results must be equal canonical values, bit for bit.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threshold_crypto_tpu.ops import threshold as jops
from threshold_crypto_tpu.device import curve as jcv
from threshold_crypto_tpu_torch import convert, ops
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R

N = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return convert.to_jax(tree)


def _jax(tree):
    if isinstance(tree, tuple):
        return tuple(_jax(t) for t in tree)
    return jnp.asarray(tree)


@pytest.fixture(scope="module", params=["G1", "G2"])
def group(request):
    """(port curve, JAX curve, host group, T, Q): Jacobian [N] with Z ≠ 1
    (T and Q doubled once) and the special lanes 0: T = inf; 1: Q = inf;
    2: T == Q; 3: T == −Q; 4: both inf."""
    g2 = request.param == "G2"
    curve, jcurve, host = ((dcv.G2, jcv.G2, hcv.G2) if g2
                           else (dcv.G1, jcv.G1, hcv.G1))
    rnd = random.Random(0xCAFE + g2)
    ts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    qs = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    ts[0] = qs[1] = ts[4] = qs[4] = None
    qs[2] = ts[2]
    qs[3] = host.neg(ts[3])
    T = curve.double(curve.from_host_affine(ts, device="cpu"))
    Q = curve.double(curve.from_host_affine(qs, device="cpu"))
    return curve, jcurve, host, T, Q


def test_double_and_add_match_host_group(group):
    curve, _, host, T, Q = group
    ts, qs = curve.to_host_affine(T), curve.to_host_affine(Q)
    assert curve.to_host_affine(curve.double(T)) == [host.double(t)
                                                     for t in ts]
    sums = curve.to_host_affine(curve.add(T, Q))
    assert sums == [host.add(t, q) for t, q in zip(ts, qs)]
    assert sums[3] is None and sums[4] is None and sums[0] == qs[0]
    assert sums[2] == host.double(ts[2])


def test_double_and_add_match_jax_curve_bit_exact(group):
    """The JAX ``curve.double``/``curve.add`` compute the same coordinates
    as the port's layered formulas, special lanes included."""
    curve, jcurve, _, T, Q = group
    jT, jQ = _jax(_np(T)), _jax(_np(Q))
    for got, want in ((curve.double(T), jcurve.double(jT)),
                      (curve.add(T, Q), jcurve.add(jT, jQ))):
        for g, w in zip(dcv.leaves(_np(got)), dcv.leaves(want)):
            assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("nbits,window", [(64, 3), (64, 4), (255, 3),
                                          (255, 4), (16, 5)])
def test_scalar_digits_match_jax(nbits, window):
    """MSB-first digits, windows straddling a 16-bit limb (w = 3 at bit 15)
    included; scalars with all bits set reach every straddle."""
    rng = np.random.default_rng(nbits * window)
    ks = [int(rng.integers(0, 1 << 62)) << 193 | int(rng.integers(0, 1 << 62))
          for _ in range(6)] + [(1 << nbits) - 1, 0, 1 << 15, 0x7 << 14]
    ks = [k % (1 << nbits) % R for k in ks]
    limbs = np.stack([mont.limbs_from_int(mont.FR, k) for k in ks])
    got = dcv.scalar_digits(torch.from_numpy(limbs), nbits, window)
    want = np.asarray(jcv.scalar_digits(jnp.asarray(limbs.astype(np.uint32)),
                                        nbits, window))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # the digits rebuild the scalars
    for i, k in enumerate(ks):
        v = 0
        for d in got[:, i].tolist():
            v = (v << window) | d
        assert v == k % (1 << nbits)


@pytest.mark.parametrize("n", [1, 5, 7, 12])
def test_fold_sum_matches_host_sum(group, n):
    """N not a power of two (the odd levels pad with infinity), infinity
    lanes and cancelling lanes among the summands."""
    curve, _, host, T, Q = group
    pts = dcv.tree_map(lambda a, b: torch.cat([a, b])[:n], T, Q)
    want = None
    for p in curve.to_host_affine(pts):
        want = host.add(want, p)
    got = curve.fold_sum(pts)
    assert curve.to_host_affine(dcv.tree_map(lambda a: a[None], got)) == \
        [want]


def test_batch_inv_field_matches_jax():
    """Product tree on the CPU: Fq with zero lanes and a non-power-of-two
    batch, Fq2 with a zero lane, a 2-d batch; zero maps to zero."""
    p = mont.FQ.p
    vals = [7, 0, 12345, p - 3, 999, 0, 1]
    a = mont.stack_mont(mont.FQ, vals)
    got = ops.batch_inv_field(dcv.FqOps, torch.from_numpy(a))
    want = jops.batch_inv_field(jcv.G1.f, jnp.asarray(a.astype(np.uint32)))
    assert np.array_equal(_np(got), np.asarray(want))
    assert mont.unstack_mont(mont.FQ, got) == [pow(v, -1, p) if v else 0
                                               for v in vals]
    pairs = [(3, 8), (p - 1, 5), (0, 0), (0, 11), (4, 0), (9, 9)]
    b = tuple(mont.stack_mont(mont.FQ, [q[i] for q in pairs]).reshape(2, 3, 24)
              for i in range(2))
    got2 = ops.batch_inv_field(dcv.Fq2Ops,
                               tuple(torch.from_numpy(x) for x in b))
    want2 = jops.batch_inv_field(jcv.G2.f,
                                 tuple(jnp.asarray(x.astype(np.uint32))
                                       for x in b))
    for g, w in zip(_np(got2), want2):
        assert g.shape == (2, 3, 24) and np.array_equal(g, np.asarray(w))
    # the card's form, f.inv, gives the same limbs
    assert np.array_equal(_np(dcv.FqOps.inv(torch.from_numpy(a))),
                          np.asarray(want))


def test_jacobian_to_affine_matches_jax(group):
    curve, jcurve, host, T, _ = group
    got = ops.jacobian_to_affine(curve, T)
    want = jops.jacobian_to_affine(jcurve, _jax(_np(T)))
    for g, w in zip(dcv.leaves(_np(got)), dcv.leaves(want)):
        assert np.array_equal(g, np.asarray(w))
    inf = got[2].tolist()
    assert inf == [i in (0, 4) for i in range(N)]
    # infinity lanes have coordinates 0; the rest are the host points
    for c in dcv.leaves(got[:2]):
        assert not c[0].any() and not c[4].any()
    back = ops.affine_to_jacobian(curve, got)
    assert curve.to_host_affine(back) == curve.to_host_affine(T)
    jback = jops.affine_to_jacobian(jcurve, _jax(_np(got)))
    for g, w in zip(dcv.leaves(_np(back)), dcv.leaves(jback)):
        assert np.array_equal(g, np.asarray(w))


def test_convert_jacobian_and_fr_round_trips(group):
    curve, _, _, T, _ = group
    arrs = _np(T)
    back = (convert.g2_jac_from_jax if curve is dcv.G2
            else convert.g1_jac_from_jax)(*arrs, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(dcv.leaves(back),
                                                 dcv.leaves(T)))
    fr = np.arange(3 * 16, dtype=np.uint32).reshape(3, 16)
    t = convert.fr_from_jax(fr, device="cpu")
    assert t.dtype == torch.int32 and np.array_equal(convert.fr_to_jax(t), fr)
    with pytest.raises(ValueError):
        convert.fr_from_jax(fr[:, :15], device="cpu")
