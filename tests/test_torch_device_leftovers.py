"""The device-layer functions the port added last, against the JAX package.

Seeded numpy inputs go through ``threshold_crypto_tpu.device`` (XLA on the
CPU, eagerly) and through the port on the CPU:

* the tower's ``fq2_is_zero``, ``fq6_sqr``, the sparse products
  ``fq6_mul_by_01`` / ``fq6_mul_by_1``, ``fq12_zero``, ``fq12_add``,
  ``fq6_frob``, the Frobenius constants and the host codecs
  ``fq6_from_host``, ``fq12_from_host``, ``fq12_to_host_batch``: equal
  limbs;
* ``keccak.keccak_f1600`` on [25, K] half-lanes, ``mont.zeros_like_el`` and
  ``mont.batch_inv``: equal limbs;
* ``DeviceCurve.msm``, ``msm_naive`` and ``scalar_mul_naive`` at N = 5 (the
  scalars of ``tests/test_device_curve.py``, 0 and R − 2 among them, one
  point at infinity) against the JAX host ``msm`` / ``mul``;
* ``pairing.multi_pairing`` against the JAX host ``multi_pairing``.

The slow tests hold ``DeviceCurve.msm`` and ``multi_pairing`` against the
JAX device functions, in a child process with XLA's fusion pass off.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import threshold_crypto_tpu.device.keccak as jkeccak
import threshold_crypto_tpu.device.mont as jmont
import threshold_crypto_tpu.device.tower as jtw
from threshold_crypto_tpu.host import curve as jhcv
from threshold_crypto_tpu.host import pairing as jhpr
from threshold_crypto_tpu.host.params import R
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import keccak, mont
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.device import tower as tw

B = 3
P = jmont.FQ.p
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_device_curve.py:84-95: base points k·G and their scalars.
MSM_BASE = [2, 3, 5, 7, 11]
MSM_SCALARS = [9, 0, 31, R - 2, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(rng, depth):
    """B host values: depth 0 Fq2, 1 Fq6, 2 Fq12."""
    def one(d):
        if d == 0:
            return tuple(int.from_bytes(rng.bytes(64), "little") % P
                         for _ in range(2))
        return tuple(one(d - 1) for _ in range(3 if d == 1 else 2))

    return [one(depth) for _ in range(B)]


def _jax(vals):
    """Lanes of nested host tuples -> the JAX pytree of uint32[B, 24]."""
    if isinstance(vals[0], int):
        return np.stack([jmont.to_mont(jmont.FQ, v) for v in vals])
    return tuple(_jax([v[i] for v in vals]) for i in range(len(vals[0])))


def _port(tree):
    if isinstance(tree, tuple):
        return tuple(_port(t) for t in tree)
    return torch.from_numpy(np.asarray(tree).astype(np.int32))


def _same(port, ref):
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _same(p, r)
    else:
        got = port.numpy() if isinstance(port, torch.Tensor) else port
        assert np.array_equal(np.asarray(got).astype(np.uint32),
                              np.asarray(ref))


def test_fq2_is_zero_and_zeros_like_el():
    rng = np.random.default_rng(0x1E0)
    vals = _host(rng, 0)
    vals[1] = (0, 0)
    vals[2] = (0, vals[2][1])
    got = tw.fq2_is_zero(_port(_jax(vals)))
    want = jtw.fq2_is_zero(_jax(vals))
    assert got.tolist() == np.asarray(want).tolist() == [False, True, False]
    a = _port(_jax(vals))[0]
    _same(mont.zeros_like_el(a), jmont.zeros_like_el(_jax(vals)[0]))
    assert mont.zeros_like_el(a).dtype == torch.int32


def test_fq6_sqr_and_sparse_products():
    rng = np.random.default_rng(0x1E1)
    a6 = _jax(_host(rng, 1))
    b0, b1 = _jax(_host(rng, 0)), _jax(_host(rng, 0))
    _same(tw.fq6_sqr(_port(a6)), jtw.fq6_sqr(a6))
    _same(tw.fq6_mul_by_01(_port(a6), _port(b0), _port(b1)),
          jtw.fq6_mul_by_01(a6, b0, b1))
    _same(tw.fq6_mul_by_1(_port(a6), _port(b1)), jtw.fq6_mul_by_1(a6, b1))
    # the sparse forms are the full product with b2 = 0 (and b0 = 0)
    zero = tw.fq2_zero((B,), "cpu")
    _same(tw.fq6_mul_by_01(_port(a6), _port(b0), _port(b1)),
          tw.fq6_mul(_port(a6), (_port(b0), _port(b1), zero)))
    _same(tw.fq6_mul_by_1(_port(a6), _port(b1)),
          tw.fq6_mul(_port(a6), (zero, _port(b1), zero)))


def test_fq12_zero_add_and_fq6_frob():
    rng = np.random.default_rng(0x1E2)
    a, b = _jax(_host(rng, 2)), _jax(_host(rng, 2))
    _same(tw.fq12_add(_port(a), _port(b)), jtw.fq12_add(a, b))
    _same(tw.fq12_zero((B,), "cpu"), jtw.fq12_zero((B,)))
    a6 = _jax(_host(rng, 1))
    for power in (1, 2, 3, 7):
        _same(tw.fq6_frob(_port(a6), power), jtw.fq6_frob(a6, power))


def test_frobenius_constants_equal_the_jax_ones():
    for name in ("FROB12_C1", "FROB6_C1", "FROB6_C2", "FROB6_C1_X_12",
                 "FROB6_C2_X_12"):
        got, want = getattr(tw, name), getattr(jtw, name)
        assert len(got) == len(want) == 12
        _same(got, want)


def test_host_codecs():
    """``fq6_from_host`` / ``fq12_from_host`` take one host value a lane
    (the JAX forms broadcast one value to a shape); ``fq12_to_host_batch``
    flattens the leading dims and reads the same host values as the JAX
    function."""
    rng = np.random.default_rng(0x1E3)
    v12, v6 = _host(rng, 2), _host(rng, 1)
    _same(tw.fq12_from_host(v12, "cpu"), _jax(v12))
    _same(tw.fq6_from_host(v6, "cpu"), _jax(v6))
    _same(tw.fq12_from_host([v12[1]] * 4, "cpu"),
          jtw.fq12_from_host(v12[1], (4,)))
    _same(tw.fq6_from_host([v6[0]] * 2, "cpu"),
          jtw.fq6_from_host(v6[0], (2,)))
    two_d = _jax(v12 + v12[::-1])
    two_d = tuple(tuple(tuple(c.reshape(2, B, 24) for c in x) for x in f6)
                  for f6 in two_d)
    got = tw.fq12_to_host_batch(_port(two_d))
    assert got == jtw.fq12_to_host_batch(two_d) == v12 + v12[::-1]


def test_keccak_f1600():
    rng = np.random.default_rng(0x1E4)
    lo, hi = (rng.integers(0, 1 << 32, (25, 6), dtype=np.uint64)
              .astype(np.uint32) for _ in range(2))
    want_lo, want_hi = jkeccak.keccak_f1600(lo, hi)
    got_lo, got_hi = keccak.keccak_f1600(
        torch.from_numpy(lo.view(np.int32)), torch.from_numpy(hi.view(
            np.int32)))
    assert len(got_lo) == len(got_hi) == 25
    _same(got_lo, [np.asarray(x) for x in want_lo])
    _same(got_hi, [np.asarray(x) for x in want_hi])
    # a list of 25 lanes, as the JAX function also takes it; the zero
    # state's permutation is the standard Keccak-f[1600] vector
    z = [torch.zeros(1, dtype=torch.int32)] * 25
    zlo, zhi = keccak.keccak_f1600(z, z)
    lane0 = (int(zhi[0]) & 0xFFFFFFFF) << 32 | (int(zlo[0]) & 0xFFFFFFFF)
    assert lane0 == 0xF1258F7940E1DDE7


@pytest.mark.parametrize("spec", ["FQ", "FR"])
def test_batch_inv(spec):
    rng = np.random.default_rng(0x1E5)
    jspec = getattr(jmont, spec)
    vals = [int.from_bytes(rng.bytes(64), "little") % jspec.p
            for _ in range(5)] + [0]
    arr = np.stack([jmont.to_mont(jspec, v) for v in vals])
    got = mont.batch_inv(getattr(mont, spec), _port(arr))
    _same(got, jmont.batch_inv(jspec, arr))
    assert mont.unstack_mont(getattr(mont, spec), got) == [
        pow(v, -1, jspec.p) if v else 0 for v in vals]


def _points(curve, hcurve, inf_lane=None):
    pts = [hcurve.mul(hcurve.generator, k) for k in MSM_BASE]
    if inf_lane is not None:
        pts[inf_lane] = None
    return pts, curve.from_host_affine(pts, device="cpu")


@pytest.fixture(scope="module", params=["G1", "G2"])
def group(request):
    return (getattr(dcv, request.param), getattr(jhcv, request.param))


def _host_msm(hcurve, pts, scalars):
    live = [(p, k) for p, k in zip(pts, scalars) if p is not None]
    return hcurve.msm([p for p, _ in live], [k for _, k in live])


@pytest.mark.parametrize("name,window", [("G1", 4), ("G1", 3), ("G2", 4),
                                         ("G2", 1)])
def test_device_curve_msm(name, window):
    """The JAX default window 4; window 1, the bitscan combine's; window 3,
    which straddles limb boundaries, with lane 2 at infinity."""
    curve, hcurve = getattr(dcv, name), getattr(jhcv, name)
    inf = 2 if window == 3 else None
    pts, jac = _points(curve, hcurve, inf)
    k = dcv.fr_limbs_from_ints(MSM_SCALARS, device="cpu")
    got = curve.to_host_affine(dcv.tree_map(
        lambda a: a[None], curve.msm(jac, k, window=window)))[0]
    assert got == _host_msm(hcurve, pts, MSM_SCALARS)


@pytest.mark.parametrize("name", [
    "G1", pytest.param("G2", marks=pytest.mark.slow)])
def test_msm_naive_and_scalar_mul_naive(name):
    """The 255-bit bit scans (G2's take ~25 s on the CPU: slow)."""
    curve, hcurve = getattr(dcv, name), getattr(jhcv, name)
    pts, jac = _points(curve, hcurve, inf_lane=4)
    k = dcv.fr_limbs_from_ints(MSM_SCALARS, device="cpu")
    got = curve.to_host_affine(dcv.tree_map(
        lambda a: a[None], curve.msm_naive(jac, k)))[0]
    assert got == _host_msm(hcurve, pts, MSM_SCALARS)
    muls = curve.to_host_affine(curve.scalar_mul_naive(jac, k))
    assert muls == [None if p is None else hcurve.mul(p, s)
                    for p, s in zip(pts, MSM_SCALARS)]


def test_bitscan_combine_runs_device_curve_msm(monkeypatch):
    """``combine_batch(path="bitscan")`` is ``DeviceCurve.msm`` at window
    1 over the λ."""
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.ops import fr as frops

    calls = []
    real = dcv.DeviceCurve.msm

    def spy(self, *a, **kw):
        calls.append(kw)
        return real(self, *a, **kw)

    monkeypatch.setattr(dcv.DeviceCurve, "msm", spy)
    pts, jac = _points(dcv.G1, jhcv.G1)
    xs = frops.fr_to_device([1, 2, 3, 4, 5], "cpu")
    out, ok = ops.combine_batch(dcv.G1, jac, xs, path="bitscan")
    assert bool(ok) and calls == [{"nbits": 255, "window": 1}]
    lam = [1]
    for i, xi in enumerate(range(1, 6)):
        num = den = 1
        for xj in range(1, 6):
            if xj != xi:
                num, den = num * xj % R, den * (xj - xi) % R
        lam.append(num * pow(den, -1, R) % R)
    assert dcv.G1.to_host_affine(dcv.tree_map(lambda a: a[None], out))[0] \
        == jhcv.G1.msm(pts, lam[1:])


def _pairs():
    """2 pairs × 2 lanes: lane 0 e(2G1, 3G2)·e(−6G1, G2) (= 1), lane 1
    random points with an infinite P in its second pair."""
    rnd = random.Random(0x1E6)
    g1, g2 = jhcv.G1, jhcv.G2
    p = [[g1.mul(g1.generator, 2), g1.mul(g1.generator, rnd.randrange(R))],
         [g1.neg(g1.mul(g1.generator, 6)), None]]
    q = [[g2.mul(g2.generator, 3), g2.mul(g2.generator, rnd.randrange(R))],
         [g2.generator, g2.mul(g2.generator, rnd.randrange(R))]]
    return p, q


def _port_pairs(p, q):
    def stack(trees):
        return dcv.tree_map(lambda *a: torch.stack(a), *trees)

    return (stack([dpr.g1_affine_from_host(row, device="cpu") for row in p]),
            stack([dpr.g2_affine_from_host(row, device="cpu") for row in q]))


def test_multi_pairing_equals_the_host_oracle():
    p, q = _pairs()
    got = tw.fq12_to_host_batch(dpr.multi_pairing(*_port_pairs(p, q)))
    want = [jhpr.multi_pairing([(p[0][i], q[0][i]), (p[1][i], q[1][i])])
            for i in range(2)]
    assert got == want
    assert got[0] == jhpr.multi_pairing([])  # the first lane's product is 1


# The JAX device functions, in a child process: their XLA:CPU compiles
# (a window-4 MSM, a pairing) take minutes with XLA's fusion pass on.
_JAX_CHILD = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from threshold_crypto_tpu.device import curve as dcv
from threshold_crypto_tpu.device import pairing as dpr
from threshold_crypto_tpu.device import tower as dtw
from threshold_crypto_tpu.host import curve as hcv
req = json.loads(sys.stdin.read())
if req["what"] == "msm":
    curve, hc = getattr(dcv, req["group"]), getattr(hcv, req["group"])
    pts = [hc.mul(hc.generator, k) for k in req["base"]]
    out = curve.msm(curve.from_host_affine(pts),
                    dcv.fr_limbs_from_ints(req["scalars"]))
    got = curve.to_host_affine(jax.tree_util.tree_map(lambda a: a[None], out))
    print(json.dumps(repr(got[0])))
else:
    p = [[None if v is None else tuple(v) for v in row] for row in req["p"]]
    q = [[None if v is None else tuple(map(tuple, v)) for v in row]
         for row in req["q"]]
    stack = lambda trees: jax.tree_util.tree_map(
        lambda *a: np.stack(a), *trees)
    f = dpr.multi_pairing(stack([dpr.g1_affine_from_host(r) for r in p]),
                          stack([dpr.g2_affine_from_host(r) for r in q]))
    print(json.dumps(repr(dtw.fq12_to_host_batch(f))))
"""


def _jax_child(req, timeout=3600):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=fusion")
    proc = subprocess.run([sys.executable, "-c", _JAX_CHILD],
                          input=json.dumps(req), capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.slow
def test_device_curve_msm_equals_the_jax_device_msm(group):
    curve, hcurve = group
    _, jac = _points(curve, hcurve)
    k = dcv.fr_limbs_from_ints(MSM_SCALARS, device="cpu")
    got = curve.to_host_affine(dcv.tree_map(
        lambda a: a[None], curve.msm(jac, k)))[0]
    want = _jax_child({"what": "msm", "group": curve.name,
                       "base": MSM_BASE, "scalars": MSM_SCALARS})
    assert repr(got) == want


@pytest.mark.slow
def test_multi_pairing_equals_the_jax_device_multi_pairing():
    p, q = _pairs()
    got = tw.fq12_to_host_batch(dpr.multi_pairing(*_port_pairs(p, q)))
    assert repr(got) == _jax_child({"what": "multi_pairing", "p": p,
                                    "q": q})
