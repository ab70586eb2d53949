"""The batch ops of the two threshold flows on the CPU, against the host
oracle: ``derive_shares``, ``sign_batch``, ``decrypt_share_batch``,
``encrypt_begin_batch`` / ``encrypt_finish_batch`` / ``encrypt_batch``,
``verify_dec_share_batch`` and ``ciphertext_verify_batch``.

Inputs are made from seeds on the host; the port runs them through the
kernels' plain versions (the ladders B10/B13, the megakernel pairing
B3-B9). Points are compared as affine points with ``host/curve.py``'s mul,
the checks with the host pairing's verdicts, on valid and tampered lanes
and on lanes at infinity. One slow case holds ``combine_batch`` against
the JAX package's on the same shares (a child process with XLA's fusion
pass off, as the JAX MSM graphs compile for minutes).
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from threshold_crypto_tpu.host import pairing as hpr
from threshold_crypto_tpu_torch import ops
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R
from threshold_crypto_tpu_torch.ops import fr as frops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs(ks):
    raw = b"".join(int(k).to_bytes(32, "little") for k in ks)
    return torch.from_numpy(np.frombuffer(raw, "<u2").astype(
        np.int32).reshape(len(ks), 16))


def _pairing_ok(p1, q1, p2, q2):
    """e(p1, q1) == e(p2, q2) by the host pairing (None = infinity)."""
    return hpr.pairing(p1, q1) == hpr.pairing(p2, q2)


def test_derive_shares_matches_host_horner():
    rnd = random.Random(5)
    coeffs = [rnd.randrange(R) for _ in range(6)]
    xs = list(range(1, 9))
    got = ops.derive_shares(frops.fr_to_device(coeffs, "cpu"),
                            frops.fr_to_device(xs, "cpu"))
    want = []
    for x in xs:
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % R
        want.append(acc)
    assert frops.fr_from_device(got) == want


def test_sign_and_decrypt_share_match_host_mul():
    """sig_i = H·sk_i and d_i = u·sk_i with a shared point broadcast to the
    batch (in Jacobian form with Z ≠ 1), sk = 0, 1, r − 1 and random."""
    rnd = random.Random(6)
    sks = [0, 1, R - 1, rnd.randrange(R)]
    h = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    u = hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R))
    n = len(sks)
    h_jac = dcv.G2.double(dcv.G2.from_host_affine([h] * n, device="cpu"))
    u_jac = dcv.tree_map(
        lambda a: a.expand((n,) + a.shape[1:]),
        dcv.G1.double(dcv.G1.from_host_affine([u], device="cpu")))
    sig = ops.sign_batch(h_jac, _limbs(sks))
    d = ops.decrypt_share_batch(u_jac, _limbs(sks))
    h2, u2 = hcv.G2.double(h), hcv.G1.double(u)
    assert dcv.G2.to_host_affine(sig) == [hcv.G2.mul(h2, k) for k in sks]
    assert dcv.G1.to_host_affine(d) == [hcv.G1.mul(u2, k) for k in sks]


def test_encrypt_halves_and_whole_match_host_mul():
    """u = r·G1, g = r·pk, w = r·H(u, v) from ``encrypt_begin_batch`` and
    ``encrypt_finish_batch``; ``encrypt_batch`` gives the same, and so does
    ``encrypt_batch_pallas`` on the affine inputs."""
    rnd = random.Random(7)
    pk = hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R))
    huv = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
           for _ in range(3)]
    rs = [rnd.randrange(1, R), 1, R - 1]
    pk_jac = dcv.G1.from_host_affine([pk] * 3, device="cpu")
    huv_jac = dcv.G2.from_host_affine(huv, device="cpu")
    r = _limbs(rs)
    u, g = ops.encrypt_begin_batch(pk_jac, r)
    w = ops.encrypt_finish_batch(huv_jac, r)
    assert dcv.G1.to_host_affine(u) == [hcv.G1.mul(hcv.G1.generator, k)
                                        for k in rs]
    assert dcv.G1.to_host_affine(g) == [hcv.G1.mul(pk, k) for k in rs]
    assert dcv.G2.to_host_affine(w) == [hcv.G2.mul(q, k)
                                        for q, k in zip(huv, rs)]
    whole = ops.encrypt_batch(pk_jac, r, huv_jac)
    assert all(torch.equal(a, b) for a, b in zip(
        dcv.leaves(whole), dcv.leaves((u, g, w))))
    aff = ops.encrypt_batch_pallas(
        dpr.g1_affine_from_host([pk] * 3, device="cpu"), r,
        dpr.g2_affine_from_host(huv, device="cpu"))
    assert [c.to_host_affine(p) for c, p in zip((dcv.G1, dcv.G1, dcv.G2),
                                                aff)] == [
        c.to_host_affine(p) for c, p in zip((dcv.G1, dcv.G1, dcv.G2),
                                            (u, g, w))]


@pytest.fixture(scope="module")
def ciphertexts():
    """Three ciphertexts (u, w) under H(u, v) points; lane 1 has another
    lane's w (tampered), lane 2 w at infinity."""
    rnd = random.Random(8)
    sk = rnd.randrange(1, R)
    rs = [rnd.randrange(1, R) for _ in range(3)]
    huv = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
           for _ in range(3)]
    u = [hcv.G1.mul(hcv.G1.generator, k) for k in rs]
    w = [hcv.G2.mul(q, k) for q, k in zip(huv, rs)]
    w[1] = w[0]
    w[2] = None
    return sk, u, w, huv


def test_ciphertext_verify_matches_host_pairing(ciphertexts):
    _, u, w, huv = ciphertexts
    got = ops.ciphertext_verify_batch(
        dpr.g1_affine_from_host(u, device="cpu"),
        dpr.g2_affine_from_host(w, device="cpu"),
        dpr.g2_affine_from_host(huv, device="cpu"))
    want = [_pairing_ok(hcv.G1.generator, wi, ui, hi)
            for ui, wi, hi in zip(u, w, huv)]
    assert got.tolist() == want == [True, False, False]


def test_verify_dec_share_matches_host_pairing(ciphertexts):
    """Shares d_i = u·sk_i of one ciphertext against pk_i = G1·sk_i: lane 0
    valid, lane 1 another lane's share, lane 2 share and pk at infinity
    (sk = 0: valid, both sides 1)."""
    rnd = random.Random(9)
    _, u, w, huv = ciphertexts
    sks = [rnd.randrange(1, R), rnd.randrange(1, R), 0]
    ds = [hcv.G1.mul(u[0], k) for k in sks]
    ds[1] = ds[0]
    pks = [hcv.G1.mul(hcv.G1.generator, k) for k in sks]
    got = ops.verify_dec_share_batch(
        dpr.g1_affine_from_host(ds, device="cpu"),
        dpr.g2_affine_from_host([huv[0]] * 3, device="cpu"),
        dpr.g1_affine_from_host(pks, device="cpu"),
        dpr.g2_affine_from_host([w[0]] * 3, device="cpu"))
    want = [_pairing_ok(d, huv[0], p, w[0]) for d, p in zip(ds, pks)]
    assert got.tolist() == want == [True, False, True]


_JAX_CHILD = r"""
import json, sys
import numpy as np
from threshold_crypto_tpu.device import curve as jcv
from threshold_crypto_tpu.ops import fr as jfr
from threshold_crypto_tpu.ops import threshold as jops
args = json.loads(sys.stdin.read())
g2 = args["g2"]
curve = jcv.G2 if g2 else jcv.G1
def conv(v):
    return tuple(int(c) for c in v) if isinstance(v, list) else int(v)
pts = [None if p is None else (conv(p[0]), conv(p[1])) for p in args["pts"]]
jac = curve.from_host_affine(pts)
xs = jfr.fr_to_device(args["xs"])
if args["path"] == "pallas":
    from threshold_crypto_tpu.device import pallas_tower as ptw
    ptw.DIRECT = True
out, ok = jops.combine_batch(curve, jac, xs, path=args["path"])
import jax
pt = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], out)
host = curve.to_host_affine(pt)[0]
def enc(v):
    return list(v) if isinstance(v, tuple) else v
pt = None if host is None else [enc(host[0]), enc(host[1])]
print(json.dumps({"ok": bool(ok), "pt": pt}))
"""


@pytest.mark.slow
@pytest.mark.parametrize("path", ["scalarwise", "bitscan", "pallas"])
def test_combine_matches_jax_combine(path):
    """``combine_batch`` (G1, 5 shares) against the JAX package's on the
    same shares and x, as host points; the JAX side in a child process
    with XLA's fusion pass off."""
    rnd = random.Random(10)
    coeffs = [rnd.randrange(R) for _ in range(5)]
    pts = [hcv.G1.mul(hcv.G1.generator,
                      sum(c * pow(x, k, R) for k, c in enumerate(coeffs)) % R)
           for x in range(1, 6)]
    xs = list(range(1, 6))
    pt, ok = ops.combine_batch(dcv.G1, dcv.G1.from_host_affine(
        pts, device="cpu"), frops.fr_to_device(xs, "cpu"), path=path)
    mine = dcv.G1.to_host_affine(dcv.tree_map(lambda a: a[None], pt))[0]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=fusion")
    child = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD], cwd=REPO, env=env,
        input=json.dumps({"g2": False, "path": path, "xs": xs,
                          "pts": [list(p) for p in pts]}),
        capture_output=True, text=True, timeout=3000)
    assert child.returncode == 0, child.stderr[-2000:]
    got = json.loads(child.stdout.strip().splitlines()[-1])
    assert bool(ok) and got["ok"]
    assert mine == hcv.G1.mul(hcv.G1.generator, coeffs[0])
    assert tuple(got["pt"]) == mine
