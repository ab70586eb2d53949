"""``ops.verify_sig_shares_rlc``, the RLC check with its two 64-bit MSMs as
per-lane bit ladders (``DeviceCurve.msm_scalarwise``), on the CPU.

8 shares over 4 keys on one hash point H, one lane with pk and sig at
infinity, exponents from ``ops.rlc_exponents``. The aggregate pairs
(Σ rᵢ·pkᵢ, −G1) × (H, Σ rᵢ·sigᵢ) equal the JAX package's
``_rlc_aggregate_pairs`` on the same inputs, as affine limbs, exactly; the
batch is accepted, and rejected with one signature or one public key
replaced, with no kernel launched. A slow case holds the verdicts against
the JAX ``verify_sig_shares_rlc`` (a child process with XLA's fusion pass
off: its pairing graph compiles for minutes).
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from threshold_crypto_tpu.device import curve as jcv
from threshold_crypto_tpu.ops import threshold as jops
from threshold_crypto_tpu_torch import convert, ops
from threshold_crypto_tpu_torch.device import cuda_curve as ccv
from threshold_crypto_tpu_torch.device import cuda_mont
from threshold_crypto_tpu_torch.device import cuda_tower as ctw
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R
from threshold_crypto_tpu_torch.ops import threshold as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, KEYS, DEAD = 8, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    """Host points per lane: pk, sig, and the hash point H; the
    exponents of the valid batch."""
    rnd = random.Random(0x5CA1)
    sks = [rnd.randrange(1, R) for _ in range(KEYS)]
    h = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    pk = [hcv.G1.mul(hcv.G1.generator, sks[i % KEYS]) for i in range(N)]
    sig = [hcv.G2.mul(h, sks[i % KEYS]) for i in range(N)]
    pk[DEAD] = sig[DEAD] = None
    r = ops.rlc_exponents(N, b"scalarwise",
                          pk_aff=dpr.g1_affine_from_host(pk, device="cpu"),
                          sig_aff=dpr.g2_affine_from_host(sig, device="cpu"))
    return pk, sig, h, r


def _args(pk, sig, h):
    return (dpr.g1_affine_from_host(pk, device="cpu"),
            dcv.G2.from_host_affine([h], device="cpu"),
            dpr.g2_affine_from_host(sig, device="cpu"))


def _tampered(batch, kind):
    pk, sig, h, r = batch
    pk, sig = list(pk), list(sig)
    if kind == "sig":
        sig[2] = sig[3]
    elif kind == "pk":
        pk[1] = pk[0]
    return pk, sig, h, r


def test_aggregate_pairs_match_jax(batch):
    pk, sig, h, r = batch
    pk_aff, h_jac, sig_aff = _args(pk, sig, h)
    p, q = tops._rlc_aggregate_pairs(pk_aff, h_jac, sig_aff, r)
    jp, jq = jops._rlc_aggregate_pairs(
        convert.to_jax(pk_aff), jcv.G2.from_host_affine([h]),
        convert.to_jax(sig_aff), convert.fr_to_jax(r))
    for mine, theirs in ((p, jp), (q, jq)):
        got = dcv.leaves(convert.to_jax(mine))
        want = [np.asarray(a) for a in dcv.leaves(theirs)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    ks = [sum(int(v) << (16 * i) for i, v in enumerate(row[:4]))
          for row in r.tolist()]
    apk = None
    for point, k in zip(pk, ks):
        apk = hcv.G1.add(apk, None if point is None else hcv.G1.mul(point, k))
    assert dpr.g1_affine_from_host([apk], device="cpu")[0].equal(p[0][0])


@pytest.mark.parametrize("kind,want", [("valid", True), ("sig", False),
                                       ("pk", False)])
def test_verdict(batch, kind, want):
    pk, sig, h, r = _tampered(batch, kind)
    kernels = [k for mod in (cuda_mont, ctw, ccv) for k in mod.KERNELS]
    before = [k.count.launches for k in kernels]
    ok = ops.verify_sig_shares_rlc(*_args(pk, sig, h), r)
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok) is want
    assert [k.count.launches for k in kernels] == before  # plain versions


_JAX_CHILD = r"""
import json, sys
import numpy as np
from threshold_crypto_tpu.device import curve as jcv
from threshold_crypto_tpu.device import pairing as jpr
from threshold_crypto_tpu.ops import threshold as jops
args = json.loads(sys.stdin.read())
def g2(p):
    return None if p is None else tuple(tuple(c) for c in p)
def g1(p):
    return None if p is None else tuple(p)
r = np.asarray(args["r"], np.uint32)
out = []
for pk, sig in args["batches"]:
    ok = jops.verify_sig_shares_rlc(
        jpr.g1_affine_from_host([g1(p) for p in pk]),
        jcv.G2.from_host_affine([g2(args["h"])]),
        jpr.g2_affine_from_host([g2(s) for s in sig]), r)
    out.append(bool(ok))
print(json.dumps(out))
"""


@pytest.mark.slow
def test_verdicts_match_jax(batch):
    """The port's verdicts on the valid and both tampered batches against
    the JAX ``verify_sig_shares_rlc``, run in a child process."""
    kinds = ["valid", "sig", "pk"]
    mine, batches = [], []
    for kind in kinds:
        pk, sig, h, r = _tampered(batch, kind)
        mine.append(bool(ops.verify_sig_shares_rlc(*_args(pk, sig, h), r)))
        batches.append([[None if p is None else list(p) for p in pk],
                        [None if s is None else [list(c) for c in s]
                         for s in sig]])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=fusion")
    child = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD], cwd=REPO, env=env,
        input=json.dumps({"batches": batches, "r": r.tolist(),
                          "h": [list(c) for c in h]}),
        capture_output=True, text=True, timeout=3000)
    assert child.returncode == 0, child.stderr[-2000:]
    assert json.loads(child.stdout.strip().splitlines()[-1]) == mine == [
        True, False, False]
