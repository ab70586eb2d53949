"""The slice as a whole: ``ops.rlc_exponents`` then
``ops.verify_sig_shares_rlc_pallas``, the RLC batch verification of N
signature shares on one message, on the CPU.

24 shares over 4 keys on one hash point H, two lanes with both pk and sig
at infinity, exponents derived from the transcript of the points (bit-exact
with the JAX ``rlc_exponents`` on the same bytes), and a small
``check_batch`` (the plain check at 512 lanes is slow on a CPU). The batch
is accepted; a batch with one signature replaced, or one public key
replaced, is rejected; the aggregate affine points equal the host oracle's
Σ rᵢ·pkᵢ and Σ rᵢ·sigᵢ. No kernel is launched on the CPU. The ladder form
(``msm="ladder"``: the per-lane window-4 ladder in place of the
shared-window MSM) gives the same verdicts and the same aggregates.
"""

import random

import numpy as np
import pytest
import torch

from threshold_crypto_tpu.ops import threshold as jops
from threshold_crypto_tpu_torch import convert, ops
from threshold_crypto_tpu_torch.device import cuda_curve as ccv
from threshold_crypto_tpu_torch.device import cuda_mont
from threshold_crypto_tpu_torch.device import cuda_tower as ctw
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import keccak as dk
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R
from threshold_crypto_tpu_torch.ops import threshold as tops

N, KEYS, DEAD = 24, 4, (5, 17)
CHECK_BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    """Host points (pk, sig per lane, H) and the secret keys."""
    rnd = random.Random(0x71C)
    sks = [rnd.randrange(1, R) for _ in range(KEYS)]
    h = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    pk = [hcv.G1.mul(hcv.G1.generator, sks[i % KEYS]) for i in range(N)]
    sig = [hcv.G2.mul(h, sks[i % KEYS]) for i in range(N)]
    for lane in DEAD:
        pk[lane] = sig[lane] = None
    return pk, sig, h, sks


def _run(pk, sig, h, seed=b"rlc-seed", unbatched_h=False, msm="shared"):
    pk_aff = dpr.g1_affine_from_host(pk, device="cpu")
    sig_aff = dpr.g2_affine_from_host(sig, device="cpu")
    h_jac = dcv.G2.from_host_affine([h], device="cpu")
    if unbatched_h:
        h_jac = dcv.tree_map(lambda a: a[0], h_jac)
    r = ops.rlc_exponents(N, seed, pk_aff=pk_aff, sig_aff=sig_aff)
    ok = ops.verify_sig_shares_rlc_pallas(pk_aff, h_jac, sig_aff, r,
                                          check_batch=CHECK_BATCH, msm=msm)
    return ok, r, pk_aff, sig_aff


def _launches():
    return [k.count.launches for mod in (cuda_mont, ctw, ccv, dk)
            for k in mod.KERNELS]


def test_valid_batch_is_accepted_and_aggregates_match_host(batch):
    pk, sig, h, _ = batch
    before = _launches()
    ok, r, pk_aff, sig_aff = _run(pk, sig, h)
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    assert _launches() == before          # CPU tensors: plain versions only
    # the exponents are the JAX package's for the same points
    want = jops.rlc_exponents(N, b"rlc-seed", pk_aff=convert.to_jax(pk_aff),
                              sig_aff=convert.to_jax(sig_aff))
    assert np.array_equal(convert.fr_to_jax(r), np.asarray(want))
    # the aggregate points are the host oracle's
    ks = [sum(int(v) << (16 * i) for i, v in enumerate(row[:4]))
          for row in r.tolist()]
    apk = asg = None
    for p, s, k in zip(pk, sig, ks):
        if p is not None:
            apk = hcv.G1.add(apk, hcv.G1.mul(p, k))
            asg = hcv.G2.add(asg, hcv.G2.mul(s, k))
    pk_a, sg_a = tops.rlc_aggregate_pallas(pk_aff, sig_aff, r)
    got = (dcv.G1.to_host_affine(ops.affine_to_jacobian(dcv.G1, pk_a)),
           dcv.G2.to_host_affine(ops.affine_to_jacobian(dcv.G2, sg_a)))
    assert got == ([apk], [asg])


def test_batch_with_one_signature_replaced_is_rejected(batch):
    pk, sig, h, sks = batch
    bad = list(sig)
    bad[7] = hcv.G2.mul(h, sks[7 % KEYS] + 1)
    ok, *_ = _run(pk, bad, h, unbatched_h=True)
    assert not bool(ok)


def test_batch_with_one_public_key_replaced_is_rejected(batch):
    pk, sig, h, sks = batch
    bad = list(pk)
    bad[10] = hcv.G1.mul(hcv.G1.generator, sks[10 % KEYS] + 1)
    ok, *_ = _run(bad, sig, h)
    assert not bool(ok)


def test_ladder_form_gives_the_shared_forms_verdicts(batch):
    """msm="ladder" on the valid batch and on one with a signature
    replaced: the verdicts of msm="shared" (accepted in
    ``test_valid_batch_is_accepted_and_aggregates_match_host``), and the
    same aggregates."""
    pk, sig, h, sks = batch
    bad = list(sig)
    bad[3] = hcv.G2.mul(h, sks[3 % KEYS] + 1)
    ok, r, pk_aff, sig_aff = _run(pk, sig, h, msm="ladder")
    assert bool(ok)
    assert [bool(_run(pk, bad, h, msm=m)[0]) for m in ("shared", "ladder")] \
        == [False, False]
    for a, b in zip(dcv.leaves(tops.rlc_aggregate_pallas(pk_aff, sig_aff, r,
                                                         msm="ladder")),
                    dcv.leaves(tops.rlc_aggregate_pallas(pk_aff, sig_aff,
                                                         r))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tops.rlc_aggregate_pallas(pk_aff, sig_aff, r, msm="scalarwise")
