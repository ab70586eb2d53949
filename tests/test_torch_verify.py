"""The port's per-pair BLS verify against the JAX package.

``threshold_crypto_tpu_torch.ops.verify_batch`` runs on the CPU (the kernels'
plain versions) over lanes of every kind: valid, corrupted signature, wrong
message, infinite pk, infinite sig. The JAX package's host oracle
(``threshold_crypto_tpu.host.pairing``) decides each lane; the slow test
also runs ``threshold_crypto_tpu.ops.verify_batch`` itself. Points reach
the port through its own host builders and through ``convert``.
"""

import random

import numpy as np
import pytest
import torch

from threshold_crypto_tpu.device import pairing as jpr
from threshold_crypto_tpu.host import curve as hcv
from threshold_crypto_tpu.host import pairing as hpr
from threshold_crypto_tpu.host.params import R
from threshold_crypto_tpu_torch import convert, ops
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.device import tower as tw


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lanes():
    """(pk, H, sig) host points per lane, and each lane's kind."""
    rnd = random.Random(0xFA57)
    sks = [rnd.randrange(1, R) for _ in range(3)]
    hs = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R)) for _ in range(2)]
    pk = [hcv.G1.mul(hcv.G1.generator, s) for s in sks]
    sig = [hcv.G2.mul(hs[0], s) for s in sks]
    rows = [
        (pk[0], hs[0], sig[0], "valid"),
        (pk[1], hs[0], sig[1], "valid"),
        (pk[2], hs[0], hcv.G2.mul(hs[0], 999), "corrupted sig"),
        (pk[2], hs[1], sig[2], "wrong message"),
        (None, hs[0], sig[0], "inf pk"),
        (pk[1], hs[0], None, "inf sig"),
    ]
    return rows


def _oracle(rows):
    neg_g1 = hcv.G1.neg(hcv.G1.generator)
    return [hpr.pairing_check([(pk, h), (neg_g1, sig)]) for pk, h, sig, _ in rows]


def test_verify_batch_matches_host_oracle(lanes):
    pk, h, sig, kinds = zip(*lanes)
    got = ops.verify_batch(
        dpr.g1_affine_from_host(pk, device="cpu"),
        dpr.g2_affine_from_host(h, device="cpu"),
        dpr.g2_affine_from_host(sig, device="cpu"),
    )
    assert got.dtype == torch.bool and got.shape == (len(lanes),)
    assert got.tolist() == _oracle(lanes)
    assert got.tolist() == [k == "valid" for k in kinds]


def test_pairing_equals_host_pairing():
    """The GT element itself, not only the check: Miller loop and final
    exponentiation give the host oracle's value exactly."""
    rnd = random.Random(7)
    p = hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R))
    q = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    got = dpr.pairing(dpr.g1_affine_from_host([p], device="cpu"),
                      dpr.g2_affine_from_host([q], device="cpu"))
    assert tw.fq12_to_host(got) == [hpr.pairing(p, q)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_convert_round_trip(group):
    """JAX affine pytrees -> port tensors -> numpy, bit-exact, and equal to
    the port's own host builders."""
    rnd = random.Random(11)
    if group == "g1":
        pts = [hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R)), None]
        jax_aff = jpr.g1_affine_from_host(pts)
        ported = convert.g1_from_jax(*map(np.asarray, jax_aff), device="cpu")
        built = dpr.g1_affine_from_host(pts, device="cpu")
    else:
        pts = [None, hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))]
        jax_aff = jpr.g2_affine_from_host(pts)
        x, y, inf = jax_aff
        ported = convert.g2_from_jax(
            tuple(np.asarray(c) for c in x), tuple(np.asarray(c) for c in y),
            np.asarray(inf), device="cpu")
        built = dpr.g2_affine_from_host(pts, device="cpu")

    def flat(tree):
        if isinstance(tree, tuple):
            return [leaf for t in tree for leaf in flat(t)]
        return [np.asarray(tree)]

    back = convert.to_jax(ported)
    for got, want in zip(flat(back), flat(jax_aff)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for got, want in zip(flat(convert.to_jax(built)), flat(jax_aff)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_convert_rejects_bad_limbs():
    x = np.zeros((2, 24), np.uint32)
    x[0, 0] = 1 << 16
    with pytest.raises(ValueError, match="16-bit"):
        convert.g1_from_jax(x, x, np.zeros(2, bool), device="cpu")
    with pytest.raises(ValueError, match="uint32"):
        convert.g1_from_jax(x.astype(np.int64), x, np.zeros(2, bool),
                            device="cpu")


# The JAX package's fused verify compiles for minutes on XLA:CPU.
@pytest.mark.slow
def test_verify_batch_matches_jax_ops(lanes):
    from threshold_crypto_tpu import ops as jops

    pk, h, sig, _ = zip(*lanes)
    want = jops.verify_batch(jpr.g1_affine_from_host(pk),
                             jpr.g2_affine_from_host(h),
                             jpr.g2_affine_from_host(sig))
    x, y, inf = jpr.g1_affine_from_host(pk)
    pk_t = convert.g1_from_jax(np.asarray(x), np.asarray(y), np.asarray(inf),
                               device="cpu")

    def g2(aff):
        x, y, inf = aff
        return convert.g2_from_jax(tuple(map(np.asarray, x)),
                                   tuple(map(np.asarray, y)),
                                   np.asarray(inf), device="cpu")

    got = ops.verify_batch(pk_t, g2(jpr.g2_affine_from_host(h)),
                           g2(jpr.g2_affine_from_host(sig)))
    assert got.tolist() == np.asarray(want).tolist()
