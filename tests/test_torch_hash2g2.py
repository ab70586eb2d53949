"""The device hash_g2 chain of the port (``device/hash2g2.py``,
``hashing.hash_g2_batch``) against the JAX package and the host oracles.

Seeded numpy inputs go through both packages: the per-message ChaCha
streams and the candidate walk bit for bit against the JAX
``_chacha_words_multikey`` and ``extract_candidates`` (cheap jitted XLA,
as ``tests/test_hash2g2.py`` runs them), also with a word budget that runs
out mid-attempt and with streams that reject draws; ``fq2_pow_fixed`` and
``_fq2_is_greatest`` against ``host/tower``; the whole chain on 8 messages
against the JAX ``hashing.hash_g2`` (its native chain), on the lanes that
are ``ok`` before the splice and on every lane after it, and with
``attempts=1``, whose ``ok`` mask must be the host walk's. On the CPU the
kernels' plain versions run (B2, and B10/B13 for the cofactor ladder). The
JAX ``hash_g2_device`` itself compiles for minutes on XLA:CPU and is not
called here.
"""

import random

import numpy as np
import pytest
import torch

from threshold_crypto_tpu import hashing as jhashing
from threshold_crypto_tpu.device import hash2g2 as jh2
from threshold_crypto_tpu_torch import convert, hashing
from threshold_crypto_tpu_torch.device import cuda_curve as ccv
from threshold_crypto_tpu_torch.device import cuda_mont
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import hash2g2
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.device import tower as tw
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host import tower as htw
from threshold_crypto_tpu_torch.host.chacha import ChaChaRng
from threshold_crypto_tpu_torch.host.params import P, R
from threshold_crypto_tpu_torch.host.sampling import fq2_random

MSGS = [b"hash-msg-%d" % i for i in range(8)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n_words", [40, 37, 512])
def test_chacha_words_multikey_matches_jax(n_words):
    keys = _keys(5, n_words)
    want = np.asarray(jh2._chacha_words_multikey(keys, n_words))
    got = hash2g2._chacha_words_multikey(
        convert.words_from_jax(keys, device="cpu"), n_words)
    assert np.array_equal(convert.words_to_jax(got), want)
    # each lane is the host ChaChaRng stream of its key
    rng = ChaChaRng(keys[2].tobytes())
    assert [rng.next_u32() for _ in range(n_words)] == \
        convert.words_to_jax(got)[2].tolist()


def _walk_words(case):
    """uint32[N, S] word streams: 'chacha' (the chain's own streams of 6
    messages); 'rejects' (uniform words, lanes 0-1 with every top word
    0xFFFFFFFF so every draw is rejected, lane 2 with every other draw's
    top word so, lane 3 all zero words)."""
    if case == "chacha":
        digests = np.stack([np.frombuffer(hashing.sha3_256(b"walk-%d" % i),
                                          dtype="<u4") for i in range(6)])
        return np.asarray(jh2._chacha_words_multikey(digests, 512))
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, (6, 400), dtype=np.uint64).astype(
        np.uint32)
    words[0:2, 11::12] = 0xFFFFFFFF
    words[2, 11::24] = 0xFFFFFFFF
    words[3] = 0
    return words


@pytest.mark.parametrize("case,n_words,attempts", [
    ("chacha", 512, 8), ("chacha", 60, 4), ("chacha", 100, 8),
    ("chacha", 38, 2), ("rejects", 400, 8), ("rejects", 150, 3)])
def test_extract_candidates_matches_jax(case, n_words, attempts):
    """xc0, xc1, greatest and nvalid bit for bit, also where the budget runs
    out mid-attempt (a lane then keeps the c0 it accepted)."""
    words = _walk_words(case)[:, :n_words]
    want = [np.asarray(v) for v in jh2.extract_candidates(words, attempts)]
    got = hash2g2.extract_candidates(
        convert.words_from_jax(words, device="cpu"), attempts)
    assert np.array_equal(convert.words_to_jax(got[0]), want[0])
    assert np.array_equal(convert.words_to_jax(got[1]), want[1])
    assert np.array_equal(got[2].numpy(), want[2])
    assert got[3].dtype == torch.int32
    assert np.array_equal(got[3].numpy(), want[3])
    if n_words < 100:
        assert (got[3].numpy() < attempts).any()


def test_words_to_limbs_is_the_montgomery_form():
    rnd = random.Random(4)
    vals = [rnd.randrange(P) for _ in range(5)]
    w = torch.tensor([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
                      for v in vals], dtype=torch.int64)
    limbs = hash2g2._words_to_limbs(w)
    assert limbs.dtype == torch.int32
    assert mont.unstack_mont(mont.FQ, limbs) == [
        v * pow(mont.FQ.r_mont, -1, P) % P for v in vals]


def _fq2_values(n, seed):
    rnd = random.Random(seed)
    vals = [(rnd.randrange(P), rnd.randrange(P)) for _ in range(n)]
    vals[0] = (0, 0)
    vals[1] = (5, 0)             # c1 = 0: the order falls to c0
    vals[2] = (P - 5, 0)
    vals[3] = (0, 7)
    return vals


@pytest.mark.parametrize("e", [0, 1, 6, 0xB3, (P - 3) // 4])
def test_fq2_pow_fixed_matches_host(e):
    vals = _fq2_values(6, e & 0xFFFF)
    got = tw.fq2_to_host(hash2g2.fq2_pow_fixed(tw.fq2_from_host(vals, "cpu"),
                                               e))
    assert got == [htw.fq2_pow(v, e) for v in vals]


def test_fq2_is_greatest_matches_host_order():
    vals = _fq2_values(12, 9)
    got = hash2g2._fq2_is_greatest(tw.fq2_from_host(vals, "cpu"))
    want = [htw.fq2_cmp(v, htw.fq2_neg(v)) > 0 for v in vals]
    assert got.tolist() == want
    assert want[1] != want[2]    # decided by c0 alone


def _jax_points(msgs):
    return [jhashing.hash_g2(m).v for m in msgs]


@pytest.fixture(scope="module")
def device_runs():
    """hash_g2_device on MSGS at attempts 8 and 1; no kernel launches."""
    digests = hashing.digest_words(MSGS, "cpu")
    before = [k.count.launches for k in (*cuda_mont.KERNELS, *ccv.KERNELS)]
    runs = {a: hash2g2.hash_g2_device(digests, attempts=a) for a in (8, 1)}
    assert before == [k.count.launches
                      for k in (*cuda_mont.KERNELS, *ccv.KERNELS)]
    return runs


def test_hash_g2_device_ok_lanes_match_jax(device_runs):
    jac, ok = device_runs[8]
    assert ok.dtype == torch.bool and ok.all()
    assert dcv.G2.to_host_affine(jac) == _jax_points(MSGS)


def _first_attempt_ok(msg):
    """The host walk: does the first candidate of G2::random land?"""
    rng = ChaChaRng(hashing.sha3_256(msg))
    x = fq2_random(rng)
    return hcv.G2.get_point_from_x(x, rng.next_u32() % 2 != 0) is not None


def test_hash_g2_device_one_attempt_mask_is_the_host_walk(device_runs):
    jac, ok = device_runs[1]
    want = [_first_attempt_ok(m) for m in MSGS]
    assert ok.tolist() == want and 0 < sum(want) < len(MSGS)
    pts = dcv.G2.to_host_affine(jac)
    jax = _jax_points(MSGS)
    assert [p for p, k in zip(pts, want) if k] == \
        [p for p, k in zip(jax, want) if k]


def test_hash_g2_batch_with_splice_matches_jax_and_host_oracle():
    """attempts=1: about half the lanes come from the host oracle."""
    got = [h.v for h in hashing.hash_g2_batch(MSGS, attempts=1,
                                                device="cpu")]
    assert got == _jax_points(MSGS)
    assert got[:2] == [hashing.hash_g2(m).v for m in MSGS[:2]]
    for p in got:
        assert hcv.G2.is_on_curve(p) and hcv.G2.mul(p, R) is None


def test_words_converters_round_trip():
    words = _keys(3, 1)
    t = convert.words_from_jax(words, device="cpu")
    assert t.dtype == torch.int64 and np.array_equal(
        convert.words_to_jax(t), words)
    with pytest.raises(ValueError):
        convert.words_from_jax(words.astype(np.int64), device="cpu")
