"""The RLC transcript and exponents against the JAX package, ``hashlib`` and
the host ChaCha stream.

* B12's plain version ``device.keccak.sha3_256_chunks`` against
  ``hashlib.sha3_256`` and the JAX ``keccak.sha3_256_chunks``;
* ``transcript_digests`` of the port's tensors against numpy copies of the
  same bytes and against the JAX ``transcript_digests``, below and above the
  level-2 threshold (64 main-stream chunks), tails and bool leaves
  included;
* ``device.chacha.chacha20_words`` against the JAX one, the port's host
  ``ChaChaRng`` and its bulk numpy stream;
* ``ops.rlc_exponents`` bit-exact with the JAX ``rlc_exponents`` for the same
  seed and points, with ``on_device`` True and False, and the zero → 1 rule
  on a stream forced to draw zeros.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threshold_crypto_tpu.device import chacha as jch
from threshold_crypto_tpu.device import keccak as jk
from threshold_crypto_tpu.ops import threshold as jops
from threshold_crypto_tpu.utils.rng import ChaChaRng as JChaChaRng
from threshold_crypto_tpu_torch import ops
from threshold_crypto_tpu_torch.device import chacha as dch
from threshold_crypto_tpu_torch.device import cuda_mont
from threshold_crypto_tpu_torch.device import keccak as dk
from threshold_crypto_tpu_torch.host import chacha as hch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    """uint32 / bool numpy -> the port's int32 / bool tensor."""
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.copy())


def test_sha3_chunks_plain_matches_hashlib_and_jax():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, (6, 544), dtype=np.uint64).astype(
        np.uint32)
    words[0] = 0
    words[1] = 0xFFFFFFFF
    got = dk.sha3_256_chunks(_t(words))
    assert got.dtype == torch.int32 and got.shape == (6, 8)
    for i in range(6):
        assert got[i].numpy().tobytes() == \
            hashlib.sha3_256(words[i].tobytes()).digest()
    want = np.asarray(jk.sha3_256_chunks(jnp.asarray(words)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(dk.hash_chunks(_t(words)), got)
    assert dk.SHA3.launches == 0     # a CPU tensor never reaches B12


@pytest.mark.parametrize("rows,level", [(700, 1), (2800, 2)])
def test_transcript_digests_match_numpy_and_jax(rows, level):
    """Two limb leaves of 700 rows: 30 full chunks and a 1920-byte tail
    each, 60 main digests (level 1); of 2800 rows: 123 chunks each, 246
    compressed to ⌈246/68⌉ = 4 level-2 digests. The host stream: the two
    tails, the bool leaf per 2176 bytes, the small leaf."""
    rng = np.random.default_rng(rows)
    a = rng.integers(0, 1 << 16, (rows, 24), dtype=np.uint64).astype(
        np.uint32)
    b = a[::-1].copy()
    inf = rng.integers(0, 2, rows).astype(bool)
    small = a[:3]                    # below one chunk: host stream
    leaves = [a, b, inf, small]
    got = dk.transcript_digests([_t(x) for x in leaves])
    assert got == dk.transcript_digests(leaves)
    assert got == jk.transcript_digests([jnp.asarray(x) for x in leaves])
    assert got == jk.transcript_digests(leaves)
    k = 2 * (rows * 96 // 2176)
    main = k if level == 1 else -(-k // 68)
    host = 2 + -(-rows // 2176) + 1
    assert len(got) == 1 + main + host
    header = hashlib.sha3_256(
        b"TC-TRANSCRIPT-v2" + k.to_bytes(8, "little")
        + host.to_bytes(8, "little") + bytes([level])).digest()
    assert got[0] == header


def test_chacha_words_match_jax_and_host_rng():
    seed = bytes(range(32))
    key = np.frombuffer(seed, dtype="<u4")
    n = 70
    got = dch.chacha20_words(torch.from_numpy(key.astype(np.int64)), n)
    assert got.tolist() == np.asarray(
        jch.chacha20_words(jnp.asarray(key), n)).tolist()
    rng, jrng = hch.ChaChaRng(seed), JChaChaRng(seed)
    want = [rng.next_u32() for _ in range(n)]
    assert got.tolist() == want == [jrng.next_u32() for _ in range(n)]
    assert hch.chacha20_words(seed, n).tolist() == want
    assert hch.chacha20_block([int(k) for k in key], 1) == want[16:32]
    rng = hch.ChaChaRng(seed)
    assert rng.next_u64() == want[0] | (want[1] << 32)


@pytest.mark.parametrize("n", [5, 64, 333])
def test_rlc_exponents_match_jax_without_points(n):
    want = np.asarray(jops.rlc_exponents(n, b"dev-vs-host", on_device=True))
    for on_device in (True, False):
        got = ops.rlc_exponents(n, b"dev-vs-host", on_device=on_device,
                                device="cpu")
        assert got.dtype == torch.int32 and got.shape == (n, 16)
        assert np.array_equal(got.numpy().view(np.uint32), want)
    assert not want[:, 4:].any() and want[:, :4].any(axis=1).all()


def test_rlc_exponents_bound_to_the_points_match_jax():
    """pk (x, y, inf) and sig ((x0, x1), (y0, y1), inf) leaves in JAX tree
    order; tensors and numpy copies give the same exponents."""
    rng = np.random.default_rng(11)
    n = 90                                        # 90·96 B: 3 chunks a leaf

    def limbs():
        return rng.integers(0, 1 << 16, (n, 24), dtype=np.uint64).astype(
            np.uint32)

    inf = np.zeros(n, bool)
    inf[3] = True
    pk = (limbs(), limbs(), inf)
    sig = ((limbs(), limbs()), (limbs(), limbs()), ~inf)
    want = np.asarray(jops.rlc_exponents(n, b"bind", pk_aff=pk, sig_aff=sig))

    def tens(tree):
        return tuple(tens(t) for t in tree) if isinstance(tree, tuple) \
            else _t(tree)

    for on_device in (True, False):
        got = ops.rlc_exponents(n, b"bind", pk_aff=tens(pk),
                                sig_aff=tens(sig), on_device=on_device)
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy().view(np.uint32), want)
    host = ops.rlc_exponents(n, b"bind", pk_aff=pk, sig_aff=sig,
                             device="cpu")
    assert np.array_equal(host.numpy().view(np.uint32), want)
    # any change to a point changes the exponents
    sig[0][1][7, 0] ^= 1
    moved = ops.rlc_exponents(n, b"bind", pk_aff=tens(pk), sig_aff=tens(sig))
    assert not torch.equal(moved, host)


def test_rlc_exponents_zero_draw_becomes_one(monkeypatch):
    """Draws 0 and 2 of a stream forced to zeros (low and high word) become
    1 on both paths; a draw with only its low word zero stays as it is."""
    real_dev, real_host = dch.chacha20_words, hch.chacha20_words

    def forced(words):
        words[0:2] = 0
        words[4:6] = 0
        words[6] = 0                  # draw 3: low word 0, high word not
        return words

    monkeypatch.setattr(dch, "chacha20_words",
                        lambda key, n: forced(real_dev(key, n).clone()))
    monkeypatch.setattr(hch, "chacha20_words",
                        lambda seed, n: forced(real_host(seed, n).copy()))
    outs = [ops.rlc_exponents(8, b"zero", on_device=d, device="cpu")
            for d in (True, False)]
    assert torch.equal(outs[0], outs[1])
    r = outs[0]
    assert r[0, :4].tolist() == [1, 0, 0, 0] == r[2, :4].tolist()
    assert r[3, 0] == 0 and r[3, 2:4].any()
    assert r[:, :4].any(1).all()


def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.rlc_exponents(4, b"s")
    assert cuda_mont.MUL.launches == 0
