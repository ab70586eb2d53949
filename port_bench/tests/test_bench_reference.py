"""The reference held to known values: the generators' standard
encodings, bilinearity, ChaCha20's RFC 8439 block, SHA3-256's, and the
transcript and exponents against an independent computation."""

import hashlib

import numpy as np
import pytest

from port_bench.reference import chacha, curve, limbs, pairing, transcript
from port_bench.reference.params import P, R

G1_GEN_COMPRESSED = (
    "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb")
G2_GEN_COMPRESSED = (
    "93e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
    "334cf11213945d57e5ac7d055d042b7e024aa2b2f08f0a91260805272dc51051"
    "c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8")
# RFC 8439 section 2.3.2: key 00..1f, counter 1, nonce 000000090000004a00000000.
RFC8439_BLOCK = (
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")


def test_generators_encode_to_the_standard_bytes():
    assert curve.g1_to_compressed(curve.G1.generator).hex() == \
        G1_GEN_COMPRESSED
    assert curve.g2_to_compressed(curve.G2.generator).hex() == \
        G2_GEN_COMPRESSED
    assert curve.G1.mul(curve.G1.generator, R) is None
    assert curve.G2.mul(curve.G2.generator, R) is None


def test_pairing_is_bilinear():
    g1, g2 = curve.G1.generator, curve.G2.generator
    e = pairing.pairing
    want = e(g1, curve.G2.mul(g2, 6))
    assert e(curve.G1.mul(g1, 2), curve.G2.mul(g2, 3)) == want
    assert e(curve.G1.mul(g1, 3), curve.G2.mul(g2, 2)) == want
    assert e(g1, g2) != want


def test_chacha20_block_is_rfc8439s():
    key = bytes(range(32))
    block = chacha.blocks(key, [[1, 0x09000000, 0x4A000000, 0]])
    assert block.astype("<u4").tobytes().hex() == RFC8439_BLOCK


def test_chacha20_stream_is_the_64_bit_counter_stream():
    cryptography = pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    key = hashlib.sha3_256(b"stream").digest()
    enc = Cipher(algorithms.ChaCha20(key, bytes(16)), mode=None).encryptor()
    want = np.frombuffer(enc.update(bytes(64 * 5)), "<u4")
    assert cryptography.__version__
    np.testing.assert_array_equal(chacha.stream_words(key, 77), want[:77])


def test_sha3_is_the_standard_one():
    assert transcript._sha3(b"abc").hex() == (
        "3a985da74fe225b2045c172d6bd390bd855f086e3e9d525b46bfe24511431532")


def test_limbs_read_back_montgomery_values():
    vals = [0, 1, P - 1, 12345678901234567890]
    arr = limbs.fq_mont_limbs(vals)
    assert limbs.fq(arr) == vals
    assert limbs.ints(limbs.to_limbs([R - 1], 16)) == [R - 1]


@pytest.mark.parametrize("n", [5, 1500])
def test_transcript_and_exponents_match_the_programs(n):
    """The program's own transcript and exponents, on the CPU, from the
    same leaves: an independent computation of the same definition."""
    import torch

    from threshold_crypto_tpu_torch.device import keccak
    from threshold_crypto_tpu_torch.ops import threshold as tops

    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 16, (n, 24), dtype=np.int32)
    y = rng.integers(0, 1 << 16, (n, 24), dtype=np.int32)
    inf = rng.integers(0, 2, n).astype(bool)
    aff = tuple(torch.from_numpy(a) for a in (x, y, inf))
    want = keccak.transcript_digests(list(aff))
    assert transcript.digests([x, y, inf]) == want
    r = tops.rlc_exponents(n, b"seed", pk_aff=aff, device="cpu",
                           on_device=False).numpy()
    got = transcript.exponents(n, b"seed", want)
    v = r[:, :4].astype(np.uint64)
    assert np.array_equal(
        v[:, 0] | v[:, 1] << np.uint64(16) | v[:, 2] << np.uint64(32)
        | v[:, 3] << np.uint64(48), got)
