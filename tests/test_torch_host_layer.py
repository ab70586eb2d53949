"""The port's host layer against the JAX package's, value for value on the
same inputs: the ZCash-format codecs of ``host/curve.py`` with their
``DecodeError`` probes (flags, infinity, length, x ≥ p, off the curve, off
the subgroup), ``in_subgroup`` and ``msm``; the host pairing
(``host/pairing.py``) and its bilinearity; the samplers of
``host/sampling.py``; the RNG classes of ``utils/rng.py``; and the mock
engine."""

import random
import struct

import pytest

from threshold_crypto_tpu.host import curve as jcv
from threshold_crypto_tpu.host import pairing as jpr
from threshold_crypto_tpu.host import sampling as jsmp
from threshold_crypto_tpu.mock import engine as jmock
from threshold_crypto_tpu.utils import rng as jrng
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host import pairing as hpr
from threshold_crypto_tpu_torch.host import sampling as smp
from threshold_crypto_tpu_torch.host import tower as htw
from threshold_crypto_tpu_torch.host.params import P, R
from threshold_crypto_tpu_torch.mock import engine as mock
from threshold_crypto_tpu_torch.utils import rng as prng

SEED = bytes(range(32))
GROUPS = {"G1": (hcv.G1, jcv.G1, "g1"), "G2": (hcv.G2, jcv.G2, "g2")}


def _points(group, n, seed=0x5EED):
    rnd = random.Random(seed)
    return [None, group.generator] + [
        group.mul(group.generator, rnd.randrange(1, R)) for _ in range(n)]


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_codecs_equal_the_jax_codecs(name):
    group, _, g = GROUPS[name]
    for pt in _points(group, 4):
        comp = getattr(hcv, f"{g}_to_compressed")(pt)
        assert comp == getattr(jcv, f"{g}_to_compressed")(pt)
        unc = getattr(hcv, f"{g}_to_uncompressed")(pt)
        assert unc == getattr(jcv, f"{g}_to_uncompressed")(pt)
        assert len(comp) == 48 * (1 + (g == "g2")) and len(unc) == 2 * len(
            comp)
        assert getattr(hcv, f"{g}_from_compressed")(comp) == pt
        assert getattr(jcv, f"{g}_from_compressed")(comp) == pt


def _off_subgroup(group, base):
    """A point on the curve outside the r-order subgroup."""
    x = base
    while True:
        pt = group.get_point_from_x(x, True)
        if pt is not None and not group.in_subgroup(pt):
            return pt
        x = x + 1 if isinstance(x, int) else (x[0] + 1, x[1])


def _not_on_curve(group, base):
    x = base
    while group.get_point_from_x(x, True) is not None:
        x = x + 1 if isinstance(x, int) else (x[0] + 1, x[1])
    return x


def _decode_probes(name):
    """(what, bytes) each decoder must refuse."""
    group, _, g = GROUPS[name]
    size = 48 * (1 + (g == "g2"))
    enc = getattr(hcv, f"{g}_to_compressed")
    gen = enc(group.generator)
    bad_inf = bytearray([0xC0]) + bytearray(size - 1)
    bad_inf[5] = 1
    too_big = bytes([0x9F]) + b"\xff" * (size - 1)
    x_off = _not_on_curve(group, 5 if g == "g1" else (5, 1))
    off_curve = bytearray((x_off if g == "g1" else x_off[1]).to_bytes(
        48, "big") + (b"" if g == "g1" else x_off[0].to_bytes(48, "big")))
    off_curve[0] |= 0x80
    return [
        ("no compression flag", bytes(size)),
        ("the generator without its compression flag",
         bytes([gen[0] & 0x7F]) + gen[1:]),
        ("x = 0", bytes([0x80]) + bytes(size - 1)),
        ("infinity with a payload", bytes(bad_inf)),
        ("infinity with the sort flag", bytes([0xE0]) + bytes(size - 1)),
        ("short", gen[:-1]),
        ("long", gen + b"\x00"),
        ("x >= p", too_big),
        ("x not on the curve", bytes(off_curve)),
        ("not in the subgroup",
         enc(_off_subgroup(group, 3 if g == "g1" else (3, 0)))),
    ]


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_decode_errors_match_the_jax_ones(name):
    _, _, g = GROUPS[name]
    for what, data in _decode_probes(name):
        with pytest.raises(hcv.DecodeError) as got:
            getattr(hcv, f"{g}_from_compressed")(data)
        with pytest.raises(jcv.DecodeError) as want:
            getattr(jcv, f"{g}_from_compressed")(data)
        assert str(got.value) == str(want.value), what
    assert issubclass(hcv.DecodeError, ValueError)


def test_check_flags_and_flag_constants():
    assert (hcv._FLAG_COMPRESSED, hcv._FLAG_INFINITY, hcv._FLAG_SORT) == (
        jcv._FLAG_COMPRESSED, jcv._FLAG_INFINITY, jcv._FLAG_SORT) == (
        0x80, 0x40, 0x20)
    hcv._check_flags(0x80, True)
    hcv._check_flags(0x00, False)
    for first, compressed in ((0x00, True), (0x80, False)):
        with pytest.raises(hcv.DecodeError) as got:
            hcv._check_flags(first, compressed)
        with pytest.raises(jcv.DecodeError) as want:
            jcv._check_flags(first, compressed)
        assert str(got.value) == str(want.value)


def test_y_is_greatest_matches_jax():
    rnd = random.Random(7)
    ys = [0, 1, P - 1, (P - 1) // 2, (P + 1) // 2] + [
        rnd.randrange(P) for _ in range(8)]
    assert [hcv._y_is_greatest_fq(y) for y in ys] == [
        jcv._y_is_greatest_fq(y) for y in ys]
    y2 = [(a, b) for a in ys[:5] for b in ys[5:9]] + [(0, 1), (0, P - 1)]
    assert [hcv._y_is_greatest_fq2(y) for y in y2] == [
        jcv._y_is_greatest_fq2(y) for y in y2]


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_in_subgroup_and_msm_equal_jax(name):
    group, jgroup, _ = GROUPS[name]
    pts = _points(group, 3, seed=11)
    off = _off_subgroup(group, 3 if name == "G1" else (3, 0))
    assert [group.in_subgroup(p) for p in pts + [off]] == [
        jgroup.in_subgroup(p) for p in pts + [off]] == [True] * len(pts) + [
        False]
    rnd = random.Random(12)
    ks = [rnd.randrange(2 * R) for _ in pts[:-1]] + [R]
    got = group.msm(pts, ks)
    assert got == jgroup.msm(pts, ks)
    want = None
    for p, k in zip(pts, ks):
        want = group.add(want, group.mul(p, k % R))
    assert got == want
    assert group.msm([], []) is None


def test_host_pairing_equals_jax_and_is_bilinear():
    p, q = hcv.G1.generator, hcv.G2.generator
    e = hpr.pairing(p, q)
    assert e == jpr.pairing(p, q) and e != htw.FQ12_ONE
    e_23 = hpr.pairing(hcv.G1.mul(p, 2), hcv.G2.mul(q, 3))
    assert e_23 == hpr.pairing(p, hcv.G2.mul(q, 6)) == htw.fq12_pow(e, 6)
    assert hpr.miller_loop(p, q) == jpr.miller_loop(p, q)
    assert hpr.pairing(None, q) == htw.FQ12_ONE
    pairs = [(hcv.G1.mul(p, 5), q), (hcv.G1.neg(p), hcv.G2.mul(q, 5))]
    assert hpr.pairing_check(pairs) and jpr.pairing_check(pairs)
    assert hpr.multi_pairing(pairs) == htw.FQ12_ONE
    pairs[1] = (hcv.G1.neg(p), hcv.G2.mul(q, 4))
    assert not hpr.pairing_check(pairs)
    assert hpr.untwist(q) == jpr.untwist(q)


def test_gt_generator_order():
    e = hpr.pairing(hcv.G1.generator, hcv.G2.generator)
    assert htw.fq12_pow(e, R) == htw.FQ12_ONE


@pytest.mark.parametrize("what", ["fq", "fr", "fq2", "g1", "g2"])
def test_samplers_equal_jax_from_one_seed(what):
    a, b = prng.ChaChaRng(SEED), jrng.ChaChaRng(SEED)
    fn, jfn = getattr(smp, f"{what}_random"), getattr(jsmp, f"{what}_random")
    got = [fn(a) for _ in range(3)]
    assert got == [jfn(b) for _ in range(3)]
    assert a.next_u32() == b.next_u32()  # the same words were consumed
    if what == "fr":
        assert all(0 <= v < R for v in got)
    if what == "g1":
        assert all(hcv.G1.in_subgroup(pt) for pt in got)


def test_chacha_rng_streams_equal_jax():
    a, b = prng.ChaChaRng(SEED), jrng.ChaChaRng(SEED)
    assert [a.next_u32() for _ in range(37)] == [b.next_u32()
                                                 for _ in range(37)]
    assert a.next_u64() == b.next_u64()
    assert a.fill_bytes(23) == b.fill_bytes(23)
    assert a.keystream_bytes(19) == b.keystream_bytes(19)
    assert a.gen_u8() == b.gen_u8()
    assert prng.chacha20_block(a._key, 5) == jrng.chacha20_block(b._key, 5)
    with pytest.raises(ValueError):
        prng.ChaChaRng(b"short")


def test_chacha20_zero_key_block():
    words = prng.chacha20_block((0,) * 8, 0)
    stream = b"".join(struct.pack("<I", w) for w in words)
    assert stream[:32] == bytes.fromhex(
        "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7")
    rng = prng.ChaChaRng(bytes(32))
    assert [rng.next_u32() for _ in range(32)] == words + \
        prng.chacha20_block((0,) * 8, 1)


def test_chacha_next_u64_and_u8_stream():
    a, b = prng.ChaChaRng(bytes(32)), prng.ChaChaRng(bytes(32))
    lo, hi = b.next_u32(), b.next_u32()
    assert a.next_u64() == (hi << 32) | lo
    a, b = prng.ChaChaRng(bytes(32)), prng.ChaChaRng(bytes(32))
    assert a.keystream_bytes(4) == bytes(b.next_u32() & 0xFF
                                         for _ in range(4))


@pytest.mark.parametrize("seed", [bytes(range(1, 17)), bytes(16)])
def test_xorshift_equals_jax(seed):
    a, b = prng.XorShiftRng(seed), jrng.XorShiftRng(seed)
    assert [a.next_u32() for _ in range(20)] == [b.next_u32()
                                                 for _ in range(20)]
    with pytest.raises(ValueError):
        prng.XorShiftRng(bytes(15))


def test_osrng_and_default_rng():
    r = prng.OsRng()
    assert 0 <= r.next_u32() < 1 << 32 and 0 <= r.next_u64() < 1 << 64
    assert len(r.fill_bytes(7)) == 7
    assert isinstance(prng.default_rng(), prng.OsRng)
    assert isinstance(r, prng.RngCore)


def test_host_chacha_reexports_the_rng():
    from threshold_crypto_tpu_torch.host import chacha

    assert chacha.ChaChaRng is prng.ChaChaRng
    assert chacha.chacha20_block is prng.chacha20_block


def test_mock_engine_equals_jax():
    M = mock.MS8
    assert M == jmock.MS8 == (1 << 31) - 1
    assert (mock.PK_SIZE, mock.SIG_SIZE, mock.FR_BYTES) == (4, 4, 4)
    for a, b in [(1, 2), (12345, 67890), (M - 1, M - 1), (0, 5)]:
        for fn in ("fr_add", "fr_sub", "fr_mul"):
            assert getattr(mock, fn)(a, b) == getattr(jmock, fn)(a, b)
        assert mock.pairing(a, b) == jmock.pairing(a, b) == a * b % M
    assert mock.fr_inv(0) is None
    for a in [1, 2, 999999]:
        assert mock.fr_mul(a, mock.fr_inv(a)) == 1
    assert mock.fr_neg(5) == M - 5
    assert mock.point_from_compressed(mock.point_to_compressed(12345)) == \
        12345
    assert mock.fr_deserialize(mock.fr_serialize(M + 3)) == 3
    with pytest.raises(ValueError):
        mock.point_from_compressed(b"\x00" * 5)
    a, b = prng.ChaChaRng(SEED), jrng.ChaChaRng(SEED)
    assert [mock.g_random(a) for _ in range(5)] == [jmock.g_random(b)
                                                    for _ in range(5)]
