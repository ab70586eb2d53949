"""The port's public API (``import threshold_crypto_tpu_torch as tc``)
against the JAX package's.

The scenarios of ``tests/test_threshold.py``, ``test_poly.py``,
``test_serde.py``, ``test_vectors.py`` and ``test_rng_and_mock.py`` run
on both packages from the same seed, each under the backend named: every
scenario asserts its protocol properties and returns a transcript (bytes,
verdicts, field values), and the port's must equal the JAX package's.
Protocol logic runs on the mock backend; the BLS backend's runs are kept
to a few. Then the golden vectors of ``tests/fixtures/golden.json``
(read, never written), the three ``examples/`` flows run against the
port, the probes of the verify skill, and the port's backend state kept
apart from the JAX package's.
"""

import importlib
import json
import os
import warnings

import pytest

import threshold_crypto_tpu as jtc
import threshold_crypto_tpu_torch as tc
from threshold_crypto_tpu_torch import codec_impl, hashing, serde_impl
from threshold_crypto_tpu_torch.lib import interpolate
from threshold_crypto_tpu_torch.poly import (BivarCommitment, BivarPoly,
                                             Commitment, Poly, coeff_pos)
from threshold_crypto_tpu_torch.utils.rng import ChaChaRng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = bytes(range(32))


class Api:
    """One package's public modules, by the JAX package's module names."""

    def __init__(self, name):
        self.name = name
        self.tc = importlib.import_module(name)
        for mod in ("poly", "lib", "serde_impl", "codec_impl", "hashing"):
            setattr(self, mod, importlib.import_module(f"{name}.{mod}"))
        self.rng = importlib.import_module(f"{name}.utils.rng")


PORT, JAX = Api("threshold_crypto_tpu_torch"), Api("threshold_crypto_tpu")


def both(scenario, backend, seed=SEED):
    """The scenario's transcript on the port and on the JAX package, each
    under ``backend`` and with its own ``ChaChaRng(seed)``: they must be
    equal and not empty. Returns the port's."""
    outs = []
    for api in (PORT, JAX):
        with api.tc.using(backend) as b:
            outs.append(scenario(api, b, api.rng.ChaChaRng(seed)))
    assert outs[0] and outs[0] == outs[1]
    return outs[0]


# ---------------------------------------------------------------------------
# tests/test_threshold.py's scenarios
# ---------------------------------------------------------------------------

def sc_interpolate(api, b, rng):
    out = []
    for deg in range(5):
        comm = api.poly.Poly.random(deg, rng).commitment()
        values, x = [], 0
        for _ in range(deg + 1):
            x += 1 + rng.next_u32() % 4
            values.append((x - 1, comm.evaluate(x)))
        actual = api.lib.interpolate(deg, values)
        assert comm.evaluate(0) == actual
        out.append(actual.to_compressed())
    return out


def sc_simple_sig(api, b, rng):
    sk0, sk1 = api.tc.SecretKey.random(rng), api.tc.SecretKey.random(rng)
    pk0 = sk0.public_key()
    msg0, msg1 = b"Real news", b"Fake news"
    sig = sk0.sign(msg0)
    assert pk0.verify(sig, msg0)
    assert not pk0.verify(sk1.sign(msg0), msg0)  # wrong key
    assert not pk0.verify(sk0.sign(msg1), msg0)  # wrong message
    return [pk0.to_bytes(), sig.to_bytes()]


def sc_threshold_sig(api, b, rng):
    sk_set = api.tc.SecretKeySet.random(3, rng)
    pk_set = sk_set.public_keys()
    pk_master = pk_set.public_key()
    for i in range(3):
        assert pk_master != pk_set.public_key_share(i).pk
        assert sk_set.secret_key() != sk_set.secret_key_share(i).sk
    msg = b"Totally real news"
    sigs = {i: sk_set.secret_key_share(i).sign(msg) for i in [5, 8, 7, 10]}
    for i, sig in sigs.items():
        assert pk_set.public_key_share(i).verify(sig, msg)
    sig = pk_set.combine_signatures(sigs)
    assert pk_set.public_key().verify(sig, msg)
    sigs2 = {i: sk_set.secret_key_share(i).sign(msg)
             for i in [42, 43, 44, 45]}
    assert pk_set.combine_signatures(sigs2) == sig
    return [api.serde_impl.serialize(pk_set), sig.to_bytes()] + [
        s.to_bytes() for s in sigs.values()]


def sc_simple_enc(api, b, rng):
    sk_bob, sk_eve = api.tc.SecretKey.random(rng), api.tc.SecretKey.random(rng)
    pk_bob = sk_bob.public_key()
    msg = b"Muffins in the canteen today! Don't tell Eve!"
    ct = pk_bob.encrypt(msg, rng)
    assert ct.verify()
    assert sk_bob.decrypt(ct) == msg
    assert sk_eve.decrypt(ct) != msg
    fake = api.tc.Ciphertext(ct.u, bytes(len(ct.v)), ct.w)
    assert not fake.verify()
    assert sk_bob.decrypt(fake) is None
    return [api.serde_impl.serialize(ct)]


def sc_extreme_thresholds(api, b, rng):
    sks = api.tc.SecretKeySet.random(0, rng)
    assert sks.threshold() == 0
    with pytest.raises(api.tc.DegreeTooHigh):
        api.tc.SecretKeySet.try_random((1 << 64) - 1, rng)
    return [api.serde_impl.serialize(api.serde_impl.SerdeSecret(sks))]


def sc_threshold_enc(api, b, rng):
    sk_set = api.tc.SecretKeySet.random(3, rng)
    pk_set = sk_set.public_keys()
    msg = b"Totally real news"
    ct = pk_set.public_key().encrypt(msg, rng)
    shares = {}
    for i in [5, 8, 7, 10]:
        share = sk_set.secret_key_share(i).decrypt_share(ct)
        assert share is not None
        shares[i] = share
    for i, share in shares.items():
        assert pk_set.public_key_share(i).verify_decryption_share(share, ct)
    assert pk_set.decrypt(shares, ct) == msg
    few = {i: shares[i] for i in [5, 8, 7]}
    with pytest.raises(api.tc.NotEnoughShares):
        pk_set.decrypt(few, ct)
    return [api.serde_impl.serialize(ct)] + [
        s.to_bytes() for s in shares.values()]


def sc_duplicate_share(api, b, rng):
    with pytest.raises(api.tc.DuplicateEntry):
        api.lib.interpolate(1, [(0, b.G2.one()), (0, b.G2.one())])
    return [str(api.tc.DuplicateEntry())]


def sc_hashes(api, b, rng):
    msg = rng.fill_bytes(1000)
    m0, m1 = msg + b"end0", msg + b"end1"
    h = api.tc.hash_g2
    assert h(msg) == h(msg) and h(msg) != h(m0) and h(m0) != h(m1)
    g0, g1 = b.G1.random(rng), b.G1.random(rng)
    hh = api.tc.hash_g1_g2
    assert hh(g0, msg) == hh(g0, msg) and hh(g0, msg) != hh(g0, m0)
    assert hh(g0, m0) != hh(g0, m1) and hh(g0, msg) != hh(g1, msg)
    xwh = api.tc.xor_with_hash
    assert xwh(g0, bytes(5)) == xwh(g0, bytes(5)) != xwh(g1, bytes(5))
    assert [len(xwh(g0, bytes(n))) for n in (5, 6, 20)] == [5, 6, 20]
    data = rng.fill_bytes(33)
    assert xwh(g0, xwh(g0, data)) == data
    short = bytes(range(64))
    return [h(msg).to_compressed(), hh(g0, msg).to_compressed(),
            hh(g0, short).to_compressed(), hh(g0, short + b"!")
            .to_compressed(), xwh(g0, data), api.tc.sha3_256(data)]


def sc_from_to_bytes(api, b, rng):
    sk = api.tc.SecretKey.random(rng)
    sig = sk.sign(b"Please sign here: ______")
    pk = sk.public_key()
    assert api.tc.PublicKey.from_bytes(pk.to_bytes()) == pk
    assert api.tc.Signature.from_bytes(sig.to_bytes()) == sig
    assert len(b.G1.one().to_compressed()) == b.PK_SIZE
    assert len(b.G2.one().to_compressed()) == b.SIG_SIZE
    return [pk.to_bytes(), sig.to_bytes(), b.G1.one().to_uncompressed(),
            b.G2.one().to_uncompressed()]


def sc_zeroize(api, b, rng):
    zero_sk = api.tc.SecretKey.from_mut([0])
    sk = api.tc.SecretKey.random(rng)
    assert zero_sk != sk and any(sk._buf)
    buf = sk._buf
    sk.zeroize()
    assert zero_sk == sk and bytes(buf) == bytes(32) and sk.fr == 0
    holder = [12345]
    sk2 = api.tc.SecretKey.from_mut(holder)
    assert holder[0] == 0 and sk2.fr == 12345 % b.r
    holder = [777]
    share = api.tc.SecretKeyShare.from_mut(holder)
    assert holder[0] == 0 and share.sk.fr == 777
    return [sk2.fr, share.reveal(), repr(share)]


def sc_rng_seed(api, b, rng):
    sk1 = api.tc.SecretKey.random(api.rng.ChaChaRng(SEED))
    sk2 = api.tc.SecretKey.random(api.rng.ChaChaRng(SEED))
    sk3 = api.tc.SecretKey.random(api.rng.ChaChaRng(bytes(32)))
    assert sk1 == sk2 and sk1 != sk3
    return [sk1.fr, sk3.fr]


def sc_parity(api, b, rng):
    sigs = [api.tc.Signature.random(rng) for _ in range(16)]
    for s in sigs:
        assert s.parity() == api.tc.Signature.from_bytes(
            s.to_bytes()).parity()
    return [s.parity() for s in sigs]


def sc_decrypt_share_no_verify(api, b, rng):
    sk_set = api.tc.SecretKeySet.random(1, rng)
    ct = sk_set.public_keys().public_key().encrypt(b"m", rng)
    a = sk_set.secret_key_share(0).decrypt_share(ct)
    assert a == sk_set.secret_key_share(0).decrypt_share_no_verify(ct)
    return [a.to_bytes()]


def sc_verify_signature_shares(api, b, rng):
    sk_set = api.tc.SecretKeySet.random(2, rng)
    pk_set = sk_set.public_keys()
    msg = b"batch me"
    shares = {i: sk_set.secret_key_share(i).sign(msg) for i in range(5)}
    out = [pk_set.verify_signature_shares(shares, msg, rng)]
    with pytest.raises(ValueError):
        pk_set.verify_signature_shares({}, msg, rng)
    bad = dict(shares)
    bad[3] = sk_set.secret_key_share(4).sign(msg)
    out.append(pk_set.verify_signature_shares(bad, msg, rng))
    out.append(pk_set.verify_signature_shares(shares, b"other", rng))
    assert out == [True, False, False]
    pks = [pk_set.public_key_share(i).pk.el for i in range(5)]
    sigs = [s.sig.el for s in shares.values()]
    exps = api.lib._batch_exponents(pks, sigs, api.tc.hash_g2(msg), rng)
    assert len(exps) == 5 and all(0 < e < 1 << 64 for e in exps)
    return out + exps


PROTOCOL = {
    "interpolate": sc_interpolate, "simple_sig": sc_simple_sig,
    "threshold_sig": sc_threshold_sig, "simple_enc": sc_simple_enc,
    "extreme_thresholds": sc_extreme_thresholds,
    "threshold_enc": sc_threshold_enc,
    "duplicate_share": sc_duplicate_share, "hashes": sc_hashes,
    "from_to_bytes": sc_from_to_bytes, "zeroize": sc_zeroize,
    "rng_seed": sc_rng_seed, "parity": sc_parity,
    "decrypt_share_no_verify": sc_decrypt_share_no_verify,
    "verify_signature_shares": sc_verify_signature_shares,
}
# The BLS backend's runs: one of each kind of object and check.
BLS_PROTOCOL = ("simple_sig", "threshold_sig", "simple_enc", "threshold_enc",
                "hashes", "from_to_bytes", "rng_seed",
                "verify_signature_shares")


@pytest.mark.parametrize("name", sorted(PROTOCOL))
def test_protocol_scenarios_on_mock_equal_jax(name):
    both(PROTOCOL[name], "mock")


@pytest.mark.parametrize("name", BLS_PROTOCOL)
def test_protocol_scenarios_on_bls_equal_jax(name):
    both(PROTOCOL[name], "bls12_381")


# ---------------------------------------------------------------------------
# tests/test_poly.py's scenarios
# ---------------------------------------------------------------------------

def test_coeff_pos():
    i = j = 0
    for n in range(100):
        assert coeff_pos(i, j) == n
        if i >= j:
            j, i = j + 1, 0
        else:
            i += 1
    assert coeff_pos(0, 1 << 32) is None
    assert coeff_pos(0, 1 << 64) is None


def sc_poly_algebra(api, b, rng):
    P, r = api.poly.Poly, b.r
    poly = P.monomial(3) * 5 + P.monomial(1) - 2
    assert poly.coeff == [(-2) % r, 1, 0, 5]
    samples = [(-1, -8), (2, 40), (3, 136), (5, 628)]
    for x, y in samples:
        assert poly.evaluate(x) == y % r
    assert P.interpolate(samples) == poly
    a, c = P([1, 2, 3]), P([5, 0, 0, 7])
    assert (a + c).coeff == [6, 2, 3, 7]
    assert (c - a).coeff == [4, (-2) % r, (-3) % r, 7]
    assert (P([1, 1]) * P([1, r - 1])).coeff == [1, 0, r - 1]
    assert (a - a).coeff == [] and (a - a).is_zero()
    assert (a * 2).coeff == [2, 4, 6] and (2 * a).coeff == [2, 4, 6]
    assert (a + 10).coeff == [11, 2, 3] and (a - 1).coeff == [0, 2, 3]
    assert P.zero().is_zero() and P.one().evaluate(12345) == 1
    assert P.identity().evaluate(7) == 7 and P.monomial(0).coeff == [1]
    assert P.constant(9).degree() == 0 == P.zero().degree()
    assert P.zero().evaluate(3) == 0 and (a * 0).is_zero()
    with pytest.raises(ValueError):
        P.interpolate([(1, 1), (1, 2)])
    assert P.interpolate([]) == P.zero()
    z = P.monomial(3) + P.monomial(2) - 1
    z.zeroize()
    assert z.is_zero() and repr(z) == 'Poly { coeff: "..." }'
    return [poly.coeff, P.interpolate({1: 5, 2: 7, 4: 0}).coeff,
            poly.reveal()]


def sc_commitments(api, b, rng):
    P = api.poly.Poly
    poly = P.random(4, rng)
    comm = poly.commitment()
    g1 = b.G1.one()
    for x in [0, 1, 7, b.fr_random(rng)]:
        assert comm.evaluate(x) == g1.mul(poly.evaluate(x))
    assert comm.degree() == poly.degree()
    a, c = P.random(2, rng), P.random(3, rng)
    assert a.commitment() + c.commitment() == (a + c).commitment()
    with pytest.raises(ValueError):
        api.poly.Commitment([]).degree()
    return [api.serde_impl.serialize(comm),
            api.serde_impl.serialize((a + c).commitment())]


def sc_bivar(api, b, rng):
    bp = api.poly.BivarPoly.random(2, rng)
    for x, y in [(1, 2), (3, 5), (0, 4)]:
        assert bp.evaluate(x, y) == bp.evaluate(y, x)
    for x in range(4):
        row = bp.row(x)
        for y in range(4):
            assert row.evaluate(y) == bp.evaluate(x, y)
    bc = bp.commitment()
    assert bc.row(2) == bp.row(2).commitment()
    assert bc.evaluate(1, 3) == b.G1.one().mul(bp.evaluate(1, 3))
    with pytest.raises(api.tc.DegreeTooHigh):
        api.poly.BivarPoly.try_random(1 << 33, rng)
    bp3 = api.poly.BivarPoly.random(3, rng)
    random_commitment = bp3.commitment()
    bp3.zeroize()
    zero_commitment = bp3.commitment()
    assert random_commitment != zero_commitment
    x, y = b.fr_random(rng), b.fr_random(rng)
    assert zero_commitment.evaluate(x, y) == b.G1.zero()
    return [bp.coeff, api.serde_impl.serialize(bc), repr(bp3),
            bp.evaluate(7, 9), api.poly._powers(5, 3)]


def sc_dkg(api, b, rng):
    """The reference's DKG test (``src/poly.rs:819-900``): dealers, nodes,
    faulty ones, in process."""
    dealer_num, node_num, faulty_num = ((3, 5, 2) if b.name == "mock"
                                        else (2, 3, 1))
    P = api.poly.Poly
    bi_polys = [api.poly.BivarPoly.random(faulty_num, rng)
                for _ in range(dealer_num)]
    pub_bi_commits = [bp.commitment() for bp in bi_polys]
    sec_keys = [0] * node_num
    g1 = b.G1.one()
    for bi_poly, bi_commit in zip(bi_polys, pub_bi_commits):
        for m in range(1, node_num + 1):
            row_poly, row_commit = bi_poly.row(m), bi_commit.row(m)
            assert row_poly.commitment() == row_commit
            for s in range(1, node_num + 1):
                val = row_poly.evaluate(s)
                assert bi_commit.evaluate(m, s) == g1.mul(val)
                assert bi_poly.evaluate(m, s) == val
            wrong_poly = row_poly + P.monomial(2) * 5
            assert wrong_poly.commitment() != row_commit
            received = {i: bi_poly.evaluate(m, i)
                        for i in range(1, faulty_num + 2)}
            my_row = P.interpolate(received)
            assert my_row.evaluate(0) == bi_poly.evaluate(m, 0)
            assert my_row == row_poly
            sec_keys[m - 1] = (sec_keys[m - 1] + my_row.evaluate(0)) % b.r
    sec_key_set = P.zero()
    for bi_poly in bi_polys:
        sec_key_set += bi_poly.row(0)
    for m in range(1, node_num + 1):
        assert sec_key_set.evaluate(m) == sec_keys[m - 1]
    sum_commit = api.poly.Commitment([])
    for bi_commit in pub_bi_commits:
        sum_commit += bi_commit.row(0)
    assert sum_commit == sec_key_set.commitment()
    return sec_keys + [api.serde_impl.serialize(sum_commit)]


POLY = {"algebra": sc_poly_algebra, "commitments": sc_commitments,
        "bivar": sc_bivar, "dkg": sc_dkg}


@pytest.mark.parametrize("name", sorted(POLY))
def test_poly_scenarios_on_mock_equal_jax(name):
    both(POLY[name], "mock")


@pytest.mark.parametrize("name", ["algebra", "dkg"])
def test_poly_scenarios_on_bls_equal_jax(name):
    both(POLY[name], "bls12_381")


# ---------------------------------------------------------------------------
# tests/test_serde.py's scenarios
# ---------------------------------------------------------------------------

G1_GEN_COMPRESSED = bytes.fromhex(
    "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb")
G2_GEN_COMPRESSED = bytes.fromhex(
    "93e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
    "334cf11213945d57e5ac7d055d042b7e024aa2b2f08f0a91260805272dc51051"
    "c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8")


def test_generator_and_identity_vectors():
    with tc.using("bls12_381") as b:
        assert b.G1.one().to_compressed() == G1_GEN_COMPRESSED
        assert b.G2.one().to_compressed() == G2_GEN_COMPRESSED
        assert b.G1.from_compressed(G1_GEN_COMPRESSED) == b.G1.one()
        assert b.G2.from_compressed(G2_GEN_COMPRESSED) == b.G2.one()
        for g in (b.G1, b.G2):
            z = g.zero().to_compressed()
            assert z[0] == 0xC0 and not any(z[1:])
            assert g.from_compressed(z).is_zero()


def test_invalid_points_raise_from_bytes_error():
    with tc.using("bls12_381") as b:
        bad_inf = bytearray([0xC0]) + bytearray(47)
        bad_inf[5] = 1
        too_big = bytes([0x9F]) + b"\xff" * 47
        for data in (bytes(48), bytes([0x80]) + bytes(47), bytes(bad_inf),
                     G1_GEN_COMPRESSED[:-1], too_big):
            with pytest.raises(tc.FromBytesError):
                b.G1.from_compressed(data)
        with pytest.raises(tc.FromBytesError):
            b.G2.from_compressed(bytes(96))
    assert issubclass(tc.FromBytesError, ValueError)


def sc_serde_roundtrips(api, b, rng):
    tc_, ser, de = api.tc, api.serde_impl.serialize, api.serde_impl.deserialize
    SerdeSecret = api.serde_impl.SerdeSecret
    sk_set = tc_.SecretKeySet.random(3, rng)
    pk_set = sk_set.public_keys()
    sk = tc_.SecretKey.random(rng)
    pk = sk.public_key()
    sig = sk.sign(b"m")
    ct = pk.encrypt(b"payload", rng)
    cases = [(tc_.PublicKey, pk), (tc_.PublicKeyShare,
                                   pk_set.public_key_share(2)),
             (tc_.Signature, sig),
             (tc_.SignatureShare, sk_set.secret_key_share(1).sign(b"m")),
             (tc_.DecryptionShare, tc_.DecryptionShare.random(rng)),
             (tc_.Ciphertext, ct), (tc_.PublicKeySet, pk_set)]
    out = []
    for cls, obj in cases:
        data = ser(obj)
        assert de(cls, data) == obj, cls.__name__
        out.append(data)
    assert len(ser(pk)) == b.PK_SIZE and len(ser(sig)) == b.SIG_SIZE
    for secret in [sk, sk_set.secret_key_share(0), sk_set]:
        with pytest.raises(TypeError):
            ser(secret)
    for cls, obj in ((tc_.SecretKey, sk),
                     (tc_.SecretKeyShare, sk_set.secret_key_share(0)),
                     (tc_.SecretKeySet, sk_set)):
        data = ser(SerdeSecret(obj))
        assert de(cls, data) == obj
        out.append(data)
    assert len(out[-3]) == b.FR_BYTES
    with pytest.raises(tc_.FromBytesError):
        de(tc_.PublicKey, ser(pk) + b"\x00")
    with pytest.raises(tc_.FromBytesError):
        de(tc_.Ciphertext, ser(ct)[:-1])
    return out


def sc_poly_serde(api, b, rng):
    ser, de = api.serde_impl.serialize, api.serde_impl.deserialize
    bc = api.poly.BivarPoly.random(2, rng).commitment()
    data = ser(bc)
    assert de(api.poly.BivarCommitment, data) == bc
    tampered = bytearray(data)
    tampered[0] ^= 1
    with pytest.raises(api.tc.FromBytesError):
        de(api.poly.BivarCommitment, bytes(tampered))
    poly = api.poly.Poly.random(3, rng)
    comm = poly.commitment()
    assert de(api.poly.Commitment, ser(comm)) == comm
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        raw = ser(poly)
    assert len(caught) == 1 and "SECRET" in str(caught[0].message)
    assert raw == ser(api.serde_impl.SerdeSecret(poly))
    assert de(api.poly.Poly, raw) == poly
    return [data, ser(comm), raw]


def sc_codec(api, b, rng):
    codec = api.codec_impl
    sk = api.tc.SecretKey.random(rng)
    pk = sk.public_key()
    objs = [(pk, api.tc.PublicKey),
            (sk.sign(b"this is a test"), api.tc.Signature),
            (pk.encrypt(b"cipher text", rng), api.tc.Ciphertext),
            (api.tc.DecryptionShare.random(rng), api.tc.DecryptionShare),
            (api.tc.SecretKeySet.random(3, rng).public_keys(),
             api.tc.PublicKeySet)]
    out = []
    for obj, cls in objs:
        data = codec.encode(obj)
        assert codec.decode(cls, data) == obj
        out.append(data)
    with pytest.raises(TypeError):
        codec.encode(sk)
    with pytest.raises(TypeError):
        codec.decode(api.tc.SecretKey, out[0])
    with pytest.raises(api.tc.FromBytesError):
        codec.decode(api.tc.PublicKey, out[0][:-1])
    return out


SERDE = {"roundtrips": sc_serde_roundtrips, "poly": sc_poly_serde,
         "codec": sc_codec}


@pytest.mark.parametrize("name", sorted(SERDE))
def test_serde_scenarios_on_mock_equal_jax(name):
    both(SERDE[name], "mock")


@pytest.mark.parametrize("name", sorted(SERDE))
def test_serde_scenarios_on_bls_equal_jax(name):
    both(SERDE[name], "bls12_381")


def test_serde_fr_validation():
    with tc.using("bls12_381") as b:
        with pytest.raises(tc.FromBytesError):
            tc.deserialize(tc.SecretKey, b.r.to_bytes(32, "little"))
        with pytest.raises(tc.FromBytesError):
            tc.deserialize(tc.SecretKey, bytes(16))
    with tc.using("mock"):
        assert len(tc.SecretKey.random(ChaChaRng(SEED)).public_key()
                   .to_bytes()) == 4
        assert len(tc.serialize(tc.SerdeSecret(tc.SecretKey(5)))) == 4


def test_scale_compact_roundtrip_equals_jax():
    for n in [0, 1, 63, 64, 16383, 16384, (1 << 30) - 1, 1 << 30, 1 << 40]:
        enc = codec_impl.scale_compact_encode(n)
        assert enc == JAX.codec_impl.scale_compact_encode(n)
        assert codec_impl.scale_compact_decode(enc) == (n, len(enc))
    with pytest.raises(tc.FromBytesError):
        codec_impl.scale_compact_decode(b"")


# ---------------------------------------------------------------------------
# tests/test_vectors.py: the golden vectors, read and never written
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(REPO, "tests", "fixtures", "golden.json")) as f:
        return json.load(f)


def test_golden_hash_g2_and_xor_with_hash(golden):
    with tc.using("bls12_381"):
        for msg, want in golden["hash_g2"].items():
            assert hashing.hash_g2(msg.encode()).to_compressed().hex() == want
        g = golden["xor_with_hash"]
        g1 = tc.SecretKey(7).public_key().el
        assert g1.to_compressed().hex() == g["key_g1"]
        assert hashing.xor_with_hash(g1, bytes.fromhex(g["data"])).hex() == \
            g["out"]


def test_golden_seeded_keygen_and_serde(golden):
    with tc.using("bls12_381"):
        g = golden["seeded_keygen"]
        sks = tc.SecretKeySet.random(g["threshold"], ChaChaRng(SEED))
        pks = sks.public_keys()
        assert serde_impl.serialize(pks).hex() == g["public_key_set"]
        assert serde_impl.serialize(serde_impl.SerdeSecret(
            sks.secret_key_share(0))).hex() == g["secret_key_share_0"]
        assert pks.public_key().to_bytes().hex() == g["master_pk"]

        g = golden["serde"]
        sk = tc.SecretKey(12345)
        pk = sk.public_key()
        sig = sk.sign(b"golden message")
        assert serde_impl.serialize(serde_impl.SerdeSecret(sk)).hex() == \
            g["secret_key"]
        assert serde_impl.serialize(pk).hex() == g["public_key"]
        assert serde_impl.serialize(sig).hex() == g["signature"]
        assert sig.to_bytes().hex() == g["sig_bytes"]
        assert pk.to_bytes().hex() == g["pk_bytes"]
        ct = pk.encrypt_with_rng(ChaChaRng(bytes(32)), b"golden plaintext")
        assert serde_impl.serialize(ct).hex() == g["ciphertext"]
        dshare = sks.secret_key_share(1).decrypt_share(ct)
        assert serde_impl.serialize(dshare).hex() == g["decryption_share"]
        assert serde_impl.deserialize(
            tc.PublicKey, bytes.fromhex(g["public_key"])) == pk
        assert serde_impl.deserialize(
            tc.Signature, bytes.fromhex(g["signature"])) == sig


def test_published_constants():
    from threshold_crypto_tpu_torch.host.params import P, R, X

    assert P == int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf"
                    "6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab", 16)
    assert R == int("73eda753299d7d483339d80809a1d805"
                    "53bda402fffe5bfeffffffff00000001", 16)
    assert X == -0xD201000000010000
    assert R == X**4 - X**2 + 1 and P == (X - 1) ** 2 * R // 3 + X


# ---------------------------------------------------------------------------
# tests/test_rng_and_mock.py: the mock backend through the API
# ---------------------------------------------------------------------------

def test_mock_backend_protocol_and_pairing_check():
    with tc.using("mock") as b:
        assert (b.PK_SIZE, b.SIG_SIZE, b.FR_BYTES) == (4, 4, 4)
        sk = tc.SecretKey.random(ChaChaRng(bytes(32)))
        sig = sk.sign(b"mock message")
        assert sk.public_key().verify(sig, b"mock message")
        assert not sk.public_key().verify(sig, b"other message")
        p, q = b.G1(3), b.G2(5)
        assert b.pairing_check([(p, q), (p.neg(), q)])
        assert not b.pairing_check([(p, q), (p, q)])
        assert b.pairing_eq(p, q, p, q)
        sig = tc.Signature.random(ChaChaRng(bytes(32)))
        acc = 0
        for byte in sig.el.to_uncompressed():
            acc ^= byte
        assert sig.parity() == (bin(acc).count("1") % 2 == 1)


def test_backend_state_is_the_port_own():
    """Switching the port's backend leaves the JAX package's as it was, and
    the other way round; an exception inside ``using`` restores it."""
    assert tc.get_backend().name == jtc.get_backend().name == "bls12_381"
    with tc.using("mock"):
        assert tc.get_backend().name == "mock"
        assert jtc.get_backend().name == "bls12_381"
    with jtc.using("mock"):
        assert tc.get_backend().name == "bls12_381"
    with pytest.raises(RuntimeError):
        with tc.using("mock"):
            raise RuntimeError("inside")
    assert tc.get_backend().name == "bls12_381"
    with pytest.raises(KeyError):
        tc.set_backend("bn254")
    tc.set_backend("mock")
    try:
        assert tc.get_backend().name == "mock"
        assert jtc.get_backend().name == "bls12_381"
    finally:
        tc.set_backend("bls12_381")


def test_into_fr_equals_jax():
    for backend in ("mock", "bls12_381"):
        with tc.using(backend), jtc.using(backend):
            for x in (0, 1, 5, -1, -7, (1 << 64) - 1, 1 << 300):
                assert tc.into_fr(x) == jtc.into_fr(x)
                assert tc.into_fr_plus_1(x) == jtc.into_fr_plus_1(x)
            for bad in (True, 1.5, "3"):
                with pytest.raises(TypeError):
                    tc.into_fr(bad)


# ---------------------------------------------------------------------------
# The three examples/ flows and the verify skill's probes, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("example", ["basic_pkc", "threshold_sig",
                                     "threshold_enc"])
def test_examples_run_against_the_port(example, capsys):
    """Each example's source, its imports pointed at the port (the file
    itself is not changed), run as ``__main__``."""
    path = os.path.join(REPO, "examples", example + ".py")
    src = open(path).read()
    assert "import threshold_crypto_tpu as tc" in src
    src = src.replace("threshold_crypto_tpu", "threshold_crypto_tpu_torch")
    exec(compile(src, path, "exec"), {"__name__": "__main__",
                                      "__file__": path})
    out = capsys.readouterr().out
    assert out.strip(), "the example printed nothing"
    assert "jax" not in src


def test_skill_probes():
    rng = ChaChaRng(bytes([5]) * 32)
    sks = tc.SecretKeySet.random(1, rng)
    pks = sks.public_keys()
    sh = {i: sks.secret_key_share(i).sign(b"m") for i in range(3)}
    with pytest.raises(tc.NotEnoughShares):
        pks.combine_signatures({0: sh[0]})
    assert pks.combine_signatures({i: sh[i] for i in [0, 1]}).to_bytes() == \
        pks.combine_signatures({i: sh[i] for i in [1, 2]}).to_bytes()
    with pytest.raises(tc.DuplicateEntry):
        tc.interpolate(1, [(3, sh[0].sig.el), (3, sh[1].sig.el)])
    with pytest.raises(tc.DegreeTooHigh):
        tc.SecretKeySet.try_random((1 << 64) - 1, rng)
    with pytest.raises(tc.FromBytesError):
        tc.PublicKey.from_bytes(b"\x00" * 48)
    ct = pks.public_key().encrypt(b"s", rng)
    tampered = tc.Ciphertext(ct.u, bytes([ct.v[0] ^ 1]) + ct.v[1:], ct.w)
    assert not tampered.verify()
    assert sks.secret_key_share(0).decrypt_share(tampered) is None
    assert sks.secret_key().decrypt(tampered) is None
    with pytest.raises(ValueError):
        pks.verify_signature_shares({}, b"m", rng)
    pk = sks.secret_key().public_key()
    assert len(pk.to_bytes()) == 48 and len(sh[0].to_bytes()) == 96
    assert tc.PublicKey.from_bytes(pk.to_bytes()) == pk
    ds = {i: sks.secret_key_share(i).decrypt_share(ct) for i in [0, 2]}
    assert pks.decrypt(ds, ct) == b"s"
    # seeded determinism
    a = tc.SecretKeySet.random(2, ChaChaRng(bytes([5]) * 32))
    b = tc.SecretKeySet.random(2, ChaChaRng(bytes([5]) * 32))
    assert a == b and a.secret_key_share(4) == b.secret_key_share(4)


def test_skill_scenario_two_on_mock():
    with tc.using("mock"):
        rng = ChaChaRng(bytes([9]) * 32)
        sks = tc.SecretKeySet.random(1, rng)
        pks = sks.public_keys()
        sh = {i: sks.secret_key_share(i).sign(b"m") for i in range(3)}
        sig = pks.combine_signatures({i: sh[i] for i in [0, 1]})
        assert sig == pks.combine_signatures({i: sh[i] for i in [1, 2]})
        assert pks.public_key().verify(sig, b"m")
        assert isinstance(sig.el, type(tc.get_backend().G2.one()))


def test_poly_types_are_the_port_own():
    assert all(cls.__module__ == "threshold_crypto_tpu_torch.poly"
               for cls in (Poly, Commitment, BivarPoly, BivarCommitment))
    assert interpolate is tc.interpolate
