"""The port's public API against its batched device ops on the CPU, on the
same shares: a ``SecretKeySet`` at t = 2 deals five shares; the
``SecretKeyShare`` scalars equal ``ops.derive_shares``, the
``SecretKeyShare.sign`` outputs equal ``ops.sign_batch``, the
``decrypt_share`` outputs equal ``ops.decrypt_share_batch``, and
``PublicKeySet.combine_signatures`` / ``decrypt``'s interpolated point
equal ``ops.combine_batch`` on each of its three paths, compressed byte
for byte. The backend's group elements hold host affine points (``.v``);
``device.curve``'s ``from_host_affine`` lifts them. No pairing runs here:
the ops' plain versions do the scalar work on CPU tensors.
"""

import pytest
import torch

import threshold_crypto_tpu_torch as tc
from threshold_crypto_tpu_torch import ops
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.ops import fr as frops
from threshold_crypto_tpu_torch.ops import threshold as tops
from threshold_crypto_tpu_torch.utils.rng import ChaChaRng

T = 2
NODES = range(5)
MSG = b"bridge message"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dealt():
    sks = tc.SecretKeySet.random(T, ChaChaRng(bytes([0xB7]) * 32))
    keys = [sks.secret_key_share(i) for i in NODES]
    ct = sks.public_keys().public_key().encrypt(
        b"bridge plaintext", ChaChaRng(bytes([0xB8]) * 32))
    return sks, keys, ct


def _one(curve, pt):
    return curve.to_host_affine(dcv.tree_map(lambda a: a[None], pt))[0]


def test_shares_sign_and_decrypt_equal_the_batch_ops(dealt):
    sks, keys, ct = dealt
    xs = frops.fr_to_device([tc.into_fr_plus_1(i) for i in NODES], "cpu")
    coeffs = frops.fr_to_device(sks.poly.coeff, "cpu")
    assert frops.fr_from_device(ops.derive_shares(coeffs, xs)) == [
        k.sk.fr for k in keys]

    sk_plain = dcv.fr_limbs_from_ints([k.sk.fr for k in keys], "cpu")
    h = tc.hash_g2(MSG)
    n = len(keys)
    h_jac = dcv.tree_map(lambda a: a.repeat((n,) + (1,) * (a.dim() - 1)),
                         dcv.G2.from_host_affine([h.v], device="cpu"))
    sigs = dcv.G2.to_host_affine(ops.sign_batch(h_jac, sk_plain))
    assert sigs == [k.sign(MSG).sig.el.v for k in keys]
    b = tc.get_backend()
    assert [b.G2(p).to_compressed() for p in sigs] == [
        k.sign(MSG).to_bytes() for k in keys]

    u_jac = dcv.tree_map(lambda a: a.repeat((n,) + (1,) * (a.dim() - 1)),
                         dcv.G1.from_host_affine([ct.u.v], device="cpu"))
    shares = dcv.G1.to_host_affine(ops.decrypt_share_batch(u_jac, sk_plain))
    assert [b.G1(p).to_compressed() for p in shares] == [
        k.decrypt_share_no_verify(ct).to_bytes() for k in keys]


@pytest.mark.parametrize("path", tops.COMBINE_PATHS)
def test_combine_signatures_equals_combine_batch(dealt, path):
    """``combine_signatures`` takes the first t + 1 shares by index (0, 1,
    2); ``combine_batch`` on those, x = i + 1, gives the same bytes, and so
    does the interpolation of the decryption shares behind ``decrypt``."""
    sks, keys, ct = dealt
    pks = sks.public_keys()
    b = tc.get_backend()
    sig_shares = {i: keys[i].sign(MSG) for i in NODES}
    want = pks.combine_signatures(sig_shares)
    assert pks.public_key().verify(want, MSG)
    used = list(NODES)[:T + 1]
    xs = frops.fr_to_device([tc.into_fr_plus_1(i) for i in used], "cpu")
    shares_jac = dcv.G2.from_host_affine(
        [sig_shares[i].sig.el.v for i in used], device="cpu")
    pt, ok = ops.combine_batch(dcv.G2, shares_jac, xs, path=path)
    assert bool(ok)
    got = tc.Signature(b.G2(_one(dcv.G2, pt)))
    assert got.to_bytes() == want.to_bytes() and got == want

    dec = {i: keys[i].decrypt_share(ct) for i in used}
    g = tc.interpolate(T, [(i, d.el) for i, d in dec.items()])
    pt, ok = ops.combine_batch(dcv.G1, dcv.G1.from_host_affine(
        [dec[i].el.v for i in used], device="cpu"), xs, path=path)
    assert bool(ok) and b.G1(_one(dcv.G1, pt)) == g
    assert pks.decrypt(dec, ct) == tc.xor_with_hash(g, ct.v) == \
        b"bridge plaintext"
