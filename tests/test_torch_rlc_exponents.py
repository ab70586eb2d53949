"""``ops.rlc_exponents`` with the JAX signature: positional trees and
``h_jac=`` beside ``pk_aff=`` / ``sig_aff=``, absorbed in the JAX order.

The JAX ``rlc_exponents(n, seed, *trees, pk_aff=None, sig_aff=None,
h_jac=None, on_device=True)`` binds, in order, the leaves of the positional
trees, then of ``pk_aff``, ``sig_aff`` and ``h_jac``, into the transcript
that keys its ChaCha stream. On the CPU, on the same bytes (numpy limbs for
the JAX side, int32 / bool tensors for the port), the port's exponents
equal the JAX ones with ``h_jac=`` alone (a G2 Jacobian tuple), with
``pk_aff`` + ``sig_aff`` + ``h_jac``, and with three positional trees (a
tuple, a list and a bare array), each with ``on_device`` True and False on
both sides; moving ``h_jac`` alone, or the order of the trees, moves the
exponents on both sides alike.
"""

import numpy as np
import pytest
import torch

from threshold_crypto_tpu.ops import threshold as jops
from threshold_crypto_tpu_torch import ops
from threshold_crypto_tpu_torch.device import curve as dcv

N = 40                                   # 40·96 B: one chunk and a tail


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tens(tree):
    """numpy uint32 / bool leaves -> the port's int32 / bool tensors, in
    the same tuple / list structure."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tens(t) for t in tree)
    return torch.from_numpy(tree.view(np.int32) if tree.dtype == np.uint32
                            else tree.copy())


@pytest.fixture(scope="module")
def points():
    """pk (x, y, inf) and sig ((x0, x1), (y0, y1), inf) affine over N lanes,
    and two G2 Jacobian hash points ((x0, x1), (y0, y1), (z0, z1)) of one
    lane that differ in one bit."""
    rng = np.random.default_rng(0xC1)

    def limbs(*shape):
        return rng.integers(0, 1 << 16, shape + (24,),
                            dtype=np.uint64).astype(np.uint32)

    inf = np.zeros(N, bool)
    inf[5] = True
    pk = (limbs(N), limbs(N), inf)
    sig = ((limbs(N), limbs(N)), (limbs(N), limbs(N)), ~inf)
    h = tuple((limbs(1), limbs(1)) for _ in range(3))
    h2 = tuple((a.copy(), b.copy()) for a, b in h)
    h2[2][1][0, 3] ^= 1
    return pk, sig, h, h2


def _both(seed, *trees, **kw):
    """The JAX and the port's exponents as uint32[N, 16], each with
    on_device True and False; the two forms agree on each side."""
    want = [np.asarray(jops.rlc_exponents(N, seed, *trees, on_device=d,
                                          **kw)) for d in (True, False)]
    assert np.array_equal(want[0], want[1])
    tkw = {k: _tens(v) for k, v in kw.items()}
    got = [ops.rlc_exponents(N, seed, *map(_tens, trees), on_device=d,
                             **tkw) for d in (True, False)]
    for g in got:
        assert g.dtype == torch.int32 and g.shape == (N, 16)
        assert g.device.type == "cpu"
    return want[0], [g.numpy().view(np.uint32) for g in got]


@pytest.mark.parametrize("case", ["h_jac", "pk_sig_h", "trees"])
def test_rlc_exponents_match_jax(points, case):
    pk, sig, h, _ = points
    if case == "h_jac":
        args, kw = (), dict(h_jac=h)
    elif case == "pk_sig_h":
        args, kw = (), dict(pk_aff=pk, sig_aff=sig, h_jac=h)
    else:
        args, kw = (pk, list(sig), pk[0]), {}
    want, got = _both(b"c1-" + case.encode(), *args, **kw)
    for g in got:
        assert np.array_equal(g, want)
    assert not want[:, 4:].any() and want[:, :4].any(axis=1).all()


def test_h_jac_moves_the_exponents_on_both_sides(points):
    """Two calls that differ only in h_jac give different exponents, each
    the JAX package's; trees after the keywords' points would too, so the
    order is the JAX one: positional trees first."""
    pk, sig, h, h2 = points
    a_want, a_got = _both(b"bind-h", pk_aff=pk, sig_aff=sig, h_jac=h)
    b_want, b_got = _both(b"bind-h", pk_aff=pk, sig_aff=sig, h_jac=h2)
    assert not np.array_equal(a_want, b_want)
    assert np.array_equal(a_got[0], a_want)
    assert np.array_equal(b_got[0], b_want)
    # pk, sig and h as positional trees in that order give the keyword form
    c_want, c_got = _both(b"bind-h", pk, sig, h)
    assert np.array_equal(c_want, a_want) and np.array_equal(c_got[0],
                                                             a_want)
    # and in another order, other exponents on both sides
    d_want, d_got = _both(b"bind-h", h, pk_aff=pk, sig_aff=sig)
    assert not np.array_equal(d_want, a_want)
    assert np.array_equal(d_got[1], d_want)


def test_default_device_is_the_first_tensor_absorbed(points):
    """The output lies where the first tensor leaf lies, positional trees
    included; numpy leaves alone need device= (else the card)."""
    pk, _, h, _ = points
    r = ops.rlc_exponents(N, b"dev", _tens(h), pk_aff=pk)
    assert r.device.type == "cpu"
    assert dcv.leaves([(1, [2, (3,)]), 4]) == [1, 2, 3, 4]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.rlc_exponents(N, b"dev", pk, h_jac=h)
