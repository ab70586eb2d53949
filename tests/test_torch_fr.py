"""The port's ``ops/fr.py`` against the JAX package's ``ops/fr.py``.

Both run on the CPU on the same Fr values, made from a seed: the port's
tensors through the kernels' plain versions, the JAX package's arrays
through its XLA field arithmetic. Limbs cross over as numpy arrays
(``convert.fr_from_jax`` / ``fr_to_jax``) and must be equal bit for bit:
conversions, the canonical form, Horner, the product tree, λ in both of
its forms (the N×N matrix up to 1024 shares; B14's route above, held
against the JAX package's chunked ``_lagrange_scan`` at N = 1100, its own
test size) with the ``ok`` flag on a duplicate pair and a zero x, and
``interpolate_at_zero``; λ and the interpolation also against Python ints.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threshold_crypto_tpu.ops import fr as jfr
from threshold_crypto_tpu_torch import convert
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.device.mont import FR
from threshold_crypto_tpu_torch.ops import fr as frops

R = FR.p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(vals):
    """The same Montgomery limbs as the port's tensor and the JAX array."""
    return frops.fr_to_device(vals, "cpu"), jfr.fr_to_device(vals)


def _same(t, j):
    return np.array_equal(convert.fr_to_jax(t), np.asarray(j))


def _distinct(n, seed):
    rnd = random.Random(seed)
    vals = set()
    while len(vals) < n:
        vals.add(rnd.randrange(1, R))
    return sorted(vals, key=lambda v: (v * 2654435761) % R)


def _lagrange_host(xs):
    """λ_i = Π_{j≠i} x_j / (x_j − x_i) mod r over Python ints."""
    out = []
    for i, xi in enumerate(xs):
        num = den = 1
        for j, xj in enumerate(xs):
            if j != i:
                num = num * xj % R
                den = den * (xj - xi) % R
        out.append(num * pow(den, -1, R) % R)
    return out


def test_conversions_match_jax():
    vals = [0, 1, R - 1, 2, 12345] + _distinct(11, 1)
    t, j = _pair(vals)
    assert t.dtype == torch.int32 and t.shape == (16, 16) and _same(t, j)
    assert frops.fr_from_device(t) == vals == jfr.fr_from_device(j)
    assert torch.equal(convert.fr_from_jax(np.asarray(j), device="cpu"), t)


def test_to_and_from_plain_match_jax():
    vals = [0, 1, R - 1] + _distinct(13, 2)
    t, j = _pair(vals)
    plain = frops.fr_to_plain(t)
    assert _same(plain, jfr.fr_to_plain(j))
    assert [mont.int_from_limbs(r) for r in plain.numpy()] == vals
    back = frops.fr_from_plain(plain)
    assert torch.equal(back, t)
    assert _same(back, jfr.fr_from_plain(jnp.asarray(
        convert.fr_to_jax(plain))))


@pytest.mark.parametrize("degree", [0, 1, 7])
def test_poly_eval_matches_jax_and_horner(degree):
    coeffs = _distinct(degree + 1, 10 + degree)
    xs = [0, 1, R - 1] + _distinct(5, 20 + degree)
    ct, cj = _pair(coeffs)
    xt, xj = _pair(xs)
    got = frops.poly_eval(ct, xt)
    assert got.shape == (len(xs), 16)
    assert _same(got, jfr.poly_eval(cj, xj))
    want = [sum(c * pow(x, k, R) for k, c in enumerate(coeffs)) % R
            for x in xs]
    assert frops.fr_from_device(got) == want
    # a batch shape of two axes
    assert torch.equal(frops.poly_eval(ct, xt.reshape(2, 4, 16)),
                       got.reshape(2, 4, 16))


@pytest.mark.parametrize("n", [1, 5, 13])
def test_prod_leading_matches_jax(n):
    vals = _distinct(n, 30 + n)
    t, j = _pair(vals)
    got = frops._prod_leading(t)
    assert _same(got, jfr._prod_leading(j))
    prod = 1
    for v in vals:
        prod = prod * v % R
    assert frops.fr_from_device(got[None]) == [prod]


@pytest.mark.parametrize("n", [1, 2, 17])
def test_lagrange_matrix_form_matches_jax(n):
    vals = _distinct(n, 40 + n)
    t, j = _pair(vals)
    lam, ok = frops.lagrange_coeffs_at_zero(t)
    jlam, jok = jfr.lagrange_coeffs_at_zero(j)
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    assert bool(jok) and _same(lam, jlam)
    assert frops.fr_from_device(lam) == _lagrange_host(vals)


@pytest.fixture(scope="module")
def large():
    """N = 1100 distinct x: λ through B14's route (N > 1024)."""
    vals = _distinct(1100, 42)
    t, j = _pair(vals)
    lam, ok = frops.lagrange_coeffs_at_zero(t)
    return vals, j, lam, ok


def test_lagrange_kernel_form_matches_jax_scan(large):
    vals, j, lam, ok = large
    jlam, jok = jfr._lagrange_scan(j)
    assert bool(ok) and bool(jok)
    assert _same(lam, jlam)


def test_one_lambda_matches_python_ints(large):
    vals, _, lam, _ = large
    num = 1
    for v in vals:
        num = num * v % R
    den = vals[0]
    for v in vals[1:]:
        den = den * (v - vals[0]) % R
    assert frops.fr_from_device(lam[:1]) == [num * pow(den, -1, R) % R]


@pytest.mark.parametrize("form", ["matrix", "kernel"])
@pytest.mark.parametrize("case", ["distinct", "duplicate", "zero"])
def test_ok_flags_duplicate_and_zero_x(monkeypatch, form, case):
    """ok is False for one duplicate pair and for one zero x, in the matrix
    form and (with the matrix bound lowered to 4) in B14's form. λ equals
    the JAX package's same form bit for bit, the zero-mapping inverse
    included: the matrix form against ``_lagrange_matrix``, B14's against
    ``_lagrange_scan``, which like B14 multiplies a zero difference as 1
    (so the two forms give other λ on a duplicate pair, in both
    packages)."""
    vals = _distinct(20, 7)
    if case == "duplicate":
        vals[13] = vals[2]
    elif case == "zero":
        vals[9] = 0
    t, j = _pair(vals)
    if form == "kernel":
        monkeypatch.setattr(frops, "_LAGRANGE_MATRIX_MAX", 4)
        jlam, jok = jfr._lagrange_scan(j)
    else:
        jlam, jok = jfr._lagrange_matrix(j)
    lam, ok = frops.lagrange_coeffs_at_zero(t)
    assert bool(ok) == bool(jok) == (case == "distinct")
    assert _same(lam, jlam)


def test_interpolate_at_zero_matches_jax_and_python_ints():
    coeffs = _distinct(9, 50)
    xs = _distinct(9, 51)
    ys = [sum(c * pow(x, k, R) for k, c in enumerate(coeffs)) % R
          for x in xs]
    xt, xj = _pair(xs)
    yt, yj = _pair(ys)
    val, ok = frops.interpolate_at_zero(xt, yt)
    jval, jok = jfr.interpolate_at_zero(xj, yj)
    assert bool(ok) and bool(jok)
    assert _same(val, jval)
    assert frops.fr_from_device(val[None]) == [coeffs[0]]
    lam = _lagrange_host(xs)
    assert coeffs[0] == sum(a * b for a, b in zip(lam, ys)) % R
