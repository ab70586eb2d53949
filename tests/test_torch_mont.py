"""The port's Montgomery field engine against the JAX package's.

Same inputs, made from numpy seeds, go through ``threshold_crypto_tpu``'s
``device.mont`` (XLA on the CPU) and through ``threshold_crypto_tpu_torch.device.mont`` on the CPU,
where the kernels' plain PyTorch versions run. Every comparison is exact:
canonical limbs are unique.
"""

import numpy as np
import pytest
import torch

import threshold_crypto_tpu.device.mont as jmont
from threshold_crypto_tpu_torch.device import cuda_mont, mont

SPECS = [(mont.FQ, jmont.FQ), (mont.FR, jmont.FR)]
IDS = ["Fq", "Fr"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(p):
    return [0, 1, p - 1, p - 2, 2, (p - 1) // 2]


def _elems(spec, n, seed):
    """Edge values, then n random field elements; (ints, uint32 limbs)."""
    rng = np.random.default_rng(seed)
    vals = _edges(spec.p) + [
        int.from_bytes(rng.bytes(64), "little") % spec.p for _ in range(n)
    ]
    return vals, np.stack([jmont.to_mont(spec, v) for v in vals])


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_spec_and_conversions_match(spec, jspec):
    assert (spec.p, spec.L, spec.n0inv, spec.r_mont, spec.r2, spec.p_limbs,
            spec.one_mont) == (jspec.p, jspec.L, jspec.n0inv, jspec.r_mont,
                               jspec.r2, jspec.p_limbs, jspec.one_mont)
    vals, want = _elems(jspec, 10, 0)
    assert np.array_equal(mont.stack_mont(spec, vals), want)
    for v in vals:
        assert np.array_equal(mont.to_mont(spec, v), jmont.to_mont(jspec, v))
        assert mont.from_mont_int(spec, mont.to_mont(spec, v)) == v
    assert mont.unstack_mont(spec, _t(want)) == vals


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_mul_matches_xla_engine(spec, jspec):
    av, a = _elems(jspec, 30, 1)
    bv, b = _elems(jspec, 30, 2)
    b = b[::-1].copy()
    bv = bv[::-1]
    got = _np(mont.mul(spec, _t(a), _t(b)))
    assert np.array_equal(got, np.asarray(jmont._mul_xla(jspec, a, b)))
    assert np.array_equal(_np(mont.sqr(spec, _t(a))),
                          np.asarray(jmont.sqr(jspec, a)))
    assert mont.unstack_mont(spec, got) == [
        x * y % spec.p for x, y in zip(av, bv)
    ]


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_mul_broadcasts_and_keeps_shape(spec, jspec):
    _, a = _elems(jspec, 0, 3)
    _, b = _elems(jspec, 0, 4)
    got = mont.mul(spec, _t(a).reshape(2, 3, spec.L), _t(b[1]))
    want = jmont._mul_xla(jspec, a.reshape(2, 3, spec.L), b[1])
    assert got.shape == (2, 3, spec.L)
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_add_sub_neg_match(spec, jspec):
    """All pairs of edge values (carry and borrow chains through 0xFFFF
    limbs, results at 0 and p−1) plus random lanes."""
    vals, e = _elems(jspec, 8, 5)
    ia, ib = np.meshgrid(np.arange(len(vals)), np.arange(len(vals)))
    a, b = e[ia.ravel()], e[ib.ravel()]
    for port_fn, jax_fn in ((mont.add, jmont.add), (mont.sub, jmont.sub)):
        got = _np(port_fn(spec, _t(a), _t(b)))
        assert np.array_equal(got, np.asarray(jax_fn(jspec, a, b)))
    got = _np(mont.neg(spec, _t(e)))
    assert np.array_equal(got, np.asarray(jmont.neg(jspec, e)))
    assert mont.unstack_mont(spec, got) == [-v % spec.p for v in vals]


def test_carry_lookahead_long_chains():
    """A carry (or borrow) that ripples through every limb."""
    L = 24
    ones = torch.full((1, L), 0xFFFF, dtype=torch.int32)
    one = torch.zeros((1, L), dtype=torch.int32)
    one[0, 0] = 1
    s, over = mont._add_limbs(ones, one)
    assert s.eq(0).all() and over.item() == 1
    d, borrow = mont._sub_limbs(torch.zeros_like(one), one)
    assert d.eq(0xFFFF).all() and borrow.item() == 1
    mixed = torch.tensor([[0xFFFF] * 11 + [3] + [0xFFFF] * 12],
                         dtype=torch.int32)
    s, over = mont._add_limbs(mixed, one)
    want = (sum(int(v) << (16 * i) for i, v in enumerate(mixed[0])) + 1)
    assert mont.int_from_limbs(s[0].numpy()) == want % (1 << 384)
    assert over.item() == want >> 384


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
@pytest.mark.parametrize("k", [2, 3, 8])
def test_mul_small_matches(spec, jspec, k):
    _, a = _elems(jspec, 6, 6)
    got = _np(mont.mul_small(spec, _t(a), k))
    assert np.array_equal(got, np.asarray(jmont.mul_small(jspec, a, k)))


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_pow_fixed_matches_xla_engine(spec, jspec):
    vals, a = _elems(jspec, 4, 7)
    e = 0xD201000000010001
    got = _np(mont.pow_fixed(spec, _t(a), e))
    assert np.array_equal(got, np.asarray(jmont._pow_fixed_xla(jspec, a, e)))
    assert mont.unstack_mont(spec, got) == [pow(v, e, spec.p) for v in vals]
    assert np.array_equal(_np(mont.pow_fixed(spec, _t(a), 0)),
                          np.asarray(jmont.pow_fixed(jspec, a, 0)))


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_inv_matches_and_maps_zero_to_zero(spec, jspec):
    vals, a = _elems(jspec, 2, 8)
    got = _np(mont.inv(spec, _t(a)))
    assert np.array_equal(
        got, np.asarray(jmont._pow_fixed_xla(jspec, a, jspec.p - 2)))
    assert mont.unstack_mont(spec, got) == [
        pow(v, spec.p - 2, spec.p) for v in vals
    ]
    assert vals[0] == 0 and not got[0].any()


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On the CPU the plain versions run; the kernel wrappers refuse CPU
    tensors rather than fall back."""
    def boom(*args):
        raise AssertionError("kernel called for a CPU tensor")

    monkeypatch.setattr(cuda_mont, "mont_mul", boom)
    monkeypatch.setattr(cuda_mont, "mont_pow", boom)
    _, a = _elems(jmont.FQ, 2, 9)
    mont.mul(mont.FQ, _t(a), _t(a))
    mont.pow_fixed(mont.FQ, _t(a), 5)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_mont.mont_mul(mont.FQ, _t(a), _t(a))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_mont.mont_pow(mont.FQ, _t(a), 5)
    with pytest.raises(RuntimeError, match="no Montgomery kernel"):
        mont.mul(mont.FQ, _t(a).to("meta"), _t(a).to("meta"))
