"""The port's Fq2/Fq6/Fq12 tower against the JAX package's device tower.

3 lanes of random elements, made from a numpy seed, go through
``threshold_crypto_tpu.device.tower`` (XLA on the CPU) and through
``threshold_crypto_tpu_torch.device.tower`` on the CPU; the limbs must be
equal. The field-level results are also held against the host tower.
"""

import zlib

import numpy as np
import pytest
import torch

import threshold_crypto_tpu.device.mont as jmont
import threshold_crypto_tpu.device.tower as jtw
import threshold_crypto_tpu.host.tower as htw
from threshold_crypto_tpu_torch.device import tower as tw

B = 3
P = jmont.FQ.p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, depth):
    """Host values: depth 0 Fq2, 1 Fq6, 2 Fq12, as lists over B lanes."""
    def fq2():
        return tuple(int.from_bytes(rng.bytes(64), "little") % P
                     for _ in range(2))

    def one(d):
        if d == 0:
            return fq2()
        return tuple(one(d - 1) for _ in range(3 if d == 1 else 2))

    return [one(depth) for _ in range(B)]


def _jax_from_host(vals):
    """Lanes of nested host tuples -> the JAX pytree of uint32[B, 24]."""
    first = vals[0]
    if isinstance(first, int):
        return np.stack([jmont.to_mont(jmont.FQ, v) for v in vals])
    return tuple(_jax_from_host([v[i] for v in vals])
                 for i in range(len(first)))


def _to_torch(tree):
    if isinstance(tree, tuple):
        return tuple(_to_torch(t) for t in tree)
    return torch.from_numpy(np.asarray(tree).astype(np.int32))


def _to_np(tree):
    if isinstance(tree, tuple):
        return tuple(_to_np(t) for t in tree)
    return np.asarray(tree).astype(np.uint32)


def _assert_same(port, ref):
    if isinstance(ref, tuple):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_same(p, r)
    else:
        assert np.array_equal(_to_np(port), np.asarray(ref))


def _host_lanes(tree):
    """Port tree of [B, 24] limbs -> list of B nested host tuples."""
    if isinstance(tree, tuple):
        parts = [_host_lanes(t) for t in tree]
        return [tuple(p[i] for p in parts) for i in range(B)]
    return tw.mont.unstack_mont(tw.FQ, tree)


def _inputs(seed, depth, k=1):
    rng = np.random.default_rng(seed)
    hosts = [_rand(rng, depth) for _ in range(k)]
    jax_in = [_jax_from_host(h) for h in hosts]
    return hosts, jax_in, [_to_torch(j) for j in jax_in]


@pytest.mark.parametrize("name,depth,nargs,host_fn", [
    ("fq2_mul", 0, 2, htw.fq2_mul),
    ("fq2_sqr", 0, 1, htw.fq2_sqr),
    ("fq2_inv", 0, 1, htw.fq2_inv),
    ("fq6_mul", 1, 2, htw.fq6_mul),
    ("fq6_inv", 1, 1, htw.fq6_inv),
    ("fq12_mul", 2, 2, htw.fq12_mul),
    ("fq12_sqr", 2, 1, htw.fq12_sqr),
    ("fq12_inv", 2, 1, htw.fq12_inv),
    ("fq12_conj", 2, 1, htw.fq12_conj),
])
def test_tower_op_matches(name, depth, nargs, host_fn):
    hosts, jax_in, port_in = _inputs(zlib.crc32(name.encode()), depth, nargs)
    got = getattr(tw, name)(*port_in)
    _assert_same(got, getattr(jtw, name)(*jax_in))
    want = [host_fn(*(h[i] for h in hosts)) for i in range(B)]
    assert _host_lanes(got) == want


@pytest.mark.parametrize("power", [1, 2, 3, 6])
def test_fq12_frob_matches(power):
    hosts, jax_in, port_in = _inputs(20 + power, 2)
    got = tw.fq12_frob(port_in[0], power)
    _assert_same(got, jtw.fq12_frob(jax_in[0], power))
    assert _host_lanes(got) == [htw.fq12_frob(h, power) for h in hosts[0]]


def test_fq12_cyclo_sqr_matches():
    """Granger–Scott squaring: equal limbs for any input, and the true
    square on an element of the cyclotomic subgroup."""
    hosts, jax_in, port_in = _inputs(30, 2)
    _assert_same(tw.fq12_cyclo_sqr(port_in[0]), jtw.fq12_cyclo_sqr(jax_in[0]))
    # f^((p^6-1)(p^2+1)) lies in the cyclotomic subgroup
    cyc = []
    for f in hosts[0]:
        g = htw.fq12_mul(htw.fq12_conj(f), htw.fq12_inv(f))
        cyc.append(htw.fq12_mul(htw.fq12_frob(g, 2), g))
    got = tw.fq12_cyclo_sqr(_to_torch(_jax_from_host(cyc)))
    assert _host_lanes(got) == [htw.fq12_sqr(g) for g in cyc]


def test_fq12_mul_by_014_matches():
    hosts, jax_in, port_in = _inputs(40, 2)
    _, jline, pline = _inputs(41, 0, 3)
    got = tw.fq12_mul_by_014(port_in[0], *pline)
    _assert_same(got, jtw.fq12_mul_by_014(jax_in[0], *jline))


def test_fq12_is_one_matches():
    hosts, jax_in, port_in = _inputs(50, 2)
    one = _to_torch(_jax_from_host([htw.FQ12_ONE] * B))
    mixed = tw.fq12_select(torch.tensor([True, False, True]), one, port_in[0])
    assert tw.fq12_is_one(mixed).tolist() == [True, False, True]
    assert np.array_equal(
        tw.fq12_is_one(port_in[0]).numpy(),
        np.asarray(jtw.fq12_is_one(jax_in[0])))
