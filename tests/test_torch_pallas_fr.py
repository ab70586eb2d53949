"""Kernel B14 (``device/cuda_fr.py``, plain versions) against the JAX
package's Pallas Lagrange kernel.

On the CPU ``cuda_fr.lagrange_rowprod`` runs B14's plain version
(``rowprod_partials_ref``: the kernel's chunks of the j range, each swept
with stacked differences and a product tree) and folds the chunks as the
card does. Both of its outputs, the row products Π_{j≠i}(x_j − x_i) and
the zero counts (the diagonal included), are held bit for bit against
``pallas_fr.lagrange_rowprod`` in DIRECT mode (the kernel's cell function
run as plain jnp code over the packed layout, as
``tests/test_pallas_fr.py`` runs it) on distinct x at N = 1100 (two
1024-lane blocks, the second ragged) and on x with one duplicate pair at
N = 300, and against Python ints.
"""

import random

import numpy as np
import pytest
import torch

from threshold_crypto_tpu.device import pallas_fr
from threshold_crypto_tpu.ops import fr as jfr
from threshold_crypto_tpu_torch import convert
from threshold_crypto_tpu_torch.device import cuda_fr
from threshold_crypto_tpu_torch.device.mont import FR
from threshold_crypto_tpu_torch.ops import fr as frops

R = FR.p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def direct():
    pallas_fr.DIRECT = True
    try:
        yield
    finally:
        pallas_fr.DIRECT = False


def _vals(n, seed, dup=None):
    rnd = random.Random(seed)
    vals = [rnd.randrange(1, R) for _ in range(n)]
    if dup is not None:
        vals[dup[1]] = vals[dup[0]]
    return vals


def _host_rowprod(vals, i):
    d = 1
    for v in vals:
        if v != vals[i]:
            d = d * (v - vals[i]) % R
    return d


def _check(vals, lanes):
    xs = frops.fr_to_device(vals, "cpu")
    prod, zcnt = cuda_fr.lagrange_rowprod(xs)
    jprod, jcnt = pallas_fr.lagrange_rowprod(jfr.fr_to_device(vals))
    assert np.array_equal(convert.fr_to_jax(prod), np.asarray(jprod))
    assert np.array_equal(zcnt.numpy(), np.asarray(jcnt).astype(np.int32))
    assert zcnt.tolist() == [sum(v == w for w in vals) for v in vals]
    for i in lanes:
        assert frops.fr_from_device(prod[i:i + 1]) == [_host_rowprod(vals, i)]
    return xs, prod, zcnt


def test_distinct_x_match_jax_kernel_across_a_block_edge(direct):
    """N = 1100: the JAX kernel's second 1024-lane block holds 76 live
    lanes; here N is exact. Every count is 1."""
    vals = _vals(1100, 1100)
    _, _, zcnt = _check(vals, (0, 1023, 1024, 1099))
    assert bool((zcnt == 1).all())


def test_duplicate_pair_matches_jax_kernel(direct):
    """One duplicate pair at N = 300: its two lanes count 2 (the diagonal
    and each other) and skip each other's zero difference; the plain
    version's single sweep (``lagrange_rowprod_ref``) agrees."""
    vals = _vals(300, 300, dup=(3, 297))
    xs, prod, zcnt = _check(vals, (3, 297, 150))
    assert zcnt[3] == zcnt[297] == 2 and int(zcnt.sum()) == 302
    ref = cuda_fr.lagrange_rowprod_ref(xs)
    assert torch.equal(ref[0], prod) and torch.equal(ref[1], zcnt)


def test_partials_follow_the_kernel_chunks():
    """The plain version of the launch gives one partial product and count
    per chunk of 128 j values (at most 32 chunks); the partial counts of a
    lane sum to its count."""
    vals = _vals(300, 301, dup=(0, 299))
    xs = frops.fr_to_device(vals, "cpu")
    prod, cnt = cuda_fr.rowprod_partials_ref(xs)
    assert cuda_fr._chunk(300) == 128 and cuda_fr._chunk(4096) == 128
    assert cuda_fr._chunk(4097) == 256
    assert prod.shape == (3, 300, 16) and cnt.shape == (3, 300)
    assert cnt[:, 0].tolist() == [1, 0, 1] and cnt[:, 5].tolist() == [1, 0, 0]
    assert torch.equal(cuda_fr.fold_products(prod),
                       cuda_fr.lagrange_rowprod(xs)[0])


def test_kernel_is_reached_through_the_module_and_cpu_never_launches():
    (k,) = cuda_fr.KERNELS
    assert getattr(cuda_fr, k.launch.__name__) is k.launch
    assert getattr(cuda_fr, k.plain.__name__) is k.plain
    xs = frops.fr_to_device([1, 2, 3], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        k.launch(xs)
    before = k.count.launches
    cuda_fr.lagrange_rowprod(xs)
    assert k.count.launches == before
