"""The MSM kernels B10 and B11 (plain versions) and the shared-window MSM
driver against the JAX package's Pallas MSM and the host oracle.

On the CPU ``device.cuda_curve``'s dispatch runs each kernel's plain
version. B10's (``g1_madd_ref``/``g2_madd_ref``) is held bit for bit
against the JAX in-kernel mixed add (``pallas_curve._g1_madd_impl`` /
``_g2_madd_impl`` in DIRECT mode, the kernel body run as plain jnp code, as
``tests/test_pallas_curve.py`` runs it) on the special lanes of that file's
``_build_cases``: T at infinity, T == Q, T == −Q and a Q-at-infinity
placeholder. The driver ``msm_pallas_shared`` with 4 accumulators over
N = 2·4 + 3 lanes (several lanes per accumulator, a ragged last block)
must give the host oracle's Σ rᵢ·Pᵢ and the JAX ``msm_pallas_shared``'s sum
(DIRECT mode) as affine points; dead (infinity) lanes with nonzero scalars
and real coordinates must never count. B11's plain version at A = 1024 over
two blocks, with digits outside 1..7 (which read entry 0), equals the JAX
shared-window Horner chain of DIRECT mode (``_dblw_impl``, then
``_selmadd_impl`` per block: the fused kernel's select chain and add) bit
for bit; a slow case holds it against the fused kernel ``_winacc_impl`` in
interpret mode.
"""

import io
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threshold_crypto_tpu.device import curve as jcv
from threshold_crypto_tpu.device import pairing as jpr
from threshold_crypto_tpu.device import pallas_curve as pcv
from threshold_crypto_tpu.device import pallas_tower as ptw
from threshold_crypto_tpu.host import curve as jhcv
from threshold_crypto_tpu_torch import convert
from threshold_crypto_tpu_torch.device import cuda_curve as ccv
from threshold_crypto_tpu_torch.device import cuda_mont
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import packed as pk
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import P, R

N_MADD = 32
A, N_MSM = 4, 11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def direct():
    ptw.DIRECT = True
    try:
        yield
    finally:
        ptw.DIRECT = False


def _flat_np(tree):
    return [np.asarray(c).reshape(-1, 24) for c in jax.tree_util.tree_leaves(
        tree)]


def _madd_cases(g2):
    """As ``tests/test_pallas_curve.py:_build_cases``: T = 2·T_in (lane 0
    T_in = inf), Q affine with lane 1 at infinity (the generator's
    placeholder coordinates), lane 2 Q = T, lane 3 Q = −T."""
    jcurve, host = (jcv.G2, jhcv.G2) if g2 else (jcv.G1, jhcv.G1)
    rnd = random.Random(0x5CA1A5 + g2)
    pts = [host.mul(host.generator, rnd.randrange(1, R))
           for _ in range(N_MADD)]
    qs = [host.mul(host.generator, rnd.randrange(1, R))
          for _ in range(N_MADD)]
    qs[2] = host.add(pts[2], pts[2])
    qs[3] = host.neg(host.add(pts[3], pts[3]))
    qs[1] = None
    T = jcurve.double(jcurve.from_host_affine(
        [None if i == 0 else p for i, p in enumerate(pts)]))
    Q = jcurve.from_host_affine(qs)
    return _flat_np(T), _flat_np(Q)[: (4 if g2 else 2)]


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_madd_plain_matches_jax_kernel_body(direct, g2):
    t_comps, q_comps = _madd_cases(g2)
    n = N_MADD
    jout = (pcv._g2_madd_impl if g2 else pcv._g1_madd_impl)(
        ptw.pack([jnp.asarray(c) for c in t_comps], n),
        ptw.pack([jnp.asarray(c) for c in q_comps], n))
    want = [np.asarray(c) for c in ptw.unpack(jout, len(t_comps), n)]
    acc = pk.pack([torch.from_numpy(c.astype(np.int32)) for c in t_comps])
    q = pk.pack([torch.from_numpy(c.astype(np.int32)) for c in q_comps])
    got = ccv.p_madd(g2, acc, q)
    assert torch.equal(got, (ccv.g2_madd_ref if g2 else ccv.g1_madd_ref)(
        acc, q))
    for i, (g, w) in enumerate(zip(pk.unpack(got, len(t_comps)), want)):
        assert np.array_equal(g.numpy().astype(np.uint32), w), i
    # lane 2 doubled, lane 3 cancelled to infinity
    curve = dcv.G2 if g2 else dcv.G1
    pts = curve.to_host_affine(ccv.unpack_jac(got, g2))
    tin = curve.to_host_affine(ccv.unpack_jac(acc, g2))
    assert pts[3] is None and pts[2] == curve.host.double(tin[2])


def test_madd_table_chain_matches_jax(direct):
    """The table 1P..7P of the shared MSM (six B10 launches from the Z = 1
    lift) equals the JAX DIRECT chain entry for entry, carried across by
    ``convert.msm_table_to_jax`` / ``msm_table_from_jax``."""
    rnd = random.Random(17)
    n = 8
    pts = [jhcv.G1.mul(jhcv.G1.generator, rnd.randrange(1, R))
           for _ in range(n)]
    aff = jpr.g1_affine_from_host(pts)
    q_comps = [np.asarray(aff[0]), np.asarray(aff[1])]
    qj = ptw.pack([jnp.asarray(c) for c in q_comps], n)
    base = jcv.G1.from_host_affine(pts)
    entries = [base]
    acc = ptw.pack([c.reshape(n, 24) for c in base], n)
    for _ in range(6):
        acc = pcv._g1_madd_impl(acc, qj)
        entries.append(tuple(ptw.unpack(acc, 3, n)))
    table = convert.msm_table_from_jax([tuple(np.asarray(c) for c in e)
                                        for e in entries], device="cpu")
    q = pk.pack([torch.from_numpy(c.astype(np.int32)) for c in q_comps])
    mine = [torch.cat([q, pk._one_rows(1, n, "cpu")])]
    for _ in range(6):
        mine.append(ccv.p_madd(False, mine[-1], q))
    assert torch.equal(torch.cat(mine), table)
    back = convert.msm_table_to_jax(table, g2=False)
    assert all(np.array_equal(a, np.asarray(b)) for e, f in zip(back, entries)
               for a, b in zip(e, f))


def _msm_case(g2, seed):
    """Points, 64-bit scalars and the host oracle's sum: lane 1 infinity
    (with another lane's real coordinates and a nonzero scalar), lane 0 a
    zero scalar, lanes 2 and 3 the same point, lane 6 P and lane 7 −P with
    equal scalars (they cancel)."""
    host = hcv.G2 if g2 else hcv.G1
    rnd = random.Random(seed)
    pts = [host.mul(host.generator, rnd.randrange(1, R))
           for _ in range(N_MSM)]
    ks = [rnd.randrange(1 << 64) for _ in range(N_MSM)]
    pts[3] = pts[2]
    pts[7] = host.neg(pts[6])
    ks[7] = ks[6]
    ks[0] = 0
    dead = pts[1]
    pts[1] = None
    want = None
    for p, k in zip(pts, ks):
        want = host.add(want, host.mul(p, k) if p is not None else None)
    return pts, ks, dead, want


def _scalars(ks):
    out = np.zeros((len(ks), 16), np.uint32)
    for i, k in enumerate(ks):
        for limb in range(4):
            out[i, limb] = (k >> (16 * limb)) & 0xFFFF
    return out


def _port_msm(g2, pts, ks, dead):
    from threshold_crypto_tpu_torch.device import pairing as dpr

    curve = dcv.G2 if g2 else dcv.G1
    aff = (dpr.g2_affine_from_host if g2 else dpr.g1_affine_from_host)(
        pts, device="cpu")
    # the dead lane carries a real point's coordinates: its digits must
    # be forced to 0 for the sum to come out right
    real = (dpr.g2_affine_from_host if g2 else dpr.g1_affine_from_host)(
        [dead], device="cpu")
    for dst, src in zip(dcv.leaves(aff[:2]), dcv.leaves(real[:2])):
        dst[1] = src[0]
    sc = torch.from_numpy(_scalars(ks).astype(np.int32))
    got = ccv.msm_pallas_shared(curve, aff, sc, nbits=64, accumulators=A)
    return curve.to_host_affine(dcv.tree_map(lambda a: a[None], got))[0]


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_msm_shared_matches_host_oracle(g2):
    pts, ks, dead, want = _msm_case(g2, 0xB11 + g2)
    counts = {k.name: k.count.launches for k in ccv.KERNELS}
    assert _port_msm(g2, pts, ks, dead) == want
    # CPU tensors never reach a kernel
    assert counts == {k.name: k.count.launches for k in ccv.KERNELS}
    assert cuda_mont.MUL.launches == cuda_mont.POW.launches == 0


def test_winacc_plain_owns_lanes_by_stride():
    """B11's plain version: accumulator j adds lanes j, j + A, … in that
    order; its partial sums add up to the whole MSM, and a digit of 0
    leaves an accumulator as it was."""
    host, curve = hcv.G1, dcv.G1
    rnd = random.Random(5)
    n, window = N_MSM, 3
    pts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(n)]
    base = ccv.pack_point(curve.from_host_affine(pts, device="cpu"))
    q = base[:48].contiguous()
    table = [base]
    for _ in range(6):
        table.append(ccv.p_madd(False, table[-1], q))
    table = torch.cat(table)
    digits = torch.from_numpy(np.random.default_rng(3).integers(
        0, 8, (5, n)).astype(np.int32))
    digits[:, A] = 0                          # lane 4: accumulator 0, block 1
    parts = curve.to_host_affine(ccv.unpack_jac(
        ccv.p_winacc(False, table, digits, A, window), False))
    for j in range(A):
        want = None
        for lane in range(j, n, A):
            k = 0
            for d in digits[:, lane].tolist():
                k = (k << window) | d
            want = host.add(want, host.mul(pts[lane], k))
        assert parts[j] == want, j


def _winacc_digit_case(g2, nblk=2, ndig=2):
    """A table of 7 entries of random canonical Fq limbs over nblk blocks of
    1024 lanes, and digits [ndig, N] with 0, 1..7 and, on lanes 0-63 of
    each window, 8, 9, 0x7fffffff and −1 (uint32 0xffffffff to JAX): digits
    outside 1..7, which the TPU's select chain reads as entry 0."""
    rng = np.random.default_rng(0xD16 + g2)
    n, k = nblk * ptw.TILE_ROWS * pcv.LANES, 6 if g2 else 3
    vals = rng.integers(0, 1 << 62, (7 * k * n, 7), dtype=np.uint64)
    limbs = np.zeros((7 * k * n, 24), np.uint32)
    for i, row in enumerate(vals):
        v = 0
        for word in row:
            v = (v << 62) | int(word)
        v %= P
        limbs[i] = [(v >> (16 * j)) & 0xFFFF for j in range(24)]
    comps = limbs.reshape(7 * k, n, 24)
    digits = rng.integers(0, 8, (ndig, n)).astype(np.int32)
    digits[:, :64] = np.array([8, 9, 0x7FFFFFFF, -1] * 16, np.int32)
    return comps, digits


def _winacc_jax_direct(g2, comps, digits):
    """The JAX DIRECT branch of ``pcv.msm_pallas_shared``: per window
    ``_dblw_impl`` once, then ``_selmadd_impl`` block by block (the
    fused kernel's select chain and complete add, run as jnp code)."""
    k, n = (6 if g2 else 3), comps.shape[1]
    nblk = n // (ptw.TILE_ROWS * pcv.LANES)
    pp = k * ptw.L
    tab = ptw.pack([jnp.asarray(c) for c in comps], n)          # [7pp, R, 128]
    tab_blocks = (tab.reshape(7 * pp, nblk, ptw.TILE_ROWS, pcv.LANES)
                  .transpose(1, 0, 2, 3))
    dig = jnp.asarray(digits.astype(np.uint32)).reshape(
        digits.shape[0], nblk, 1, ptw.TILE_ROWS, pcv.LANES)
    selmadd, dblw = pcv._selmadd_impl(g2, 7), pcv._dblw_impl(g2, 3)
    acc = pcv._packed_inf_jac(pp, ptw.TILE_ROWS)
    for w in range(digits.shape[0]):
        acc = dblw(acc)
        for j in range(nblk):
            acc = selmadd(acc, tab_blocks[j], dig[w, j])
    return [np.asarray(c) for c in ptw.unpack(acc, k, ptw.TILE_ROWS
                                              * pcv.LANES)]


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_winacc_plain_digit_rule_matches_jax(direct, g2):
    """B11's plain version at A = 1024 over two blocks, digits outside
    1..7 included, bit for bit against the JAX shared-window Horner chain
    (DIRECT mode)."""
    comps, digits = _winacc_digit_case(g2)
    want = _winacc_jax_direct(g2, comps, digits)
    table = pk.pack([torch.from_numpy(c.astype(np.int32)) for c in comps])
    got = ccv.p_winacc(g2, table, torch.from_numpy(digits), 1024, 3)
    for i, (g, w) in enumerate(zip(pk.unpack(got, len(want)), want)):
        assert np.array_equal(g.numpy().astype(np.uint32), w), i


# The fused TPU kernel ``pcv._winacc_impl`` in interpret mode, in a child
# process with XLA's fusion pass off (with it on the interpreted kernel
# compiles for hours; off, G1 at two blocks and two windows takes about a
# quarter of an hour on a small CPU host).
_WINACC_CHILD = """
import io, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from threshold_crypto_tpu.device import pallas_curve as pcv
from threshold_crypto_tpu.device import pallas_tower as ptw
inp = np.load(io.BytesIO(sys.stdin.buffer.read()))
comps, digits, g2 = inp["comps"], inp["digits"], bool(inp["g2"])
k, n = comps.shape[0] // 7, comps.shape[1]
nblk = n // (ptw.TILE_ROWS * pcv.LANES)
ptw.INTERPRET = True
tab = ptw.pack([jnp.asarray(c) for c in comps], n)
dig = jnp.asarray(digits.astype(np.uint32)).reshape(
    digits.shape[0], nblk, ptw.TILE_ROWS, pcv.LANES)
acc = pcv._winacc_impl(g2, 7, 3, digits.shape[0], nblk)(tab, dig)
buf = io.BytesIO()
np.savez(buf, *[np.asarray(c) for c in ptw.unpack(
    acc, k, ptw.TILE_ROWS * pcv.LANES)])
sys.stdout.buffer.write(buf.getvalue())
"""


@pytest.mark.slow
def test_winacc_plain_digit_rule_matches_jax_kernel_interpret():
    """The same in G1 against the fused TPU kernel ``_winacc_impl`` itself
    (Pallas interpret mode): its compile alone takes minutes."""
    comps, digits = _winacc_digit_case(False)
    buf = io.BytesIO()
    np.savez(buf, comps=comps, digits=digits, g2=False)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=fusion")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _WINACC_CHILD],
                          input=buf.getvalue(), capture_output=True, env=env,
                          cwd=root, timeout=3600)
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    out = np.load(io.BytesIO(proc.stdout))
    want = [out[f"arr_{i}"] for i in range(3)]
    table = pk.pack([torch.from_numpy(c.astype(np.int32)) for c in comps])
    got = ccv.p_winacc(False, table, torch.from_numpy(digits), 1024, 3)
    for i, (g, w) in enumerate(zip(pk.unpack(got, 3), want)):
        assert np.array_equal(g.numpy().astype(np.uint32), w), i


def _jax_msm(g2, pts, ks):
    jcurve = jcv.G2 if g2 else jcv.G1
    aff = (jpr.g2_affine_from_host if g2 else jpr.g1_affine_from_host)(pts)
    ptw.DIRECT = True
    try:
        got = pcv.msm_pallas_shared(jcurve, aff, jnp.asarray(_scalars(ks)),
                                    nbits=64, window=3)
    finally:
        ptw.DIRECT = False
    return jcurve.to_host_affine(jax.tree_util.tree_map(lambda a: a[None],
                                                        got))[0]


def test_msm_shared_g1_matches_jax():
    pts, ks, dead, want = _msm_case(False, 0xB11)
    assert _jax_msm(False, pts, ks) == want == _port_msm(False, pts, ks, dead)


@pytest.mark.slow
def test_msm_shared_g2_matches_jax():
    """The JAX side in G2 (DIRECT mode) runs for minutes on the CPU."""
    pts, ks, dead, want = _msm_case(True, 0xB12)
    assert _jax_msm(True, pts, ks) == want == _port_msm(True, pts, ks, dead)


def test_registry_lists_the_msm_kernels():
    msm = [k for k in ccv.KERNELS if k.source.endswith("csrc/msm.cu")]
    assert [k.name for k in msm] == ["g1_madd", "g2_madd", "g1_winacc",
                                     "g2_winacc"]
    assert ccv.KERNELS[:4] == tuple(msm)
    for k in msm:
        assert getattr(ccv, k.launch.__name__) is k.launch
        assert getattr(ccv, k.plain.__name__) is k.plain
        with pytest.raises(ValueError):
            if "madd" in k.name:
                k.launch(torch.zeros(72, 4, dtype=torch.int32),
                         torch.zeros(48, 4, dtype=torch.int32))
            else:
                k.launch(torch.zeros(504, 4, dtype=torch.int32),
                         torch.zeros(22, 4, dtype=torch.int32), 2, 3)
