"""The ladder kernels B13 and B15 (plain versions), the ladder drivers and
the two entry points that run them, against the JAX package and the host
oracle.

On the CPU ``device.cuda_curve``'s dispatch runs each kernel's plain
version. B13's (``g1/g2_step4_ref``) and B15's (``g1/g2_step_ref``) are
held bit for bit against the JAX kernel bodies (``pallas_curve.
_g1/_g2_step4_impl`` and ``_g1/_g2_step_impl`` in DIRECT mode, as
``tests/test_pallas_curve.py`` runs them) on the special lanes: an infinite
accumulator, digit or bit 0, 16T == ±table[d − 1] and 2T == ±Q. The drivers
(``msm_pallas`` at window 1 and 4 with fold on and off,
``scalar_mul_pallas``, ``scalar_mul_fixed_pallas`` with a small k, k = 0
and the cofactor H2) are held against the host oracle and, in G1, against
the JAX ``scalar_mul_fixed_pallas`` as affine points (the tables are built
with other Jacobian coordinates there). ``ops.verify_with_hash_batch`` and
``ops.encrypt_batch_pallas`` are held against the constructed mask and the
host oracle. The JAX G2 ladders take minutes on XLA:CPU: they are
slow-marked and run in a child process with XLA's fusion pass off.
"""

import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threshold_crypto_tpu.device import curve as jcv
from threshold_crypto_tpu.device import pairing as jpr
from threshold_crypto_tpu.device import pallas_curve as pcv
from threshold_crypto_tpu.device import pallas_tower as ptw
from threshold_crypto_tpu_torch import convert, hashing, ops
from threshold_crypto_tpu_torch.device import cuda_curve as ccv
from threshold_crypto_tpu_torch.device import cuda_mont
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import packed as pk
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host import tower as htw
from threshold_crypto_tpu_torch.host.params import H2, P, R

N = 16


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


def _groups(g2):
    return (dcv.G2, hcv.G2) if g2 else (dcv.G1, hcv.G1)


def _jacobian(curve, pts, rnd):
    """Host affine points (None = infinity) -> Jacobian tuple with a random
    Z on every live lane."""
    mul = htw.fq_mul if curve is dcv.G1 else htw.fq2_mul
    one = 1 if curve is dcv.G1 else (1, 0)
    zero = 0 if curve is dcv.G1 else (0, 0)
    cols = ([], [], [])
    for p in pts:
        if p is None:
            x, y, z = one, one, zero
        else:
            z = rnd.randrange(2, P) if curve is dcv.G1 else \
                (rnd.randrange(P), rnd.randrange(P))
            z2 = mul(z, z)
            x, y = mul(p[0], z2), mul(p[1], mul(z2, z))
        for c, v in zip(cols, (x, y, z)):
            c.append(v)
    return tuple(curve.f.from_host(c, "cpu") for c in cols)


def _affine(curve, pts):
    pts = [curve.gen_affine_host if p is None else p for p in pts]
    return ccv.pack_point(tuple(curve.f.from_host([p[c] for p in pts], "cpu")
                                for c in range(2)))


def _case(g2, kind, seed):
    """(acc, table or q, digits [1, N]) with the special lanes: 0-3 acc at
    infinity, 4-7 digit (bit) 0, 8-11 table[d − 1] == 16T (Q == 2T),
    12-15 table[d − 1] == −16T (Q == −2T)."""
    curve, host = _groups(g2)
    rnd = random.Random(seed)
    ts = [None] * 4 + [host.mul(host.generator, rnd.randrange(1, R))
                       for _ in range(N - 4)]
    if kind == "step4":
        entries = [[host.mul(host.generator, rnd.randrange(1, R))
                    for _ in range(N)] for _ in range(15)]
        digits = [rnd.randrange(1, 16) for _ in range(N)]
        digits[4:8] = [0] * 4
        for i in range(8, 16):
            q = host.mul(ts[i], 16)
            entries[digits[i] - 1][i] = q if i < 12 else host.neg(q)
        other = torch.cat([ccv.pack_point(_jacobian(curve, e, rnd))
                           for e in entries])
    else:
        qs = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
        for i in range(8, 16):
            q = host.double(ts[i])
            qs[i] = q if i < 12 else host.neg(q)
        other = _affine(curve, qs)
        digits = [0 if 4 <= i < 8 else 1 for i in range(N)]
    acc = ccv.pack_point(_jacobian(curve, ts, rnd))
    return acc, other, torch.tensor([digits], dtype=torch.int32)


def _jax_packed(x):
    """The port's packed [m·24, N] -> the JAX packed [m·24, R, 128]."""
    arr = x.numpy().astype(np.uint32)
    comps = [jnp.asarray(arr[i * 24:(i + 1) * 24].T)
             for i in range(arr.shape[0] // 24)]
    return ptw.pack(comps, arr.shape[1])


def _jax_plane(digits):
    rows = ptw.pack_rows(N)
    plane = np.zeros(rows * 128, np.uint32)
    plane[:N] = digits[0].numpy()
    return jnp.asarray(plane.reshape(1, rows, 128))


@pytest.mark.parametrize("kind", ["step4", "step"])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_step_plain_matches_jax_kernel_body(direct, kind, g2):
    acc, other, digits = _case(g2, kind, 0x1AD + g2)
    impl = {("step4", False): pcv._g1_step4_impl,
            ("step4", True): pcv._g2_step4_impl,
            ("step", False): pcv._g1_step_impl,
            ("step", True): pcv._g2_step_impl}[kind, g2]
    jout = impl(_jax_packed(acc), _jax_packed(other), _jax_plane(digits))
    k = acc.shape[0] // 24
    want = [np.asarray(c) for c in ptw.unpack(jout, k, N)]
    plain = ccv.p_step4 if kind == "step4" else ccv.p_step
    got = plain(g2, acc, other, digits)
    for i, (g, w) in enumerate(zip(pk.unpack(got, k), want)):
        assert np.array_equal(g.numpy().astype(np.uint32), w), i
    curve, host = _groups(g2)
    pts = curve.to_host_affine(ccv.unpack_jac(got, g2))
    assert all(p is None for p in pts[12:16])          # 16T == −Q, 2T == −Q
    tin = curve.to_host_affine(ccv.unpack_jac(acc, g2))
    mult = 32 if kind == "step4" else 4                # 16T == Q, 2T == Q
    assert pts[8:12] == [host.mul(t, mult) for t in tin[8:12]]
    if kind == "step":                                 # T at infinity -> Q
        assert torch.equal(got[:2 * k * 8, :4], other[:, :4])


@pytest.mark.parametrize("kind", ["step4", "step"])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_multi_digit_plain_loop_equals_single_steps(kind, g2):
    acc, other, _ = _case(g2, kind, 7 + g2)
    top = 16 if kind == "step4" else 2
    digits = torch.from_numpy(np.random.default_rng(g2).integers(
        0, top, (5, N)).astype(np.int32))
    digits[:, 0] = 0
    digits[2, 1] = 17 if kind == "step4" else 0        # outside 1..15
    plain = ccv.p_step4 if kind == "step4" else ccv.p_step
    want = acc
    for d in digits:
        want = plain(g2, want, other, d[None].contiguous())
    assert torch.equal(plain(g2, acc, other, digits), want)


def _points(host, n, seed, dead=()):
    rnd = random.Random(seed)
    pts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(n)]
    for i in dead:
        pts[i] = None
    return pts, rnd


def _aff(g2, pts):
    return (dpr.g2_affine_from_host if g2 else dpr.g1_affine_from_host)(
        pts, device="cpu")


def _limbs(ks):
    out = np.zeros((len(ks), 16), np.int32)
    for i, k in enumerate(ks):
        for limb in range(16):
            out[i, limb] = (k >> (16 * limb)) & 0xFFFF
    return torch.from_numpy(out)


@pytest.mark.parametrize("k", [0, 1, 0x9A7])
def test_scalar_mul_fixed_matches_jax_g1(direct, k):
    pts, _ = _points(hcv.G1, 5, k & 0xFF, dead=(2,))
    got = dcv.G1.to_host_affine(ccv.scalar_mul_fixed_pallas(
        dcv.G1, _aff(False, pts), k))
    jout = pcv.scalar_mul_fixed_pallas(jcv.G1, jpr.g1_affine_from_host(pts),
                                       k)
    assert got == jcv.G1.to_host_affine(jout)
    assert got == [hcv.G1.mul(p, k) if p is not None else None for p in pts]


def test_scalar_mul_fixed_by_the_cofactor_matches_host():
    """H2's 127 digits on a point off the subgroup (x from the hash chain,
    before the cofactor) and on an infinity lane."""
    x = (5, 7)
    while hcv.G2.get_point_from_x(x, True) is None:
        x = (x[0] + 1, x[1])
    pts = [hcv.G2.get_point_from_x(x, True), None]
    got = dcv.G2.to_host_affine(ccv.scalar_mul_fixed_pallas(
        dcv.G2, _aff(True, pts), H2))
    assert got == [hcv.G2.mul(pts[0], H2), None]
    assert ccv.fixed_digits(H2)[0] != 0 and len(ccv.fixed_digits(H2)) == 127
    assert ccv.fixed_digits(0) == [0]


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_msm_and_scalar_mul_match_host(window, g2):
    """Per-lane products (fold off) and their sum (fold on) over 6 lanes:
    a dead lane with real coordinates and a nonzero scalar, a zero scalar,
    P and −P with equal scalars."""
    curve, host = _groups(g2)
    pts, rnd = _points(host, 6, 0x5E + window + g2)
    ks = [rnd.randrange(1 << 64) for _ in pts]
    ks[0] = 0
    pts[5] = host.neg(pts[4])
    ks[5] = ks[4]
    aff = _aff(g2, pts)
    for c in dcv.leaves(aff[:2]):
        c[1] = c[2]
    aff[2][1] = True                         # dead, with lane 2's point
    want = [None if i == 1 else host.mul(p, k)
            for i, (p, k) in enumerate(zip(pts, ks))]
    per = ccv.msm_pallas(curve, aff, _limbs(ks), nbits=64, window=window,
                         fold=False)
    assert curve.to_host_affine(per) == want
    total = ccv.msm_pallas(curve, aff, _limbs(ks), nbits=64, window=window)
    acc = None
    for w in want:
        acc = host.add(acc, w)
    assert curve.to_host_affine(dcv.tree_map(lambda a: a[None], total)) == \
        [acc]
    if window == 4:
        big = [rnd.randrange(R) for _ in pts]
        got = curve.to_host_affine(ccv.scalar_mul_pallas(curve, aff,
                                                         _limbs(big)))
        assert got == [None if i == 1 else host.mul(p, k)
                       for i, (p, k) in enumerate(zip(pts, big))]


def test_ladder_table_entries_are_the_multiples():
    pts, _ = _points(hcv.G2, 3, 11, dead=(1,))
    table = ccv._ladder_table(dcv.G2, _aff(True, pts))
    assert table.shape == (15 * 144, 3)
    back = convert.msm_table_to_jax(table, g2=True)
    assert len(back) == 15
    for j, entry in enumerate(back):
        e = convert.g2_jac_from_jax(*entry, device="cpu")
        got = dcv.G2.to_host_affine(e)
        assert got[0] == hcv.G2.mul(pts[0], j + 1)
        assert got[2] == hcv.G2.mul(pts[2], j + 1)
    assert dcv.G2.to_host_affine(convert.g2_jac_from_jax(
        *back[0], device="cpu"))[1] is None


def test_verify_with_hash_batch_equals_the_mask():
    """6 messages: valid, a swapped signature (False), an infinite pk
    (False), valid; attempts=1 sends about half the lanes to the host
    oracle's splice."""
    rnd = random.Random(0xBEEF)
    msgs = [b"vwh-%d" % i for i in range(6)]
    sks = [rnd.randrange(1, R) for _ in msgs]
    hs = [hashing.hash_g2(m).v for m in msgs]
    pks = [hcv.G1.mul(hcv.G1.generator, s) for s in sks]
    sigs = [hcv.G2.mul(h, s) for h, s in zip(hs, sks)]
    sigs[1], sigs[2] = sigs[2], sigs[1]
    pks[4] = None
    want = [True, False, False, True, False, True]
    before = [k.count.launches for k in (*cuda_mont.KERNELS, *ccv.KERNELS)]
    got = ops.verify_with_hash_batch(
        dpr.g1_affine_from_host(pks, device="cpu"), msgs,
        dpr.g2_affine_from_host(sigs, device="cpu"), attempts=1)
    assert isinstance(got, np.ndarray) and got.tolist() == want
    assert before == [k.count.launches
                      for k in (*cuda_mont.KERNELS, *ccv.KERNELS)]


def test_encrypt_batch_pallas_matches_host():
    rnd = random.Random(0xE2C)
    pk_pt = hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R))
    huv = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
           for _ in range(3)]
    r = [rnd.randrange(R) for _ in range(3)]
    r[2] = R - 1
    u, g, w = ops.encrypt_batch_pallas(
        dpr.g1_affine_from_host([pk_pt] * 3, device="cpu"), _limbs(r),
        dpr.g2_affine_from_host(huv, device="cpu"))
    assert dcv.G1.to_host_affine(u) == [hcv.G1.mul(hcv.G1.generator, k)
                                        for k in r]
    assert dcv.G1.to_host_affine(g) == [hcv.G1.mul(pk_pt, k) for k in r]
    assert dcv.G2.to_host_affine(w) == [hcv.G2.mul(h, k)
                                        for h, k in zip(huv, r)]


def test_ladder_wrappers_are_reached_through_the_module():
    """Every caller reaches B13/B15 through the module attributes (which
    chip_smoke.py replaces to count and time them), and a CPU tensor never
    reaches a kernel."""
    for k in [k for k in ccv.KERNELS if k.source.endswith("ladder.cu")]:
        assert getattr(ccv, k.launch.__name__) is k.launch
        assert getattr(ccv, k.plain.__name__) is k.plain
        rows = 144 if k.name.startswith("g2") else 72
        other = rows * 15 if "step4" in k.name else rows * 2 // 3
        with pytest.raises(ValueError):
            k.launch(torch.zeros(rows, 4, dtype=torch.int32),
                     torch.zeros(other, 4, dtype=torch.int32),
                     torch.zeros(1, 4, dtype=torch.int32))


_JAX_CHILD = r"""
import random, sys
from threshold_crypto_tpu.device import curve as jcv
from threshold_crypto_tpu.device import pairing as jpr
from threshold_crypto_tpu.device import pallas_curve as pcv
from threshold_crypto_tpu.device import pallas_tower as ptw
from threshold_crypto_tpu.host import curve as hcv
from threshold_crypto_tpu.host.params import R
import jax.numpy as jnp, numpy as np
ptw.DIRECT = True
seed, k, ks = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3:]
rnd = random.Random(seed)
pts = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R)) for _ in range(3)]
pts[1] = None
aff = jpr.g2_affine_from_host(pts)
print(jcv.G2.to_host_affine(pcv.scalar_mul_fixed_pallas(jcv.G2, aff, k)))
limbs = np.array([[(int(x) >> (16 * i)) & 0xFFFF for i in range(16)]
                  for x in ks], np.uint32)
for window in (1, 4):
    out = pcv.msm_pallas(jcv.G2, aff, jnp.asarray(limbs), nbits=64,
                         window=window, fold=False)
    print(jcv.G2.to_host_affine(out))
"""


@pytest.mark.slow
def test_g2_ladders_match_jax():
    """The JAX G2 ladders (DIRECT) run for minutes on XLA:CPU."""
    seed, k = 0x6A2, 0xABCDEF0123
    rnd = random.Random(seed)
    pts = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
           for _ in range(3)]
    pts[1] = None
    ks = [rnd.randrange(1 << 64) for _ in range(3)]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=fusion")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _JAX_CHILD, str(seed),
                           str(k), *map(str, ks)], capture_output=True,
                          env=env, cwd=root, timeout=3600, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    aff = _aff(True, pts)
    assert lines[0] == repr(dcv.G2.to_host_affine(
        ccv.scalar_mul_fixed_pallas(dcv.G2, aff, k)))
    for line, window in zip(lines[1:], (1, 4)):
        got = ccv.msm_pallas(dcv.G2, aff, _limbs(ks), nbits=64,
                             window=window, fold=False)
        assert line == repr(dcv.G2.to_host_affine(got))
