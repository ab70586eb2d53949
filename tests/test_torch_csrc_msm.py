"""The curve and SHA3 kernels' CUDA sources, compiled for the host, against
their plain versions and ``hashlib``.

The per-lane bodies of B10, B11, B13, B15, B16 and B19
(``csrc/ladder_engine.cuh``: the doubling, the complete add and the
complete mixed add ``jac_madd``, each with its T == Q case a branch into
the doubling, the mixed add of one lane, the Horner loop of one
accumulator, the digit and the bit ladder of one lane, the gated table
add and the w doublings of one accumulator lane, and one level of the
pairwise fold) and of B12
(``csrc/keccak.cuh``) are plain C++
behind CUDA's function qualifiers. Here g++ compiles them with the
qualifiers defined away, and a serial loop over the lanes (or
accumulators, or chunks) stands in for the grid: the same integer arithmetic the kernels run on the card,
on the packed layout, checked bit-exact against the plain versions
(``device/curve.py``, ``device/cuda_curve.py``, ``device/keccak.py``) on
seeded points with the special lanes T == Q, T == −Q and infinity on
either side (for the ladders: 16T == ±table[d − 1], 2T == ±Q, T at
infinity and digit or bit 0; for B15 also 2T == ±Q at a later bit, the
4T of 2T == Q before another bit or after the last, and 255 random bits;
for B10 also zero and p − 1 lanes, and the table builds' six and
fourteen launches from acc = Q with Z = 1; for B11 T == Q
followed by another add in the same window and digits outside 1..7; for
B16 the block's first lane, T == Q on the first lane of a later block,
digits outside 1..nent, a ragged last block whose padding has digit 0, and
0, 1 and 3 doublings; for B19 whole folds of 1, 2, 3, 43 and 87 entries,
T == Q, T == −Q and infinity on either side at the first level and T ==
Q at the second, a batch all at infinity, and a [4, 5, 7] batch over each
axis, against the torch tree ``fold_axis`` ran before B19), and against
``hashlib.sha3_256``. Without g++ the
tests skip (the kernels themselves run only on the card, in
``chip_smoke.py``).
"""

import hashlib
import random
import shutil
import subprocess

import chip_smoke
import numpy as np
import pytest
import torch

from threshold_crypto_tpu_torch import _build
from threshold_crypto_tpu_torch.device import cuda_curve as ccv
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import keccak as dk
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.device.mont import FQ
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host import tower as htw
from threshold_crypto_tpu_torch.host.params import P, R

HARNESS = r"""
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "keccak.cuh"
#include "ladder_engine.cuh"

// stdin: int32 op, g2, n, accs, ndig, window, start, then the inputs;
// stdout: the output.
static std::vector<int32_t> rd(size_t count) {
  std::vector<int32_t> v(count);
  if (fread(v.data(), 4, count, stdin) != count) exit(3);
  return v;
}

template <class F>
void run(int op, int n, int accs, int ndig, int window, int start) {
  using R = typename tc::reg::Field<F>::type;
  constexpr int kc = tc::reg::Field<F>::k;
  const size_t P = 3ul * kc * 24;  // Jacobian rows
  std::vector<int32_t> out;
  if (op == 0) {  // madd
    auto acc = rd(P * n), q = rd(2 * P / 3 * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l)
      tc::madd_lane_r<F>(acc.data(), q.data(), out.data(), n, l);
  } else if (op == 1) {  // dbl: the register engine's
    auto a = rd(P * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l) {
      tc::reg::Jac<R> T;
      tc::reg::f_load(T.X, a.data(), 0, n, l);
      tc::reg::f_load(T.Y, a.data(), kc, n, l);
      tc::reg::f_load(T.Z, a.data(), 2 * kc, n, l);
      tc::reg::jac_dbl(T);
      tc::reg::f_store(out.data(), T.X, 0, n, l);
      tc::reg::f_store(out.data(), T.Y, kc, n, l);
      tc::reg::f_store(out.data(), T.Z, 2 * kc, n, l);
    }
  } else if (op == 2) {  // add: the register engine's, 2T where it says
    auto a = rd(P * n), b = rd(P * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l) {
      tc::reg::Jac<R> T;
      tc::reg::f_load(T.X, a.data(), 0, n, l);
      tc::reg::f_load(T.Y, a.data(), kc, n, l);
      tc::reg::f_load(T.Z, a.data(), 2 * kc, n, l);
      int dbl = 0;
      tc::reg::jac_add(T, b.data(), 0, kc, n, l, dbl);
      if (dbl) tc::reg::jac_dbl(T);
      tc::reg::f_store(out.data(), T.X, 0, n, l);
      tc::reg::f_store(out.data(), T.Y, kc, n, l);
      tc::reg::f_store(out.data(), T.Z, 2 * kc, n, l);
    }
  } else if (op == 3) {  // winacc
    auto table = rd(((1ul << window) - 1) * P * n), digits = rd(ndig * n);
    out.resize(P * accs);
    for (int j = 0; j < accs; ++j)
      tc::winacc_lane_r<F>(table.data(), digits.data(), out.data(), n,
                           accs, ndig, window, j);
  } else if (op == 7) {  // selmadd (B16): acc [P, accs], table, digits
    auto acc = rd(P * accs), table = rd(window * P * n), digits = rd(n);
    out.resize(P * accs);
    for (int j = 0; j < accs; ++j)
      tc::selmadd_lane_r<F>(acc.data(), table.data(), digits.data(),
                            out.data(), accs, n, window, start, j);
  } else if (op == 8) {  // dblw (B16)
    auto acc = rd(P * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l)
      tc::dblw_lane_r<F>(acc.data(), out.data(), n, window, l);
  } else if (op == 9) {  // fold level (B19): in [P, n] -> out [P, accs]
    auto in = rd(P * n);
    out.resize(P * accs);
    for (int l = 0; l < accs; ++l)
      tc::fold_lane_r<F>(in.data(), out.data(), n, accs, l);
  } else if (op == 5) {  // step (B15): acc, q affine, bits
    auto acc = rd(P * n), q = rd(2 * P / 3 * n), bits = rd(ndig * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l)
      tc::step_lane_r<F>(acc.data(), q.data(), bits.data(), out.data(), n,
                         ndig, l);
  } else {  // step4 (B13): acc, table of 15, digits
    auto acc = rd(P * n), table = rd(15 * P * n), digits = rd(ndig * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l)
      tc::step4_lane_r<F>(acc.data(), table.data(), digits.data(),
                          out.data(), n, ndig, l);
  }
  fwrite(out.data(), 4, out.size(), stdout);
}

int main() {
  int32_t h[7];
  if (fread(h, 4, 7, stdin) != 7) return 2;
  const int op = h[0], g2 = h[1], n = h[2];
  if (op == 4) {  // sha3 chunks
    auto words = rd(544ul * n);
    std::vector<int32_t> out(8ul * n);
    for (int c = 0; c < n; ++c)
      tc::sha3_chunk_lane(words.data(), out.data(), c);
    fwrite(out.data(), 4, out.size(), stdout);
  } else if (g2) {
    run<tc::Fq2>(op, n, h[3], h[4], h[5], h[6]);
  } else {
    run<tc::Fq>(op, n, h[3], h[4], h[5], h[6]);
  }
  return 0;
}
"""

OPS = {"madd": 0, "dbl": 1, "add": 2, "winacc": 3, "sha3": 4, "step": 5,
       "step4": 6, "selmadd": 7, "dblw": 8, "fold": 9}
N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel sources for the host")
    d = tmp_path_factory.mktemp("csrc_msm")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", _build.CSRC, str(src),
                    "-o", exe], check=True, capture_output=True, timeout=300)
    return exe


def _run(exe, op, g2, n, ins, out_shape, accs=0, ndig=0, window=0,
         start=0):
    blob = np.array([OPS[op], int(g2), n, accs, ndig, window, start],
                    np.int32).tobytes()
    blob += b"".join(t.numpy().tobytes() for t in ins)
    proc = subprocess.run([exe], input=blob, capture_output=True,
                          timeout=120, check=True)
    flat = np.frombuffer(proc.stdout, np.int32).copy()
    return torch.from_numpy(flat.reshape(out_shape))


def _jacobian(curve, host, pts, rnd):
    """Host affine points (None = infinity) as a Jacobian tuple with a
    random Z ≠ 1 on every live lane (X·z², Y·z³, z)."""
    mul = htw.fq_mul if curve is dcv.G1 else htw.fq2_mul
    one = 1 if curve is dcv.G1 else (1, 0)
    xs, ys, zs = [], [], []
    for p in pts:
        if p is None:
            xs.append(one), ys.append(one), zs.append(0 if curve is dcv.G1
                                                      else (0, 0))
            continue
        z = rnd.randrange(2, P) if curve is dcv.G1 else \
            (rnd.randrange(P), rnd.randrange(P))
        z2 = mul(z, z)
        xs.append(mul(p[0], z2)), ys.append(mul(p[1], mul(z2, z)))
        zs.append(z)
    f = curve.f
    return tuple(f.from_host(v, "cpu") for v in (xs, ys, zs))


@pytest.fixture(scope="module", params=["G1", "G2"])
def group(request):
    """(curve, host group, T, Q): T and Q Jacobian [N] with the special lanes
    0: T = inf; 1: Q = inf; 2: T == Q; 3: T == −Q; 4: both inf."""
    g2 = request.param == "G2"
    curve, host = (dcv.G2, hcv.G2) if g2 else (dcv.G1, hcv.G1)
    rnd = random.Random(0xC0DE + g2)
    ts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    qs = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    ts[0] = None
    qs[1] = None
    qs[2] = ts[2]
    qs[3] = host.neg(ts[3])
    ts[4] = qs[4] = None
    return (curve, host, _jacobian(curve, host, ts, rnd),
            _jacobian(curve, host, qs, rnd))


def test_doubling_body_matches_plain_version(harness, group):
    curve, _, T, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    got = _run(harness, "dbl", g2, N, [ccv.pack_point(T)], (rows, N))
    assert torch.equal(got, ccv.pack_point(dcv.jac_dbl(curve.f, T)))


def test_complete_add_body_matches_plain_version(harness, group):
    curve, host, T, Q = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    got = _run(harness, "add", g2, N,
               [ccv.pack_point(T), ccv.pack_point(Q)], (rows, N))
    want = dcv.jac_add(curve.f, T, Q)
    assert torch.equal(got, ccv.pack_point(want))
    # and the sums are the host group's, special lanes included
    sums = curve.to_host_affine(want)
    hosts = [host.add(a, b) for a, b in zip(curve.to_host_affine(T),
                                            curve.to_host_affine(Q))]
    assert sums == hosts and sums[3] is None and sums[4] is None


def test_mixed_add_body_matches_plain_version(harness, group):
    curve, _, T, Q = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    # Q affine: lane 2 equals T, lane 3 is −T, lane 1 (infinity) carries
    # the generator, as ``from_host_affine`` places it
    pts = [curve.gen_affine_host if p is None else p
           for p in curve.to_host_affine(Q)]
    q = ccv.pack_point(tuple(curve.f.from_host([p[c] for p in pts], "cpu")
                             for c in range(2)))
    got = _run(harness, "madd", g2, N, [ccv.pack_point(T), q], (rows, N))
    want = ccv._madd_ref(g2, ccv.pack_point(T), q)
    assert torch.equal(got, want)
    pts = curve.to_host_affine(ccv.unpack_jac(want, g2))
    assert pts[3] is None and pts[2] is not None


def test_mixed_add_body_on_edge_lanes(harness, group):
    """B10's lane body on ``chip_smoke.madd_inputs``' lanes (T at infinity,
    T == Q with Z = 1, T == −Q, everything zero) and lanes of p − 1 in
    every component of acc, of q or of both, the rest random values."""
    curve, _, _, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    n = 24
    gen = torch.Generator()
    gen.manual_seed(0xB10 + g2)
    acc, q = chip_smoke.madd_inputs(g2, n, gen, "cpu")
    pm1 = mont.limbs_from_int(FQ, FQ.p - 1)
    for x, lanes in ((acc, (16, 18)), (q, (17, 18))):
        for lane in lanes:
            x[:, lane] = torch.from_numpy(np.tile(pm1, x.shape[0] // FQ.L))
    got = _run(harness, "madd", g2, n, [acc, q], (rows, n))
    want = ccv._madd_ref(g2, acc, q)
    assert torch.equal(got, want)
    z = want[2 * rows // 3:]
    assert not bool(z[:, 8:12].any())                   # T == −Q
    assert all(bool(z[:, lane].any()) for lane in range(4, 8))  # 2T


def test_mixed_add_body_builds_the_table(harness, group):
    """The table build of ``msm_pallas_shared``: six launches from acc = Q
    with Z = 1 (the first takes the doubling branch on every lane), P to
    7P, bit-exact with ``p_madd``'s chain, and the host's multiples."""
    curve, host, _, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    rnd = random.Random(0x7AB + g2)
    pts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    q = _affine(curve, pts)
    acc = torch.cat([q, ccv.pk._one_rows(2 if g2 else 1, N, "cpu")])
    want = acc
    for i in range(2, 8):
        acc = _run(harness, "madd", g2, N, [acc, q], (rows, N))
        want = ccv.p_madd(g2, want, q)
        assert torch.equal(acc, want)
        assert curve.to_host_affine(ccv.unpack_jac(acc, g2)) == [
            host.mul(p, i) for p in pts]


@pytest.mark.parametrize("accs", [1, 3, 5])
def test_winacc_body_matches_plain_version(harness, group, accs):
    """The Horner loop of each accumulator over 2 windows of w = 3 (and a
    ragged last block of lanes), bit-exact with the plain version."""
    curve, _, T, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    n, window, ndig = 11, 3, 4
    rng = np.random.default_rng(accs)
    table = torch.cat([ccv.pack_point(T)[:, i:i + n] for i in range(5)]
                      + [ccv.pack_point(T)[:, :n]] * 2)
    digits = torch.from_numpy(rng.integers(0, 8, (ndig, n)).astype(np.int32))
    digits[:, 0] = 0
    got = _run(harness, "winacc", g2, n, [table.contiguous(), digits],
               (rows, accs), accs=accs, ndig=ndig, window=window)
    want = ccv._winacc_ref(g2, table, digits, accs, window)
    assert torch.equal(got, want)


def test_winacc_body_matches_plain_version_on_special_lanes(harness, group):
    """The Horner loop on the special lanes of
    ``chip_smoke.winacc_special_points`` (T == Q followed by another add in
    the same window, T == −Q, infinity on either side, dead lanes, digits
    outside 1..7, a ragged last block), bit-exact with the plain version,
    whose partial sums equal the host's."""
    curve, host, _, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    rnd = random.Random(0xB11 + g2)
    entries, digits, sums = chip_smoke.winacc_special_points(host, rnd)
    n, A = len(digits[0]), chip_smoke.WINACC_SPECIAL_A
    table = torch.cat([ccv.pack_point(_jacobian(curve, host, e, rnd))
                       for e in entries]).contiguous()
    digits = torch.tensor(digits, dtype=torch.int32)
    got = _run(harness, "winacc", g2, n, [table, digits], (rows, A),
               accs=A, ndig=2, window=3)
    want = ccv._winacc_ref(g2, table, digits, A, 3)
    assert torch.equal(got, want)
    assert curve.to_host_affine(ccv.unpack_jac(want, g2)) == sums
    assert sums[3] is None and sums[0] is not None


def _affine(curve, pts):
    """Host affine points (None: the generator's coordinates) -> packed
    affine [2k·24, n]."""
    pts = [curve.gen_affine_host if p is None else p for p in pts]
    return ccv.pack_point(tuple(curve.f.from_host([p[c] for p in pts], "cpu")
                                for c in range(2)))


def _ladder_case(curve, host, kind, rnd):
    """Inputs of one ladder kernel over N lanes with its special lanes.

    step4: acc, a table of 15 entries, digits [1, N]: lanes 0-3 acc at
    infinity, 4-7 digit 0, 8-11 table[d − 1] == 16T, 12-15 == −16T.
    step: acc, q affine, bits [1, N]: lanes 0-3 T at infinity, 4-7 bit 0,
    8-11 Q == 2T, 12-15 Q == −2T. The other lanes are random points; every
    point has a random Z."""
    ts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    for i in range(4):
        ts[i] = None
    if kind == "step4":
        entries = [[host.mul(host.generator, rnd.randrange(1, R))
                    for _ in range(N)] for _ in range(15)]
        digits = [rnd.randrange(1, 16) for _ in range(N)]
        for i in range(4, 8):
            digits[i] = 0
        for i in range(8, 16):
            q = host.mul(ts[i], 16)
            entries[digits[i] - 1][i] = q if i < 12 else host.neg(q)
        table = torch.cat([ccv.pack_point(_jacobian(curve, host, e, rnd))
                           for e in entries])
        return (ccv.pack_point(_jacobian(curve, host, ts, rnd)), table,
                torch.tensor([digits], dtype=torch.int32))
    qs = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    bits = [1] * N
    for i in range(4, 8):
        bits[i] = 0
    for i in range(8, 16):
        q = host.double(ts[i])
        qs[i] = q if i < 12 else host.neg(q)
    return (ccv.pack_point(_jacobian(curve, host, ts, rnd)), _affine(curve, qs),
            torch.tensor([bits], dtype=torch.int32))


@pytest.mark.parametrize("kind", ["step4", "step"])
def test_ladder_body_matches_plain_version_on_special_lanes(harness, group,
                                                            kind):
    """One ladder step (B13, B15) on the special lanes, bit-exact with the
    plain version; 16T == −table[d − 1] and 2T == −Q give infinity, and an
    infinite accumulator gives table[d − 1] (or Q) exactly."""
    curve, host, _, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    rnd = random.Random(0x1AD + g2)
    acc, other, digits = _ladder_case(curve, host, kind, rnd)
    got = _run(harness, kind, g2, N, [acc, other.contiguous(), digits],
               (rows, N), ndig=1)
    plain = ccv.p_step4 if kind == "step4" else ccv.p_step
    want = plain(g2, acc, other, digits)
    assert torch.equal(got, want)
    pts = curve.to_host_affine(ccv.unpack_jac(want, g2))
    tin = curve.to_host_affine(ccv.unpack_jac(acc, g2))
    assert all(p is None for p in pts[12:16])
    if kind == "step4":
        entry = [ccv.unpack_jac(other[(d - 1) * rows:d * rows], g2)
                 for d in range(1, 16)]
        for i in range(4):
            d = int(digits[0, i])
            assert torch.equal(want[:, i], ccv.pack_point(entry[d - 1])[:, i])
        assert pts[4:8] == [host.mul(t, 16) for t in tin[4:8]]
        assert pts[8:12] == [host.mul(t, 32) for t in tin[8:12]]
    else:
        assert torch.equal(want[:2 * rows // 3, :4], other[:, :4])
        assert pts[4:8] == [host.double(t) for t in tin[4:8]]
        assert pts[8:12] == [host.mul(t, 4) for t in tin[8:12]]


@pytest.mark.parametrize("kind", ["step4", "step"])
def test_ladder_loop_matches_plain_version(harness, group, kind):
    """The digit (bit) loop inside the thread over D = 6 steps with random
    digits, zeros included, from random accumulators."""
    curve, host, T, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    rnd = random.Random(0x100 + g2)
    acc, other, _ = _ladder_case(curve, host, kind, rnd)
    acc = ccv.pack_point(T)
    top = 16 if kind == "step4" else 2
    digits = torch.from_numpy(np.random.default_rng(g2).integers(
        0, top, (6, N)).astype(np.int32))
    got = _run(harness, kind, g2, N, [acc, other.contiguous(), digits],
               (rows, N), ndig=6)
    plain = ccv.p_step4 if kind == "step4" else ccv.p_step
    assert torch.equal(got, plain(g2, acc, other, digits))


def test_step_body_on_special_lanes_over_several_bits(harness, group):
    """B15's bit loop (``step_lane_r``) over three bits on
    ``chip_smoke.step_special_points``, every T with a random Z: 2T == Q at
    a bit after the first takes the doubling branch (its 4T before the
    next bit's doubling, or after the last bit), 2T == −Q gives infinity,
    an infinite accumulator then a set bit gives Q with Z = 1; bit-exact
    with the plain version and equal to the host's points."""
    curve, host, _, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    rnd = random.Random(0xB15 + g2)
    ts, qs, bits, host_want = chip_smoke.step_special_points(host, rnd)
    acc = ccv.pack_point(_jacobian(curve, host, ts, rnd))
    q = _affine(curve, qs)
    bits = torch.tensor(bits, dtype=torch.int32)
    got = _run(harness, "step", g2, N, [acc, q, bits], (rows, N), ndig=3)
    want = ccv.p_step(g2, acc, q, bits)
    assert torch.equal(got, want)
    assert curve.to_host_affine(ccv.unpack_jac(want, g2)) == host_want
    one = ccv.pk._one_rows(2 if g2 else 1, 2, "cpu")
    assert torch.equal(want[:, 6:8], torch.cat([q[:, 6:8], one]))


def test_step_body_over_255_random_bits(harness, group):
    """B15's bit loop over 255 random bits (the combine's λ width) from
    random accumulators (lanes 0 and 4 at infinity) and random Q, against
    ``g1_step_ref`` / ``g2_step_ref`` and the host's 2^255·T + k·Q."""
    curve, host, T, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    rnd = random.Random(0x255 + g2)
    qs = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    q = _affine(curve, qs)
    bits = torch.from_numpy(np.random.default_rng(0x255 + g2).integers(
        0, 2, (255, N)).astype(np.int32))
    acc = ccv.pack_point(T)
    got = _run(harness, "step", g2, N, [acc, q, bits], (rows, N), ndig=255)
    want = (ccv.g2_step_ref if g2 else ccv.g1_step_ref)(acc, q, bits)
    assert torch.equal(got, want)
    pts = curve.to_host_affine(ccv.unpack_jac(want, g2))
    tin = curve.to_host_affine(T)
    for i in (0, 1, 4, 9):
        k = int("".join(str(int(b)) for b in bits[:, i]), 2)
        t = None if tin[i] is None else host.mul(tin[i], 1 << 255)
        assert pts[i] == host.add(t, host.mul(qs[i], k))


def test_mixed_add_body_builds_the_ladder_table(harness, group):
    """The table of B13's ladders (1P..15P): fourteen launches of
    ``madd_lane_r`` over the shared ``jac_madd`` from acc = Q with Z = 1
    (the first takes the doubling branch on every lane), bit-exact with
    ``p_madd``'s chain, and the host's multiples."""
    curve, host, _, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    rnd = random.Random(0x15AB + g2)
    pts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(4)]
    q = _affine(curve, pts)
    acc = torch.cat([q, ccv.pk._one_rows(2 if g2 else 1, 4, "cpu")])
    want = acc
    for i in range(2, 16):
        acc = _run(harness, "madd", g2, 4, [acc, q], (rows, 4))
        want = ccv.p_madd(g2, want, q)
        assert torch.equal(acc, want)
    assert curve.to_host_affine(ccv.unpack_jac(acc, g2)) == [
        host.mul(p, 15) for p in pts]


@pytest.mark.parametrize("nent", [1, 7])
def test_selmadd_body_matches_plain_version(harness, group, nent):
    """B16's gated table add over the blocks of A = 6 accumulator lanes of
    N = 14 table lanes (the last block ragged: its padding has digit 0),
    with window 1's one entry and window 3's seven: lanes 0-4 of each block
    hold T at infinity, Q at infinity, T == Q, T == −Q and both at infinity
    (Q the entry the lane's digit selects), lane 5 digit 0."""
    curve, host, T, Q = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    A, n = 6, 14
    rng = np.random.default_rng(nent)
    tp, qp = ccv.pack_point(T), ccv.pack_point(Q)
    acc = tp[:, :A].contiguous()
    for start in range(0, n, A):
        digits = torch.from_numpy(
            rng.integers(1, nent + 1, n).astype(np.int32))
        entries = [qp[:, torch.from_numpy(rng.integers(5, N, n))]
                   for _ in range(nent)]
        for j in range(min(A, n - start)):
            if j == 5:
                digits[start + j] = 0
            else:
                entries[int(digits[start + j]) - 1][:, start + j] = qp[:, j]
        table = torch.cat(entries).contiguous()
        got = _run(harness, "selmadd", g2, n, [acc, table, digits],
                   (rows, A), accs=A, window=nent, start=start)
        want = ccv._selmadd_ref(g2, acc, table, digits, start)
        assert torch.equal(got, want)
        pts = curve.to_host_affine(ccv.unpack_jac(want, g2))
        tin = curve.to_host_affine(ccv.unpack_jac(acc, g2))
        live = min(A, n - start)
        assert torch.equal(want[:, live:], acc[:, live:])   # padding
        if live == A:
            assert pts[3] is None and pts[4] is None
            assert pts[2] == host.double(tin[2])
            assert torch.equal(want[:, 5], acc[:, 5])       # digit 0


def test_selmadd_body_reads_entry_0_for_digits_out_of_range(harness, group):
    """A digit outside 1..nent (nent + 1, 8, 100, −1, −7) selects entry 0,
    as the TPU's select chain does: against the plain version and the
    host's T + entry 0, with window 3's seven entries."""
    curve, host, T, Q = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    nent, A, n = 7, 8, 8
    rng = np.random.default_rng(0xD16)
    acc = ccv.pack_point(T)[:, 5:5 + A].contiguous()
    qp = ccv.pack_point(Q)
    table = torch.cat([qp[:, torch.from_numpy(rng.integers(5, N, n))]
                       for _ in range(nent)]).contiguous()
    digits = torch.tensor([nent + 1, 8, 100, -1, -7, 3, 0, 1],
                          dtype=torch.int32)
    got = _run(harness, "selmadd", g2, n, [acc, table, digits], (rows, A),
               accs=A, window=nent)
    want = ccv._selmadd_ref(g2, acc, table, digits, 0)
    assert torch.equal(got, want)
    pts = curve.to_host_affine(ccv.unpack_jac(want, g2))
    tin = curve.to_host_affine(ccv.unpack_jac(acc, g2))
    entry0 = curve.to_host_affine(ccv.unpack_jac(table[:rows], g2))
    assert pts[:5] == [host.add(t, e) for t, e in zip(tin[:5], entry0[:5])]
    assert torch.equal(want[:, 6], acc[:, 6])           # digit 0


def test_selmadd_body_doubles_on_the_first_lane_of_a_later_block(harness,
                                                                 group):
    """T == Q on lane 0 of the blocks that start at A and 2A (the add's
    doubling branch where ``start`` is not 0), beside random lanes:
    against the plain version and the host's 2T."""
    curve, host, T, Q = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    A, n = 4, 12
    rng = np.random.default_rng(0xB16)
    acc = ccv.pack_point(T)[:, 5:5 + A].contiguous()
    qp = ccv.pack_point(Q)
    for start in (A, 2 * A):
        digits = torch.from_numpy(rng.integers(1, 4, n).astype(np.int32))
        entries = [qp[:, torch.from_numpy(rng.integers(5, N, n))]
                   for _ in range(3)]
        entries[int(digits[start]) - 1][:, start] = acc[:, 0]
        table = torch.cat(entries).contiguous()
        got = _run(harness, "selmadd", g2, n, [acc, table, digits],
                   (rows, A), accs=A, window=3, start=start)
        want = ccv._selmadd_ref(g2, acc, table, digits, start)
        assert torch.equal(got, want)
        pts = curve.to_host_affine(ccv.unpack_jac(want, g2))
        tin = curve.to_host_affine(ccv.unpack_jac(acc, g2))
        assert pts[0] == host.double(tin[0])


@pytest.mark.parametrize("window", [1, 3, 0])
def test_dblw_body_matches_plain_version(harness, group, window):
    """B16's w doublings per lane, infinity lanes included; at window 0
    the accumulator unchanged."""
    curve, host, T, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    got = _run(harness, "dblw", g2, N, [ccv.pack_point(T)], (rows, N),
               window=window)
    want = ccv._dblw_ref(g2, ccv.pack_point(T), window)
    assert torch.equal(got, want)
    if window == 0:
        assert torch.equal(got, ccv.pack_point(T))
    assert curve.to_host_affine(ccv.unpack_jac(want, g2)) == [
        None if t is None else host.mul(t, 1 << window)
        for t in curve.to_host_affine(T)]


def test_sha3_body_matches_hashlib_and_plain_version(harness):
    rng = np.random.default_rng(12)
    words = rng.integers(0, 1 << 32, (5, 544), dtype=np.uint64).astype(
        np.uint32)
    words[0] = 0
    got = _run(harness, "sha3", False, 5,
               [torch.from_numpy(words.view(np.int32))], (5, 8))
    for i in range(5):
        assert got[i].numpy().tobytes() == \
            hashlib.sha3_256(words[i].tobytes()).digest()
    assert torch.equal(got, dk.sha3_256_chunks(
        torch.from_numpy(words.view(np.int32))))


# ---------------------------------------------------------------------------
# B19: one level of the pairwise fold
# ---------------------------------------------------------------------------

def _torch_tree(curve, pts, axis):
    """The pairwise tree as ``DeviceCurve.fold_axis`` ran it in torch ops
    before B19: per level one stacked ``jac_add`` of the first half of the
    entries to the second, an odd level padded with infinity at its end."""
    pts = dcv.tree_map(lambda a: a.movedim(axis, 0), pts)
    n = curve.f.shape(pts[2])[0]
    while n > 1:
        if n % 2:
            pad = curve.infinity((1,) + tuple(curve.f.shape(pts[2])[1:]),
                                 "cpu")
            pts = dcv.tree_map(lambda a, b: torch.cat([a, b]), pts, pad)
            n += 1
        half = n // 2
        pts = dcv.jac_add(curve.f, dcv.tree_map(lambda a: a[:half], pts),
                          dcv.tree_map(lambda a: a[half:], pts))
        n = half
    return dcv.tree_map(lambda a: a[0], pts)


def _harness_level(exe, g2):
    """One fold level (``p_fold_level``'s arguments) run by the lane body,
    a serial loop over the output lanes."""
    rows = (6 if g2 else 3) * 24

    def level(pts, rest):
        half = ccv.fold_half(pts.shape[1], rest)
        return _run(exe, "fold", g2, pts.shape[1], [pts], (rows, half),
                    accs=half)
    return level


def _harness_fold(exe, curve, pts, axis, monkeypatch):
    """``curve.fold_axis`` with every level run by the lane body; returns
    the sums and the number of levels."""
    level = _harness_level(exe, curve is dcv.G2)
    calls = []

    def run(g2, packed, rest):
        calls.append(packed.shape[1])
        return level(packed, rest)

    with monkeypatch.context() as m:
        m.setattr(ccv, "p_fold_level", run)
        out = curve.fold_axis(pts, axis)
    return out, len(calls)


def _fold_entries(curve, host, entries, shape, rnd):
    """Host points (None: infinity) in row-major order -> a Jacobian batch
    of ``shape``: a random Z on every live entry, and random X and Y on
    the infinite ones (Z = 0), so that the selects' choice of limbs shows."""
    pts = _jacobian(curve, host, entries, rnd)
    live = [p for p in entries if p is not None] or [host.generator]
    filler = _jacobian(curve, host, [rnd.choice(live) for _ in entries],
                       rnd)
    inf = torch.tensor([p is None for p in entries])
    pts = (*(dcv.tree_map(lambda a, b: torch.where(inf[:, None], b, a),
                          pts[c], filler[c]) for c in range(2)), pts[2])
    return dcv.tree_map(lambda a: a.reshape(tuple(shape) + a.shape[1:]), pts)


def _walk(host, count, rnd):
    """count distinct points a + i·b of the group."""
    a = host.mul(host.generator, rnd.randrange(1, R))
    b = host.mul(host.generator, rnd.randrange(1, R))
    out = [a]
    for _ in range(count - 1):
        out.append(host.add(out[-1], b))
    return out


def _host_sums(curve, host, entries, shape, axis):
    """The host group's sums of a row-major batch over ``axis``."""
    idx = np.arange(len(entries)).reshape(shape)
    idx = np.moveaxis(idx, axis, 0).reshape(shape[axis], -1)
    sums = []
    for col in idx.T:
        acc = None
        for i in col:
            acc = host.add(acc, entries[i])
        sums.append(acc)
    return sums


def _check_fold(harness, curve, host, entries, shape, axis, rnd,
                monkeypatch):
    """The lane body's fold equals the plain versions' and the torch
    tree's limb for limb, and the host's sums."""
    pts = _fold_entries(curve, host, entries, shape, rnd)
    got, levels = _harness_fold(harness, curve, pts, axis, monkeypatch)
    plain = curve.fold_axis(pts, axis)
    tree = _torch_tree(curve, pts, axis)
    for g, p, t in zip(dcv.leaves(got), dcv.leaves(plain), dcv.leaves(tree)):
        assert torch.equal(g, t) and torch.equal(p, t)
    assert levels == (shape[axis] - 1).bit_length()
    flat = dcv.tree_map(lambda a: a.reshape(-1, a.shape[-1]), got)
    assert curve.to_host_affine(flat) == _host_sums(curve, host, entries,
                                                    shape, axis)
    return got


@pytest.mark.parametrize("n", [1, 2, 3, 43, 87])
def test_fold_body_matches_the_torch_tree(harness, group, n, monkeypatch):
    """``fold_axis`` over n entries (odd levels among them), every level
    run by B19's lane body: entry 1 (and 40) at infinity with random X and
    Y; bit-exact with the plain versions, the torch tree and the host's
    sum. n = 1 runs no level."""
    curve, host, _, _ = group
    rnd = random.Random(0xF01D + n)
    entries = _walk(host, n, rnd)
    for i in (1, 40):
        if i < n:
            entries[i] = None
    _check_fold(harness, curve, host, entries, (n,), 0, rnd, monkeypatch)


def test_fold_body_pads_a_lone_entry(harness, group):
    """One level over a single entry of 6 lanes (every partner the
    padding): a live lane stays as it is, a lane at infinity with random
    X and Y becomes the padding (1, 1, 0), as the plain version's select
    gives."""
    curve, host, _, _ = group
    g2 = curve is dcv.G2
    rnd = random.Random(0xF1)
    entries = _walk(host, 6, rnd)
    entries[2] = entries[4] = None
    pts = ccv.pack_point(_fold_entries(curve, host, entries, (6,), rnd))
    got = _harness_level(harness, g2)(pts, 6)
    want = ccv._fold_level_ref(g2, pts, 6)
    assert torch.equal(got, want)
    inf = ccv.packed_infinity(g2, 1, "cpu")[:, 0]
    for lane in range(6):
        assert torch.equal(got[:, lane], inf if lane in (2, 4)
                           else pts[:, lane])


def test_fold_body_on_special_pairs(harness, group, monkeypatch):
    """A [6, 6] batch over axis 0 (levels of 6, 3 and 2 entries; the
    second pads): batch 0 pairs T == Q (entry 3 = entry 0, another Z),
    T == −Q (4 = −1) and T at infinity (2) at the first level; batch 1 Q
    at infinity (3) and both at infinity (1, 4); batch 2 T == Q at the
    second level (2 = 0 and 5 = 3); batch 3 entirely at infinity; batch 4
    the doubling at both levels (entries a, b, a, a, b, a); batch 5
    random."""
    curve, host, _, _ = group
    rnd = random.Random(0x5BEC)
    cols = [_walk(host, 6, rnd) for _ in range(6)]
    a, b = cols[0][0], cols[0][1]
    cols[0][3], cols[0][4], cols[0][2] = a, host.neg(b), None
    cols[1][3] = cols[1][1] = cols[1][4] = None
    cols[2][2], cols[2][5] = cols[2][0], cols[2][3]
    cols[3] = [None] * 6
    cols[4] = [a, b, a, a, b, a]
    entries = [cols[c][f] for f in range(6) for c in range(6)]
    got = _check_fold(harness, curve, host, entries, (6, 6), 0, rnd,
                      monkeypatch)
    assert curve.to_host_affine(dcv.tree_map(lambda a: a[3:4], got)) == [
        None]


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fold_body_over_each_axis_of_a_batch(harness, group, axis,
                                             monkeypatch):
    """A [4, 5, 7] batch folded over each of its axes, as the DKG folds
    its row commitments over axis 2 and its value commitments over axis 1;
    three entries at infinity."""
    curve, host, _, _ = group
    rnd = random.Random(0xA215 + axis)
    entries = _walk(host, 140, rnd)
    for i in (3, 50, 139):
        entries[i] = None
    _check_fold(harness, curve, host, entries, (4, 5, 7), axis, rnd,
                monkeypatch)
