"""The curve and SHA3 kernels' CUDA sources, compiled for the host, against
their plain versions and ``hashlib``.

The per-lane bodies of B10, B15 and B16 (``csrc/curve.cuh``: the
doubling, the complete add, the complete mixed add, the bit ladder of one
lane, and the gated table add and the w doublings of one accumulator
lane), of B11 and B13 (``csrc/ladder_engine.cuh``: the Horner loop of one
accumulator, the digit ladder of one lane) and of B12
(``csrc/keccak.cuh``) are plain C++ behind CUDA's
function qualifiers. Here g++ compiles them with the qualifiers defined
away, and a serial loop over the lanes (or accumulators, or chunks) stands
in for the grid: the same integer arithmetic the kernels run on the card,
on the packed layout, checked bit-exact against the plain versions
(``device/curve.py``, ``device/cuda_curve.py``, ``device/keccak.py``) on
seeded points with the special lanes T == Q, T == −Q and infinity on
either side (for the ladders: 16T == ±table[d − 1], 2T == ±Q, T at
infinity and digit or bit 0; for B11 T == Q followed by another add in
the same window and digits outside 1..7; for B16 the block's first lane
and a ragged last block whose padding has digit 0), and against
``hashlib.sha3_256``. Without g++ the tests skip
(the kernels themselves run only on the card, in ``chip_smoke.py``).
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
#include "curve.cuh"
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
  const size_t P = 3ul * tc::Comps<F>::k * 24;  // Jacobian rows
  std::vector<int32_t> out;
  if (op == 0) {  // madd
    auto acc = rd(P * n), q = rd(2 * P / 3 * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l)
      tc::madd_lane<F>(acc.data(), q.data(), out.data(), n, l);
  } else if (op == 1 || op == 2) {  // dbl, add
    auto a = rd(P * n);
    auto b = op == 2 ? rd(P * n) : std::vector<int32_t>();
    out.resize(P * n);
    for (int l = 0; l < n; ++l) {
      tc::Jac<F> T, Q;
      tc::load_jac(T, a.data(), 0, n, l);
      if (op == 1) {
        tc::jac_dbl(T, T);
      } else {
        tc::load_jac(Q, b.data(), 0, n, l);
        tc::jac_add(T, T, Q);
      }
      tc::store_jac(out.data(), T, n, l);
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
      tc::selmadd_lane<F>(acc.data(), table.data(), digits.data(),
                          out.data(), accs, n, window, start, j);
  } else if (op == 8) {  // dblw (B16)
    auto acc = rd(P * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l)
      tc::dblw_lane<F>(acc.data(), out.data(), n, window, l);
  } else if (op == 5) {  // step (B15): acc, q affine, bits
    auto acc = rd(P * n), q = rd(2 * P / 3 * n), bits = rd(ndig * n);
    out.resize(P * n);
    for (int l = 0; l < n; ++l)
      tc::step_lane<F>(acc.data(), q.data(), bits.data(), out.data(), n,
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
       "step4": 6, "selmadd": 7, "dblw": 8}
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


@pytest.mark.parametrize("window", [1, 3])
def test_dblw_body_matches_plain_version(harness, group, window):
    """B16's w doublings per lane, infinity lanes included."""
    curve, host, T, _ = group
    g2 = curve is dcv.G2
    rows = (6 if g2 else 3) * 24
    got = _run(harness, "dblw", g2, N, [ccv.pack_point(T)], (rows, N),
               window=window)
    want = ccv._dblw_ref(g2, ccv.pack_point(T), window)
    assert torch.equal(got, want)
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
