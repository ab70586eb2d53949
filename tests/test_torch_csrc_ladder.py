"""B13's register engine (``csrc/ladder_engine.cuh``), compiled for the
host, against Python ints and the plain versions.

The engine's carry chains and wide multiply-adds have two forms: inline
PTX on the card, and everywhere else the same arithmetic in plain C++ (the
carry flag a variable of ``tc::reg::Chain``, ``mad_wide`` a 64-bit
multiply-add). Here g++ compiles the header with CUDA's qualifiers defined
away, so the C++ form runs the engine's sequence of steps:

* ``fp_mul`` (CIOS in carry-save rounds, one carry chain and one
  conditional subtract at the end), ``fp_add`` and ``fp_sub`` against
  Python ints mod p, on 0, 1, p − 1,
  R mod p, 2^381 − 1 mod p and seeded values, every pair of them;
* the engine's doubling and complete add against ``device.curve``'s
  ``jac_dbl`` / ``jac_add``, bit-exact, on T at infinity, Q at infinity,
  T == Q (the add's doubling branch: the engine leaves T and asks for one
  more doubling), T == −Q (infinity) and both at infinity;
* B13's lane body ``step4_lane_r``, G1 and G2, bit-exact with
  ``g1_step4_ref`` / ``g2_step4_ref``: one digit on the special lanes
  (an infinite accumulator, digit 0, table[d − 1] == 16T, which must take
  the doubling branch, and table[d − 1] == −16T, which must give
  infinity), and 64 random digits with zeros and out-of-range digits
  (which read entry 0).

The PTX form runs only on the card: ``chip_smoke.py`` phase 3 holds B13
G1 and G2 bit-exact against their plain versions on the same special lanes
and on the paths' digits.
"""

import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from threshold_crypto_tpu_torch import _build
from threshold_crypto_tpu_torch.device import cuda_curve as ccv
from threshold_crypto_tpu_torch.device import curve as dcv
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
#include "ladder_engine.cuh"

// stdin: int32 op, g2, n, ndig, then the inputs; stdout: the output.
static std::vector<int32_t> rd(size_t count) {
  std::vector<int32_t> v(count);
  if (fread(v.data(), 4, count, stdin) != count) exit(3);
  return v;
}

template <class F>
void run(int op, int n, int ndig) {
  using Rf = typename tc::reg::Field<F>::type;
  constexpr int kc = tc::reg::Field<F>::k;
  const size_t P = 3ul * kc * 24;  // Jacobian rows
  std::vector<int32_t> out(P * n);
  if (op == 1 || op == 2) {  // dbl; add (and the doubling it asks for)
    auto a = rd(P * n);
    auto b = op == 2 ? rd(P * n) : std::vector<int32_t>();
    for (int l = 0; l < n; ++l) {
      tc::reg::Jac<Rf> T;
      tc::reg::f_load(T.X, a.data(), 0, n, l);
      tc::reg::f_load(T.Y, a.data(), kc, n, l);
      tc::reg::f_load(T.Z, a.data(), 2 * kc, n, l);
      int dbl = op == 1;
      if (op == 2) tc::reg::jac_add(T, b.data(), 0, kc, n, l, dbl);
      if (dbl) tc::reg::jac_dbl(T);
      tc::reg::f_store(out.data(), T.X, 0, n, l);
      tc::reg::f_store(out.data(), T.Y, kc, n, l);
      tc::reg::f_store(out.data(), T.Z, 2 * kc, n, l);
      out.push_back(op == 2 ? dbl : 0);
    }
  } else {  // step4: acc, table of 15, digits
    auto acc = rd(P * n), table = rd(15 * P * n), digits = rd(ndig * n);
    for (int l = 0; l < n; ++l)
      tc::step4_lane_r<F>(acc.data(), table.data(), digits.data(),
                          out.data(), n, ndig, l);
  }
  fwrite(out.data(), 4, out.size(), stdout);
}

int main() {
  int32_t h[4];
  if (fread(h, 4, 4, stdin) != 4) return 2;
  const int op = h[0], g2 = h[1], n = h[2];
  if (op == 0) {  // fp_mul, fp_add, fp_sub of n pairs of 12-word values
    auto a = rd(12ul * n), b = rd(12ul * n);
    std::vector<uint32_t> out(36ul * n);
    for (int l = 0; l < n; ++l) {
      tc::reg::Fp x, y, r;
      for (int j = 0; j < 12; ++j) {
        x.w[j] = static_cast<uint32_t>(a[12 * l + j]);
        y.w[j] = static_cast<uint32_t>(b[12 * l + j]);
      }
      tc::reg::fp_mul(r, x, y);
      for (int j = 0; j < 12; ++j) out[36 * l + j] = r.w[j];
      tc::reg::fp_add(r, x, y);
      for (int j = 0; j < 12; ++j) out[36 * l + 12 + j] = r.w[j];
      tc::reg::fp_sub(r, x, y);
      for (int j = 0; j < 12; ++j) out[36 * l + 24 + j] = r.w[j];
    }
    fwrite(out.data(), 4, out.size(), stdout);
  } else if (op == 4) {  // the engine's constants: p, R mod p, n0
    uint32_t c[25];
    for (int j = 0; j < 12; ++j) {
      c[j] = tc::reg::p_word(j);
      c[12 + j] = tc::reg::one_word(j);
    }
    c[24] = tc::reg::kN0;
    fwrite(c, 4, 25, stdout);
  } else if (g2) {
    run<tc::Fq2>(op, n, h[3]);
  } else {
    run<tc::Fq>(op, n, h[3]);
  }
  return 0;
}
"""

OPS = {"field": 0, "dbl": 1, "add": 2, "step4": 3, "constants": 4}
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
    d = tmp_path_factory.mktemp("csrc_ladder")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", _build.CSRC, str(src),
                    "-o", exe], check=True, capture_output=True, timeout=300)
    return exe


def _run(exe, op, g2, n, blobs, ndig=0):
    head = np.array([OPS[op], int(g2), n, ndig], np.int32).tobytes()
    proc = subprocess.run([exe], input=head + b"".join(blobs),
                          capture_output=True, timeout=120, check=True)
    return np.frombuffer(proc.stdout, np.uint32).copy()


def _words(x):
    return [(x >> (32 * j)) & 0xFFFFFFFF for j in range(12)]


def test_engine_constants_are_the_field_constants(harness):
    got = _run(harness, "constants", False, 0, []).tolist()
    assert got[:12] == _words(P)
    assert got[12:24] == _words((1 << 384) % P)
    assert got[24] == (-pow(P, -1, 1 << 32)) % (1 << 32)


def test_field_ops_match_python_ints(harness):
    """fp_mul = a·b·R⁻¹ mod p, fp_add, fp_sub, canonical, on every pair of
    the edge values and on seeded pairs."""
    rnd = random.Random(0x3E61)
    edge = [0, 1, P - 1, (1 << 384) % P, ((1 << 381) - 1) % P, P // 2,
            (P + 1) // 2]
    pairs = [(a, b) for a in edge for b in edge]
    pairs += [(rnd.randrange(P), rnd.randrange(P)) for _ in range(200)]
    pairs += [(P - 1 - rnd.randrange(1 << 40), rnd.randrange(P))
              for _ in range(20)]
    a = np.array([_words(x) for x, _ in pairs], np.uint32)
    b = np.array([_words(y) for _, y in pairs], np.uint32)
    got = _run(harness, "field", False, len(pairs),
               [a.tobytes(), b.tobytes()]).reshape(len(pairs), 3, 12)
    rinv = pow(1 << 384, -1, P)
    for (x, y), g in zip(pairs, got):
        vals = [sum(int(w) << (32 * j) for j, w in enumerate(row))
                for row in g]
        assert vals == [x * y * rinv % P, (x + y) % P, (x - y) % P]


def _jacobian(curve, pts, rnd):
    """Host affine points (None = infinity) as a Jacobian tuple with a
    random Z ≠ 1 on every live lane (X·z², Y·z³, z)."""
    mul = htw.fq_mul if curve is dcv.G1 else htw.fq2_mul
    one = 1 if curve is dcv.G1 else (1, 0)
    zero = 0 if curve is dcv.G1 else (0, 0)
    xs, ys, zs = [], [], []
    for p in pts:
        if p is None:
            xs.append(one), ys.append(one), zs.append(zero)
            continue
        z = rnd.randrange(2, P) if curve is dcv.G1 else \
            (rnd.randrange(P), rnd.randrange(P))
        z2 = mul(z, z)
        xs.append(mul(p[0], z2)), ys.append(mul(p[1], mul(z2, z)))
        zs.append(z)
    return tuple(curve.f.from_host(v, "cpu") for v in (xs, ys, zs))


def _bytes(t):
    return t.contiguous().numpy().tobytes()


@pytest.fixture(scope="module", params=["G1", "G2"])
def group(request):
    """(g2, curve, host group, rows, rnd)."""
    g2 = request.param == "G2"
    curve, host = (dcv.G2, hcv.G2) if g2 else (dcv.G1, hcv.G1)
    return g2, curve, host, (6 if g2 else 3) * 24, random.Random(0x5E4 + g2)


def test_doubling_and_complete_add_match_plain_versions(harness, group):
    """Lanes 0: T = inf; 1: Q = inf; 2: T == Q (other Z); 3: T == −Q;
    4: both inf; the rest random. The add asks for the doubling on lane 2
    alone, and with it the result is ``jac_add``'s, bit for bit."""
    g2, curve, host, rows, rnd = group
    ts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    qs = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(N)]
    ts[0] = qs[1] = ts[4] = qs[4] = None
    qs[2] = ts[2]
    qs[3] = host.neg(ts[3])
    T, Q = _jacobian(curve, ts, rnd), _jacobian(curve, qs, rnd)
    got = _run(harness, "dbl", g2, N, [_bytes(ccv.pack_point(T))])
    want = ccv.pack_point(dcv.jac_dbl(curve.f, T))
    assert np.array_equal(got[:rows * N].view(np.int32),
                          want.numpy().reshape(-1))
    got = _run(harness, "add", g2, N, [_bytes(ccv.pack_point(T)),
                                       _bytes(ccv.pack_point(Q))])
    want = dcv.jac_add(curve.f, T, Q)
    assert np.array_equal(got[:rows * N].view(np.int32),
                          ccv.pack_point(want).numpy().reshape(-1))
    assert got[rows * N:].tolist() == [int(i == 2) for i in range(N)]
    pts = curve.to_host_affine(want)
    assert pts[2] == host.double(ts[2]) and pts[3] is None
    assert pts[0] == qs[0] and pts[1] == ts[1] and pts[4] is None


def _step4_special(curve, host, rnd):
    """acc, a table of 15 entries and digits [1, N]: lanes 0-3 acc at
    infinity, 4-7 digit 0, 8-11 table[d − 1] == 16T, 12-15 == −16T."""
    ts = [None] * 4 + [host.mul(host.generator, rnd.randrange(1, R))
                       for _ in range(N - 4)]
    entries = [[host.mul(host.generator, rnd.randrange(1, R))
                for _ in range(N)] for _ in range(15)]
    digits = [rnd.randrange(1, 16) if not 4 <= i < 8 else 0
              for i in range(N)]
    for i in range(8, 16):
        q = host.mul(ts[i], 16)
        entries[digits[i] - 1][i] = q if i < 12 else host.neg(q)
    table = torch.cat([ccv.pack_point(_jacobian(curve, e, rnd))
                       for e in entries])
    return (ccv.pack_point(_jacobian(curve, ts, rnd)), table,
            torch.tensor([digits], dtype=torch.int32), ts)


def test_step4_body_on_special_lanes(harness, group):
    g2, curve, host, rows, rnd = group
    acc, table, digits, ts = _step4_special(curve, host, rnd)
    got = _run(harness, "step4", g2, N, [_bytes(acc), _bytes(table),
                                         _bytes(digits)], ndig=1)
    want = ccv.p_step4(g2, acc, table, digits)
    assert np.array_equal(got.view(np.int32), want.numpy().reshape(-1))
    pts = curve.to_host_affine(ccv.unpack_jac(want, g2))
    assert all(p is None for p in pts[12:16])                 # 16T − 16T
    assert pts[8:12] == [host.mul(t, 32) for t in ts[8:12]]   # doubling
    assert pts[4:8] == [host.mul(t, 16) for t in ts[4:8]]     # digit 0
    for i in range(4):                                        # 0 + Q
        d = int(digits[0, i])
        assert torch.equal(want[:, i], table[(d - 1) * rows:d * rows, i])


def test_step4_body_over_64_digits(harness, group):
    """64 random digits from random accumulators, zeros included, and on
    two lanes digits outside 1..15 (entry 0)."""
    g2, curve, host, rows, rnd = group
    n = 8
    ts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(n)]
    acc = ccv.pack_point(_jacobian(curve, ts, rnd))
    table = torch.cat([ccv.pack_point(_jacobian(
        curve, [host.mul(host.generator, rnd.randrange(1, R))
                for _ in range(n)], rnd)) for _ in range(15)])
    digits = torch.from_numpy(np.random.default_rng(64 + g2).integers(
        0, 16, (64, n)).astype(np.int32))
    digits[5, 1], digits[9, 2] = 17, -3
    got = _run(harness, "step4", g2, n, [_bytes(acc), _bytes(table),
                                         _bytes(digits)], ndig=64)
    want = ccv.p_step4(g2, acc, table, digits)
    assert np.array_equal(got.view(np.int32), want.numpy().reshape(-1))
