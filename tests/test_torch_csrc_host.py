"""The tower kernels' CUDA sources, compiled for the host, against their plain
PyTorch versions.

The old per-lane bodies of B3-B5, B8 and B9 live in ``csrc/tower.cuh``
over the engine of ``csrc/fq.cuh``, those of B6 and B7 in the lane-group
engine ``csrc/tower_group.cuh``, and B3's test entry on the register
engine (``csrc/ladder_engine.cuh`` ``engine_lane_r``, the body its kernel
runs), as plain C++ behind CUDA's function qualifiers.
Here g++ compiles those headers with the qualifiers defined away, and a
serial loop over the lanes stands in for the grid (for B6 and B7, over one
lane's group of ``kGroup`` threads, phase by phase): the same integer
arithmetic the kernels run on the card, on the packed int32[k·24, N]
layout, checked bit-exact against ``cuda_tower``'s plain versions on seeded
inputs with zero lanes. ``tests/test_torch_csrc_tower_group.py`` holds the
lane-group bodies at other group sizes and block shapes. Without g++ the tests skip (the kernels themselves run only on the
card, in ``chip_smoke.py``).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from threshold_crypto_tpu_torch import _build
from threshold_crypto_tpu_torch.device import cuda_tower as ctw
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.device.mont import FQ

N = 24

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
#include "tower.cuh"
#include "tower_group.cuh"

// B6 (g == nullptr) and B7 on the lane-group engine: one block of one lane
// and kGroup threads after another; each loop over tid is what the
// threads do between two barriers.
static void group_lanes(const int32_t* f, const int32_t* g, int32_t* fo,
                        int n) {
  using namespace tc::grp;
  const bool mul = g != nullptr;
  const int words = mul ? kB7LaneWords : kB6LaneWords;
  std::vector<uint32_t> smem(words);
  for (int lane = 0; lane < n; ++lane) {
    for (int tid = 0; tid < kGroup; ++tid) {
      stage_in(f, 12, 0, n, lane, 0, tid, kGroup, smem.data(), words);
      if (mul)
        stage_in(g, 12, 12, n, lane, 0, tid, kGroup, smem.data(), words);
    }
    for (int ph = 0; ph < (mul ? kB7Phases : kB6Phases); ++ph)
      for (int tid = 0; tid < kGroup; ++tid)
        run_phase(mul ? kB7PhaseOps : kB6PhaseOps, mul ? kB7Ops : kB6Ops,
                  mul ? kB7Terms : kB6Terms, kTowerConsts, ph, tid, kGroup,
                  smem.data());
    for (int tid = 0; tid < kGroup; ++tid)
      stage_out(fo, mul ? kB7OutSlots : kB6OutSlots, 12, n, lane, 0, tid,
                kGroup, smem.data(), words);
  }
}

// stdin: int32 op, n, m, k, then the packed inputs; stdout: the outputs.
static std::vector<int32_t> rd(size_t count) {
  std::vector<int32_t> v(count);
  if (fread(v.data(), 4, count, stdin) != count) exit(3);
  return v;
}

int main() {
  int32_t h[4];
  if (fread(h, 4, 4, stdin) != 4) return 2;
  const int op = h[0], n = h[1], m = h[2], k = h[3];
  const size_t F = 288ul * n, T = 144ul * n;
  std::vector<std::vector<int32_t>> in;
  const size_t rows[7][4] = {{288, 144, 48, 0}, {288, 144, 96, 48},
                             {288, 0, 0, 0},    {288, 288, 0, 0},
                             {288, 288, 0, 0},  {288, 0, 0, 0},
                             {0, 0, 0, 0}};
  for (int i = 0; i < 4 && op < 6; ++i)
    if (rows[op][i]) in.push_back(rd(rows[op][i] * n));
  if (op >= 6) {
    in.push_back(rd(24ul * m * n));
    in.push_back(rd(24ul * m * n));
  }
  std::vector<int32_t> a(op >= 6 ? 5 * 24ul * m * n : F), b(T);
  if (op == 2 || op == 3)
    group_lanes(in[0].data(), op == 3 ? in[1].data() : nullptr, a.data(), n);
  for (int l = 0; l < n && op != 2 && op != 3; ++l) {
    switch (op) {
      case 0: tc::dbl_fold_lane(in[0].data(), in[1].data(), in[2].data(),
                                a.data(), b.data(), n, l); break;
      case 1: tc::add_fold_lane(in[0].data(), in[1].data(), in[2].data(),
                                in[3].data(), a.data(), b.data(), n, l); break;
      case 4: tc::fq12_mul_lane(in[0].data(), in[1].data(), a.data(), n, l);
              break;
      case 5: tc::fq12_mul_lane(in[0].data(), nullptr, a.data(), n, l); break;
      case 6: tc::engine_lane(in[0].data(), in[1].data(), a.data(), m, k, n, l);
              break;
      case 7:
        for (int c = 0; c < m; ++c)
          tc::engine_lane_r(in[0].data(), in[1].data(), a.data(), c, m, k, n,
                            l);
        break;
    }
  }
  fwrite(a.data(), 4, a.size(), stdout);
  if (op < 2) fwrite(b.data(), 4, b.size(), stdout);
  return 0;
}
"""

OPS = {"dbl_fold": 0, "add_fold": 1, "cyclo_sqr": 2, "cyclo_sqr_mul": 3,
       "fq12_mul": 4, "fq12_sqr": 5, "fq_engine": 6, "fq_engine_r": 7}


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
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", _build.CSRC, str(src),
                    "-o", exe], check=True, capture_output=True, timeout=300)
    return exe


def _rows(rng, k):
    """Packed int32[k·24, N] of random Fq values; lanes 0-1 zero, lane 2
    p − 1 in every component."""
    vals = [int.from_bytes(rng.bytes(64), "little") % FQ.p
            for _ in range(k * N)]
    x = mont.stack_mont(FQ, vals).reshape(k, N, FQ.L)
    x[:, :2] = 0
    x[:, 2] = mont.limbs_from_int(FQ, FQ.p - 1)
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1).reshape(k * FQ.L, N)))


def _run(exe, op, ins, out_rows, m=0, k=0):
    blob = np.array([OPS[op], N, m, k], np.int32).tobytes() + b"".join(
        t.numpy().tobytes() for t in ins)
    proc = subprocess.run([exe], input=blob, capture_output=True,
                          timeout=120, check=True)
    flat = np.frombuffer(proc.stdout, np.int32)
    assert flat.size == sum(out_rows) * N
    outs, off = [], 0
    for rows in out_rows:
        outs.append(torch.from_numpy(flat[off:off + rows * N].reshape(rows, N)
                                     .copy()))
        off += rows * N
    return outs


CASES = {
    "dbl_fold": (("f", "T", "P"), (288, 144)),
    "add_fold": (("f", "T", "Q", "P"), (288, 144)),
    "cyclo_sqr": (("f",), (288,)),
    "cyclo_sqr_mul": (("f", "g"), (288,)),
    "fq12_mul": (("f", "g"), (288,)),
    "fq12_sqr": (("f",), (288,)),
}
ROWS = {"f": 12, "g": 12, "T": 6, "Q": 4, "P": 2}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_body_matches_plain_version(harness, name):
    rng = np.random.default_rng(sum(map(ord, name)))
    names, out_rows = CASES[name]
    ins = [_rows(rng, ROWS[x]) for x in names]
    got = _run(harness, name, ins, out_rows)
    want = getattr(ctw, name + "_ref")(*ins)
    want = list(want) if isinstance(want, tuple) else [want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_engine_body_matches_plain_field_ops(harness, k):
    rng = np.random.default_rng(k)
    a, b = _rows(rng, 5), _rows(rng, 5)
    (got,) = _run(harness, "fq_engine", [a, b], [5 * 5 * FQ.L], m=5, k=k)
    assert torch.equal(got.reshape(5, 5 * FQ.L, N), ctw.fq_engine_ref(a, b, k))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 127, 1000003, 2 ** 31 - 1])
def test_register_engine_body_matches_plain_field_ops(harness, k):
    """B3's test entry on the register engine (``ladder_engine.cuh``
    ``engine_lane_r``: ``fp_mul``'s carry-save product, ``fp_add``,
    ``fp_sub``, ``fp_neg`` and ``fp_small``'s add chain), one (component,
    lane) at a time, against the plain field operations: a·b, a + b,
    a − b, −a and k·a on zero, p − 1 and random lanes, for small and large
    k; the same as the old body's."""
    rng = np.random.default_rng(0xB3 + k)
    a, b = _rows(rng, 5), _rows(rng, 5)
    b[:, 3] = a[:, 3]                       # a − b = 0 on lane 3
    (got,) = _run(harness, "fq_engine_r", [a, b], [5 * 5 * FQ.L], m=5, k=k)
    assert torch.equal(got.reshape(5, 5 * FQ.L, N), ctw.fq_engine_ref(a, b, k))
    (old,) = _run(harness, "fq_engine", [a, b], [5 * 5 * FQ.L], m=5, k=k)
    assert torch.equal(got, old)


def test_engine_constants_are_the_field_constants():
    """The modulus, −p⁻¹ mod 2³² and R mod p written into fq.cuh."""
    text = open(os.path.join(_build.CSRC, "fq.cuh")).read()
    body = text[text.index("kFq = {"):]
    body = body[:body.index("};")]
    words = [int(w.rstrip("u"), 16) for w in
             body.replace("{", " ").replace("}", " ").replace(",", " ").split()
             if w.startswith("0x")]
    assert len(words) == 25
    as_int = lambda ws: sum(w << (32 * i) for i, w in enumerate(ws))  # noqa
    assert as_int(words[:12]) == FQ.p
    assert words[12] == (-pow(FQ.p, -1, 1 << 32)) % (1 << 32)
    assert as_int(words[13:]) == FQ.one_mont == (1 << 384) % FQ.p
