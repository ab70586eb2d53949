"""B14's CUDA source, compiled for the host, against its plain version.

``csrc/fr.cuh`` holds the Fr product, the modular subtraction and the
per-lane j-sweep of kernel B14 as plain C++ behind CUDA's function
qualifiers. Here g++ compiles them with the qualifiers defined away, and a
serial loop over the lanes stands in for the grid (and, for the sweep, a
loop over chunks of 128 j values for the kernel's shared-memory tiles and
its blockIdx.y split): the same integer arithmetic the kernel runs on the
card, checked bit-exact against ``mont.mul`` / ``mont.sub`` (plain versions
on the CPU), against ``cuda_fr.lagrange_rowprod_ref`` and against Python
ints, on edge values (0, 1, r − 1, their Montgomery forms), a duplicate
pair and a zero lane. Without g++ the tests skip (the kernel itself runs
only on the card, in ``chip_smoke.py``).
"""

import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from threshold_crypto_tpu_torch import _build
from threshold_crypto_tpu_torch.device import cuda_fr, mont
from threshold_crypto_tpu_torch.device.mont import FR

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
#include "fr.cuh"

// stdin: int32 op, n, chunk, then the inputs; stdout: the outputs.
static std::vector<int32_t> rd(size_t count) {
  std::vector<int32_t> v(count);
  if (fread(v.data(), 4, count, stdin) != count) exit(3);
  return v;
}

int main() {
  int32_t h[3];
  if (fread(h, 4, 3, stdin) != 3) return 2;
  const int op = h[0], n = h[1], chunk = h[2];
  std::vector<int32_t> out(16ul * n);
  if (op == 0 || op == 1) {  // product, difference
    auto a = rd(16ul * n), b = rd(16ul * n);
    for (int i = 0; i < n; ++i) {
      tc::Fr x, y;
      tc::load_fr(x, a.data(), i);
      tc::load_fr(y, b.data(), i);
      if (op == 0) tc::fr_mul(x, x, y); else tc::fr_sub(x, x, y);
      tc::store_fr(out.data(), x, i);
    }
    fwrite(out.data(), 4, out.size(), stdout);
    return 0;
  }
  // the sweep as the kernel runs it: per chunk of j (blockIdx.y), tiles of
  // 128 staged values, one partial product and count per chunk
  auto xs = rd(16ul * n);
  const int splits = (n + chunk - 1) / chunk;
  std::vector<int32_t> prod(16ul * n * splits), cnt(1ul * n * splits);
  std::vector<tc::Fr> tile(128);
  for (int s = 0; s < splits; ++s) {
    const int j0 = s * chunk, j1 = j0 + chunk < n ? j0 + chunk : n;
    for (int i = 0; i < n; ++i) {
      tc::Fr xi, acc;
      int zc = 0;
      tc::fr_set_one(acc);
      tc::load_fr(xi, xs.data(), i);
      for (int t = j0; t < j1; t += 128) {
        const int m = j1 - t < 128 ? j1 - t : 128;
        for (int q = 0; q < m; ++q) tc::load_fr(tile[q], xs.data(), t + q);
        tc::lagr_sweep(acc, zc, xi, tile.data(), m);
      }
      tc::store_fr(prod.data() + 16ul * n * s, acc, i);
      cnt[1ul * n * s + i] = zc;
    }
  }
  fwrite(prod.data(), 4, prod.size(), stdout);
  fwrite(cnt.data(), 4, cnt.size(), stdout);
  return 0;
}
"""

OPS = {"mul": 0, "sub": 1, "sweep": 2}


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
    d = tmp_path_factory.mktemp("csrc_fr")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", _build.CSRC, str(src),
                    "-o", exe], check=True, capture_output=True, timeout=300)
    return exe


def _run(exe, op, n, ins, chunk=0):
    blob = np.array([OPS[op], n, chunk], np.int32).tobytes()
    blob += b"".join(t.contiguous().numpy().tobytes() for t in ins)
    proc = subprocess.run([exe], input=blob, capture_output=True,
                          timeout=120, check=True)
    return torch.from_numpy(np.frombuffer(proc.stdout, np.int32).copy())


def _edges():
    """Edge values as raw limbs: 0, 1, r − 1 and their Montgomery forms."""
    r_inv = pow(FR.r_mont, -1, FR.p)
    raw = [0, 1, FR.p - 1]
    return [v * r_inv % FR.p for v in raw] + raw


def _lanes(n, seed):
    rnd = random.Random(seed)
    vals = _edges() + [rnd.randrange(FR.p) for _ in range(n - 6)]
    return vals, torch.from_numpy(mont.stack_mont(FR, vals))


@pytest.mark.parametrize("op", ["mul", "sub"])
def test_product_and_difference_match_plain_version(harness, op):
    """fr_mul and fr_sub on every pair of edge values and on random lanes,
    bit-exact with the plain Montgomery product and difference."""
    e = len(_edges())
    _, a = _lanes(64, 1)
    _, b = _lanes(64, 2)
    a[:e * e] = a[:e].repeat_interleave(e, 0)[:e * e]
    b[:e * e] = b[:e].repeat(e, 1)[:e * e]
    got = _run(harness, op, 64, [a, b]).reshape(64, 16)
    want = (mont.mul if op == "mul" else mont.sub)(FR, a, b)
    assert torch.equal(got, want)
    ia, ib = mont.unstack_mont(FR, a), mont.unstack_mont(FR, b)
    exp = [(x * y if op == "mul" else x - y) % FR.p for x, y in zip(ia, ib)]
    assert mont.unstack_mont(FR, got) == exp


@pytest.mark.parametrize("n,chunk", [(300, 128), (300, 256), (131, 128)])
def test_sweep_matches_plain_version(harness, n, chunk):
    """The kernel's sweep (chunks of the j range, tiles of 128, partial
    products folded by ``cuda_fr.fold_products``), with a duplicate pair
    and a zero lane, against ``rowprod_partials_ref`` (chunk by chunk, at
    the kernel's chunk), ``lagrange_rowprod_ref`` and Python ints."""
    rnd = random.Random(n + chunk)
    vals = [rnd.randrange(1, FR.p) for _ in range(n)]
    vals[n - 1] = vals[40]
    vals[7] = 0
    xs = torch.from_numpy(mont.stack_mont(FR, vals))
    out = _run(harness, "sweep", n, [xs], chunk=chunk)
    splits = -(-n // chunk)
    prod = out[:16 * n * splits].reshape(splits, n, 16)
    cnt = out[16 * n * splits:].reshape(splits, n)
    if chunk == cuda_fr._chunk(n):
        ref = cuda_fr.rowprod_partials_ref(xs)
        assert torch.equal(prod, ref[0]) and torch.equal(cnt, ref[1])
    got = (cuda_fr.fold_products(prod), cnt.sum(0, dtype=torch.int32))
    want = cuda_fr.lagrange_rowprod_ref(xs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    zc = [sum(v == w for w in vals) for v in vals]
    assert got[1].tolist() == zc
    assert zc[40] == zc[n - 1] == 2 and zc[7] == 1
    for i in (0, 7, 40, n - 1):
        d = 1
        for j, v in enumerate(vals):
            if v != vals[i]:
                d = d * (v - vals[i]) % FR.p
        assert mont.unstack_mont(FR, got[0][i:i + 1]) == [d]
