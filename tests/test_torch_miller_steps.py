"""B17, the unfused Miller pieces, on the CPU: their plain versions against
the JAX package's Pallas kernels and against B4/B5, and their CUDA lane
bodies compiled for the host.

* The plain versions of ``dbl_step``, ``add_step``, ``f_sqr_fold`` and
  ``f_fold`` (``threshold_crypto_tpu_torch.device.cuda_tower``) against the
  kernel functions ``_k_dbl_step``, ``_k_add_step``, ``_k_f_sqr_fold`` and
  ``_k_f_fold`` of ``threshold_crypto_tpu/device/pallas_tower.py``, run
  through its ``_call`` in DIRECT mode (the kernel bodies on plain jnp
  arrays, no Pallas lowering), on the same seeded 128 lanes with four zero
  lanes; outputs, the line's plane order included, compared exactly.
* A step then its fold equals B4 / B5 (``dbl_fold_ref`` / ``add_fold_ref``).
* The lane bodies of ``csrc/tower.cuh`` (``dbl_step_lane``,
  ``add_step_lane``, ``f_sqr_fold_lane``, ``f_fold_lane``), compiled with
  g++ behind stub qualifiers and run lane by lane, against the plain
  versions, bit for bit (skipped without g++; the kernels themselves run
  only on the card, in ``chip_smoke.py``).
"""

import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threshold_crypto_tpu.device import pallas_tower as ptw
from threshold_crypto_tpu_torch import _build
from threshold_crypto_tpu_torch.device import cuda_tower as ctw
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.device import packed as pk
from threshold_crypto_tpu_torch.device.mont import FQ

N = 128
ZERO_LANES = (0, 1, 2, 3)
ROWS = {"f": 12, "T": 6, "Q": 4, "P": 2, "line": 6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _comps(rng, k, n=N):
    """k random Fq components, uint32[n, 24] Montgomery limbs; the zero
    lanes zero (an affine (0, 0) P is an infinity lane)."""
    out = []
    for _ in range(k):
        vals = [int.from_bytes(rng.bytes(64), "little") % FQ.p
                for _ in range(n)]
        for z in ZERO_LANES:
            vals[z] = 0
        out.append(mont.stack_mont(FQ, vals).astype(np.uint32))
    return out


@pytest.fixture(scope="module")
def vals():
    rng = np.random.default_rng(0xB17)
    return {name: _comps(rng, k) for name, k in ROWS.items()}


def _port(comps):
    return pk.pack([torch.from_numpy(c.astype(np.int32)) for c in comps])


def _port_out(packed):
    k = packed.shape[0] // FQ.L
    return [c.numpy().astype(np.uint32) for c in pk.unpack(packed, k)]


def _direct(kernel, ins, out_rows, monkeypatch):
    """One JAX kernel body on packed planes, through ``ptw._call`` in DIRECT
    mode; outputs as uint32[N, 24] components."""
    monkeypatch.setattr(ptw, "DIRECT", True)
    args = [ptw.pack([jnp.asarray(c) for c in comps], N) for comps in ins]
    outs = ptw._call(kernel, [len(c) * ptw.L for c in ins],
                     [k * ptw.L for k in out_rows], args)
    outs = outs if isinstance(outs, list) else [outs]
    return [[np.asarray(c) for c in ptw.unpack(o, k, N)]
            for o, k in zip(outs, out_rows)]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and np.array_equal(g, w), f"component {i}"


CASES = {
    # name: (JAX kernel, operands, output components)
    "dbl_step": (ptw._k_dbl_step, ("T", "P"), (6, 6)),
    "add_step": (ptw._k_add_step, ("T", "Q", "P"), (6, 6)),
    "f_sqr_fold": (ptw._k_f_sqr_fold, ("f", "line"), (12,)),
    "f_fold": (ptw._k_f_fold, ("f", "line"), (12,)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_kernel(vals, name, monkeypatch):
    kernel, operands, out_rows = CASES[name]
    ins = [vals[x] for x in operands]
    got = getattr(ctw, "p_" + name)(*[_port(c) for c in ins])
    got = got if isinstance(got, tuple) else (got,)
    want = _direct(kernel, ins, out_rows, monkeypatch)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_equal(_port_out(g), w)


def test_step_then_fold_is_the_fused_iteration(vals):
    """dbl_step → f_sqr_fold is B4, add_step → f_fold is B5, bit for bit;
    the line out of each step is the JAX kernel's for the same T."""
    f, T, Q, P = (_port(vals[x]) for x in ("f", "T", "Q", "P"))
    To, line = ctw.p_dbl_step(T, P)
    assert line.shape == (ctw.LINE, N)
    fo, To_fused = ctw.dbl_fold_ref(f, T, P)
    assert torch.equal(ctw.p_f_sqr_fold(f, line), fo)
    assert torch.equal(To, To_fused)
    To, line = ctw.p_add_step(T, Q, P)
    fo, To_fused = ctw.add_fold_ref(f, T, Q, P)
    assert torch.equal(ctw.p_f_fold(f, line), fo)
    assert torch.equal(To, To_fused)


def test_wrappers_take_cuda_tensors_only(vals):
    """No fallback: the wrappers refuse CPU tensors, and the dispatch sends
    them to the plain versions without counting a launch."""
    f, T, Q, P, line = (_port(vals[x]) for x in ("f", "T", "Q", "P", "line"))
    b17 = [k for k in ctw.KERNELS if k.name in CASES]
    for k in b17:
        k.count.reset()
    for call in (lambda: ctw.dbl_step(T, P), lambda: ctw.add_step(T, Q, P),
                 lambda: ctw.f_sqr_fold(f, line),
                 lambda: ctw.f_fold(f, line)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    ctw.p_f_fold(f, line)
    assert all(k.count.launches == 0 for k in b17)


# ---------------------------------------------------------------------------
# The CUDA lane bodies, compiled for the host
# ---------------------------------------------------------------------------

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

// stdin: int32 op, n, then the packed inputs; stdout: the outputs.
static std::vector<int32_t> rd(size_t count) {
  std::vector<int32_t> v(count);
  if (fread(v.data(), 4, count, stdin) != count) exit(3);
  return v;
}

int main() {
  int32_t h[2];
  if (fread(h, 4, 2, stdin) != 2) return 2;
  const int op = h[0], n = h[1];
  const size_t rows[4][3] = {{144, 48, 0}, {144, 96, 48}, {288, 144, 0},
                             {288, 144, 0}};
  std::vector<std::vector<int32_t>> in;
  for (int i = 0; i < 3; ++i)
    if (rows[op][i]) in.push_back(rd(rows[op][i] * n));
  std::vector<int32_t> a((op < 2 ? 144ul : 288ul) * n), b(144ul * n);
  for (int l = 0; l < n; ++l) {
    switch (op) {
      case 0: tc::dbl_step_lane(in[0].data(), in[1].data(), a.data(),
                                b.data(), n, l); break;
      case 1: tc::add_step_lane(in[0].data(), in[1].data(), in[2].data(),
                                a.data(), b.data(), n, l); break;
      case 2: tc::f_sqr_fold_lane(in[0].data(), in[1].data(), a.data(), n,
                                  l); break;
      case 3: tc::f_fold_lane(in[0].data(), in[1].data(), a.data(), n, l);
              break;
    }
  }
  fwrite(a.data(), 4, a.size(), stdout);
  if (op < 2) fwrite(b.data(), 4, b.size(), stdout);
  return 0;
}
"""

OPS = {"dbl_step": 0, "add_step": 1, "f_sqr_fold": 2, "f_fold": 3}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel sources for the host")
    d = tmp_path_factory.mktemp("miller_steps")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", _build.CSRC, str(src),
                    "-o", exe], check=True, capture_output=True, timeout=300)
    return exe


@pytest.mark.parametrize("name", list(OPS))
def test_lane_body_matches_plain_version(harness, name):
    """24 lanes: two zero, one with p − 1 in every component (raw limbs),
    the rest random."""
    n = 24
    rng = np.random.default_rng(OPS[name] + 17)
    _, operands, out_rows = CASES[name]
    ins = []
    for x in operands:
        comps = _comps(rng, ROWS[x], n)
        for c in comps:
            c[2] = mont.limbs_from_int(FQ, FQ.p - 1)
        ins.append(_port(comps))
    blob = np.array([OPS[name], n], np.int32).tobytes() + b"".join(
        t.numpy().tobytes() for t in ins)
    proc = subprocess.run([harness], input=blob, capture_output=True,
                          timeout=120, check=True)
    flat = np.frombuffer(proc.stdout, np.int32)
    assert flat.size == sum(out_rows) * FQ.L * n
    want = getattr(ctw, name + "_ref")(*ins)
    want = want if isinstance(want, tuple) else (want,)
    off = 0
    for w, k in zip(want, out_rows):
        rows = k * FQ.L
        got = torch.from_numpy(flat[off:off + rows * n].reshape(rows, n)
                               .copy())
        assert torch.equal(got, w)
        off += rows * n
