"""The lane-group tower engine (``csrc/tower_group.cuh``), compiled for the
host, against the plain versions of B4, B5, B6, B7, B8, B9, B17 and B18.

On the card one lane of B4 ``dbl_fold`` / B5 ``add_fold`` / B6
``cyclo_sqr`` / B7 ``cyclo_sqr_mul`` / B8 ``fq12_mul`` / B9 ``fq12_sqr``
/ B17 ``dbl_step``, ``f_sqr_fold``, ``add_step``, ``f_fold`` / B18
``frob_mul``, ``easy_down``, ``easy_up`` runs on a group of ``kGroup``
threads: the block stages its lanes' inputs into shared
memory, each phase of the static schedule is dealt over the group's
threads with a barrier after it, and the block writes its outputs. Here
g++ compiles the header with CUDA's qualifiers defined away and a serial
loop over the threads stands in for the block, calling the same stage and
phase functions in the barriers' order:

* the bodies bit-exact with ``cuda_tower.dbl_fold_ref`` /
  ``add_fold_ref`` / ``cyclo_sqr_ref`` / ``cyclo_sqr_mul_ref`` /
  ``fq12_mul_ref`` / ``fq12_sqr_ref`` at the kernel's group size and at
  others, on zero f, g and T and infinity P and Q lanes, lanes of p − 1,
  (B9) lanes of one, random lanes and (B6, B7) cyclotomic lanes, over
  blocks whose last one is ragged; B17's four bodies bit-exact with
  ``dbl_step_ref`` / ``f_sqr_fold_ref`` / ``add_step_ref`` /
  ``f_fold_ref`` the same way (the folds on zero, random and real lines),
  and a step's body then its fold's equal to B4's or B5's body; B18's
  ``frob_mul`` bit-exact with ``frob_mul_ref`` at p and p², and
  ``easy_down``, the plain inversion and ``easy_up`` with their plain
  versions and with the tower's easy part, on zero lanes (which stay
  zero), lanes of one, of p − 1, real Miller values and random lanes;
* the dealing: each op of each phase runs on exactly one thread of the
  group, the product phases hold the 122 (B4: 48, 19, 16, 39), 80 (B5: 6,
  14, 48, 12), 18 (B6), 72 (B7: 18, 54), 54 (B8), 36 (B9) and B17's 47
  (12, 19, 16), 75 (36, 39), 41 (6, 14, 9, 12) and 39 Fq products, B18's
  64 (10, 54) twice, 62 (36, 15, 9, 2) and 111 (2, 9, 36, 10, 54), and a
  thread runs Σ ceil(layer / G) of them;
* a product whose second operand is a constant of the header's table is
  the product by that constant;
* a linear form reduced as its steps say (canonical when stored; as a
  product's operand, the bound the product needs) on edge and random
  slots, B9's, B17's step schedules' and B18's own forms among them, and
  the product canonical on operands up to that bound;
* the tables in the header are the generator's
  (``tools/tower_group_schedule.py``);
* a wrapper's dispatch sends a CPU tensor to the plain version.

The kernels themselves run only on the card: ``chip_smoke.py`` phase 3
holds them bit-exact against the plain versions at the paths' widths.
"""

import importlib.util
import os
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from threshold_crypto_tpu_torch import _build
from threshold_crypto_tpu_torch.device import cuda_tower as ctw
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.device.mont import FQ
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host import pairing as hpr
from threshold_crypto_tpu_torch.host import tower as htw
from threshold_crypto_tpu_torch.host.params import R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
#include "tower_group.cuh"

using namespace tc::grp;

struct Sched {
  const int32_t *phase_ops, *ops, *terms, *out_slots;
  int phases, slots, lane_words;
};
static const Sched kS[14] = {
    {kB4PhaseOps, kB4Ops, kB4Terms, kB4OutSlots, kB4Phases, kB4Slots,
     kB4LaneWords},
    {kB6PhaseOps, kB6Ops, kB6Terms, kB6OutSlots, kB6Phases, kB6Slots,
     kB6LaneWords},
    {kB7PhaseOps, kB7Ops, kB7Terms, kB7OutSlots, kB7Phases, kB7Slots,
     kB7LaneWords},
    {kB8PhaseOps, kB8Ops, kB8Terms, kB8OutSlots, kB8Phases, kB8Slots,
     kB8LaneWords},
    {kB5PhaseOps, kB5Ops, kB5Terms, kB5OutSlots, kB5Phases, kB5Slots,
     kB5LaneWords},
    {kB9PhaseOps, kB9Ops, kB9Terms, kB9OutSlots, kB9Phases, kB9Slots,
     kB9LaneWords},
    {kDblStepPhaseOps, kDblStepOps, kDblStepTerms, kDblStepOutSlots,
     kDblStepPhases, kDblStepSlots, kDblStepLaneWords},
    {kFSqrFoldPhaseOps, kFSqrFoldOps, kFSqrFoldTerms, kFSqrFoldOutSlots,
     kFSqrFoldPhases, kFSqrFoldSlots, kFSqrFoldLaneWords},
    {kAddStepPhaseOps, kAddStepOps, kAddStepTerms, kAddStepOutSlots,
     kAddStepPhases, kAddStepSlots, kAddStepLaneWords},
    {kFFoldPhaseOps, kFFoldOps, kFFoldTerms, kFFoldOutSlots, kFFoldPhases,
     kFFoldSlots, kFFoldLaneWords},
    {kFrobMul1PhaseOps, kFrobMul1Ops, kFrobMul1Terms, kFrobMul1OutSlots,
     kFrobMul1Phases, kFrobMul1Slots, kFrobMulLaneWords},
    {kFrobMul2PhaseOps, kFrobMul2Ops, kFrobMul2Terms, kFrobMul2OutSlots,
     kFrobMul2Phases, kFrobMul2Slots, kFrobMulLaneWords},
    {kEasyDownPhaseOps, kEasyDownOps, kEasyDownTerms, kEasyDownOutSlots,
     kEasyDownPhases, kEasyDownSlots, kEasyDownLaneWords},
    {kEasyUpPhaseOps, kEasyUpOps, kEasyUpTerms, kEasyUpOutSlots,
     kEasyUpPhases, kEasyUpSlots, kEasyUpLaneWords}};

static std::vector<int32_t> rd(size_t count) {
  std::vector<int32_t> v(count);
  if (fread(v.data(), 4, count, stdin) != count) exit(3);
  return v;
}

// One block after another of 2^shift lanes and 2^shift·G threads; each
// loop over tid is what the block's threads do between two barriers. An
// operand or output of 0 components is one Fq value as int32[n, 24] limb
// rows.
static void emulate(const Sched& s, const std::vector<const int32_t*>& in,
                    const std::vector<int>& in_comps,
                    const std::vector<int32_t*>& out,
                    const std::vector<int>& out_comps, int n, int G,
                    int shift) {
  const int lanes = 1 << shift, nthreads = lanes * G;
  std::vector<uint32_t> smem(static_cast<size_t>(lanes) * s.lane_words);
  for (int lane0 = 0; lane0 < n; lane0 += lanes) {
    for (auto& w : smem) w = 0xA5A5A5A5u;
    int slot0 = 0;
    for (size_t k = 0; k < in.size(); ++k) {
      for (int tid = 0; tid < nthreads; ++tid)
        if (in_comps[k] == 0)
          stage_in_rows(in[k], slot0, n, lane0, shift, tid, nthreads,
                        smem.data(), s.lane_words);
        else
          stage_in(in[k], in_comps[k], slot0, n, lane0, shift, tid, nthreads,
                   smem.data(), s.lane_words);
      slot0 += in_comps[k] == 0 ? 1 : in_comps[k];
    }
    for (int ph = 0; ph < s.phases; ++ph)
      for (int tid = 0; tid < nthreads; ++tid)
        run_phase(s.phase_ops, s.ops, s.terms, kTowerConsts, ph, tid % G, G,
                  smem.data() + static_cast<size_t>(tid / G) * s.lane_words);
    int c0 = 0;
    for (size_t k = 0; k < out.size(); ++k) {
      for (int tid = 0; tid < nthreads; ++tid)
        if (out_comps[k] == 0)
          stage_out_rows(out[k], s.out_slots[c0], n, lane0, shift, tid,
                         nthreads, smem.data(), s.lane_words);
        else
          stage_out(out[k], s.out_slots + c0, out_comps[k], n, lane0, shift,
                    tid, nthreads, smem.data(), s.lane_words);
      c0 += out_comps[k] == 0 ? 1 : out_comps[k];
    }
  }
}

// stdin: int32 op, G, shift, n, then the inputs; stdout: the outputs.
// op 0: B4 (f, T, P -> f, T); op 1: B6 (f -> f); op 6: B7 (f, g -> f);
// op 7: B8 (a, b -> a·b); op 8: B5 (f, T, Q, P -> f, T); op 9: B9 (a -> a²);
// B17: op 20 dbl_step (T, P -> T, line), op 21 f_sqr_fold (f, line -> f),
// op 22 add_step (T, Q, P -> T, line), op 23 f_fold (f, line -> f);
// B18: op 24 / 25 frob_mul at p / p² (a, b -> a·σ(b)), op 26 easy_down
// (f -> n as limb rows, s, m, c0-c2, tt), op 27 easy_up (s, m, c0-c2, tt,
// n⁻¹ as limb rows -> f);
// op 100 + s: for schedule s, a scratch of random values, then per phase
// its op count, its product flag and per thread g the slots thread g's
// share of it writes; op 4: n forms (words, first terms, `shift` terms)
// over a scratch of G slots; op 5: n products; op 30: n values, each
// times every constant of kTowerConsts by a product op whose second
// operand is that constant.
int main() {
  int32_t h[4];
  if (fread(h, 4, 4, stdin) != 4) return 2;
  const int op = h[0], G = h[1], shift = h[2], n = h[3];
  if (op == 0) {
    auto f = rd(288ul * n), T = rd(144ul * n), P = rd(48ul * n);
    std::vector<int32_t> fo(288ul * n), To(144ul * n);
    emulate(kS[0], {f.data(), T.data(), P.data()}, {12, 6, 2},
            {fo.data(), To.data()}, {12, 6}, n, G, shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
    fwrite(To.data(), 4, To.size(), stdout);
  } else if (op == 1) {
    auto f = rd(288ul * n);
    std::vector<int32_t> fo(288ul * n);
    emulate(kS[1], {f.data()}, {12}, {fo.data()}, {12}, n, G, shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
  } else if (op == 6) {
    auto f = rd(288ul * n), g = rd(288ul * n);
    std::vector<int32_t> fo(288ul * n);
    emulate(kS[2], {f.data(), g.data()}, {12, 12}, {fo.data()}, {12}, n, G,
            shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
  } else if (op == 7) {
    auto a = rd(288ul * n), b = rd(288ul * n);
    std::vector<int32_t> fo(288ul * n);
    emulate(kS[3], {a.data(), b.data()}, {12, 12}, {fo.data()}, {12}, n, G,
            shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
  } else if (op == 8) {
    auto f = rd(288ul * n), T = rd(144ul * n), Q = rd(96ul * n),
         P = rd(48ul * n);
    std::vector<int32_t> fo(288ul * n), To(144ul * n);
    emulate(kS[4], {f.data(), T.data(), Q.data(), P.data()}, {12, 6, 4, 2},
            {fo.data(), To.data()}, {12, 6}, n, G, shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
    fwrite(To.data(), 4, To.size(), stdout);
  } else if (op == 9) {
    auto a = rd(288ul * n);
    std::vector<int32_t> fo(288ul * n);
    emulate(kS[5], {a.data()}, {12}, {fo.data()}, {12}, n, G, shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
  } else if (op == 20 || op == 22) {
    auto T = rd(144ul * n);
    auto Q = rd(op == 22 ? 96ul * n : 0ul);
    auto P = rd(48ul * n);
    std::vector<int32_t> To(144ul * n), line(144ul * n);
    std::vector<const int32_t*> in = {T.data(), P.data()};
    std::vector<int> comps = {6, 2};
    if (op == 22) {
      in = {T.data(), Q.data(), P.data()};
      comps = {6, 4, 2};
    }
    emulate(kS[op == 20 ? 6 : 8], in, comps, {To.data(), line.data()},
            {6, 6}, n, G, shift);
    fwrite(To.data(), 4, To.size(), stdout);
    fwrite(line.data(), 4, line.size(), stdout);
  } else if (op == 21 || op == 23) {
    auto f = rd(288ul * n), line = rd(144ul * n);
    std::vector<int32_t> fo(288ul * n);
    emulate(kS[op == 21 ? 7 : 9], {f.data(), line.data()}, {12, 6},
            {fo.data()}, {12}, n, G, shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
  } else if (op == 4) {  // n forms over a scratch of G slots
    auto init = rd(static_cast<size_t>(G) * kWords);
    auto words = rd(n);
    auto starts = rd(n);
    auto terms = rd(static_cast<size_t>(shift));
    std::vector<uint32_t> lane(init.begin(), init.end()), out;
    for (int i = 0; i < n; ++i) {
      tc::reg::Fp r;
      form(r, terms.data() + starts[i], words[i], lane.data());
      out.insert(out.end(), r.w, r.w + kWords);
    }
    fwrite(out.data(), 4, out.size(), stdout);
  } else if (op == 5) {  // n products of 12-word operands
    auto a = rd(12ul * n), b = rd(12ul * n);
    std::vector<uint32_t> out;
    for (int i = 0; i < n; ++i) {
      tc::reg::Fp x, y;
      for (int j = 0; j < kWords; ++j) {
        x.w[j] = static_cast<uint32_t>(a[12 * i + j]);
        y.w[j] = static_cast<uint32_t>(b[12 * i + j]);
      }
      const tc::reg::Fp r = tc::reg::fp_mul_call(x, y);
      out.insert(out.end(), r.w, r.w + kWords);
    }
    fwrite(out.data(), 4, out.size(), stdout);
  } else if (op == 24 || op == 25) {
    auto a = rd(288ul * n), b = rd(288ul * n);
    std::vector<int32_t> fo(288ul * n);
    emulate(kS[op - 14], {a.data(), b.data()}, {12, 12}, {fo.data()}, {12}, n,
            G, shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
  } else if (op == 26) {
    auto f = rd(288ul * n);
    std::vector<int32_t> norm(24ul * n), inter(480ul * n);
    emulate(kS[12], {f.data()}, {12}, {norm.data(), inter.data()}, {0, 20},
            n, G, shift);
    fwrite(norm.data(), 4, norm.size(), stdout);
    fwrite(inter.data(), 4, inter.size(), stdout);
  } else if (op == 27) {
    auto inter = rd(480ul * n), ninv = rd(24ul * n);
    std::vector<int32_t> fo(288ul * n);
    emulate(kS[13], {inter.data(), ninv.data()}, {20, 0}, {fo.data()}, {12},
            n, G, shift);
    fwrite(fo.data(), 4, fo.size(), stdout);
  } else if (op == 30) {  // n values times each constant
    auto vals = rd(12ul * n);
    const int32_t phase_ops[2] = {0, 1};
    const int32_t ops[4] = {1, 0, 1, 1 | kConstForm};
    std::vector<uint32_t> out;
    for (int i = 0; i < n; ++i)
      for (int c = 0; c < kTowerConstCount; ++c) {
        const int32_t terms[2] = {1, c << 8 | 1};
        std::vector<uint32_t> lane(2 * kWords);
        for (int j = 0; j < kWords; ++j)
          lane[j] = static_cast<uint32_t>(vals[12 * i + j]);
        run_phase(phase_ops, ops, terms, kTowerConsts, 0, 0, 1, lane.data());
        out.insert(out.end(), lane.begin() + kWords, lane.end());
      }
    fwrite(out.data(), 4, out.size(), stdout);
  } else if (op >= 100 && op < 114) {
    const Sched& s = kS[op - 100];
    auto init = rd(static_cast<size_t>(s.slots) * kWords);
    std::vector<int32_t> out;
    for (int ph = 0; ph < s.phases; ++ph) {
      const int first = s.phase_ops[2 * ph], count = s.phase_ops[2 * ph + 1];
      out.push_back(count);
      out.push_back(s.ops[4 * first + 3] > 0);
      for (int g = 0; g < G; ++g) {
        std::vector<uint32_t> lane(init.begin(), init.end());
        run_phase(s.phase_ops, s.ops, s.terms, kTowerConsts, ph, g, G,
                  lane.data());
        for (int k = 0; k < s.slots; ++k) {
          bool changed = false;
          for (int j = 0; j < kWords; ++j)
            changed |= lane[k * kWords + j] !=
                       static_cast<uint32_t>(init[k * kWords + j]);
          out.push_back(changed);
        }
      }
    }
    fwrite(out.data(), 4, out.size(), stdout);
  } else {
    return 4;
  }
  return 0;
}
"""

N = 22          # lanes: blocks of 4 (shift 2), the last one ragged
SHIFT = 2
GROUP = 8       # the kernel's kGroup
PRODUCTS = {"dbl_fold": [48, 19, 16, 39], "cyclo_sqr": [18],
            "cyclo_sqr_mul": [18, 54], "fq12_mul": [54],
            "add_fold": [6, 14, 48, 12], "fq12_sqr": [36],
            "dbl_step": [12, 19, 16], "f_sqr_fold": [36, 39],
            "add_step": [6, 14, 9, 12], "f_fold": [39],
            "frob_mul1": [10, 54], "frob_mul2": [10, 54],
            "easy_down": [36, 15, 9, 2], "easy_up": [2, 9, 36, 10, 54]}
# The schedules in the header's order (the harness's kS), by kernel.
SCHEDS = ["dbl_fold", "cyclo_sqr", "cyclo_sqr_mul", "fq12_mul", "add_fold",
          "fq12_sqr", "dbl_step", "f_sqr_fold", "add_step", "f_fold",
          "frob_mul1", "frob_mul2", "easy_down", "easy_up"]
PREFIXES = ["kB4", "kB6", "kB7", "kB8", "kB5", "kB9", "kDblStep",
            "kFSqrFold", "kAddStep", "kFFold", "kFrobMul1", "kFrobMul2",
            "kEasyDown", "kEasyUp"]


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
    d = tmp_path_factory.mktemp("csrc_tower_group")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", _build.CSRC, str(src),
                    "-o", exe], check=True, capture_output=True, timeout=300)
    return exe


def _run(exe, op, G, n, blobs, shift=SHIFT):
    head = np.array([op, G, shift, n], np.int32).tobytes()
    proc = subprocess.run([exe], input=head + b"".join(blobs),
                          capture_output=True, timeout=120, check=True)
    return np.frombuffer(proc.stdout, np.int32).copy()


def _packed(comps):
    """Host int values [k][N] -> packed int32[k·24, N] Montgomery limbs."""
    x = np.stack([mont.stack_mont(FQ, c) for c in comps])   # [k, N, 24]
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1).reshape(len(comps) * FQ.L, -1)))


def _random(rnd, k):
    return [[rnd.randrange(FQ.p) for _ in range(N)] for _ in range(k)]


def _flat12(f):
    return [c for fq6 in f for fq2 in fq6 for c in fq2]


def _dbl_fold_inputs(seed):
    """f, T, P with lanes 0-1 all zero, 2-3 P = (0, 0) (infinity), 4-5
    T = 0, 6 every component p − 1, the rest random."""
    rnd = random.Random(seed)
    f, T, P = _random(rnd, 12), _random(rnd, 6), _random(rnd, 2)
    for lane in (0, 1):
        for x in (f, T, P):
            for c in x:
                c[lane] = 0
    for lane in (2, 3):
        for c in P:
            c[lane] = 0
    for lane in (4, 5):
        for c in T:
            c[lane] = 0
    for x in (f, T, P):
        for c in x:
            c[6] = FQ.p - 1
    return _packed(f), _packed(T), _packed(P)


def _cyclo_inputs(seed):
    """f with lanes 0-1 zero, 2 every component p − 1, 8-13 in the
    cyclotomic subgroup (g^((p^6 − 1)(p^2 + 1)) of a random g), the rest
    random."""
    rnd = random.Random(seed)
    f = _random(rnd, 12)
    for c in f:
        c[0] = c[1] = 0
        c[2] = FQ.p - 1
    for lane in range(8, 14):
        g = ((tuple(tuple(rnd.randrange(FQ.p) for _ in range(2))
                    for _ in range(3))),
             (tuple(tuple(rnd.randrange(FQ.p) for _ in range(2))
                    for _ in range(3))))
        e = htw.fq12_mul(htw.fq12_conj(g), htw.fq12_inv(g))
        e = htw.fq12_mul(htw.fq12_frob(e, 2), e)
        for c, v in zip(f, _flat12(e)):
            c[lane] = v
    return _packed(f), f


@pytest.mark.parametrize("G", [GROUP, 4, 16])
def test_dbl_fold_group_body_matches_plain_version(harness, G):
    f, T, P = _dbl_fold_inputs(0xB4 + G)
    out = _run(harness, 0, G, N, [x.numpy().tobytes() for x in (f, T, P)])
    fo = torch.from_numpy(out[:288 * N].reshape(288, N).copy())
    To = torch.from_numpy(out[288 * N:].reshape(144, N).copy())
    want_f, want_T = ctw.dbl_fold_ref(f, T, P)
    assert torch.equal(fo, want_f)
    assert torch.equal(To, want_T)


@pytest.mark.parametrize("G", [GROUP, 4, 16])
def test_cyclo_sqr_group_body_matches_plain_version(harness, G):
    f, host = _cyclo_inputs(0xB6 + G)
    out = _run(harness, 1, G, N, [f.numpy().tobytes()])
    fo = torch.from_numpy(out.reshape(288, N).copy())
    assert torch.equal(fo, ctw.cyclo_sqr_ref(f))
    # on the cyclotomic lanes, the true square
    got = [mont.unstack_mont(FQ, c) for c in pk_unpack(fo)]
    for lane in range(8, 14):
        x = [host[i][lane] for i in range(12)]
        fq2 = [(x[2 * i], x[2 * i + 1]) for i in range(6)]
        e = (tuple(fq2[:3]), tuple(fq2[3:]))
        assert [got[i][lane] for i in range(12)] == \
            _flat12(htw.fq12_sqr(e))


@pytest.mark.parametrize("G", [GROUP, 1, 4, 16, 32])
def test_cyclo_sqr_mul_group_body_matches_plain_version(harness, G):
    """B7: f²·g with f on B6's lanes (zero, p − 1, cyclotomic, random) and
    g random with zero lanes 0 and 3 and p − 1 on lane 4."""
    f, host = _cyclo_inputs(0xB7 + G)
    rnd = random.Random(0xB70 + G)
    g_host = _random(rnd, 12)
    for c in g_host:
        c[0] = c[3] = 0
        c[4] = FQ.p - 1
    g = _packed(g_host)
    out = _run(harness, 6, G, N, [f.numpy().tobytes(), g.numpy().tobytes()])
    fo = torch.from_numpy(out.reshape(288, N).copy())
    assert torch.equal(fo, ctw.cyclo_sqr_mul_ref(f, g))
    # on the cyclotomic lanes, the true f²·g
    got = [mont.unstack_mont(FQ, c) for c in pk_unpack(fo)]
    for lane in range(8, 14):
        e, h = (_fq12([x[i][lane] for i in range(12)])
                for x in (host, g_host))
        assert [got[i][lane] for i in range(12)] == \
            _flat12(htw.fq12_mul(htw.fq12_sqr(e), h))


def _add_fold_inputs(seed):
    """f, T, Q, P with lanes 0-1 all zero, 2-3 P = (0, 0) (infinity), 4-5
    T = 0, 6 every component p − 1, 7-8 Q = (0, 0) (infinity), 9 f = 0,
    the rest random."""
    rnd = random.Random(seed)
    f, T, Q, P = (_random(rnd, k) for k in (12, 6, 4, 2))
    zero = {0: (f, T, Q, P), 1: (f, T, Q, P), 2: (P,), 3: (P,), 4: (T,),
            5: (T,), 7: (Q,), 8: (Q,), 9: (f,)}
    for lane, xs in zero.items():
        for x in xs:
            for c in x:
                c[lane] = 0
    for x in (f, T, Q, P):
        for c in x:
            c[6] = FQ.p - 1
    return tuple(_packed(x) for x in (f, T, Q, P))


@pytest.mark.parametrize("G", [GROUP, 4, 16])
def test_add_fold_group_body_matches_plain_version(harness, G):
    """B5: T + Q and f·l_chord(P) on zero, infinity, p − 1 and random
    lanes, the last block ragged."""
    ins = _add_fold_inputs(0xB5 + G)
    out = _run(harness, 8, G, N, [x.numpy().tobytes() for x in ins])
    fo = torch.from_numpy(out[:288 * N].reshape(288, N).copy())
    To = torch.from_numpy(out[288 * N:].reshape(144, N).copy())
    want_f, want_T = ctw.add_fold_ref(*ins)
    assert torch.equal(fo, want_f)
    assert torch.equal(To, want_T)


@pytest.mark.parametrize("G", [GROUP, 4, 16])
def test_fq12_mul_group_body_matches_plain_version(harness, G):
    """B8: a·b with a zero on lanes 0-1, b zero on lanes 0 and 3, both p − 1
    on lane 4 (every component) and random elsewhere, against the plain
    version and, on the random lanes, the host tower."""
    rnd = random.Random(0xB8 + G)
    a_host, b_host = _random(rnd, 12), _random(rnd, 12)
    for c in a_host:
        c[0] = c[1] = 0
    for c in b_host:
        c[0] = c[3] = 0
    for x in (a_host, b_host):
        for c in x:
            c[4] = FQ.p - 1
    a, b = _packed(a_host), _packed(b_host)
    out = _run(harness, 7, G, N, [a.numpy().tobytes(), b.numpy().tobytes()])
    fo = torch.from_numpy(out.reshape(288, N).copy())
    assert torch.equal(fo, ctw.fq12_mul_ref(a, b))
    got = [mont.unstack_mont(FQ, c) for c in pk_unpack(fo)]
    for lane in range(5, 10):
        e, h = (_fq12([x[i][lane] for i in range(12)])
                for x in (a_host, b_host))
        assert [got[i][lane] for i in range(12)] == \
            _flat12(htw.fq12_mul(e, h))


@pytest.mark.parametrize("G", [GROUP, 4, 16])
def test_fq12_sqr_group_body_matches_plain_version(harness, G):
    """B9: a² with a zero on lanes 0-1, one (the Fq12 identity) on lanes
    2-3, p − 1 in every component on lane 4, one Fq6 half zero on lanes 5
    (a1) and 6 (a0), and random elsewhere, against the plain version and
    the host tower on every lane."""
    rnd = random.Random(0xB9 + G)
    a_host = _random(rnd, 12)
    for c in a_host:
        c[0] = c[1] = 0
        c[2] = c[3] = 0
        c[4] = FQ.p - 1
    for c in a_host[:1]:
        c[2] = c[3] = 1
    for c in a_host[6:]:
        c[5] = 0
    for c in a_host[:6]:
        c[6] = 0
    a = _packed(a_host)
    out = _run(harness, 9, G, N, [a.numpy().tobytes()])
    fo = torch.from_numpy(out.reshape(288, N).copy())
    assert torch.equal(fo, ctw.fq12_sqr_ref(a))
    got = [mont.unstack_mont(FQ, c) for c in pk_unpack(fo)]
    for lane in range(N):
        e = _fq12([a_host[i][lane] for i in range(12)])
        assert [got[i][lane] for i in range(12)] == _flat12(htw.fq12_sqr(e))
    assert [got[i][2] for i in range(12)] == [1] + [0] * 11
    assert all(got[i][0] == 0 for i in range(12))


# B17's bodies: harness op, and the packed rows of each output.
B17 = {"dbl_step": (20, (144, 144)), "f_sqr_fold": (21, (288,)),
       "add_step": (22, (144, 144)), "f_fold": (23, (288,))}


def _line_inputs(seed):
    """f and a line (c0, c1, c4) with lanes 0-1 both zero, 2 every
    component p − 1, 3 the line zero, 4 f zero, 8-15 the tangent lines of
    ``_dbl_fold_inputs``' lanes 2-9 (infinity P, zero T, p − 1 and random
    T among them), the rest random."""
    rnd = random.Random(seed)
    f, line = _random(rnd, 12), _random(rnd, 6)
    for lane, xs in {0: (f, line), 1: (f, line), 3: (line,), 4: (f,)}.items():
        for x in xs:
            for c in x:
                c[lane] = 0
    for x in (f, line):
        for c in x:
            c[2] = FQ.p - 1
    f, line = _packed(f), _packed(line)
    _, T, P = _dbl_fold_inputs(seed + 1)
    line[:, 8:16] = ctw.dbl_step_ref(T, P)[1][:, 2:10]
    return f, line


def _b17_inputs(name, seed):
    if name == "dbl_step":
        return _dbl_fold_inputs(seed)[1:]
    if name == "add_step":
        return _add_fold_inputs(seed)[1:]
    return _line_inputs(seed)


def _b17_body(harness, name, G, ins):
    """One of B17's group bodies on the harness: its output tensors."""
    op, rows = B17[name]
    out = _run(harness, op, G, N, [x.numpy().tobytes() for x in ins])
    assert out.size == sum(rows) * N
    outs, off = [], 0
    for r in rows:
        outs.append(torch.from_numpy(out[off:off + r * N].reshape(r, N)
                                     .copy()))
        off += r * N
    return outs


@pytest.mark.parametrize("name", list(B17))
@pytest.mark.parametrize("G", [GROUP, 4, 16])
def test_b17_group_body_matches_plain_version(harness, name, G):
    """B17's four pieces on the lane-group engine: ``dbl_step`` and
    ``add_step`` (T and the line) on B4's and B5's zero, infinity, p − 1
    and random lanes, ``f_sqr_fold`` and ``f_fold`` on zero, p − 1, real
    and random lines, the last block ragged, bit-exact with the plain
    versions."""
    ins = _b17_inputs(name, 0x17 + G + len(name))
    got = _b17_body(harness, name, G, ins)
    want = getattr(ctw, name + "_ref")(*ins)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("which", ["dbl", "add"])
@pytest.mark.parametrize("G", [GROUP, 4])
def test_b17_step_then_fold_is_the_fused_body(harness, which, G):
    """On the group bodies, ``dbl_step`` then ``f_sqr_fold`` is B4's body
    and ``add_step`` then ``f_fold`` B5's, bit for bit: f and T."""
    if which == "dbl":
        f, T, P = _dbl_fold_inputs(0xD0 + G)
        To, line = _b17_body(harness, "dbl_step", G, (T, P))
        (fo,) = _b17_body(harness, "f_sqr_fold", G, (f, line))
        fused = _run(harness, 0, G, N, [x.numpy().tobytes()
                                        for x in (f, T, P)])
    else:
        f, T, Q, P = _add_fold_inputs(0xA0 + G)
        To, line = _b17_body(harness, "add_step", G, (T, Q, P))
        (fo,) = _b17_body(harness, "f_fold", G, (f, line))
        fused = _run(harness, 8, G, N, [x.numpy().tobytes()
                                        for x in (f, T, Q, P)])
    assert torch.equal(fo, torch.from_numpy(
        fused[:288 * N].reshape(288, N).copy()))
    assert torch.equal(To, torch.from_numpy(
        fused[288 * N:].reshape(144, N).copy()))


def _b18_inputs(seed):
    """Fq12 lanes for B18: 0-1 zero, 2-3 one, 4 every component p − 1,
    5 one with c1 = p − 1 in every component, 8-11 real Miller values
    (``host.pairing.miller_loop`` of random pairs), the rest random; as
    host lists and packed."""
    rnd = random.Random(seed)
    f = _random(rnd, 12)
    for c in f:
        c[0] = c[1] = c[2] = c[3] = 0
        c[4] = c[5] = FQ.p - 1
    f[0][2] = f[0][3] = f[0][5] = 1
    for c in f[1:6]:
        c[5] = 0
    for lane in range(8, 12):
        p = hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R))
        q = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
        for c, v in zip(f, _flat12(hpr.miller_loop(p, q))):
            c[lane] = v
    return f, _packed(f)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("G", [GROUP, 4, 16])
def test_frob_mul_group_body_matches_plain_version(harness, k, G):
    """B18 ``frob_mul``: a·σ_k(b) with a on B18's lanes (zero, one, p − 1,
    real Miller values, random) and b zero on lanes 0, 1 and 3, p − 1 on
    lane 2, cyclotomic on 8-13 and random elsewhere, the last block ragged,
    against
    ``fq12_mul(a, fq12_frob(b, k))`` and, on every lane, the host tower."""
    a_host, a = _b18_inputs(0x18 + G + k)
    b, b_host = _cyclo_inputs(0x180 + G + k)
    for c in b_host:
        c[3] = 0
    b = _packed(b_host)
    out = _run(harness, 23 + k, G, N, [a.numpy().tobytes(),
                                       b.numpy().tobytes()])
    fo = torch.from_numpy(out.reshape(288, N).copy())
    assert torch.equal(fo, ctw.frob_mul_ref(a, b, k))
    got = [mont.unstack_mont(FQ, c) for c in pk_unpack(fo)]
    for lane in range(N):
        e, h = (_fq12([x[i][lane] for i in range(12)])
                for x in (a_host, b_host))
        assert [got[i][lane] for i in range(12)] == \
            _flat12(htw.fq12_mul(e, htw.fq12_frob(h, k)))


@pytest.mark.parametrize("G", [GROUP, 1, 4, 16])
def test_easy_part_group_bodies_match_plain_versions(harness, G):
    """B18's easy part: ``easy_down``, then the plain Fermat inversion of
    its n (``mont.inv``: zero to zero), then ``easy_up``, on B18's lanes
    (zero lanes stay zero, one stays one), the last block ragged: each body
    bit-exact with its plain version, and the whole with the tower's easy
    part (``tower.fq12_easy_part``) and the host tower's."""
    host, f = _b18_inputs(0xE5 + G)
    out = _run(harness, 26, G, N, [f.numpy().tobytes()])
    norm = torch.from_numpy(out[:24 * N].reshape(N, 24).copy())
    inter = torch.from_numpy(out[24 * N:].reshape(480, N).copy())
    want_norm, want_inter = ctw.easy_down_ref(f)
    assert torch.equal(norm, want_norm)
    assert torch.equal(inter, want_inter)
    ninv = mont.inv(FQ, norm)
    out = _run(harness, 27, G, N, [inter.numpy().tobytes(),
                                   ninv.numpy().tobytes()])
    fo = torch.from_numpy(out.reshape(288, N).copy())
    assert torch.equal(fo, ctw.easy_up_ref(inter, ninv))
    assert torch.equal(fo, ctw.easy_part_ref(f))
    got = [mont.unstack_mont(FQ, c) for c in pk_unpack(fo)]
    for lane in range(N):
        e = _fq12([host[i][lane] for i in range(12)])
        if lane < 2:
            assert [got[i][lane] for i in range(12)] == [0] * 12
            continue
        x = htw.fq12_mul(htw.fq12_conj(e), htw.fq12_inv(e))
        assert [got[i][lane] for i in range(12)] == \
            _flat12(htw.fq12_mul(htw.fq12_frob(x, 2), x))
    assert [got[i][2] for i in range(12)] == [1] + [0] * 11


def test_constant_operand_is_the_tower_constant(harness):
    """A product whose second operand is constant c of ``kTowerConsts``:
    v·c for v of 0, 1, p − 1 and random values, c each of the generator's
    constants (B18's Frobenius operands, Montgomery form in the table)."""
    gen = _gen()
    P = FQ.p
    rnd = random.Random(0xC0)
    vals = [0, 1, P - 1] + [rnd.randrange(P) for _ in range(5)]
    words = np.array([_words(v * (1 << 384) % P) for v in vals], np.uint32)
    out = _run(harness, 30, 0, len(vals), [words.tobytes()])
    got = [_int(r) for r in out.view(np.uint32).reshape(-1, 12)]
    assert len(gen.CONSTS) == 8
    assert got == [v * c % P * (1 << 384) % P for v in vals
                   for c in gen.CONSTS]


def _fq12(x):
    """12 Fq components in the packed order -> a host Fq12."""
    fq2 = [(x[2 * i], x[2 * i + 1]) for i in range(6)]
    return (tuple(fq2[:3]), tuple(fq2[3:]))


def pk_unpack(packed):
    """Packed int32[288, N] -> 12 int32[N, 24] components."""
    return [packed[i * FQ.L:(i + 1) * FQ.L].T.contiguous()
            for i in range(12)]


@pytest.mark.parametrize("name,sched", [(n, i) for i, n in enumerate(SCHEDS)])
@pytest.mark.parametrize("G", [GROUP, 4])
def test_schedule_deals_each_op_to_one_thread(harness, name, sched, G):
    """Thread g's share of a phase writes the slots of ops g, g + G, …:
    over the group the shares are disjoint and cover every op of the
    phase once; the product phases hold the 122 (B4), 18 (B6), 72 (B7),
    54 (B8), 80 (B5), 36 (B9) or B17's 47 (dbl_step), 75 (f_sqr_fold), 41
    (add_step) and 39 (f_fold) Fq products, and the busiest thread runs
    Σ ceil(layer / G) of them."""
    text = open(os.path.join(_build.CSRC, "tower_group.cuh")).read()
    prefix = PREFIXES[sched]
    slots = int(re.search(rf"constexpr int {prefix}Slots = (\d+);",
                          text).group(1))
    rnd = random.Random(sched)
    init = np.array([(rnd.randrange(FQ.p) >> (32 * j)) & 0xFFFFFFFF
                     for _ in range(slots) for j in range(12)], np.uint32)
    out = _run(harness, 100 + sched, G, 0, [init.tobytes()])
    pos, products, busiest = 0, [], 0
    while pos < out.size:
        count, is_product = int(out[pos]), bool(out[pos + 1])
        pos += 2
        shares = out[pos:pos + G * slots].reshape(G, slots).astype(bool)
        pos += G * slots
        assert shares.sum(axis=0).max() <= 1        # disjoint
        assert shares.sum() == count                # every op once
        assert [int(s.sum()) for s in shares] == [
            len(range(g, count, G)) for g in range(G)]
        if is_product:
            products.append(count)
            busiest += -(-count // G)
    assert products == PRODUCTS[name]
    assert busiest == sum(-(-c // G) for c in PRODUCTS[name])
    if G == GROUP:
        assert busiest == {"dbl_fold": 16, "cyclo_sqr": 3,
                           "cyclo_sqr_mul": 10, "fq12_mul": 7,
                           "add_fold": 11, "fq12_sqr": 5, "dbl_step": 7,
                           "f_sqr_fold": 10, "add_step": 7,
                           "f_fold": 5, "frob_mul1": 9, "frob_mul2": 9,
                           "easy_down": 10, "easy_up": 17}[name]


def _gen():
    spec = importlib.util.spec_from_file_location(
        "tower_group_schedule",
        os.path.join(ROOT, "tools", "tower_group_schedule.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def _words(x):
    return [(x >> (32 * j)) & 0xFFFFFFFF for j in range(12)]


def _int(ws):
    return sum(int(w) << (32 * j) for j, w in enumerate(ws))


def _schedule_forms(gen, make):
    """Every form of a schedule's ops, in op order, as (slot: coefficient,
    word, "stored" for a linear op's form, "operand" for a product's or
    "const" for a product's constant operand, whose one term is no slot)."""
    terms, ops, _, _, _ = make().tables()
    out = []
    for _, t0, fa, fb in ops:
        for start, word in ((t0, fa), (t0 + (fa & 0xFF), fb)):
            if word == 0:
                continue
            f = {t >> 8: (t & 0xFF) - ((t & 0x80) << 1)
                 for t in terms[start:start + (word & 0xFF)]}
            what = ("const" if word >> 8 & gen.CONST else
                    "operand" if fb else "stored")
            out.append((f, word, what))
    return out


@pytest.mark.parametrize("steps", ["product", "stored", "kB9", "kDblStep",
                                   "kAddStep", "kFrobMul1", "kEasyDown",
                                   "kEasyUp"])
def test_forms_reduce_as_their_steps_say(harness, steps):
    """A form Σ c·slot with the generator's reduction steps: stored, the
    canonical value; as a product operand, its value mod p below 2^384
    (below 3p after QSTEP) and within the weight bound the product needs.
    Slots of 0, 1, p − 1, p − 2 and random values; 1 to 24 terms with
    coefficients up to ±127, all of one sign among them; or ("kB9",
    "kDblStep", "kAddStep", B18's "kFrobMul1", "kEasyDown", "kEasyUp") the
    forms of B9's, B17's step schedules' or B18's schedules over their
    slots, each product's two operands within a·b < R·p (a constant
    operand below p)."""
    gen = _gen()
    P = FQ.p
    rnd = random.Random(0xF0 + len(steps))
    whole = steps.startswith("k")
    if whole:
        every = _schedule_forms(gen, gen.SCHEDULES[steps])
        sched = [x for x in every if x[2] != "const"]
        n_slots = 1 + max(s for f, _, _ in sched for s in f)
        vals = [0, 1, P - 1, P - 2] + [rnd.randrange(P)
                                       for _ in range(n_slots - 4)]
        vals[rnd.randrange(4, n_slots)] = P - 1
    else:
        vals = [0, 1, P - 1, P - 2] + [rnd.randrange(P) for _ in range(12)]
    init = np.array([w for v in vals for w in _words(v)], np.uint32)
    forms, whats = [], []
    for i in range(0 if whole else 300):
        nt = rnd.randint(1, 24)
        slots = rnd.sample(range(len(vals)), min(nt, len(vals)))
        sign = [1, -1, 0][i % 3]
        coefs = [(sign or rnd.choice([1, -1])) * rnd.randint(1, 127)
                 for _ in slots]
        forms.append(dict(zip(slots, coefs)))
    words, starts, terms = [], [], []
    for f in forms:
        lin = gen.Lin(f)
        if steps == "stored":
            red = gen.reduction(lin, None)[0]
        else:
            red = gen.reduction(lin, gen.Lin({0: 4}))[0]
        starts.append(len(terms))
        terms += [s << 8 | (c & 0xFF) for s, c in f.items()]
        words.append(len(f) | red << 8)
        whats.append(steps)
    if whole:
        for f, word, what in sched:
            forms.append(f)
            starts.append(len(terms))
            terms += [s << 8 | (c & 0xFF) for s, c in sorted(f.items())]
            words.append(word)
            whats.append(what)
    blobs = [init.tobytes(), np.array(words, np.int32).tobytes(),
             np.array(starts, np.int32).tobytes(),
             np.array(terms, np.int32).tobytes()]
    out = _run(harness, 4, len(vals), len(forms), blobs, shift=len(terms))
    got = [_int(r) for r in out.view(np.uint32).reshape(-1, 12)]
    bound = []
    for f, g, w, what in zip(forms, got, words, whats):
        want = sum(c * vals[s] for s, c in f.items()) % P
        assert g % P == want
        weight = sum(abs(c) for c in f.values())
        if what == "stored":
            assert g == want
        elif w >> 8:
            assert g < 3 * P
            bound.append(3)
        else:
            assert g <= weight * P
            bound.append(weight)
    if whole:
        # a product's two operands (consecutive forms, each below its bound
        # times p; a constant below p) within the product's bound a·b < R·p
        for i, (_, _, what) in enumerate(every):
            if what == "const":
                bound.insert(sum(x[2] != "stored" for x in every[:i]), 1)
        assert len(bound) == 2 * sum(gen.SCHEDULES[steps]().product_counts())
        for ba, bb in zip(bound[::2], bound[1::2]):
            assert ba * bb * P < 1 << 384


def test_product_is_canonical_below_its_bound(harness):
    """The engine's product on operands a, b < 2^384 with a·b < R·p (the
    unreduced forms' bound): the canonical a·b·R⁻¹ mod p."""
    P, R = FQ.p, 1 << 384
    rnd = random.Random(0x3B)
    pairs = [(9 * P - 1, P - 1), (3 * P - 1, 3 * P - 1), (P - 1, 9 * P - 1),
             (4 * P - 1, 2 * P - 1), (0, 9 * P - 1), (3 * P - 1, 0)]
    for _ in range(200):
        wa = rnd.randint(1, 9)
        wb = rnd.randint(1, 9 // wa)
        pairs.append((rnd.randrange(wa * P), rnd.randrange(wb * P)))
    assert all(a * b < R * P and a < R and b < R for a, b in pairs)
    a = np.array([_words(x) for x, _ in pairs], np.uint32)
    b = np.array([_words(y) for _, y in pairs], np.uint32)
    out = _run(harness, 5, 0, len(pairs), [a.tobytes(), b.tobytes()])
    got = [_int(r) for r in out.view(np.uint32).reshape(-1, 12)]
    rinv = pow(R, -1, P)
    assert got == [x * y * rinv % P for x, y in pairs]


def test_header_tables_are_the_generators():
    gen = _gen()
    text = open(gen.HEADER).read()
    assert gen.header_with(text, gen.block()) == text
    assert [s().product_counts() for s in gen.SCHEDULES.values()] == [
        PRODUCTS[name] for name in SCHEDS]
    assert list(gen.SCHEDULES) == PREFIXES


def test_cpu_tensors_take_the_plain_versions():
    """The dispatch sends a CPU tensor to the plain version, without a
    launch; the wrapper itself takes CUDA tensors only."""
    f, T, P = _dbl_fold_inputs(7)
    _, _, Q, _ = _add_fold_inputs(7)
    counts = (ctw.DBL_FOLD, ctw.ADD_FOLD, ctw.CYCLO_SQR, ctw.CYCLO_SQR_MUL,
              ctw.FQ12_MUL, ctw.FROB_MUL, ctw.EASY_DOWN, ctw.EASY_UP)
    before = [c.launches for c in counts]
    got = ctw.p_dbl_fold(f, T, P)
    want = ctw.dbl_fold_ref(f, T, P)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ctw.p_add_fold(f, T, Q, P)
    want = ctw.add_fold_ref(f, T, Q, P)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(ctw.p_cyclo_sqr(f), ctw.cyclo_sqr_ref(f))
    assert torch.equal(ctw.p_cyclo_sqr_mul(f, f), ctw.cyclo_sqr_mul_ref(f, f))
    assert torch.equal(ctw.p_fq12_mul(f, f), ctw.fq12_mul_ref(f, f))
    for k in (1, 2):
        assert torch.equal(ctw.p_frob_mul(f, f, k), ctw.frob_mul_ref(f, f, k))
    assert torch.equal(ctw.p_easy_part(f), ctw.easy_part_ref(f))
    assert [c.launches for c in counts] == before
    with pytest.raises(ValueError, match="CUDA"):
        ctw.dbl_fold(f, T, P)
    with pytest.raises(ValueError, match="CUDA"):
        ctw.cyclo_sqr(f)
    with pytest.raises(ValueError, match="CUDA"):
        ctw.cyclo_sqr_mul(f, f)
    with pytest.raises(ValueError, match="CUDA"):
        ctw.add_fold(f, T, Q, P)
    with pytest.raises(ValueError, match="CUDA"):
        ctw.fq12_mul(f, f)
    with pytest.raises(ValueError, match="CUDA"):
        ctw.frob_mul(f, f, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ctw.easy_down(f)
    with pytest.raises(ValueError, match="CUDA"):
        ctw.easy_up(torch.zeros((480, N), dtype=torch.int32),
                    torch.zeros((N, 24), dtype=torch.int32))
