#!/usr/bin/env python3
"""B4 (``dbl_fold``), B5 (``add_fold``), B6 (``cyclo_sqr``), B7
(``cyclo_sqr_mul``), B8 (``fq12_mul``), B9 (``fq12_sqr``) and B17
(``dbl_step``, ``add_step``, ``f_sqr_fold``, ``f_fold``) on the lane-group
engine (``csrc/tower_group.cuh``), and B3's test entry (``fq_engine``) on
the register engine (``csrc/ladder_engine.cuh``), against their old bodies
and other group sizes, on one card.

    python3 tools/tower_variants.py [--split | --final-exp] [--parent ROOT]

The variants, each built with the package's nvcc flags into
``threshold_crypto_tpu_torch/_build/variants/``:

* ``old``: the one-thread-per-lane kernels the package ran before the
  engines (``tower.cuh`` ``dbl_fold_lane``, ``add_fold_lane``,
  ``fq12_mul_lane``, B9 its form without b, ``dbl_step_lane``,
  ``add_step_lane``, ``f_sqr_fold_lane``, ``f_fold_lane``, B3's
  ``engine_lane`` on ``fq.cuh``'s ``__noinline__`` field, and
  ``cyclo_sqr_lane`` with its Granger-Scott ``fq12_cyclo_sqr``, kept here
  as text; 128-thread blocks);
* ``g1``, ``g4``, ``g8``, ``g16``, ``g32``: the package's ``miller.cu``
  and ``fq12.cu`` with ``tc::grp::kGroup`` set to 1, 4, 8 (the package's),
  16 or 32 threads a lane. G = 1 keeps the register product and the
  staging in shared memory without the split.

For each: ptxas's registers, stack frame and spills of the B3-B9 and
B17 kernels; bit-exact against the package's kernels (which are held
against their plain versions here too) on ``chip_smoke.tower_inputs``
(zero and infinity lanes) at both widths of each kernel: slice 2's (B4,
B5 and B17 16,384 pair lanes, B6-B9 8192) and the RLC check's (B4, B5
and B17 2 × RLC_CHECK_BATCH = 1,024, B6-B9 512), B3 at [288, 16384]
(``chip_smoke.TOWER_CHECKS``); and the kernel time with CUDA events, in
turns
(old, g1, …, g16, g16, …, old) at each width, beside ``chip_smoke``'s
bound: launched one by one from Python (``chip_smoke.cuda_time_ms``, as
the path launches them) and replayed from a CUDA graph (the device time
alone).

With ``--split`` it builds, in place of the variants, the package's kernels
and copies of them with one part of the work taken out (``SPLIT``: the
product, the product operands' sums, the linear ops, the reduction steps,
everything but the staging), whose results are wrong, and times them the
same way: where the kernels' time goes.

With ``--final-exp`` it builds no variant and times B18 instead, at the
pairing check's widths (``chip_smoke.B18_WIDTHS``: 1, 256, 8192 and
65,536 lanes), launched one by one and replayed from a CUDA graph, in
turns: the easy part as ``easy_down``, B2 and ``easy_up``
(``cuda_tower.p_easy_part``) against the tower path it replaced
(``easy_part_ref`` with its products on B1 and its inversion on B2), and
``frob_mul`` at k = 1 and 2 against B8 ``fq12_mul`` and against the tower
Frobenius and B8 it replaced; each pair checked bit-exact first.

With ``--parent ROOT`` (another checkout: its ``chip_smoke.py`` and
``threshold_crypto_tpu_torch/``) it also times both checkouts' calls in
turns, one child process per turn (parent, this, this, parent, twice):
the RLC call (``chip_smoke.rlc_call``, N = 262,144, exponents included),
its MSM table stages (B10, G1 and G2 together) and its check stage
(``verify_batch_pallas`` at 512 lanes), from the program's spans
(``chip_smoke.stage_timer``), B9's launch in it (``chip_smoke.kernel_event_timer``), the
per-pair call ``ops.verify_batch_pallas`` at 8192 lanes with its B9
launch the same way, and that call alone at the check's 512
lanes (the per-pair inputs' first RLC_CHECK_BATCH lanes), CHECK_CALLS
times a turn, and the B17 composition (``chip_smoke.run_b17_composition``:
one whole Miller loop over the per-pair inputs through B17, and through
B4/B5, each in its turns). Prints one JSON line last and writes it to
``tower_variants.json``
beside the builds. Without CUDA it exits 2.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from threshold_crypto_tpu_torch import _build  # noqa: E402

# The kernels B4-B9 ran before the lane-group engine: tower.cuh's lane
# bodies, and B6 and B7's lane body and Granger-Scott square from
# tower.cuh before the engine.
OLD_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

#include "tower.cuh"

namespace tc {

// Granger-Scott cyclotomic squaring (`pallas_tower.fq12_cyclo_sqr`).
// With a = ((z0, z4, z3), (z2, z1, z5)), the Fq4 pieces (x, y) are
// (z0, z1), (z2, z3), (z4, z5); each squares to
// t0 = x² + ξy², t1 = (x+y)² − x² − y². The outputs are 3t − 2z, computed
// as 2(t − z) + t, for (t0a, z0), (t0b, z4), (t0c, z3), and 3t + 2z, as
// 2(t + z) + t, for (t1a, z1), (t1b, z5), (ξ·t1c, z2).
__device__ __noinline__ void fq12_cyclo_sqr(Fq12& r, const Fq12& a) {
  const Fq2* z[6] = {&a.c[0].c[0], &a.c[1].c[1], &a.c[1].c[0],
                     &a.c[0].c[2], &a.c[0].c[1], &a.c[1].c[2]};
  Fq2 t0[3], t1[3];
  for (int k = 0; k < 3; ++k) {
    const Fq2& x = *z[2 * k];
    const Fq2& y = *z[2 * k + 1];
    Fq2 xx, yy, ss;
    fq2_add(ss, x, y);
    fq2_sqr(ss, ss);
    fq2_sqr(xx, x);
    fq2_sqr(yy, y);
    fq2_sub(ss, ss, xx);
    fq2_sub(t1[k], ss, yy);
    fq2_mul_by_xi(yy, yy);
    fq2_add(t0[k], yy, xx);
  }
  fq2_mul_by_xi(t1[2], t1[2]);
  // out[i] = 2(t ∓ z_i) + t with z[i] = z_i and its t and sign from above.
  const Fq2* ts[6] = {&t0[0], &t1[0], &t1[2], &t0[2], &t0[1], &t1[1]};
  const bool plus[6] = {false, true, true, false, false, true};
  Fq2 out[6];
  for (int i = 0; i < 6; ++i) {
    Fq2 d;
    if (plus[i]) {
      fq2_add(d, *ts[i], *z[i]);
    } else {
      fq2_sub(d, *ts[i], *z[i]);
    }
    fq2_add(d, d, d);
    fq2_add(out[i], d, *ts[i]);
  }
  // c0 = (z0o, z4o, z3o), c1 = (z2o, z1o, z5o).
  r.c[0].c[0] = out[0];
  r.c[1].c[1] = out[1];
  r.c[1].c[0] = out[2];
  r.c[0].c[2] = out[3];
  r.c[0].c[1] = out[4];
  r.c[1].c[2] = out[5];
}

// B6 (`_k_cyclo_sqr`) and B7 (`_k_cyclo_sqr_mul`: acc²·g).
__device__ __forceinline__ void cyclo_sqr_lane(const int32_t* f_in,
                                               const int32_t* g_in,
                                               int32_t* f_out, int n,
                                               int lane) {
  Fq12 f;
  load_fq12(f, f_in, n, lane);
  fq12_cyclo_sqr(f, f);
  if (g_in != nullptr) {
    Fq12 g;
    load_fq12(g, g_in, n, lane);
    fq12_mul(f, f, g);
  }
  store_fq12(f_out, f, n, lane);
}

}  // namespace tc

namespace {

using tc::kThreads;

__global__ void __launch_bounds__(kThreads)
dbl_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ T,
                const int32_t* __restrict__ P, int32_t* __restrict__ fo,
                int32_t* __restrict__ To, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::dbl_fold_lane(f, T, P, fo, To, n, lane);
}

__global__ void __launch_bounds__(kThreads)
add_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ T,
                const int32_t* __restrict__ Q, const int32_t* __restrict__ P,
                int32_t* __restrict__ fo, int32_t* __restrict__ To, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::add_fold_lane(f, T, Q, P, fo, To, n, lane);
}

__global__ void __launch_bounds__(kThreads)
fq12_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ fo, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::fq12_mul_lane(a, b, fo, n, lane);
}

__global__ void __launch_bounds__(kThreads)
cyclo_sqr_kernel(const int32_t* __restrict__ f, int32_t* __restrict__ fo,
                 int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::cyclo_sqr_lane(f, nullptr, fo, n, lane);
}

__global__ void __launch_bounds__(kThreads)
cyclo_sqr_mul_kernel(const int32_t* __restrict__ f,
                     const int32_t* __restrict__ g, int32_t* __restrict__ fo,
                     int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::cyclo_sqr_lane(f, g, fo, n, lane);
}

// B17's pieces and B3's test entry before the engines.
__global__ void __launch_bounds__(kThreads)
dbl_step_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ P,
                int32_t* __restrict__ To, int32_t* __restrict__ line, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::dbl_step_lane(T, P, To, line, n, lane);
}

__global__ void __launch_bounds__(kThreads)
add_step_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ Q,
                const int32_t* __restrict__ P, int32_t* __restrict__ To,
                int32_t* __restrict__ line, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::add_step_lane(T, Q, P, To, line, n, lane);
}

__global__ void __launch_bounds__(kThreads)
f_sqr_fold_kernel(const int32_t* __restrict__ f,
                  const int32_t* __restrict__ line, int32_t* __restrict__ fo,
                  int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::f_sqr_fold_lane(f, line, fo, n, lane);
}

__global__ void __launch_bounds__(kThreads)
f_fold_kernel(const int32_t* __restrict__ f, const int32_t* __restrict__ line,
              int32_t* __restrict__ fo, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::f_fold_lane(f, line, fo, n, lane);
}

__global__ void __launch_bounds__(kThreads)
engine_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, int m, int k, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::engine_lane(a, b, out, m, k, n, lane);
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* out(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

extern "C" int tc_dbl_step(const void* T, const void* P, void* To, void* line,
                           int n, void* stream) {
  if (n <= 0) return 0;
  dbl_step_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      in(T), in(P), out(To), out(line), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_add_step(const void* T, const void* Q, const void* P,
                           void* To, void* line, int n, void* stream) {
  if (n <= 0) return 0;
  add_step_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      in(T), in(Q), in(P), out(To), out(line), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_f_sqr_fold(const void* f, const void* line, void* fo, int n,
                             void* stream) {
  if (n <= 0) return 0;
  f_sqr_fold_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      in(f), in(line), out(fo), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_f_fold(const void* f, const void* line, void* fo, int n,
                         void* stream) {
  if (n <= 0) return 0;
  f_fold_kernel<<<grid_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      in(f), in(line), out(fo), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_fq_engine(const void* a, const void* b, void* out_, int m,
                            int k, int n, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  engine_kernel<<<grid_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(in(a), in(b), out(out_),
                                                       m, k, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_dbl_fold(const void* f, const void* T, const void* P,
                           void* fo, void* To, int n, void* stream) {
  if (n <= 0) return 0;
  dbl_fold_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f), static_cast<const int32_t*>(T),
      static_cast<const int32_t*>(P), static_cast<int32_t*>(fo),
      static_cast<int32_t*>(To), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_add_fold(const void* f, const void* T, const void* Q,
                           const void* P, void* fo, void* To, int n,
                           void* stream) {
  if (n <= 0) return 0;
  add_fold_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f), static_cast<const int32_t*>(T),
      static_cast<const int32_t*>(Q), static_cast<const int32_t*>(P),
      static_cast<int32_t*>(fo), static_cast<int32_t*>(To), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_fq12_mul(const void* a, const void* b, void* fo, int n,
                           void* stream) {
  if (n <= 0) return 0;
  fq12_mul_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(fo), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_fq12_sqr(const void* a, void* fo, int n, void* stream) {
  if (n <= 0) return 0;
  fq12_mul_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), nullptr, static_cast<int32_t*>(fo), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_cyclo_sqr(const void* f, void* fo, int n, void* stream) {
  if (n <= 0) return 0;
  cyclo_sqr_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f), static_cast<int32_t*>(fo), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_cyclo_sqr_mul(const void* f, const void* g, void* fo, int n,
                                void* stream) {
  if (n <= 0) return 0;
  cyclo_sqr_mul_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f), static_cast<const int32_t*>(g),
      static_cast<int32_t*>(fo), n);
  return static_cast<int>(cudaGetLastError());
}
"""
# --split: the package's kernels with one part of the work taken out, to
# see where their time goes (their results are wrong, so they are timed
# only): (name, [(text, replacement) in tower_group.cuh, miller.cu,
# fq12.cu]).
SPLIT = {
    "no product (an add instead)": [
        ("      a = reg::fp_mul_call(a, b);", "      reg::fp_add(a, a, b);")],
    "product operands one slot each": [
        ("    form(a, terms + t0, fa, lane);",
         "    if (fb != 0) slot_load(a, lane, terms[t0] >> 8);\n"
         "    else form(a, terms + t0, fa, lane);"),
        ("        form(b, tb, fb, lane);",
         "        slot_load(b, lane, tb[0] >> 8);")],
    "no linear ops": [
        ("    const int dst = op[0], t0 = op[1], fa = op[2], fb = op[3];",
         "    const int dst = op[0], t0 = op[1], fa = op[2], fb = op[3];\n"
         "    if (fb == 0) continue;")],
    "no reduction steps": [
        ("  if (word & kQStep) qstep(t);", ""),
        ("  const int csubs = (word >> kCSubShift) & 3;",
         "  const int csubs = 0;")],
    "staging only": [("  for (int ph = 0; ph < phases; ++ph) {",
                      "  for (int ph = 0; ph < 0; ++ph) {")],
}
GROUP_LINE = "constexpr int kGroup = 8;"
GROUPS = (1, 4, 8, 16, 32)
# The B3-B9 and B17 kernels' names (demangled) in the variants: old (B8
# and B9 share fq12_mul_kernel; B17 and B3 have their names in both),
# group.
KERNEL_NAMES = ("dbl_fold_kernel", "add_fold_kernel", "cyclo_sqr_kernel",
                "cyclo_sqr_mul_kernel", "fq12_mul_kernel",
                "cyclo_sqr_group_kernel", "cyclo_sqr_mul_group_kernel",
                "fq12_mul_group_kernel", "fq12_sqr_group_kernel",
                "dbl_step_kernel", "add_step_kernel", "f_sqr_fold_kernel",
                "f_fold_kernel", "engine_kernel")
WIDTHS = {"dbl_fold": (2 * cs.LANES, 2 * cs.RLC_CHECK_BATCH),
          "add_fold": (2 * cs.LANES, 2 * cs.RLC_CHECK_BATCH),
          "cyclo_sqr": (cs.LANES, cs.RLC_CHECK_BATCH),
          "cyclo_sqr_mul": (cs.LANES, cs.RLC_CHECK_BATCH),
          "fq12_mul": (cs.LANES, cs.RLC_CHECK_BATCH),
          "fq12_sqr": (cs.LANES, cs.RLC_CHECK_BATCH),
          "dbl_step": (2 * cs.LANES, 2 * cs.RLC_CHECK_BATCH),
          "add_step": (2 * cs.LANES, 2 * cs.RLC_CHECK_BATCH),
          "f_sqr_fold": (2 * cs.LANES, 2 * cs.RLC_CHECK_BATCH),
          "f_fold": (2 * cs.LANES, 2 * cs.RLC_CHECK_BATCH),
          "fq_engine": (cs.TOWER_CHECKS["fq_engine"][3],)}
REPS = {"dbl_fold": 20, "add_fold": 20, "cyclo_sqr": 50,
        "cyclo_sqr_mul": 20, "fq12_mul": 20, "fq12_sqr": 20,
        "dbl_step": 20, "add_step": 20, "f_sqr_fold": 20, "f_fold": 20,
        "fq_engine": 50}
# Per kernel: its C entry, its input tensors and its outputs' rows (B3:
# five blocks of its inputs' rows, and m, k before n).
ENTRIES = {"dbl_fold": ("miller", "tc_dbl_fold", 3, (288, 144)),
           "add_fold": ("miller", "tc_add_fold", 4, (288, 144)),
           "cyclo_sqr": ("fq12", "tc_cyclo_sqr", 1, (288,)),
           "cyclo_sqr_mul": ("fq12", "tc_cyclo_sqr_mul", 2, (288,)),
           "fq12_mul": ("fq12", "tc_fq12_mul", 2, (288,)),
           "fq12_sqr": ("fq12", "tc_fq12_sqr", 1, (288,)),
           "dbl_step": ("miller", "tc_dbl_step", 2, (144, 144)),
           "add_step": ("miller", "tc_add_step", 3, (144, 144)),
           "f_sqr_fold": ("miller", "tc_f_sqr_fold", 2, (288,)),
           "f_fold": ("miller", "tc_f_fold", 2, (288,)),
           "fq_engine": ("fq12", "tc_fq_engine", 2, None)}
# B3's k in the check (chip_smoke.check_tower's).
ENGINE_K = 8
# The stages of an RLC call read in each turn (the program's span names):
# the check, and the two MSM tables (B10).
TURN_STAGES = {"check_ms": "ops.verify_batch_pallas",
               "table_ms": "msm.table"}
# Kernels summed from chip_smoke.kernel_event_timer's events in each turn's
# RLC and per-pair calls: B9.
TURN_KERNELS = {"b9": "fq12_sqr"}
# Timed calls of one turn, after a warm-up call; of the check's width
# alone, which is short and spreads widely, CHECK_CALLS.
TURN_CALLS = 5
CHECK_CALLS = 20
# One turn in the checkout that is the child's working directory: its
# kernels built (one nvcc per source, together), then TURN_CALLS RLC
# calls, as many with the stages bracketed by events (TURN_STAGES, given
# as argv[2]), as many with the kernels of TURN_KERNELS (argv[3])
# bracketed, and as many per-pair calls at 8192 lanes, then as many with
# those kernels bracketed, and CHECK_CALLS (argv[4]) per-pair calls at
# RLC_CHECK_BATCH lanes, each after a warm-up call; then TURN_CALLS B17
# compositions (a Miller loop through B17 and one through B4/B5, in turns
# inside each) after a warm-up one.
TURN_CHILD = """
import json, sys
import torch
import chip_smoke as cs
from threshold_crypto_tpu_torch import _build, ops
from threshold_crypto_tpu_torch.device import pairing as dpr
_build.build()
dev = torch.device("cuda", 0)
calls = int(sys.argv[1])
stages = json.loads(sys.argv[2])
kernels = json.loads(sys.argv[3])
check_calls = int(sys.argv[4])


def kernel_ms(call, out):
    spans = []
    with cs.kernel_event_timer(spans):
        call()
    torch.cuda.synchronize()
    for key, name in kernels.items():
        out.setdefault(key, []).append(
            sum(a.elapsed_time(b) for k, a, b in spans if k == name))
pk_aff, sig_aff, h_jac = cs.rlc_inputs(dev)[:3]
rlc, staged = [], {k: [] for k in stages}
for i in range(1 + calls):
    ok, _, s = cs.rlc_call(pk_aff, sig_aff, h_jac, bytes([40 + i]) * 32)
    if not ok:
        raise SystemExit("the valid batch was rejected")
    rlc.append(s)
for i in range(1 + calls):
    spans = []
    with cs.stage_timer(spans):
        ok, _, _ = cs.rlc_call(pk_aff, sig_aff, h_jac, bytes([80 + i]) * 32)
    torch.cuda.synchronize()
    if not ok:
        raise SystemExit("the valid batch was rejected")
    for key, name in stages.items():
        staged[key].append(sum(r["device_ms"] for r in spans
                               if r["name"] == name))
pk, h, sig, want = cs.build_inputs()
args = (dpr.g1_affine_from_host(pk, device=dev),
        dpr.g2_affine_from_host(h, device=dev),
        dpr.g2_affine_from_host(sig, device=dev))
want_t = torch.tensor(want, device=dev)
pair = [cs.timed_call(ops.verify_batch_pallas, args, want_t, "pairs")[1]
        for _ in range(1 + calls)]

def cut(x):
    if isinstance(x, tuple):
        return tuple(cut(y) for y in x)
    return x[:cs.RLC_CHECK_BATCH].contiguous()


args_c, want_c = cut(args), want_t[:cs.RLC_CHECK_BATCH]
check = [cs.timed_call(ops.verify_batch_pallas, args_c, want_c, "check")[1]
         for _ in range(1 + check_calls)]
rlc_k, pair_k = {}, {}
for i in range(1 + calls):
    kernel_ms(lambda: cs.rlc_call(pk_aff, sig_aff, h_jac,
                                  bytes([120 + i]) * 32), rlc_k)
    kernel_ms(lambda: ops.verify_batch_pallas(*args), pair_k)
b17 = [cs.run_b17_composition(args, dev) for _ in range(1 + calls)]
print(json.dumps({"rlc_s": rlc[1:], "pair_s": pair[1:],
                  "check512_s": check[1:],
                  "b17_loop_ms": [c["split_ms"] for c in b17[1:]],
                  "b4b5_loop_ms": [c["fused_ms"] for c in b17[1:]],
                  **{k: v[1:] for k, v in staged.items()},
                  **{f"rlc_{k}_ms": v[1:] for k, v in rlc_k.items()},
                  **{f"pair_{k}_ms": v[1:] for k, v in pair_k.items()}}))
"""


def nvcc_start(src, out_dir, name):
    so = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_build.nvcc(), *_build.FLAGS, "-o", so, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def nvcc_wait(proc, what):
    log, _ = proc.communicate(timeout=1500)
    if proc.returncode != 0:
        print(log[-4000:], flush=True)
        raise RuntimeError(f"nvcc failed for {what}")
    return log


def build_variants(bdir, split):
    """{variant: {source: (Popen, so)}}, every nvcc started together; with
    split, the package's kernels and the SPLIT cuts only."""
    procs = {}
    if split:
        for i, (name, patches) in enumerate({"kernel": [],
                                             **SPLIT}.items()):
            d = os.path.join(bdir, f"split{i}")
            shutil.copytree(_build.CSRC, d)
            for fname in ("tower_group.cuh", "miller.cu", "fq12.cu"):
                path = os.path.join(d, fname)
                text = open(path).read()
                for old, new in patches:
                    text = text.replace(old, new)
                with open(path, "w") as f:
                    f.write(text)
            procs[name] = {src: nvcc_start(os.path.join(d, f"{src}.cu"), d,
                                           src)
                           for src in ("miller", "fq12")}
        for name, patches in SPLIT.items():
            for old, _ in patches:
                if not any(old in open(os.path.join(_build.CSRC, f)).read()
                           for f in ("tower_group.cuh", "miller.cu",
                                     "fq12.cu")):
                    raise RuntimeError(f"split anchor not found: {old!r}")
        return procs
    d = os.path.join(bdir, "old")
    shutil.copytree(_build.CSRC, d)
    with open(os.path.join(d, "tower_old.cu"), "w") as f:
        f.write(OLD_CU)
    lib = nvcc_start(os.path.join(d, "tower_old.cu"), d, "tower_old")
    procs["old"] = {"miller": lib, "fq12": lib}
    for g in GROUPS:
        d = os.path.join(bdir, f"g{g}")
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, "tower_group.cuh")
        text = open(path).read()
        if GROUP_LINE not in text:
            raise RuntimeError(f"patch anchor not found: {GROUP_LINE!r}")
        with open(path, "w") as f:
            f.write(text.replace(GROUP_LINE, f"constexpr int kGroup = {g};"))
        procs[f"g{g}"] = {name: nvcc_start(os.path.join(d, f"{name}.cu"), d,
                                           name)
                          for name in ("miller", "fq12")}
    return procs


def load(so, kernel):
    """The C entry of kernel (ENTRIES) in the library at so, with its
    signature: the input and output pointers, (B3: m, k,) n, the
    stream."""
    _, fn, n_in, out_rows = ENTRIES[kernel]
    entry = getattr(ctypes.CDLL(so), fn)
    ints = 1 if out_rows else 3
    entry.argtypes = ([ctypes.c_void_p] * (n_in + len(out_rows or (0,)))
                      + [ctypes.c_int] * ints + [ctypes.c_void_p])
    entry.restype = ctypes.c_int
    return entry


def graph_time_ms(fn, reps):
    """Mean device time of one fn() over reps launches captured in one CUDA
    graph and replayed (no host dispatch between them), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# --final-exp: timed launches a graph holds at each width (a launch of the
# tower path at 65,536 lanes takes about 120 ms).
FINAL_EXP_REPS = {"kernel": {1: 50, 256: 50, cs.LANES: 20, 65536: 10},
                  "tower": {1: 5, 256: 5, cs.LANES: 3, 65536: 2}}


def final_exp_turns(cardd):
    """B18 against what it replaced and against B8, in turns at each of
    chip_smoke.B18_WIDTHS: {key: {name: {"ms": [...], "graph_ms": [...]}}}
    and the bounds."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_tower as ctw
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.device import packed as pk
    from threshold_crypto_tpu_torch.device import tower as tw

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    out = {}
    for n in cs.B18_WIDTHS:
        a, b = cs.b18_inputs(n, gen, dev)
        cases = {"easy part": {
            "kernel": lambda: ctw.p_easy_part(a),
            "tower": lambda: ctw.easy_part_ref(a)}}
        for k in (1, 2):
            cases[f"frob_mul k={k}"] = {
                "kernel": lambda k=k: ctw.frob_mul(a, b, k),
                "fq12_mul": lambda: ctw.fq12_mul(a, b),
                "tower": lambda k=k: ctw.fq12_mul(a, pk.pack12(
                    tw.fq12_frob(pk.unpack12(b), k)))}
        bound = {"easy part": sum(
            cs.bound_ms((comps + outs) * 24 * 4 * n,
                        n * prods * cs.FQ_PRODUCT_IMADS, cardd)[0]
            for name, (comps, outs, prods) in cs.B18_CHECKS.items()
            if name != "frob_mul")
            + cs.pow_bound(mont.FQ, n, mont.FQ.p - 2, cardd)[0]}
        comps, outs, prods = cs.B18_CHECKS["frob_mul"]
        for k in (1, 2):
            bound[f"frob_mul k={k}"] = cs.bound_ms(
                (comps + outs) * 24 * 4 * n, n * prods * cs.FQ_PRODUCT_IMADS,
                cardd)[0]
        for case, fns in cases.items():
            key = f"{case} n={n}"
            want = fns["kernel"]()
            for name, fn in fns.items():
                if name != "fq12_mul" and not torch.equal(fn(), want):
                    raise RuntimeError(f"{key}: {name} differs from the "
                                       f"kernel")
            names = list(fns)
            times = {name: {"ms": [], "graph_ms": []} for name in names}
            for name in names[::-1] + names:
                reps = FINAL_EXP_REPS["tower" if name == "tower"
                                      else "kernel"][n]
                times[name]["ms"].append(cs.cuda_time_ms(fns[name], reps))
                times[name]["graph_ms"].append(graph_time_ms(fns[name],
                                                             reps))
            out[key] = times
            times["bound_ms"] = bound[case]
            print(f"{key} (bit-exact; bound {bound[case]:.4f} ms), "
                  f"launched one by one | replayed from a CUDA graph: "
                  + ", ".join(f"{nm} {statistics.mean(t['ms']):.4f} | "
                              f"{statistics.mean(t['graph_ms']):.4f} ms"
                              for nm, t in times.items()
                              if nm != "bound_ms"), flush=True)
        del a, b, cases, want
        torch.cuda.empty_cache()
    return out


def turns(parent):
    """Both checkouts' calls in turns (parent, this, this, parent, twice):
    {"parent": {...}, "this": {...}}, each key a list over the turns."""
    roots = {"parent": os.path.abspath(parent), "this": ROOT}
    keys = ["rlc_s", "pair_s", "check512_s", "b17_loop_ms", "b4b5_loop_ms",
            *TURN_STAGES,
            *(f"{w}_{k}_ms" for w in ("rlc", "pair") for k in TURN_KERNELS)]
    out = {k: {key: [] for key in keys} for k in roots}
    for who in ("parent", "this", "this", "parent") * 2:
        proc = subprocess.run([sys.executable, "-c", TURN_CHILD,
                               str(TURN_CALLS), json.dumps(TURN_STAGES),
                               json.dumps(TURN_KERNELS), str(CHECK_CALLS)],
                              cwd=roots[who],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            raise RuntimeError(f"the turn of {who} failed")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        for k, v in got.items():
            out[who][k] += v
        print(f"turn {who}: " + ", ".join(
            f"{k} {[round(x, 4) for x in v]}" for k, v in got.items()),
            flush=True)
    for key in keys:
        calls = CHECK_CALLS if key == "check512_s" else TURN_CALLS
        print(f"{key} in turns ({calls} calls a turn): " + ", ".join(
            f"{who} median {statistics.median(v[key]):.4f} (quartiles "
            f"{statistics.quantiles(v[key], n=4)[0]:.4f}-"
            f"{statistics.quantiles(v[key], n=4)[2]:.4f})"
            for who, v in out.items()), flush=True)
    return out


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout: time its "
                    "RLC call, check stage and per-pair call in turns with "
                    "this one's")
    ap.add_argument("--split", action="store_true", help="time the "
                    "package's kernels with one part of their work taken "
                    "out (SPLIT) instead of the variants")
    ap.add_argument("--final-exp", action="store_true", help="time B18 "
                    "against the tower path it replaced and against B8 "
                    "instead of the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tower_variants: no CUDA device", file=sys.stderr)
        return 2
    from threshold_crypto_tpu_torch.device import cuda_tower as ctw

    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    cardd = {"sms": props.multi_processor_count, "clock_hz": clock * 1e6}

    bdir = os.path.join(_build.BUILD_DIR, "variants")
    shutil.rmtree(bdir, ignore_errors=True)
    os.makedirs(bdir)
    if args.final_exp:
        _build.build(["fq12", "mont"])
        res = {"card": card, "final_exp": final_exp_turns(cardd)}
        if args.parent:
            res["turns"] = turns(args.parent)
        line = json.dumps(res)
        with open(os.path.join(bdir, "tower_variants.json"), "w") as f:
            f.write(line + "\n")
        print(line, flush=True)
        return 0
    t0 = time.time()
    procs = build_variants(bdir, args.split)
    _build.build(["miller", "fq12"])
    res = {"card": card, "variants": {}}
    libs = {}
    for name, srcs in procs.items():
        ptxas, sos = {}, {}
        for src, (proc, so) in srcs.items():
            if so in sos.values():
                continue
            ptxas.update(cs.print_ptxas(
                src, nvcc_wait(proc, f"variant {name} {src}.cu")))
            sos[src] = so
        res["variants"][name] = {
            "ptxas": {k: v for k, v in ptxas.items() if k in KERNEL_NAMES},
            "ms": {}}
        libs[name] = {k: load(sos.get(src, sos["miller"]), k)
                      for k, (src, _, _, _) in ENTRIES.items()}
        print(f"{name}: ptxas {res['variants'][name]['ptxas']}", flush=True)
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def run(variant, kernel, ins):
        out_rows, n = ENTRIES[kernel][3], ins[0].shape[1]
        if out_rows is None:     # B3: a·b, a + b, a − b, −a, k·a
            out = (torch.empty((5,) + tuple(ins[0].shape),
                               dtype=torch.int32, device=dev),)
            extra = (ins[0].shape[0] // 24, ENGINE_K, n)
        else:
            out = tuple(torch.empty((r, n), dtype=torch.int32, device=dev)
                        for r in out_rows)
            extra = (n,)
        err = libs[variant][kernel](*(x.data_ptr() for x in (*ins, *out)),
                                    *extra, stream())
        if err:
            raise RuntimeError(f"{variant} {kernel}: launch error {err}")
        return out

    res["bound_ms"] = {}
    order = list(libs) + list(libs)[::-1]
    for kernel, widths in WIDTHS.items():
        pkg = getattr(ctw, kernel)
        plain = getattr(ctw, kernel + "_ref")
        comps, out_comps, products, _ = cs.TOWER_CHECKS[kernel]
        k_arg = (ENGINE_K,) if kernel == "fq_engine" else ()
        for n in widths:
            ins = cs.tower_inputs(kernel, gen, dev, n)
            want = pkg(*ins, *k_arg)
            want = want if isinstance(want, tuple) else (want,)
            ref = plain(*ins, *k_arg)
            ref = ref if isinstance(ref, tuple) else (ref,)
            if not all(torch.equal(a, b) for a, b in zip(want, ref)):
                raise RuntimeError(f"the package's {kernel} differs from its "
                                   f"plain version at {n} lanes")
            for name in libs:
                if args.split and name != "kernel":
                    continue
                got = run(name, kernel, ins)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"variant {name} {kernel} differs "
                                       f"from the package's at {n} lanes")
            bound = cs.bound_ms((sum(comps) + out_comps) * 24 * 4 * n,
                                n * products * cs.FQ_PRODUCT_IMADS, cardd)[0]
            key = f"{kernel} n={n}"
            res["bound_ms"][key] = bound
            for name in order:
                fn = (lambda: run(name, kernel, ins))  # noqa: E731
                v = res["variants"][name]
                v["ms"].setdefault(key, []).append(
                    cs.cuda_time_ms(fn, REPS[kernel]))
                v.setdefault("graph_ms", {}).setdefault(key, []).append(
                    graph_time_ms(fn, REPS[kernel]))
            checked = "the kernel" if args.split else "every variant"
            print(f"{key} (bound {bound:.4f} ms; {checked} bit-exact), "
                  f"launched one by one | replayed from a CUDA graph: "
                  + ", ".join(
                      f"{nm} {statistics.mean(v['ms'][key]):.4f} | "
                      f"{statistics.mean(v['graph_ms'][key]):.4f} ms"
                      for nm, v in res["variants"].items()), flush=True)
            del ins, want, ref
    torch.cuda.empty_cache()
    if args.parent:
        res["turns"] = turns(args.parent)
    line = json.dumps(res)
    with open(os.path.join(bdir, "tower_variants.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
