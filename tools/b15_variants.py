#!/usr/bin/env python3
"""B15 (``csrc/ladder.cu`` ``step_kernel``) and B14 (``csrc/fr.cu``
``lagr_kernel``) against their old bodies and design variants, on one card.

    python3 tools/b15_variants.py [--parent ROOT]

Each variant is the package's ``csrc/`` with one design choice changed by a
text patch, built with the package's nvcc flags into
``threshold_crypto_tpu_torch/_build/variants/``. B15 (ladder.cu):

* ``old``: the lane body of ``csrc/curve.cuh`` that B15 ran before the
  register engine (``msm_step`` and ``step_lane``, kept here as text):
  ``__noinline__`` formulas over a local-memory frame, the doubling of 2T
  computed on every set-bit lane and selected; no register cap;
* ``kernel``: the sources as they are (``step_lane_r`` on
  ``csrc/ladder_engine.cuh``, Q read where first used, G1 at 3 blocks of
  128 threads an SM (168-register cap), G2 at 2 (255));
* ``g1b2``: G1 at 2 blocks (the 255-register cap);
* ``held``: Q's x and y loaded once and held in registers across the bits.

B14 (fr.cu):

* ``old``: the ``fq.cuh`` body B14 ran before (the serial-carry
  ``mont_mul<8>``, one product chain a thread, a branch on a zero
  difference), kept here as text;
* ``acc1``, ``acc2``, ``acc4``: the carry-save product of the register
  engine with 1, 2 and 4 accumulators a lane (``kLagrAccs``; the package
  runs ``acc1``).

For each: ptxas's registers, stack frame and spills; bit-exact against the
package's kernels, B15 at its three paths' widths (``chip_smoke.STEP_WIDTHS``:
65,536 x 64, 262,144 x 64 and 4096 x 255 bits) on ``chip_smoke.step_special``
and on random bits, G1 and G2, B14 on ``chip_smoke.rowprod_inputs`` (N =
4096, a duplicate pair and a zero lane); and the kernel time from a CUDA
graph in turns (the variants, then the same in reverse), beside the bound
(``chip_smoke.ladder_bound``, B14's n² Fr products) and for B15 the
latency yardstick (``chip_smoke.thread_product_latency_ms`` times a lane's
mean products).

With ``--parent ROOT`` (another checkout: its ``chip_smoke.py`` and
``threshold_crypto_tpu_torch/``) it also times both checkouts' calls in
turns, one child process per turn (parent, this, this, parent, twice):
``ops.verify_sig_shares_rlc`` on ``chip_smoke.rlc_inputs``' batch at
``chip_smoke.RLC_N`` (exponents ``rlc_exponents(.., b"\\x09" * 32)``), then
``ops.combine_batch(path="scalarwise")`` at t + 1 = COMBINE_N shares in G2
and G1 (the inputs of ``benches/combine_large.py``, seed COMBINE_SEED, as
``tools/b16_variants.py``); a warm-up call, TURN_CALLS timed calls and one
with the kernels bracketed by events (B15's and B14's event sums); every
call must accept, and every turn's combined points must be the same.
Prints one JSON line last and writes it to ``b15_variants.json`` beside
the builds. Without CUDA it exits 2.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
import tower_variants as tv  # noqa: E402
from threshold_crypto_tpu_torch import _build  # noqa: E402

# curve.cuh's B15 formula and lane body before the register engine.
OLD_STEP = r"""
// One set bit of the per-lane ladder (`_msm_step` with do_add): r = 2T + Q
// (Q affine). The doubling of T runs as in jac_dbl; the mixed add starts
// from 2T with Zd² = 4S² and Zd³ = Zd²·Zd, and the doubling of 2T (Xdd,
// Ydd, Zdd) covers the 2T == Q case. The selects, in the JAX order:
// 2T == Q -> 4T, 2T == -Q -> infinity, T at infinity -> Q. The JAX gate
// (a clear bit gives 2T = (Xd, Yd, Zd)) is a branch in step_lane, which runs
// jac_dbl for a clear bit: the same bits. The gate is not an early return
// here: nvcc 12.9 miscompiled an early return from this function for Fq on
// sm_90a (wrong values, and an illegal address where r did not alias T).
template <class F>
__device__ __noinline__ void msm_step(Jac<F>& r, const Jac<F>& T,
                                      const F& x2, const F& y2) {
  F A, B, S, XpB, E, C, XB2, E2, SS, D, Xd, z1z, Zd, EDX, u2, z1cu, Yd, h;
  F s2, hh, A2, B2, S2, rr_, XpB2, E2_, hhh, v, rr, C2, XB2b, E2sq, Xn, D2;
  F Xdd, Yn, Zn, Ydd, Zdd, t, u;
  // L1
  f_sqr(A, T.X);
  f_sqr(B, T.Y);
  f_mul(S, T.Y, T.Z);
  f_add(XpB, T.X, B);
  f_small(E, A, 3);
  // L2
  f_sqr(C, B);
  f_sqr(XB2, XpB);
  f_sqr(E2, E);
  f_sqr(SS, S);
  f_sub(t, XB2, A);
  f_sub(t, t, C);
  f_small(D, t, 2);
  f_small(t, D, 2);
  f_sub(Xd, E2, t);                      // Xd = E² − 2D
  f_small(z1z, SS, 4);                   // Zd² = 4S²
  f_small(Zd, S, 2);                     // Zd = 2S
  // L3
  f_sub(t, D, Xd);
  f_mul(EDX, E, t);
  f_small(u, C, 8);
  f_sub(Yd, EDX, u);                     // Yd = E(D − Xd) − 8C
  f_mul(u2, x2, z1z);
  f_mul(z1cu, z1z, Zd);
  f_sub(h, u2, Xd);
  // L4
  f_mul(s2, y2, z1cu);
  f_sqr(hh, h);
  f_sqr(A2, Xd);
  f_sqr(B2, Yd);
  f_mul(S2, Yd, Zd);
  f_sub(rr_, s2, Yd);                    // r
  f_add(XpB2, Xd, B2);
  f_small(E2_, A2, 3);
  // L5
  f_mul(hhh, h, hh);
  f_mul(v, Xd, hh);
  f_sqr(rr, rr_);
  f_sqr(C2, B2);
  f_sqr(XB2b, XpB2);
  f_sqr(E2sq, E2_);
  f_sub(t, rr, hhh);
  f_small(u, v, 2);
  f_sub(Xn, t, u);                       // Xn = r² − hhh − 2v
  f_sub(t, XB2b, A2);
  f_sub(t, t, C2);
  f_small(D2, t, 2);
  f_small(t, D2, 2);
  f_sub(Xdd, E2sq, t);
  // L6
  f_sub(t, v, Xn);
  f_mul(t, rr_, t);                      // r(v − Xn)
  f_mul(u, Yd, hhh);
  f_sub(Yn, t, u);
  f_mul(Zn, Zd, h);
  f_sub(t, D2, Xdd);
  f_mul(t, E2_, t);
  f_small(u, C2, 8);
  f_sub(Ydd, t, u);
  f_small(Zdd, S2, 2);

  const bool h0 = f_is_zero(h);
  const bool r0 = f_is_zero(rr_);
  const bool t_inf = f_is_zero(Zd);
  Jac<F> out;
  out.X = Xn;
  out.Y = Yn;
  out.Z = Zn;
  select3(out, h0 && r0, Xdd, Ydd, Zdd);  // 2T == Q  -> 4T
  F one, zero;
  f_set(one, true);
  f_set(zero, false);
  select3(out, h0 && !r0, one, one, zero);  // 2T == -Q -> infinity
  select3(out, t_inf, x2, y2, one);      // T at infinity -> Q
  r = out;
}

// ---------------------------------------------------------------------------
// Per-lane bodies
// ---------------------------------------------------------------------------

// B15 (`_k_g1_msm_step` / `_k_g2_msm_step`) with the ladder inside the
// thread: acc [3k·24, n] Jacobian, q [2k·24, n] affine, bits [nbits, n]
// MSB first; per bit T <- 2T (+ Q where the bit is set). nbits = 1 is the
// TPU kernel.
template <class F>
__device__ __forceinline__ void step_lane(const int32_t* acc_in,
                                          const int32_t* q_in,
                                          const int32_t* bits, int32_t* out,
                                          int n, int nbits, int lane) {
  Jac<F> T;
  F x2, y2;
  load_jac(T, acc_in, 0, n, lane);
  f_load(x2, q_in, 0, n, lane);
  f_load(y2, q_in, Comps<F>::k, n, lane);
  for (int b = 0; b < nbits; ++b) {
    if (bits[static_cast<size_t>(b) * n + lane] != 0)
      msm_step(T, T, x2, y2);
    else
      jac_dbl(T, T);
  }
  store_jac(out, T, n, lane);
}

}  // namespace tc
"""
# ladder.cu's B15 kernel before the register engine: one thread a lane
# over curve.cuh, no register cap.
OLD_STEP_KERNEL = r"""template <class F>
__global__ void __launch_bounds__(kThreads)
step_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ q,
            const int32_t* __restrict__ bits, int32_t* __restrict__ out,
            int n, int nbits) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::step_lane<F>(acc, q, bits, out, n, nbits, lane);
}
"""
# The package's ladder.cu from B15's block count to the end of its kernel:
# what OLD_STEP_KERNEL takes the place of.
STEP_HEAD = "// B15's blocks of kThreads that must fit on an SM together"
STEP_TAIL = ("  if (lane < n) tc::step_lane_r<F>(acc, q, bits, out, n, nbits, "
             "lane);\n}\n")
ENGINE_INCLUDE = '#include "ladder_engine.cuh"\n'
# Q held in registers across the bits, in place of AffineAt.
HELD_STRUCT = r"""namespace reg {

// Q affine, loaded once and held in registers.
template <class R>
struct AffineHeld {
  R x2, y2;
  __device__ __forceinline__ void x(R& r) const { r = x2; }
  __device__ __forceinline__ void y(R& r) const { r = y2; }
};

}  // namespace reg

"""
HELD_ANCHOR = "// B15 (`_k_g1_msm_step` / `_k_g2_msm_step`, body `_msm_step`)"
Q_LINE = "  const reg::AffineAt<R> q{q_in, kc, n, lane};\n"
Q_HELD = ("  reg::AffineHeld<R> q;\n"
          "  reg::f_load(q.x2, q_in, 0, n, lane);\n"
          "  reg::f_load(q.y2, q_in, kc, n, lane);\n")
G1_BLOCKS = ("ladder.cu",
             "struct StepBlocks<tc::Fq> {\n  static constexpr int value = 3;",
             "struct StepBlocks<tc::Fq> {\n  static constexpr int value = 2;")
# fr.cuh before the register engine's product (its fq.cuh engine, one
# product chain a thread).
OLD_FR_CUH = r"""#pragma once

#include "fq.cuh"
#include "ladder_engine.cuh"

namespace tc {

using reg::FrField;

constexpr int kFrWords = FrField::kWords;
constexpr int kFrLimbs = 2 * kFrWords;  // 16-bit limbs of the public layout

__constant__ Modulus<kFrWords> kFr = {
    {FrField::p(0), FrField::p(1), FrField::p(2), FrField::p(3),
     FrField::p(4), FrField::p(5), FrField::p(6), FrField::p(7)},
    FrField::kN0,
    {FrField::one(0), FrField::one(1), FrField::one(2), FrField::one(3),
     FrField::one(4), FrField::one(5), FrField::one(6), FrField::one(7)},
};

struct Fr {
  uint32_t w[kFrWords];
};

// r = a·b·R^-1 mod r. r may alias a or b.
__device__ __forceinline__ void fr_mul(Fr& r, const Fr& a, const Fr& b) {
  mont_mul<kFrWords>(r.w, a.w, b.w, kFr);
}

// r = (a − b) mod r. r may alias a or b.
__device__ __forceinline__ void fr_sub(Fr& r, const Fr& a, const Fr& b) {
  mod_sub<kFrWords>(r.w, a.w, b.w, kFr);
}

__device__ __forceinline__ bool fr_is_zero(const Fr& a) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < kFrWords; ++k) any |= a.w[k];
  return any == 0;
}

__device__ __forceinline__ void fr_set_one(Fr& a) {
#pragma unroll
  for (int k = 0; k < kFrWords; ++k) a.w[k] = kFr.one[k];
}

// Lane i of a row-major [n, 16] tensor.
__device__ __forceinline__ void load_fr(Fr& x, const int32_t* xs, int i) {
  load_row<kFrWords>(xs + static_cast<size_t>(i) * kFrLimbs, x.w);
}

__device__ __forceinline__ void store_fr(int32_t* dst, const Fr& x, int i) {
  store_row<kFrWords>(dst + static_cast<size_t>(i) * kFrLimbs, x.w);
}

// The j-sweep of B14 for one lane i: for each of the m values xj[0..m),
// acc ·= (x_j − x_i) where the difference is not zero, and zc += 1 where it
// is (the diagonal j = i, and any x_j equal to x_i). The branch diverges
// only on those lanes.
__device__ __forceinline__ void lagr_sweep(Fr& acc, int& zc, const Fr& xi,
                                           const Fr* xj, int m) {
  for (int j = 0; j < m; ++j) {
    Fr d;
    fr_sub(d, xj[j], xi);
    if (fr_is_zero(d)) {
      ++zc;
    } else {
      fr_mul(acc, acc, d);
    }
  }
}

}  // namespace tc
"""
# fr.cu's kernel and launcher before, over OLD_FR_CUH.
OLD_FR_CU = r"""#include <cstdint>
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

using tc::kThreads;

__global__ void __launch_bounds__(kThreads)
lagr_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ prod,
            int32_t* __restrict__ cnt, int n, int chunk) {
  __shared__ tc::Fr tile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(n, j0 + chunk);
  tc::Fr xi, acc;
  int zc = 0;
  tc::fr_set_one(acc);
  if (i < n) {
    tc::load_fr(xi, xs, i);
  } else {
    xi = acc;
  }
  // Every thread of the block takes part in the staging, the lanes past n
  // included, so no thread leaves before a barrier.
  for (int t = j0; t < j1; t += kThreads) {
    const int m = min(kThreads, j1 - t);
    __syncthreads();
    if (threadIdx.x < m) tc::load_fr(tile[threadIdx.x], xs, t + threadIdx.x);
    __syncthreads();
    if (i < n) tc::lagr_sweep(acc, zc, xi, tile, m);
  }
  if (i < n) {
    tc::store_fr(prod + static_cast<size_t>(blockIdx.y) * n * tc::kFrLimbs,
                 acc, i);
    cnt[static_cast<size_t>(blockIdx.y) * n + i] = zc;
  }
}

}  // namespace

extern "C" int tc_lagrange_rowprod(const void* xs, void* prod, void* cnt,
                                   int n, int chunk, void* stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || chunk % tc::kThreads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + tc::kThreads - 1) / tc::kThreads,
                  (n + chunk - 1) / chunk);
  lagr_kernel<<<grid, tc::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(prod),
      static_cast<int32_t*>(cnt), n, chunk);
  return static_cast<int>(cudaGetLastError());
}
"""
ACCS = "constexpr int kLagrAccs = 1;"
STEP_VARIANTS = {"old": ["old step"], "kernel": [], "g1b2": [G1_BLOCKS],
                 "held": ["held"]}
FR_VARIANTS = {"old": ["old fr"], "acc1": [],
               "acc2": [("fr.cuh", ACCS, ACCS.replace("1", "2"))],
               "acc4": [("fr.cuh", ACCS, ACCS.replace("1", "4"))]}
REPS = 3
# Timed calls of one turn, after a warm-up call.
TURN_CALLS = 5
COMBINE_SEED = 0xC0B1E   # benches/combine_large.py
# One turn in the checkout that is the child's working directory: its
# kernels built (one nvcc per source, together), then
# verify_sig_shares_rlc on chip_smoke's RLC batch, and per curve (G2, G1)
# the scalarwise combine on the inputs of benches/combine_large.py at
# argv[2] shares (seed argv[3]); each a warm-up call, argv[1] timed calls
# and one with the kernels bracketed by events. Prints per call the times,
# B15's and B14's event sums and the result.
TURN_CHILD = """
import json, random, sys, time
import torch
import chip_smoke as cs
from threshold_crypto_tpu_torch import _build, ops
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R
from threshold_crypto_tpu_torch.ops import fr as frops
_build.build()
dev = torch.device("cuda", 0)
calls, n, seed = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])


def events(call):
    spans = []
    with cs.kernel_event_timer(spans):
        call()
    torch.cuda.synchronize()
    ms = lambda names: sum(a.elapsed_time(b) for k, a, b in spans
                           if k in names)
    return ms(("g1_step", "g2_step")), ms(("lagrange_rowprod",))


out = {}
pk_aff, sig_aff, h_jac, _, _ = cs.rlc_inputs(dev)
r = ops.rlc_exponents(cs.RLC_N, b"\\x09" * 32, pk_aff=pk_aff,
                      sig_aff=sig_aff)
rlc = lambda: ops.verify_sig_shares_rlc(pk_aff, h_jac, sig_aff, r)
times, ok = [], bool(rlc())
for _ in range(calls):
    torch.cuda.synchronize()
    t0 = time.time()
    ok = ok and bool(rlc())
    torch.cuda.synchronize()
    times.append(time.time() - t0)
if not ok:
    raise SystemExit("verify_sig_shares_rlc rejected the batch")
b15, _ = events(rlc)
out["rlc"] = {"s": times, "b15_ms": [b15], "b14_ms": [0.0], "point": "True"}
del pk_aff, sig_aff, h_jac, r
for curve, host in ((dcv.G2, hcv.G2), (dcv.G1, hcv.G1)):
    rnd = random.Random(seed)
    h = host.mul(host.generator, rnd.randrange(1, R))
    uniq = [host.mul(h, rnd.randrange(1, R)) for _ in range(8)]
    shares = curve.from_host_affine((uniq * ((n + 7) // 8))[:n], device=dev)
    xs = frops.fr_to_device(range(1, n + 1), dev)
    pt, ok, _ = cs.combine_call(curve, shares, xs, "scalarwise")
    times = []
    for _ in range(calls):
        again, ok2, s = cs.combine_call(curve, shares, xs, "scalarwise")
        ok = ok and ok2 and cs.one_point(curve, again) == cs.one_point(
            curve, pt)
        times.append(s)
    if not ok:
        raise SystemExit(f"{curve.name}: not ok, or the calls differ")
    b15, b14 = events(lambda: cs.combine_call(curve, shares, xs,
                                              "scalarwise"))
    out[curve.name] = {"s": times, "b15_ms": [b15], "b14_ms": [b14],
                       "point": repr(cs.one_point(curve, pt))}
print(json.dumps(out))
"""
CALLS = ("rlc", "G2", "G1")
CALL_NAMES = {"rlc": "verify_sig_shares_rlc at N = {rlc_n}",
              "G2": "combine_batch(G2, scalarwise) at t+1 = {n}",
              "G1": "combine_batch(G1, scalarwise) at t+1 = {n}"}


def patched(csrc, patches):
    """{file name: text} of the files of csrc the patches change: "old
    step" (B15's old body), "old fr" (B14's), "held", or (file, old, new)."""
    files = {}

    def text(name):
        if name not in files:
            files[name] = open(os.path.join(csrc, name)).read()
        return files[name]

    def replace(name, old, new):
        if old not in text(name):
            raise RuntimeError(f"patch anchor not found: {old[:60]!r}")
        files[name] = text(name).replace(old, new)

    for p in patches:
        if p == "old fr":
            files["fr.cuh"], files["fr.cu"] = OLD_FR_CUH, OLD_FR_CU
        elif p == "old step":
            cu = text("ladder.cu")
            a, b = cu.index(STEP_HEAD), cu.index(STEP_TAIL)
            files["ladder.cu"] = (cu[:a] + OLD_STEP_KERNEL
                                  + cu[b + len(STEP_TAIL):])
            replace("ladder.cu", ENGINE_INCLUDE,
                    '#include "curve.cuh"\n' + ENGINE_INCLUDE)
            cuh = text("curve.cuh")
            a = cuh.rindex("}  // namespace tc")
            files["curve.cuh"] = cuh[:a] + OLD_STEP.lstrip("\n")
        elif p == "held":
            replace("ladder_engine.cuh", HELD_ANCHOR,
                    HELD_STRUCT + HELD_ANCHOR)
            replace("ladder_engine.cuh", Q_LINE, Q_HELD)
        else:
            replace(*p)
    return files


def turns(parent, rlc_n, n):
    """Both checkouts' calls in turns (parent, this, this, parent, twice):
    {"parent": {...}, "this": {...}}, per call the times and B15's and
    B14's event sums over the turns."""
    roots = {"parent": os.path.abspath(parent), "this": ROOT}
    out = {who: {c: {"s": [], "b15_ms": [], "b14_ms": []} for c in CALLS}
           for who in roots}
    results = set()
    for who in ("parent", "this", "this", "parent") * 2:
        proc = subprocess.run([sys.executable, "-c", TURN_CHILD,
                               str(TURN_CALLS), str(n), str(COMBINE_SEED)],
                              cwd=roots[who], capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            raise RuntimeError(f"the turn of {who} failed")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        for c, v in got.items():
            for key in ("s", "b15_ms", "b14_ms"):
                out[who][c][key] += v[key]
            results.add((c, v["point"]))
        print(f"turn {who}: " + ", ".join(
            f"{c} {[round(x, 4) for x in v['s']]} s, B15 events "
            f"{v['b15_ms'][0]:.2f} ms" for c, v in got.items()), flush=True)
    if len(results) != len(CALLS):
        raise RuntimeError("the turns' results differ")
    for c in CALLS:
        what = CALL_NAMES[c].format(rlc_n=rlc_n, n=n)
        for key, label, unit in (("s", "call", "s"),
                                 ("b15_ms", "B15 events", "ms"),
                                 ("b14_ms", "B14 events", "ms")):
            if c == "rlc" and key == "b14_ms":
                continue
            print(f"{what}, {label} in turns: " + ", ".join(
                f"{who} median {statistics.median(v[c][key]):.4f} {unit} "
                f"(quartiles {statistics.quantiles(v[c][key], n=4)[0]:.4f}-"
                f"{statistics.quantiles(v[c][key], n=4)[2]:.4f})"
                for who, v in out.items()), flush=True)
    return out


def build_variants(bdir):
    """Copy csrc per variant, patch it and start nvcc on its source:
    {(kernel, variant): (process, library path)}."""
    procs = {}
    for group, variants, src in (("b15", STEP_VARIANTS, "ladder"),
                                 ("b14", FR_VARIANTS, "fr")):
        for name, patches in variants.items():
            d = os.path.join(bdir, f"{group}_{name}")
            shutil.copytree(_build.CSRC, d)
            for fname, text in patched(_build.CSRC, patches).items():
                with open(os.path.join(d, fname), "w") as f:
                    f.write(text)
            procs[(group, name)] = tv.nvcc_start(
                os.path.join(d, f"{src}.cu"), d, src)
    return procs


def ptxas_of(report, names):
    return {k: v for k, v in report.items() if k.startswith(names)}


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout: time its "
                    "verify_sig_shares_rlc and scalarwise combines in turns "
                    "with this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b15_variants: no CUDA device", file=sys.stderr)
        return 2
    from threshold_crypto_tpu_torch.device import cuda_fr

    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    cardd = {"sms": props.multi_processor_count, "clock_hz": clock * 1e6}

    bdir = os.path.join(_build.BUILD_DIR, "variants")
    shutil.rmtree(bdir, ignore_errors=True)
    t0 = time.time()
    procs = build_variants(bdir)
    _build.build()
    libs = {"b15": {}, "b14": {}}
    res = {"card": card, "b15": {}, "b14": {}}
    for (group, name), (p, so) in procs.items():
        report = cs.print_ptxas(f"{group} {name}",
                                tv.nvcc_wait(p, f"variant {group} {name}"))
        lib = ctypes.CDLL(so)
        if group == "b15":
            for fn in ("tc_g1_step", "tc_g2_step"):
                getattr(lib, fn).argtypes = ([ctypes.c_void_p] * 4
                                             + [ctypes.c_int] * 2
                                             + [ctypes.c_void_p])
                getattr(lib, fn).restype = ctypes.c_int
            names = ("step_kernel",)
        else:
            lib.tc_lagrange_rowprod.argtypes = ([ctypes.c_void_p] * 3
                                                + [ctypes.c_int] * 2
                                                + [ctypes.c_void_p])
            lib.tc_lagrange_rowprod.restype = ctypes.c_int
            names = ("lagr_kernel",)
        libs[group][name] = lib
        res[group][name] = {"ptxas": ptxas_of(report, names), "ms": {}}
    print(f"built {len(procs)} variants in {time.time() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    kernels = {k.name: k for _, k in cs.registry()}

    def check(err, what):
        if err:
            raise RuntimeError(f"launch error {err}: {what}")

    def step(lib, g2, acc, q, bits):
        out = torch.empty_like(acc)
        check(getattr(lib, f"tc_g{1 + g2}_step")(
            acc.data_ptr(), q.data_ptr(), bits.data_ptr(), out.data_ptr(),
            acc.shape[1], bits.shape[0], stream()), "step")
        return out

    def rowprod(lib, xs, chunk):
        n = xs.shape[0]
        splits = -(-n // chunk)
        prod = torch.empty(splits, n, 16, dtype=torch.int32, device=dev)
        cnt = torch.empty(splits, n, dtype=torch.int32, device=dev)
        check(lib.tc_lagrange_rowprod(xs.data_ptr(), prod.data_ptr(),
                                      cnt.data_ptr(), n, chunk, stream()),
              "lagrange_rowprod")
        return prod, cnt

    def in_turns(group, key, call):
        order = list(libs[group]) + list(libs[group])[::-1]
        for name in order:
            res[group][name]["ms"].setdefault(key, []).append(
                tv.graph_time_ms(lambda: call(libs[group][name]), REPS))
        return ", ".join(f"{nm} {statistics.mean(v['ms'][key]):.4f}"
                         for nm, v in res[group].items())

    m = cs.LADDER_CHECK_LANES
    res["b15_bound_ms"], res["b15_latency_ms"] = {}, {}
    for g2 in (False, True):
        k = 2 if g2 else 1
        kernel = kernels[f"g{1 + g2}_step"]
        latency = cs.thread_product_latency_ms(g2, gen, dev)
        print(f"g{1 + g2}: one thread's Fq product in series "
              f"{1e3 * latency:.3f} us", flush=True)
        for where, (n, nbits) in cs.STEP_WIDTHS.items():
            acc, q, bits, _ = cs.step_special(g2, n, gen, dev)
            want = kernel.launch(acc, q, bits)
            with cs.plain_versions():
                plain = kernel.plain(acc[:, :m].contiguous(),
                                     q[:, :m].contiguous(),
                                     bits[:, :m].contiguous())
            if not torch.equal(want[:, :m], plain):
                raise RuntimeError(f"the package's g{1 + g2}_step differs "
                                   f"from its plain version at {where}")
            for name, lib in libs["b15"].items():
                if not torch.equal(step(lib, g2, acc, q, bits), want):
                    raise RuntimeError(f"variant {name} g{1 + g2}_step "
                                       f"differs on the special lanes at "
                                       f"{where}")
            acc, q, bits = cs.ladder_path_inputs(g2, "step", n, gen, dev,
                                                 nbits)
            want = kernel.launch(acc, q, bits)
            for name, lib in libs["b15"].items():
                if not torch.equal(step(lib, g2, acc, q, bits), want):
                    raise RuntimeError(f"variant {name} g{1 + g2}_step "
                                       f"differs at {where}")
            key = f"g{1 + g2}_step {n} x {nbits}"
            bound, by = cs.ladder_bound(g2, "step", bits, cardd)
            set_bits = int((bits != 0).sum().item())
            yardstick = (nbits * cs.DBL_FQ_PRODUCTS[k - 1] + set_bits / n
                         * cs.MADD_FQ_PRODUCTS[k - 1]) * latency
            res["b15_bound_ms"][key] = bound
            res["b15_latency_ms"][key] = yardstick
            times = in_turns("b15", key,
                             lambda lib: step(lib, g2, acc, q, bits))
            print(f"{key} ({where}; bound {bound:.4f} ms ({by}), latency "
                  f"yardstick {yardstick:.4f} ms; every variant bit-exact), "
                  f"from a CUDA graph: {times} ms", flush=True)
            del acc, q, bits, want
            torch.cuda.empty_cache()

    kernel = kernels["lagrange_rowprod"]
    vals, xs = cs.rowprod_inputs(dev)
    n = len(vals)
    chunk = cuda_fr._chunk(n)
    want = kernel.launch(xs)
    with cs.plain_versions():
        plain = kernel.plain(xs)
    if not (torch.equal(want[0], plain[0]) and torch.equal(want[1],
                                                           plain[1])):
        raise RuntimeError("the package's lagrange_rowprod differs from its "
                           "plain version")
    for name, lib in libs["b14"].items():
        got = rowprod(lib, xs, chunk)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise RuntimeError(f"variant {name} lagrange_rowprod differs")
    zeros = int(want[1].sum().item())
    bound, by = cs.bound_ms(n * 16 * 4 + want[0].numel() * 4
                            + want[1].numel() * 4,
                            (n * n - zeros) * cs.FR_PRODUCT_IMADS, cardd)
    res["b14_bound_ms"] = bound
    key = f"lagrange_rowprod N = {n}"
    times = in_turns("b14", key, lambda lib: rowprod(lib, xs, chunk))
    print(f"{key} ({chunk}-value chunks, a duplicate pair and a zero lane; "
          f"bound {bound:.4f} ms ({by}); every variant bit-exact), from a "
          f"CUDA graph: {times} ms", flush=True)

    if args.parent:
        res["turns"] = turns(args.parent, cs.RLC_N, cs.COMBINE_N)
    line = json.dumps(res)
    with open(os.path.join(bdir, "b15_variants.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
