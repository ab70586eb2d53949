#!/usr/bin/env python3
"""B16 (``csrc/shared.cu`` ``selmadd_kernel`` and ``dblw_kernel``) against
their old bodies and another block size, on one card.

    python3 tools/b16_variants.py [--parent ROOT]

Each variant is the package's ``csrc/`` with one design choice changed by a
text patch, built with the package's nvcc flags into
``threshold_crypto_tpu_torch/_build/variants/``:

* ``old``: the lane bodies of ``csrc/curve.cuh`` that B16 ran before the
  register engine (``jac_add``, ``selmadd_lane`` and ``dblw_lane``, kept
  here as text): ``__noinline__`` formulas over a local-memory frame, the
  add's doubling branch computed on every lane and selected; blocks of 128
  threads, no register cap;
* ``kernel``: the sources as they are (``selmadd_lane_r`` and
  ``dblw_lane_r`` on ``csrc/ladder_engine.cuh``, blocks of 128 threads,
  the 255-register cap);
* ``t32``: blocks of 32 threads at the same cap, so that the combine's
  A = 1,024 accumulators run one warp on each of 32 SMs rather than four
  on each of 8.

For each: ptxas's registers, stack frame and spills of selmadd_kernel and
dblw_kernel, G1 and G2; bit-exact against the package's kernels (which are
held against their plain versions on the first block here too) on
``chip_smoke.b16_inputs``' special lanes at windows 1 and 3, every block of
a ragged table of ``chip_smoke.B16_TABLE_N`` lanes; and the kernel time
with CUDA events, in turns (old, kernel, t32, t32, kernel, old), at the
bitscan combine's shape (A = 1,024, window 1, a 4,096-lane table), G1 and
G2, beside ``chip_smoke.b16_bounds`` and the latency yardstick (the general
path's products times the per-product latency of B2's one-lane chain,
``chip_smoke.product_latency_ms``, measured here): launched one by one from
Python and replayed from a CUDA graph.

With ``--parent ROOT`` (another checkout: its ``chip_smoke.py`` and
``threshold_crypto_tpu_torch/``) it also times both checkouts'
``ops.combine_batch(path="bitscan")`` at t + 1 = COMBINE_N shares in turns,
one child process per turn (parent, this, this, parent, twice), G2 then
G1: the inputs of ``benches/combine_large.py`` (seed COMBINE_SEED: eight
host multiples of a random point, tiled, x = 1..t + 1; G1 the same on
G1), a warm-up call, TURN_CALLS timed calls and one with B16's launches
bracketed by events (``chip_smoke.kernel_event_timer``); every turn's
combined point must be the same. Prints one JSON line last and writes it
to ``b16_variants.json`` beside the builds. Without CUDA it exits 2.
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

# curve.cuh's complete add before the register engine (B11's and B16's old
# bodies call it).
OLD_JAC_ADD = r"""
// The complete add T + Q: the general chord, the doubling of T (for
// T == Q), infinity for T == −Q, and either operand at infinity.
template <class F>
__device__ __noinline__ void jac_add(Jac<F>& r, const Jac<F>& T,
                                     const Jac<F>& Q) {
  F z1z, z2z, Z1Z2, u1, u2, z2c, z1c, h, s1, s2, hh, A, B, S, rr_, XpB, E;
  F hhh, v, rr, Zo, C, XB2, E2, Xo, D, Xd, Yo, Yd, Zd, t, u;
  // L1
  f_sqr(z1z, T.Z);
  f_sqr(z2z, Q.Z);
  f_mul(Z1Z2, T.Z, Q.Z);
  // L2
  f_mul(u1, T.X, z2z);
  f_mul(u2, Q.X, z1z);
  f_mul(z2c, z2z, Q.Z);
  f_mul(z1c, z1z, T.Z);
  f_sub(h, u2, u1);
  // L3: the chord products and layer 1 of dbl(T)
  f_mul(s1, T.Y, z2c);
  f_mul(s2, Q.Y, z1c);
  f_sqr(hh, h);
  f_sqr(A, T.X);
  f_sqr(B, T.Y);
  f_mul(S, T.Y, T.Z);
  f_sub(rr_, s2, s1);                    // r
  f_add(XpB, T.X, B);
  f_small(E, A, 3);
  // L4
  f_mul(hhh, h, hh);
  f_mul(v, u1, hh);
  f_sqr(rr, rr_);
  f_mul(Zo, Z1Z2, h);
  f_sqr(C, B);
  f_sqr(XB2, XpB);
  f_sqr(E2, E);
  f_sub(t, rr, hhh);
  f_small(u, v, 2);
  f_sub(Xo, t, u);                       // Xo = r² − hhh − 2v
  f_sub(t, XB2, A);
  f_sub(t, t, C);
  f_small(D, t, 2);
  f_small(t, D, 2);
  f_sub(Xd, E2, t);                      // Xd = E² − 2D
  // L5
  f_sub(t, v, Xo);
  f_mul(t, rr_, t);                      // r(v − Xo)
  f_mul(u, s1, hhh);
  f_sub(Yo, t, u);
  f_sub(t, D, Xd);
  f_mul(t, E, t);
  f_small(u, C, 8);
  f_sub(Yd, t, u);
  f_small(Zd, S, 2);

  const bool inf1 = f_is_zero(T.Z);
  const bool inf2 = f_is_zero(Q.Z);
  const bool h0 = f_is_zero(h);
  const bool r0 = f_is_zero(rr_);
  Jac<F> out;
  out.X = Xo;
  out.Y = Yo;
  out.Z = Zo;
  select3(out, h0 && r0, Xd, Yd, Zd);    // T == Q  -> 2T
  F one, zero;
  f_set(one, true);
  f_set(zero, false);
  select3(out, h0 && !r0, one, one, zero);  // T == -Q -> infinity
  select3(out, inf2, T.X, T.Y, T.Z);     // T + 0
  select3(out, inf1, Q.X, Q.Y, Q.Z);     // 0 + Q
  r = out;
}
"""
# curve.cuh's B16 lane bodies before the register engine.
OLD_LANE = r"""
template <class F>
__device__ __forceinline__ void selmadd_lane(const int32_t* acc_in,
                                             const int32_t* table,
                                             const int32_t* digits,
                                             int32_t* out, int accs, int n,
                                             int nent, int start, int j) {
  Jac<F> T, Q;
  load_jac(T, acc_in, 0, accs, j);
  const int lane = start + j;
  const int d = lane < n ? digits[lane] : 0;
  if (d != 0) {
    const int e = (d >= 1 && d <= nent) ? d - 1 : 0;
    load_jac(Q, table, e * 3 * Comps<F>::k, n, lane);
    jac_add(T, T, Q);
  }
  store_jac(out, T, accs, j);
}

template <class F>
__device__ __forceinline__ void dblw_lane(const int32_t* acc_in,
                                          int32_t* out, int n, int window,
                                          int lane) {
  Jac<F> T;
  load_jac(T, acc_in, 0, n, lane);
  for (int i = 0; i < window; ++i) jac_dbl(T, T);
  store_jac(out, T, n, lane);
}

}  // namespace tc
"""
# shared.cu's kernels before the register engine: one thread an
# accumulator lane over curve.cuh, blocks of kThreads, no register cap.
OLD_KERNELS = r"""#include "curve.cuh"

namespace {

using tc::kThreads;

template <class F>
__global__ void __launch_bounds__(kThreads)
selmadd_kernel(const int32_t* __restrict__ acc,
               const int32_t* __restrict__ table,
               const int32_t* __restrict__ digits, int32_t* __restrict__ out,
               int accs, int n, int nent, int start) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= accs) return;
  tc::selmadd_lane<F>(acc, table, digits, out, accs, n, nent, start, j);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
dblw_kernel(const int32_t* __restrict__ acc, int32_t* __restrict__ out,
            int accs, int window) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= accs) return;
  tc::dblw_lane<F>(acc, out, accs, window, j);
}

constexpr int kBlockThreads = kThreads;
"""
# The package's shared.cu from its include of the engine to the end of its
# dblw kernel: what OLD_KERNELS takes the place of.
KERNELS_HEAD = '#include "ladder_engine.cuh"\n'
KERNELS_TAIL = ("  if (j < accs) tc::dblw_lane_r<F>(acc, out, accs, window, "
                "j);\n}\n")
THREADS_LINE = "constexpr int kBlockThreads = 128;"
VARIANTS = {"old": ["old"], "kernel": [], "t32": [(THREADS_LINE,
                                                   "constexpr int "
                                                   "kBlockThreads = 32;")]}
REPS = 20
# Timed combine calls of one turn, after a warm-up call.
TURN_CALLS = 5
COMBINE_SEED = 0xC0B1E   # benches/combine_large.py
# One turn in the checkout that is the child's working directory: its
# kernels built (one nvcc per source, together), then per curve (G2, G1)
# the inputs of benches/combine_large.py at argv[2] shares (seed argv[3]),
# a warm-up call, argv[1] timed calls and one with the kernels bracketed by
# events; prints per curve the call times, B16's event sum and the point.
TURN_CHILD = """
import json, random, sys
import torch
import chip_smoke as cs
from threshold_crypto_tpu_torch import _build
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R
from threshold_crypto_tpu_torch.ops import fr as frops
_build.build()
dev = torch.device("cuda", 0)
calls, n, seed = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
out = {}
for curve, host in ((dcv.G2, hcv.G2), (dcv.G1, hcv.G1)):
    rnd = random.Random(seed)
    h = host.mul(host.generator, rnd.randrange(1, R))
    uniq = [host.mul(h, rnd.randrange(1, R)) for _ in range(8)]
    shares = curve.from_host_affine((uniq * ((n + 7) // 8))[:n], device=dev)
    xs = frops.fr_to_device(range(1, n + 1), dev)
    pt, ok, _ = cs.combine_call(curve, shares, xs, "bitscan")
    times = []
    for _ in range(calls):
        again, ok2, s = cs.combine_call(curve, shares, xs, "bitscan")
        ok = ok and ok2 and cs.one_point(curve, again) == cs.one_point(
            curve, pt)
        times.append(s)
    spans = []
    with cs.kernel_event_timer(spans):
        cs.combine_call(curve, shares, xs, "bitscan")
    torch.cuda.synchronize()
    if not ok:
        raise SystemExit(f"{curve.name}: not ok, or the calls differ")
    b16 = sum(a.elapsed_time(b) for k, a, b in spans
              if k.endswith(("_selmadd", "_dblw")))
    out[curve.name] = {"s": times, "b16_ms": [b16],
                       "point": repr(cs.one_point(curve, pt))}
print(json.dumps(out))
"""


def patched(csrc, patches):
    """{file name: text} of the files of csrc the patches change."""
    files = {}

    def text(name):
        if name not in files:
            files[name] = open(os.path.join(csrc, name)).read()
        return files[name]

    for p in patches:
        if p == "old":
            cu = text("shared.cu")
            a, b = cu.index(KERNELS_HEAD), cu.index(KERNELS_TAIL)
            files["shared.cu"] = (cu[:a] + OLD_KERNELS
                                  + cu[b + len(KERNELS_TAIL):])
            cuh = text("curve.cuh")
            a = cuh.rindex("}  // namespace tc")
            files["curve.cuh"] = (cuh[:a] + OLD_JAC_ADD.lstrip("\n") + "\n"
                                  + OLD_LANE.lstrip("\n"))
            continue
        old, new = p
        if old not in text("shared.cu"):
            raise RuntimeError(f"patch anchor not found: {old!r}")
        files["shared.cu"] = text("shared.cu").replace(old, new)
    return files


def turns(parent, n):
    """Both checkouts' bitscan combines in turns (parent, this, this,
    parent, twice): {"parent": {...}, "this": {...}}, per curve the call
    times and B16's event sums over the turns."""
    roots = {"parent": os.path.abspath(parent), "this": ROOT}
    out = {who: {c: {"s": [], "b16_ms": []} for c in ("G2", "G1")}
           for who in roots}
    points = set()
    for who in ("parent", "this", "this", "parent") * 2:
        proc = subprocess.run([sys.executable, "-c", TURN_CHILD,
                               str(TURN_CALLS), str(n), str(COMBINE_SEED)],
                              cwd=roots[who], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            raise RuntimeError(f"the turn of {who} failed")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        for c, v in got.items():
            out[who][c]["s"] += v["s"]
            out[who][c]["b16_ms"] += v["b16_ms"]
            points.add((c, v["point"]))
        print(f"turn {who}: " + ", ".join(
            f"{c} {[round(x, 4) for x in v['s']]} s, B16 events "
            f"{v['b16_ms'][0]:.2f} ms" for c, v in got.items()), flush=True)
    if len(points) != 2:
        raise RuntimeError("the turns' combined points differ")
    for c in ("G2", "G1"):
        for key, unit in (("s", "s"), ("b16_ms", "ms")):
            print(f"combine_batch({c}, bitscan) at t+1 = {n}, "
                  f"{'call' if key == 's' else 'B16 events'} in turns: "
                  + ", ".join(
                      f"{who} median {statistics.median(v[c][key]):.4f} "
                      f"{unit} (quartiles "
                      f"{statistics.quantiles(v[c][key], n=4)[0]:.4f}-"
                      f"{statistics.quantiles(v[c][key], n=4)[2]:.4f})"
                      for who, v in out.items()), flush=True)
    return out


def main():
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout: time its "
                    "bitscan combines in turns with this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b16_variants: no CUDA device", file=sys.stderr)
        return 2
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import mont

    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    cardd = {"sms": props.multi_processor_count, "clock_hz": clock * 1e6}

    bdir = os.path.join(_build.BUILD_DIR, "variants")
    shutil.rmtree(bdir, ignore_errors=True)
    procs, t0 = {}, time.time()
    for name, patches in VARIANTS.items():
        d = os.path.join(bdir, name)
        shutil.copytree(_build.CSRC, d)
        for fname, text in patched(_build.CSRC, patches).items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        procs[name] = tv.nvcc_start(os.path.join(d, "shared.cu"), d,
                                    "shared")
    _build.build(["shared", "mont"])
    libs, res = {}, {"card": card, "variants": {}}
    for name, (p, so) in procs.items():
        report = cs.print_ptxas(name, tv.nvcc_wait(p, f"variant {name}"))
        lib = ctypes.CDLL(so)
        for g in ("g1", "g2"):
            getattr(lib, f"tc_{g}_selmadd").argtypes = \
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            getattr(lib, f"tc_{g}_dblw").argtypes = \
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            getattr(lib, f"tc_{g}_selmadd").restype = ctypes.c_int
            getattr(lib, f"tc_{g}_dblw").restype = ctypes.c_int
        libs[name] = lib
        res["variants"][name] = {
            "ptxas": {k: v for k, v in report.items()
                      if k.startswith(("selmadd", "dblw"))},
            "ms": {}, "graph_ms": {}}
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    one = cs.check_pow(mont.FQ, 1, mont.FQ.p - 2, "p-2",
                       np.random.default_rng(cs.SEED), dev, cardd)
    product_ms = cs.product_latency_ms(one)
    res["product_latency_ms"] = product_ms
    print(f"one Fq product in series (B2's one-lane chain): "
          f"{1e3 * product_ms:.3f} us", flush=True)

    def selmadd(lib, g2, acc, table, digits, start):
        out = torch.empty_like(acc)
        nent = table.shape[0] // acc.shape[0]
        err = getattr(lib, f"tc_g{1 + g2}_selmadd")(
            acc.data_ptr(), table.data_ptr(), digits.data_ptr(),
            out.data_ptr(), acc.shape[1], table.shape[1], nent, start,
            stream())
        if err:
            raise RuntimeError(f"launch error {err}")
        return out

    def dblw(lib, g2, acc, window):
        out = torch.empty_like(acc)
        err = getattr(lib, f"tc_g{1 + g2}_dblw")(
            acc.data_ptr(), out.data_ptr(), acc.shape[1], window, stream())
        if err:
            raise RuntimeError(f"launch error {err}")
        return out

    res["bound_ms"], res["latency_ms"] = {}, {}
    order = list(libs) + list(libs)[::-1]
    A = ccv.SHARED_BLOCK
    for g2 in (False, True):
        k = 2 if g2 else 1
        g = f"g{1 + g2}"
        package_sel = ccv.g2_selmadd if g2 else ccv.g1_selmadd
        package_dbl = ccv.g2_dblw if g2 else ccv.g1_dblw
        plain_sel = ccv.g2_selmadd_ref if g2 else ccv.g1_selmadd_ref
        plain_dbl = ccv.g2_dblw_ref if g2 else ccv.g1_dblw_ref
        for window in (1, 3):
            acc, table, digits = cs.b16_inputs(g2, window, cs.B16_TABLE_N,
                                               gen, dev)
            if not torch.equal(package_sel(acc, table, digits, 0),
                               plain_sel(acc, table, digits, 0)) or \
                    not torch.equal(package_dbl(acc, window),
                                    plain_dbl(acc, window)):
                raise RuntimeError(f"the package's {g} B16 differs from its "
                                   f"plain version at window {window}")
            for start in range(0, cs.B16_TABLE_N, A):
                want = package_sel(acc, table, digits, start)
                for name, lib in libs.items():
                    if not torch.equal(selmadd(lib, g2, acc, table, digits,
                                               start), want):
                        raise RuntimeError(f"variant {name} {g}_selmadd "
                                           f"differs at window {window}, "
                                           f"block {start}")
            want = package_dbl(acc, window)
            for name, lib in libs.items():
                if not torch.equal(dblw(lib, g2, acc, window), want):
                    raise RuntimeError(f"variant {name} {g}_dblw differs at "
                                       f"window {window}")
        acc, table, digits = cs.b16_inputs(g2, 1, cs.COMBINE_N, gen, dev)
        nonzero = int((digits[:A] != 0).sum().item())
        sel_b, dbl_b = cs.b16_bounds(g2, nonzero, A, 1, cardd)
        cases = {f"{g}_selmadd A={A} w=1": (
                     lambda lib: selmadd(lib, g2, acc, table, digits, 0),
                     sel_b[0], cs.ADD_FQ_PRODUCTS[k - 1] * product_ms),
                 f"{g}_dblw A={A} w=1": (
                     lambda lib: dblw(lib, g2, acc, 1), dbl_b[0],
                     cs.DBL_FQ_PRODUCTS[k - 1] * product_ms)}
        for key, (call, bound, latency) in cases.items():
            res["bound_ms"][key] = bound
            res["latency_ms"][key] = latency
            for name in order:
                fn = (lambda: call(libs[name]))  # noqa: E731
                v = res["variants"][name]
                v["ms"].setdefault(key, []).append(cs.cuda_time_ms(fn, REPS))
                v["graph_ms"].setdefault(key, []).append(
                    tv.graph_time_ms(fn, REPS))
            print(f"{key} (bound {bound:.5f} ms, latency yardstick "
                  f"{latency:.4f} ms; every variant bit-exact at windows 1 "
                  f"and 3), launched one by one | replayed from a CUDA "
                  f"graph: " + ", ".join(
                      f"{nm} {statistics.mean(v['ms'][key]):.4f} | "
                      f"{statistics.mean(v['graph_ms'][key]):.4f} ms"
                      for nm, v in res["variants"].items()), flush=True)
        del acc, table, digits
        torch.cuda.empty_cache()
    if args.parent:
        res["turns"] = turns(args.parent, cs.COMBINE_N)
    line = json.dumps(res)
    with open(os.path.join(bdir, "b16_variants.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
