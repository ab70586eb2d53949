#!/usr/bin/env python3
"""B1 (``mont_mul``) and B2 (``mont_pow``) of ``csrc/mont.cu`` against their
old bodies and design variants, on one card.

    python3 tools/mont_variants.py [--parent ROOT] [--group-sweep]

Each variant is built with the package's nvcc flags into
``threshold_crypto_tpu_torch/_build/variants/``:

* ``old``: the kernels B1 and B2 ran before the register product (one
  thread a lane over ``csrc/fq.cuh``'s serial-carry CIOS, rows read in
  place, the exponent bit by bit from device memory), kept here as text;
* ``kernel``: the sources as they are;
* ``t32``, ``t64``, ``t128``: B2 with blocks of 32, 64 or 128 threads at
  every width (the package picks one from n);
* ``g2``: B2's group kernel at G = 2 threads a lane (the package's is 4),
  launched at every width;
* ``rows``: B1 staged with one bulk copy a row, into rows padded to L + 4
  limbs (no bank conflict on the rows' reads), in place of the package's
  one bulk copy a tile;
* ``vector``: B1 staged with 16-byte vector loads into the padded rows;
* ``vector_nopad``: the same into rows of L limbs.

B2 also runs the package's kernel at one lane over G = 1 and 4 threads
(the wrapper takes 4 up to 8192 Fq or 4096 Fr lanes, else 1) and with the
exponent bit by bit (w = 1) and in windows of w = 4 and 5 (the package's),
through the same launcher.

For each: ptxas's registers, stack frame and spills of the B1 / B2 kernels;
bit-exact against the package's kernel (held against its plain version
here too); and the kernel time with CUDA events, in turns (old, kernel, …,
kernel, old), launched one by one from Python and replayed from a CUDA
graph: B2 for p − 2 at 1, RLC_CHECK_BATCH and LANES lanes and for
(p − 1)/2 at the hash path's Euler width; B1 at slice 1's widest launch and
the RLC fold's first level, Fq and Fr. A variant that does not build or
differs is reported and not timed.

With ``--group-sweep`` it builds only ``kernel`` and times B2 at one lane
over G = 1 and over G = 4 threads (w = 5), in turns, across SWEEP_WIDTHS:
Fq for p − 2 and Fr for r − 2, from 1 lane to past the wrapper's crossover
``cuda_mont.GROUP_MAX_LANES``, where the group kernel stops paying.

With ``--parent ROOT`` (another checkout: its ``chip_smoke.py`` and
``threshold_crypto_tpu_torch/``) it also times both checkouts' RLC calls
(N = 262,144) in turns, one child process a turn (parent, this, this,
parent, twice; TURN_CALLS calls a turn after a warm-up, 20 a checkout):
the call, and the B1 and B2 time in it (every launch bracketed by CUDA
events, ``chip_smoke.kernel_event_timer``). Medians and quartiles. Prints
one JSON line last and writes it to ``mont_variants.json`` beside the
builds. Without CUDA it exits 2.
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

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
import tower_variants as tv  # noqa: E402
from threshold_crypto_tpu_torch import _build  # noqa: E402

# csrc/mont.cu before the register product: fq.cuh's engine, one thread a
# lane, the exponent's bits read from device memory.
OLD_CU = r"""#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

using tc::kThreads;
using tc::Modulus;

template <int S>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int n, const Modulus<S> m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t off = static_cast<size_t>(lane) * (2 * S);
  uint32_t x[S], y[S];
  tc::load_row<S>(a + off, x);
  tc::load_row<S>(b + off, y);
  tc::mont_mul<S>(x, x, y, m);
  tc::store_row<S>(out + off, x);
}

// acc = a^e, e given MSB first as bits[0..nbits). Every lane reads the same
// bit, so the branch is warp-uniform. acc starts at 1, so 0^e = 0.
template <int S>
__global__ void __launch_bounds__(kThreads)
mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                int n, const int32_t* __restrict__ bits, int nbits,
                const Modulus<S> m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t off = static_cast<size_t>(lane) * (2 * S);
  uint32_t base[S], acc[S];
  tc::load_row<S>(a + off, base);
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = m.one[k];
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    tc::mont_mul<S>(acc, acc, acc, m);
    if (bits[i]) tc::mont_mul<S>(acc, acc, base, m);
  }
  tc::store_row<S>(out + off, acc);
}

// mod = p words[S], n0, one words[S] (host memory).
template <int S>
Modulus<S> modulus_from(const uint32_t* mod) {
  Modulus<S> m;
  for (int k = 0; k < S; ++k) m.p[k] = mod[k];
  m.n0 = mod[S];
  for (int k = 0; k < S; ++k) m.one[k] = mod[S + 1 + k];
  return m;
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int tc_mont_mul(const void* a, const void* b, void* out, int n,
                           int words, const uint32_t* mod, void* stream) {
  if (n <= 0) return 0;
  const auto* ap = static_cast<const int32_t*>(a);
  const auto* bp = static_cast<const int32_t*>(b);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (words == 12) {
    mont_mul_kernel<12><<<grid_for(n), kThreads, 0, s>>>(
        ap, bp, op, n, modulus_from<12>(mod));
  } else if (words == 8) {
    mont_mul_kernel<8><<<grid_for(n), kThreads, 0, s>>>(
        ap, bp, op, n, modulus_from<8>(mod));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_mont_pow(const void* a, void* out, int n, const void* bits,
                           int nbits, int words, const uint32_t* mod,
                           void* stream) {
  if (n <= 0) return 0;
  const auto* ap = static_cast<const int32_t*>(a);
  auto* op = static_cast<int32_t*>(out);
  const auto* bp = static_cast<const int32_t*>(bits);
  auto s = static_cast<cudaStream_t>(stream);
  if (words == 12) {
    mont_pow_kernel<12><<<grid_for(n), kThreads, 0, s>>>(
        ap, op, n, bp, nbits, modulus_from<12>(mod));
  } else if (words == 8) {
    mont_pow_kernel<8><<<grid_for(n), kThreads, 0, s>>>(
        ap, op, n, bp, nbits, modulus_from<8>(mod));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# B1's staging in the package's kernel, and what the variants put there.
TILE_STAGE = """  if (tid == 0) {
    tc::mnt::bar_arm(&bar, 2 * lanes * L * 4);
    tc::mnt::copy_tile_in<Fd>(ta, a + off, lanes, &bar);
    tc::mnt::copy_tile_in<Fd>(tb, b + off, lanes, &bar);
  }
  __syncthreads();  // the mbarrier is armed before anyone waits on it
  tc::mnt::bar_wait(&bar);
"""
# One bulk copy a row (rows may be padded), from the row's thread.
ROWS_STAGE = """  if (tid == 0) tc::mnt::bar_arm(&bar, 2 * lanes * L * 4);
  __syncthreads();
  if (tid < lanes) {
    const unsigned bs =
        static_cast<unsigned>(__cvta_generic_to_shared(&bar));
    const int32_t* srcs[2] = {a + off + tid * L, b + off + tid * L};
    int32_t* dsts[2] = {ta + tid * Tile<Fd>::kRow, tb + tid * Tile<Fd>::kRow};
    for (int k = 0; k < 2; ++k)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dsts[k]))),
             "l"(srcs[k]), "r"(L * 4), "r"(bs) : "memory");
  }
  tc::mnt::bar_wait(&bar);
"""
# 16-byte vector loads, neighbouring threads on neighbouring chunks.
VECTOR_STAGE = """  for (int c = tid; c < lanes * (L / 4); c += kTile) {
    const int w = c * 4, r = w / L;
    const int d = r * Tile<Fd>::kRow + (w - r * L);
    tc::mnt::store4(ta + d, tc::mnt::load4(a + off + w));
    tc::mnt::store4(tb + d, tc::mnt::load4(b + off + w));
  }
  __syncthreads();
"""
DENSE = "kRow = kLimbs;  "
POW_THREADS = "inline int pow_threads(long long n) {\n"
GROUP = "constexpr int kGroup = 4;"


def replace(text, old, new):
    if old not in text:
        raise RuntimeError(f"patch anchor not found: {old[:60]!r}")
    return text.replace(old, new)


def threads(T):
    return lambda text: replace(text, POW_THREADS,
                                POW_THREADS + f"  return {T};\n")


def padded(text):
    """Rows of L + 4 limbs in shared memory, and the store that reads them."""
    text = replace(text, DENSE, "kRow = kLimbs + 4;  ")
    return replace(text, "    store4(dst + 4 * c, load4(tile + 4 * c));",
                   "    store4(dst + 4 * c, load4(tile + 4 * c / Tile<Fd>::"
                   "kLimbs * Tile<Fd>::kRow + 4 * c % Tile<Fd>::kLimbs));")


VARIANTS = {
    "old": None,
    "kernel": [],
    "t32": [threads(32)], "t64": [threads(64)], "t128": [threads(128)],
    "g2": [lambda t: replace(t, GROUP, "constexpr int kGroup = 2;")],
    "rows": [lambda t: replace(t, TILE_STAGE, ROWS_STAGE), padded],
    "vector": [lambda t: replace(t, TILE_STAGE, VECTOR_STAGE), padded],
    "vector_nopad": [lambda t: replace(t, TILE_STAGE, VECTOR_STAGE)],
}
# B2 runs of the package's kernel: (window, threads a lane); None: the
# wrapper's choice from n.
POW_RUNS = [(5, None), (5, 1), (5, 4), (4, None), (1, None)]
POW_VARIANTS = ("old", "kernel", "t32", "t64", "t128", "g2")
MUL_VARIANTS = ("old", "kernel", "rows", "vector", "vector_nopad")
REPS = {"pow": 5, "mul": 20}
# --group-sweep: B2's widths, and its runs (window, threads a lane).
SWEEP_WIDTHS = (1, 512, 2048, 4096, 8192, 16384, 32768, 65536)
SWEEP_RUNS = [(5, 1), (5, 4)]
# Calls of one turn, after a warm-up call.
TURN_CALLS = 5
# One turn in the checkout that is the child's working directory: its
# kernels built, then TURN_CALLS RLC calls, each timed alone and again
# with every kernel launch bracketed by CUDA events (the B1 and B2 ms).
TURN_CHILD = """
import json, sys
import torch
import chip_smoke as cs
from threshold_crypto_tpu_torch import _build
_build.build()
dev = torch.device("cuda", 0)
calls = int(sys.argv[1])
pk_aff, sig_aff, h_jac = cs.rlc_inputs(dev)[:3]
out = {"rlc_s": [], "b1_ms": [], "b2_ms": []}
for i in range(1 + calls):
    ok, _, s = cs.rlc_call(pk_aff, sig_aff, h_jac, bytes([40 + i]) * 32)
    if not ok:
        raise SystemExit("the valid batch was rejected")
    spans = []
    with cs.kernel_event_timer(spans):
        ok, _, _ = cs.rlc_call(pk_aff, sig_aff, h_jac, bytes([90 + i]) * 32)
    torch.cuda.synchronize()
    if i:
        out["rlc_s"].append(s)
        for key, name in (("b1_ms", "mont_mul"), ("b2_ms", "mont_pow")):
            out[key].append(sum(a.elapsed_time(b) for k, a, b in spans
                                if k == name))
print(json.dumps(out))
"""


def build(bdir, names):
    """{variant: (Popen, so)} for the variants ``names``, every nvcc
    started together."""
    procs = {}
    for name in names:
        patches = VARIANTS[name]
        d = os.path.join(bdir, name)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, "mont.cu")
        if patches is None:
            text = OLD_CU
        else:
            text = open(path).read()
            for p in patches:
                text = p(text)
        with open(path, "w") as f:
            f.write(text)
        procs[name] = tv.nvcc_start(path, d, "mont")
    return procs


def load(so, old):
    lib = ctypes.CDLL(so)
    vp, i, u32p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
        ctypes.c_uint32)
    lib.tc_mont_mul.argtypes = [vp, vp, vp, i, i, u32p, vp]
    lib.tc_mont_pow.argtypes = (
        [vp, vp, i, vp, i, i, u32p, vp] if old else
        [vp, vp, i, ctypes.POINTER(ctypes.c_uint16), i, i, i, i, u32p, vp])
    lib.tc_mont_mul.restype = lib.tc_mont_pow.restype = i
    return lib


def old_modulus(spec):
    """The old launchers' modulus argument: p, n0, R mod p as words."""
    S = spec.L // 2
    words = [(spec.p >> (32 * k)) & 0xFFFFFFFF for k in range(S)]
    n0 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    one = [(spec.one_mont >> (32 * k)) & 0xFFFFFFFF for k in range(S)]
    return (ctypes.c_uint32 * (2 * S + 1))(*words, n0, *one)


def caller(lib, old, spec, what, e=None, window=5, group=None, bits=None):
    """fn(a[, b], out) -> out through the library's launcher; B2 with the
    chain of ``window`` and ``group`` threads a lane (None: the wrapper's
    choice from n)."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_mont

    S = spec.L // 2
    mod = old_modulus(spec) if old else cuda_mont._modulus_arg(spec)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            raise RuntimeError(f"launch error {err}")

    if what == "mul":
        def mul(a, b, out):
            check(lib.tc_mont_mul(a.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), a.shape[0], S, mod,
                                  stream()))
            return out
        return mul
    if old:
        def pow_old(a, out):
            check(lib.tc_mont_pow(a.data_ptr(), out.data_ptr(), a.shape[0],
                                  bits.data_ptr(), bits.numel(), S, mod,
                                  stream()))
            return out
        return pow_old
    steps, nsteps, entries = cuda_mont.pow_chain(spec, e, window)

    def pow_new(a, out):
        n = a.shape[0]
        check(lib.tc_mont_pow(a.data_ptr(), out.data_ptr(), n, steps,
                              nsteps, entries,
                              group or cuda_mont.pow_group(spec, n), S, mod,
                              stream()))
        return out
    return pow_new


def summary(v):
    return (f"median {statistics.median(v):.4f}, quartiles "
            f"{statistics.quantiles(v, n=4)[0]:.4f}-"
            f"{statistics.quantiles(v, n=4)[2]:.4f}")


def turns(parent):
    """Both checkouts' RLC calls in turns: {"parent": {...}, "this": ...}."""
    roots = {"parent": os.path.abspath(parent), "this": ROOT}
    keys = ("rlc_s", "b1_ms", "b2_ms")
    out = {k: {key: [] for key in keys} for k in roots}
    for who in ("parent", "this", "this", "parent") * 2:
        proc = subprocess.run([sys.executable, "-c", TURN_CHILD,
                               str(TURN_CALLS)], cwd=roots[who],
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
        print(f"{key} in turns ({TURN_CALLS} calls a turn): " + ", ".join(
            f"{who} {summary(v[key])}" for who, v in out.items()),
            flush=True)
    return out


def main():
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import cuda_mont, mont

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout: time its "
                    "RLC call and the B1 and B2 time in it in turns with "
                    "this one's")
    ap.add_argument("--group-sweep", action="store_true",
                    help="time only B2 at G = 1 against G = 4 across "
                    "SWEEP_WIDTHS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mont_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    cardd = {"sms": props.multi_processor_count, "clock_hz": clock * 1e6}

    bdir = os.path.join(_build.BUILD_DIR, "variants")
    shutil.rmtree(bdir, ignore_errors=True)
    os.makedirs(bdir)
    t0 = time.time()
    procs = build(bdir, ("kernel",) if args.group_sweep else VARIANTS)
    _build.build(["mont"])
    libs, res = {}, {"card": card, "variants": {}, "bound_ms": {}}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=1500)
        if proc.returncode != 0:
            print(f"variant {name} did not build:\n{log[-3000:]}", flush=True)
            res["variants"][name] = {"error": "nvcc failed"}
            continue
        report = cs.print_ptxas(name, log)
        libs[name] = load(so, name == "old")
        res["variants"][name] = {
            "ptxas": {k: v for k, v in report.items() if "mont_" in k}}
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    FQ, FR = mont.FQ, mont.FR
    if args.group_sweep:
        cases = [("pow", spec, n, spec.p - 2, what)
                 for spec, what in ((FQ, "p-2"), (FR, "r-2"))
                 for n in SWEEP_WIDTHS]
    else:
        cases = [("pow", FQ, n, FQ.p - 2, "p-2")
                 for n in (1, cs.RLC_CHECK_BATCH, cs.LANES)]
        cases += [("pow", FQ, cs.HASH_N * cs.HASH_ATTEMPTS, (FQ.p - 1) // 2,
                   "(p-1)/2"), ("pow", FR, 1, FR.p - 2, "r-2")]
        # the RLC fold's first level: 7 Fq2 products (3 Fq each) a pair
        fold = 3 * 7 * (ccv.ACCUMULATORS // 2)
        cases += [("mul", spec, n, None, None) for spec in (FQ, FR)
                  for n in (78 * cs.LANES, fold)]
    for what, spec, n, e, ename in cases:
        a = cs.random_fq_lanes(spec, n, rng).to(dev)
        b = cs.random_fq_lanes(spec, n, rng).to(dev)
        if n >= 8:
            a[-4:] = 0
        out = torch.empty_like(a)
        if what == "mul":
            want = cuda_mont.mont_mul(spec, a, b)
            plain = cuda_mont.mul_ref(spec, a, b)
            S = spec.L // 2
            bound = cs.bound_ms(n * 3 * spec.L * 4, n * (4 * S * S + S),
                                cardd)[0]
            runs = {name: (caller(libs[name], name == "old", spec, "mul"),
                           (a, b, out))
                    for name in MUL_VARIANTS if name in libs}
            key = f"mul {spec.name} n={n}"
        else:
            want = cuda_mont.mont_pow(spec, a, e)
            m = min(n, 512)
            plain = cuda_mont.pow_fixed_ref(spec, a[:m].contiguous(), e)
            bound = cs.pow_bound(spec, n, e, cardd)[0]
            bits = torch.tensor([int(c) for c in bin(e)[2:]],
                                dtype=torch.int32, device=dev)
            runs = {}
            for name in POW_VARIANTS:
                if name not in libs:
                    continue
                if name == "kernel":
                    for w, g in (SWEEP_RUNS if args.group_sweep
                                 else POW_RUNS):
                        label = f"kernel w={w} G={g or 'wrapper'}"
                        runs[label] = (caller(libs[name], False, spec, "pow",
                                              e, w, g), (a, out))
                else:
                    runs[name] = (caller(libs[name], name == "old", spec,
                                         "pow", e, group=2 if name == "g2"
                                         else None, bits=bits), (a, out))
            key = f"pow {spec.name} e={ename} n={n}"
        torch.cuda.synchronize()
        if not torch.equal(want[:plain.shape[0]], plain):
            raise RuntimeError(f"{key}: the package's kernel differs from "
                               f"its plain version")
        res["bound_ms"][key] = bound
        good = {}
        for name, (fn, argv) in runs.items():
            out.fill_(-1)
            fn(*argv)
            torch.cuda.synchronize()
            if torch.equal(out, want):
                good[name] = (fn, argv)
            else:
                print(f"{key}: variant {name} differs from the package's "
                      f"kernel; not timed", flush=True)
                res["variants"].setdefault(name.split()[0], {}).setdefault(
                    "differs", []).append(key)
        order = list(good) + list(good)[::-1]
        times = {name: {"ms": [], "graph_ms": []} for name in good}
        for name in order:
            fn, argv = good[name]
            call = (lambda: fn(*argv))  # noqa: E731
            reps = REPS[what]
            times[name]["ms"].append(cs.cuda_time_ms(call, reps))
            times[name]["graph_ms"].append(tv.graph_time_ms(call, reps))
        res.setdefault("cases", {})[key] = {
            name: {k: statistics.mean(v) for k, v in t.items()}
            for name, t in times.items()}
        print(f"{key} (bound {bound:.4f} ms; bit-exact: {len(good)} of "
              f"{len(runs)}), one by one | from a CUDA graph: " + ", ".join(
                  f"{name} {statistics.mean(t['ms']):.4f} | "
                  f"{statistics.mean(t['graph_ms']):.4f} ms"
                  for name, t in times.items()), flush=True)
        del a, b, out, want, plain
        torch.cuda.empty_cache()
    if args.parent:
        res["turns"] = turns(args.parent)
    line = json.dumps(res)
    with open(os.path.join(bdir, "mont_variants.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
