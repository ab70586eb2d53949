#!/usr/bin/env python3
"""B11 (``csrc/msm.cu`` ``winacc_kernel``) against variants of its design,
on one card.

    python3 tools/b11_variants.py [--parent ROOT]

Each variant is the package's ``csrc/`` with one design choice changed by a
text patch, built with the package's nvcc flags into
``threshold_crypto_tpu_torch/_build/variants/``:

* ``old``: the lane body of ``csrc/curve.cuh`` that B11 ran before the
  register engine (``winacc_lane``, kept here as text, a variant only):
  ``__noinline__`` formulas over a local-memory frame, the add's doubling
  branch computed on every lane and selected; no register cap;
* ``kernel``: the sources as they are (``winacc_lane_r`` on
  ``csrc/ladder_engine.cuh``, a 255-register cap in both fields);
* ``cap168``: a 168-register cap (3 blocks of 128 a SM), B13 G1's choice;
* ``threads64``: blocks of 64 threads at the same cap, so that A = 16,384
  accumulators make 256 blocks over all 132 SMs.

For each: ptxas's registers, stack frame and spills of winacc_kernel<Fq>
and <Fq2>; each kernel's SASS instruction count and its calls (with the
out-of-line product, the doubling's 7 / 16 and the add's 16 / 44 Fq
products when each formula has one copy in the kernel); bit-exact against
the package's kernel on ``chip_smoke.winacc_special_points`` (not ``old``,
which predates the digit rule), at N = 2A and at the RLC shape; the kernel
time with CUDA events, in turns, at the RLC shape (N = 262,144, 22 windows
of w = 3, A = 8192, 16,384 and 32,768) and the combine shape (G2, N = A =
4096, 85 windows), beside ``chip_smoke.winacc_bound``; and at the RLC shape
with A = 16,384 the table gather's cost: random digits 1..7 (a warp's load
of one window spreads over up to 7 entries) against every digit 5 (one
entry), the same adds.

With ``--parent ROOT`` (another checkout: its ``chip_smoke.py`` and
``threshold_crypto_tpu_torch/``) it also builds that checkout's msm.cu,
ladder.cu and shared.cu and compares ptxas's figures of B10, B13, B15 and
B16 with the package's, and times the whole RLC call of both checkouts
(``chip_smoke.rlc_call``, N = 262,144, exponents included) in turns, one
child process per turn (parent, this, this, parent, twice), each a warm-up
and RLC_TURN_CALLS timed calls; it exits 1 if the ptxas figures differ.
Prints one JSON line last and writes it to ``b11_variants.json`` beside
the builds. Without CUDA it exits 2.
"""

import argparse
import ctypes
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from threshold_crypto_tpu_torch import _build  # noqa: E402

# curve.cuh's B11 lane body before the register engine.
OLD_LANE = r"""
template <class F>
__device__ __forceinline__ void set_infinity(Jac<F>& p) {
  f_set(p.X, true);
  f_set(p.Y, true);
  f_set(p.Z, false);
}

template <class F>
__device__ __forceinline__ void winacc_lane(const int32_t* table,
                                            const int32_t* digits,
                                            int32_t* out, int n, int accs,
                                            int ndig, int window, int j) {
  Jac<F> acc, q;
  set_infinity(acc);
  for (int w = 0; w < ndig; ++w) {
    for (int i = 0; i < window; ++i) jac_dbl(acc, acc);
    const int32_t* row = digits + static_cast<size_t>(w) * n;
    for (int lane = j; lane < n; lane += accs) {
      const int d = row[lane];
      if (d != 0) {
        load_jac(q, table, (d - 1) * 3 * Comps<F>::k, n, lane);
        jac_add(acc, acc, q);
      }
    }
  }
  store_jac(out, acc, accs, j);
}

}  // namespace tc
"""
OLD_KERNEL = r"""template <class F>
__global__ void __launch_bounds__(kThreads)
winacc_kernel(const int32_t* __restrict__ table,
              const int32_t* __restrict__ digits, int32_t* __restrict__ out,
              int n, int accs, int ndig, int window) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= accs) return;
  tc::winacc_lane<F>(table, digits, out, n, accs, ndig, window, j);
}
"""
KERNEL_HEAD = ("template <class F>\n__global__ void __launch_bounds__("
               "kThreads, WinaccBlocks<F>::value)\nwinacc_kernel(")
KERNEL_TAIL = ("tc::winacc_lane_r<F>(table, digits, out, n, accs, ndig, "
               "window, j);\n}\n")
CAP168 = [tuple(f"struct WinaccBlocks<tc::{f}> {{\n  static constexpr int "
                f"value = {b};" for b in (2, 3)) for f in ("Fq", "Fq2")]
THREADS64 = [("__launch_bounds__(kThreads, WinaccBlocks<F>::value)",
              "__launch_bounds__(64, 2 * WinaccBlocks<F>::value)"),
             ("winacc_kernel<F><<<grid_for(accs), kThreads,",
              "winacc_kernel<F><<<dim3((accs + 63) / 64), 64,")]
VARIANTS = {"old": ["old"], "kernel": [], "cap168": CAP168,
            "threads64": THREADS64}
# Timed RLC calls of one turn, after a warm-up call.
RLC_TURN_CALLS = 5
# One turn: argv[1] RLC calls of the checkout that is the child's working
# directory, after its kernels are built (one nvcc per source, together)
# and one warm-up call.
RLC_CHILD = """
import json, sys
import torch
import chip_smoke as cs
from threshold_crypto_tpu_torch import _build
_build.build()
dev = torch.device("cuda", 0)
pk_aff, sig_aff, h_jac = cs.rlc_inputs(dev)[:3]
times = []
for i in range(1 + int(sys.argv[1])):
    ok, _, s = cs.rlc_call(pk_aff, sig_aff, h_jac, bytes([40 + i]) * 32)
    if not ok:
        raise SystemExit("the valid batch was rejected")
    times.append(s)
print(json.dumps(times[1:]))
"""
# The kernels whose ptxas figures must equal the parent checkout's.
UNCHANGED = {"msm": ("madd_kernel",), "ladder": ("step4_kernel",
                                                 "step_kernel"),
             "shared": ("selmadd_kernel", "dblw_kernel")}


def patched(csrc, patches):
    """{file name: text} of the files of csrc the patches change."""
    files = {}

    def text(name):
        if name not in files:
            files[name] = open(os.path.join(csrc, name)).read()
        return files[name]

    for p in patches:
        if p == "old":
            cu = text("msm.cu")
            a, b = cu.index(KERNEL_HEAD), cu.index(KERNEL_TAIL)
            files["msm.cu"] = cu[:a] + OLD_KERNEL + cu[b + len(KERNEL_TAIL):]
            cuh = text("curve.cuh")
            a = cuh.rindex("}  // namespace tc")
            files["curve.cuh"] = cuh[:a] + OLD_LANE.lstrip("\n")
            continue
        old, new = p
        if old not in text("msm.cu"):
            raise RuntimeError(f"patch anchor not found: {old[:60]!r}")
        files["msm.cu"] = text("msm.cu").replace(old, new)
    return files


def nvcc_start(csrc, name, out_dir):
    """Start nvcc on csrc/<name>.cu into out_dir/lib<name>.so."""
    so = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_build.nvcc(), *_build.FLAGS, "-o", so,
           os.path.join(csrc, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def nvcc_wait(proc, what):
    log, _ = proc.communicate(timeout=1500)
    if proc.returncode != 0:
        print(log[-4000:], flush=True)
        raise RuntimeError(f"nvcc failed for {what}")
    return log


def sass_counts(cuobjdump, so):
    """{kernel: (SASS instructions, CALL instructions)} of the winacc
    kernels, from cuobjdump -sass."""
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    out = {}
    for f in re.split(r"\n\s+Function : ", text)[1:]:
        name = f.split("\n", 1)[0].strip()
        if "winacc" not in name:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", f)
        out[cs._demangle(name)] = (len(ops),
                                   sum(op.startswith("CALL") for op in ops))
    return out


def compare_parent(parent, logs):
    """Build msm.cu, ladder.cu and shared.cu of the checkout at parent
    beside the package's logs and print both figures of the kernels that
    must not change. Returns {kernel: [parent, package]} and whether all
    are equal."""
    pdir = os.path.join(_build.BUILD_DIR, "variants", "parent")
    os.makedirs(pdir, exist_ok=True)
    csrc = os.path.join(parent, "threshold_crypto_tpu_torch", "csrc")
    procs = {n: nvcc_start(csrc, n, pdir) for n in UNCHANGED}
    table, same = {}, True
    for name, (proc, _) in procs.items():
        print(f"parent {name}.cu:", flush=True)
        theirs = cs.print_ptxas(name, nvcc_wait(proc, f"parent {name}.cu"))
        print(f"package {name}.cu:", flush=True)
        ours = cs.print_ptxas(name, logs[name])
        for kern, fig in theirs.items():
            if kern.split("<")[0] in UNCHANGED[name]:
                table[kern] = [list(fig), list(ours.get(kern, ()))]
                same &= tuple(fig) == tuple(ours.get(kern, ()))
    print(f"B10, B13, B15, B16 ptxas equal the parent's: {same}", flush=True)
    return table, same


def rlc_turns(parent):
    """The RLC call's seconds in the checkout at parent and in this one, in
    turns (parent, this, this, parent, twice): {"parent": [...], "this":
    [...]}."""
    roots = {"parent": os.path.abspath(parent), "this": ROOT}
    out = {k: [] for k in roots}
    for who in ("parent", "this", "this", "parent") * 2:
        proc = subprocess.run([sys.executable, "-c", RLC_CHILD,
                               str(RLC_TURN_CALLS)], cwd=roots[who],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            raise RuntimeError(f"the RLC turn of {who} failed")
        out[who] += json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"rlc call in turns (parent, this, this, parent, twice; "
          f"{RLC_TURN_CALLS} calls a turn): " + ", ".join(
              f"{k} median {statistics.median(v):.4f} s of "
              f"{[round(t, 4) for t in v]}" for k, v in out.items()),
          flush=True)
    return out


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout: compare "
                    "B10, B13, B15 and B16's ptxas figures with it and time "
                    "both RLC calls in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b11_variants: no CUDA device", file=sys.stderr)
        return 2
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host import curve as hcv

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
        procs[name] = nvcc_start(d, "msm", d)
    logs = _build.build(list(UNCHANGED))
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    libs, res = {}, {"card": card, "variants": {}}
    for name, (p, so) in procs.items():
        report = cs.print_ptxas(name, nvcc_wait(p, f"variant {name}"))
        lib = ctypes.CDLL(so)
        for fn in ("tc_g1_winacc", "tc_g2_winacc"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * 3 + \
                [ctypes.c_int] * 4 + [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        sass = sass_counts(cuobjdump, so)
        print(f"  SASS (instructions, calls): {sass}", flush=True)
        res["variants"][name] = {
            "ptxas": {k: v for k, v in report.items() if "winacc" in k},
            "sass": sass, "ms": {}}
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)
    same = True
    if args.parent:
        res["parent_ptxas"], same = compare_parent(args.parent, logs)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)

    def run(lib, g2, table, digits, accs):
        out = torch.empty((3 * (1 + g2) * 24, accs), dtype=torch.int32,
                          device=dev)
        err = getattr(lib, f"tc_g{1 + g2}_winacc")(
            table.data_ptr(), digits.data_ptr(), out.data_ptr(),
            table.shape[1], accs, digits.shape[0], cs.RLC_WINDOW,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch error {err}")
        return out

    def package(g2, table, digits, accs):
        return (ccv.g2_winacc if g2 else ccv.g1_winacc)(table, digits, accs,
                                                        cs.RLC_WINDOW)

    A = ccv.ACCUMULATORS
    for g2 in (False, True):
        curve, host = (dcv.G2, hcv.G2) if g2 else (dcv.G1, hcv.G1)
        entries, digs, _ = cs.winacc_special_points(
            host, random.Random(0xB11 + g2))
        special = (torch.cat([cs._host_packed(curve, e, dev)
                              for e in entries]),
                   torch.tensor(digs, dtype=torch.int32, device=dev),
                   cs.WINACC_SPECIAL_A)
        checks = [(special, "old"), ((*cs.winacc_inputs(g2, 2 * A, gen, dev),
                                      A), None),
                  ((*cs.winacc_inputs(g2, cs.RLC_N, gen, dev), A), None)]
        for args_, skip in checks:
            want = package(g2, *args_)
            for name, lib in libs.items():
                if name != skip and not torch.equal(run(lib, g2, *args_),
                                                    want):
                    raise RuntimeError(f"variant {name} differs from the "
                                       f"package's kernel (G{1 + g2})")
        del checks, want
    torch.cuda.synchronize()
    print("every variant bit-exact with the package's kernel (the special "
          "lanes but old, N = 2A, the RLC shape)", flush=True)

    res["bound_ms"] = {}
    order = list(libs) + list(libs)[::-1]

    def timed(sname, g2, table, digits, accs, reps):
        bound = cs.winacc_bound(g2, table, digits, accs, cs.RLC_WINDOW,
                                cardd)[0]
        res["bound_ms"][sname] = bound
        for name in order:
            ms = cs.cuda_time_ms(
                lambda: run(libs[name], g2, table, digits, accs), reps)
            res["variants"][name]["ms"].setdefault(sname, []).append(ms)
        print(f"{sname} (bound {bound:.3f} ms): " + ", ".join(
            f"{nm} {min(v['ms'][sname]):.3f} ms "
            f"({min(v['ms'][sname]) / bound:.2f}x)"
            for nm, v in res["variants"].items()), flush=True)

    for g2 in (False, True):
        table, digits = cs.winacc_inputs(g2, cs.RLC_N, gen, dev)
        for accs in cs.RLC_A_SWEEP:
            timed(f"rlc G{1 + g2} A={accs}", g2, table, digits, accs, 2)
        digits = torch.randint(1, 8, digits.shape, generator=gen, device=dev,
                               dtype=torch.int32)
        timed(f"rlc G{1 + g2} A={A} digits 1..7", g2, table, digits, A, 2)
        timed(f"rlc G{1 + g2} A={A} every digit 5", g2, table,
              torch.full_like(digits, 5), A, 2)
        del table, digits
    n = cs.COMBINE_N
    table = cs.random_packed(7 * 6, n, gen, dev)
    digits = torch.randint(0, 8, (85, n), generator=gen, device=dev,
                           dtype=torch.int32)
    timed(f"combine G2 N=A={n} x 85", True, table, digits, n, 3)
    if args.parent:
        del table, digits
        torch.cuda.empty_cache()
        res["rlc_turns_s"] = rlc_turns(args.parent)
    line = json.dumps(res)
    with open(os.path.join(bdir, "b11_variants.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
