#!/usr/bin/env python3
"""B10 (``csrc/msm.cu`` ``madd_kernel``) against its old body and other
register caps, on one card.

    python3 tools/b10_variants.py [--parent ROOT]

Each variant is the package's ``csrc/`` with one design choice changed by a
text patch, built with the package's nvcc flags into
``threshold_crypto_tpu_torch/_build/variants/``:

* ``old``: the lane body of ``csrc/curve.cuh`` that B10 ran before the
  register engine (``jac_madd`` and ``madd_lane``, kept here as text):
  ``__noinline__`` formulas over a local-memory frame, the doubling branch
  computed on every lane and selected; no register cap;
* ``kernel``: the sources as they are (``madd_lane_r`` on
  ``csrc/ladder_engine.cuh``, ``MaddBlocks`` per field);
* ``b2``, ``b3``, ``b4``: ``MaddBlocks`` 2, 3 or 4 in both fields, that is
  a cap of 255, 168 or 128 registers (blocks of 128 threads).

For each: ptxas's registers, stack frame and spills of madd_kernel<Fq> and
<Fq2>; bit-exact against the package's kernel (which is held against its
plain version on 16,384 lanes here too) on ``chip_smoke.madd_inputs`` (T at
infinity, T == Q, T == −Q, zero lanes) and on the table build's first
launch (acc = Q with Z = 1) at the RLC path's N = 262,144 lanes; and the
kernel time with CUDA events, in turns (old, kernel, …, b4, b4, …, old),
at N = 262,144 in G1 and G2 with random acc (the general path, as in the
table build's later launches) and with acc = Q (every lane takes the
doubling branch), beside ``chip_smoke``'s bound: launched one by one from
Python and replayed from a CUDA graph.

With ``--parent ROOT`` (another checkout: its ``chip_smoke.py`` and
``threshold_crypto_tpu_torch/``) it also times both checkouts' calls in
turns (``tools/tower_variants.py``'s ``turns``: the RLC call, its MSM
table and check stages, the per-pair call). Prints one JSON line last and
writes it to ``b10_variants.json`` beside the builds. Without CUDA it
exits 2.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
import tower_variants as tv  # noqa: E402
from threshold_crypto_tpu_torch import _build  # noqa: E402

# curve.cuh's B10 formula and lane body before the register engine.
OLD_LANE = r"""
// The complete mixed add T (Jacobian) + Q (affine, not at infinity).
template <class F>
__device__ __noinline__ void jac_madd(Jac<F>& r, const Jac<F>& T,
                                      const F& x2, const F& y2) {
  F z1z, A, B, S, XpB, E, u2, z1cu, C, XB2, E2, h, D, Xd, s2, hh, EDX, rr_;
  F Yd, Zd, hhh, v, rr, Zn, Xn, Yn, t, u;
  // L1
  f_sqr(z1z, T.Z);
  f_sqr(A, T.X);
  f_sqr(B, T.Y);
  f_mul(S, T.Y, T.Z);
  f_add(XpB, T.X, B);
  f_small(E, A, 3);
  // L2
  f_mul(u2, x2, z1z);
  f_mul(z1cu, z1z, T.Z);
  f_sqr(C, B);
  f_sqr(XB2, XpB);
  f_sqr(E2, E);
  f_sub(h, u2, T.X);
  f_sub(t, XB2, A);
  f_sub(t, t, C);
  f_small(D, t, 2);
  f_small(t, D, 2);
  f_sub(Xd, E2, t);
  // L3
  f_mul(s2, y2, z1cu);
  f_sqr(hh, h);
  f_sub(t, D, Xd);
  f_mul(EDX, E, t);
  f_sub(rr_, s2, T.Y);                   // r
  f_small(u, C, 8);
  f_sub(Yd, EDX, u);
  f_small(Zd, S, 2);
  // L4
  f_mul(hhh, h, hh);
  f_mul(v, T.X, hh);
  f_sqr(rr, rr_);
  f_mul(Zn, T.Z, h);
  f_sub(t, rr, hhh);
  f_small(u, v, 2);
  f_sub(Xn, t, u);
  // L5
  f_sub(t, v, Xn);
  f_mul(t, rr_, t);
  f_mul(u, T.Y, hhh);
  f_sub(Yn, t, u);

  const bool h0 = f_is_zero(h);
  const bool r0 = f_is_zero(rr_);
  const bool t_inf = f_is_zero(T.Z);
  Jac<F> out;
  out.X = Xn;
  out.Y = Yn;
  out.Z = Zn;
  select3(out, h0 && r0, Xd, Yd, Zd);    // T == Q  -> 2T
  F one, zero;
  f_set(one, true);
  f_set(zero, false);
  select3(out, h0 && !r0, one, one, zero);  // T == -Q -> infinity
  select3(out, t_inf, x2, y2, one);      // 0 + Q -> Q
  r = out;
}

// B10 (`_k_g1_madd` / `_k_g2_madd`): acc [3k·24, n] + q [2k·24, n] affine.
template <class F>
__device__ __forceinline__ void madd_lane(const int32_t* acc_in,
                                          const int32_t* q_in, int32_t* out,
                                          int n, int lane) {
  Jac<F> T;
  F x2, y2;
  load_jac(T, acc_in, 0, n, lane);
  f_load(x2, q_in, 0, n, lane);
  f_load(y2, q_in, Comps<F>::k, n, lane);
  jac_madd(T, T, x2, y2);
  store_jac(out, T, n, lane);
}

}  // namespace tc
"""
OLD_KERNEL = r"""template <class F>
__global__ void __launch_bounds__(kThreads)
madd_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ q,
            int32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  tc::madd_lane<F>(acc, q, out, n, lane);
}
"""
KERNEL_HEAD = ("template <class F>\n__global__ void __launch_bounds__("
               "kThreads, MaddBlocks<F>::value)\nmadd_kernel(")
KERNEL_TAIL = "tc::madd_lane_r<F>(acc, q, out, n, lane);\n}\n"


BLOCKS = re.compile(r"(struct MaddBlocks<tc::Fq2?> \{\n  static constexpr "
                    r"int value = )\d+;")


def blocks(b):
    """msm.cu with MaddBlocks b in both fields."""
    def patch(text):
        new, count = BLOCKS.subn(rf"\g<1>{b};", text)
        if count != 2:
            raise RuntimeError("patch anchor not found: MaddBlocks")
        return new
    return patch


VARIANTS = {"old": ["old"], "kernel": [], "b2": [blocks(2)],
            "b3": [blocks(3)], "b4": [blocks(4)]}
LANES = cs.RLC_N
REPS = 10


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
        files["msm.cu"] = p(text("msm.cu"))
    return files


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout: time its "
                    "RLC call, table and check stages and per-pair call in "
                    "turns with this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b10_variants: no CUDA device", file=sys.stderr)
        return 2
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import packed as pk

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
        procs[name] = tv.nvcc_start(os.path.join(d, "msm.cu"), d, "msm")
    _build.build(["msm"])
    libs, res = {}, {"card": card, "variants": {}}
    for name, (p, so) in procs.items():
        report = cs.print_ptxas(name, tv.nvcc_wait(p, f"variant {name}"))
        lib = ctypes.CDLL(so)
        for fn in ("tc_g1_madd", "tc_g2_madd"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * 3 + \
                [ctypes.c_int, ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        res["variants"][name] = {
            "ptxas": {k: v for k, v in report.items() if "madd" in k},
            "ms": {}, "graph_ms": {}}
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)

    def run(lib, g2, acc, q):
        out = torch.empty_like(acc)
        err = getattr(lib, f"tc_g{1 + g2}_madd")(
            acc.data_ptr(), q.data_ptr(), out.data_ptr(), acc.shape[1],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch error {err}")
        return out

    res["bound_ms"] = {}
    order = list(libs) + list(libs)[::-1]
    for g2 in (False, True):
        k = 2 if g2 else 1
        acc, q = cs.madd_inputs(g2, LANES, gen, dev)
        first = torch.cat([q, pk._one_rows(k, LANES, dev)])
        package = ccv.g2_madd if g2 else ccv.g1_madd
        plain = ccv.g2_madd_ref if g2 else ccv.g1_madd_ref
        bound = cs.bound_ms(LANES * 8 * k * 96,
                            LANES * cs.MADD_FQ_PRODUCTS[k - 1]
                            * cs.FQ_PRODUCT_IMADS, cardd)[0]
        for what, a in (("random acc", acc), ("acc = Q, every lane doubles",
                                             first)):
            want = package(a, q)
            s = 16384
            if not torch.equal(want[:, :s], plain(a[:, :s].contiguous(),
                                                  q[:, :s].contiguous())):
                raise RuntimeError(f"the package's G{1 + g2} madd differs "
                                   f"from its plain version ({what})")
            for name, lib in libs.items():
                if not torch.equal(run(lib, g2, a, q), want):
                    raise RuntimeError(f"variant {name} G{1 + g2} differs "
                                       f"from the package's ({what})")
            key = f"G{1 + g2} n={LANES} {what}"
            res["bound_ms"][key] = bound
            for name in order:
                fn = (lambda: run(libs[name], g2, a, q))  # noqa: E731
                v = res["variants"][name]
                v["ms"].setdefault(key, []).append(cs.cuda_time_ms(fn, REPS))
                v["graph_ms"].setdefault(key, []).append(
                    tv.graph_time_ms(fn, REPS))
            print(f"{key} (bound {bound:.4f} ms; every variant bit-exact), "
                  f"launched one by one | replayed from a CUDA graph: "
                  + ", ".join(
                      f"{nm} {statistics.mean(v['ms'][key]):.4f} | "
                      f"{statistics.mean(v['graph_ms'][key]):.4f} ms"
                      for nm, v in res["variants"].items()), flush=True)
        del acc, q, first, want
        torch.cuda.empty_cache()
    if args.parent:
        res["turns"] = tv.turns(args.parent)
    line = json.dumps(res)
    with open(os.path.join(bdir, "b10_variants.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
