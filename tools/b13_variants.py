#!/usr/bin/env python3
"""B13 (``csrc/ladder.cu`` ``step4_kernel``) against variants of its design,
on one card.

    python3 tools/b13_variants.py

Each variant is the package's ``csrc/ladder.cu`` and ``csrc/ladder_engine.cuh``
with one design choice changed by a text patch, built with the package's
nvcc flags into ``threshold_crypto_tpu_torch/_build/variants/``:

* ``kernel``: the sources as they are (G1 3 blocks of 128, G2 2);
* ``g1_2_blocks``: G1 at 2 blocks of 128 (a 255-register cap);
* ``inlined``: the Montgomery product inlined at every product site of the
  ladder instead of its one out-of-line copy;
* ``inlined_rolled2``: inlined, its 12 rounds a loop of 6 passes of 2;
* ``carry_chain``: inlined, CIOS with a carry chain through the words
  (``mad.lo.cc`` / ``madc.hi.cc``) in place of the carry-save rounds.

For each: ptxas's registers, stack frame and spills of step4_kernel<Fq> and
<Fq2>, and each kernel's SASS instruction count (with the out-of-line
product, where there is one);
bit-exact against the package's kernel on the special lanes and the paths'
digits at 8192 lanes and at the DKG's launch shape; the kernel time with
CUDA events at the DKG shape (G1, 2^19 lanes x 64 digits), the encrypt
shape (G1, 4096 x 64) and the hash shape (G2, 8192 x 127 digits of H2), in
turns, beside ``chip_smoke.ladder_bound``. Prints one JSON line last and
writes it to ``b13_variants.json`` beside the variants' builds. Without
CUDA it exits 2.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# The out-of-line product made inline.
INLINE = [("__device__ __noinline__ Fp fp_mul_call",
           "__device__ __forceinline__ Fp fp_mul_call")]
# Its rounds a loop of passes of 2, the b words rotated after each pass.
ROLLED2 = INLINE + [(
    """#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    cs_step(t, h, a.w, b.w[i]);
    cs_step(t, h, pw, t[0] * kN0);     // t_0 becomes 0
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      t[j] = t[j + 1];
      h[j] = h[j + 1];
    }
    t[kWords] = h[kWords] = 0;
  }""",
    """uint32_t bw[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) bw[j] = b.w[j];
#pragma unroll 1
  for (int i = 0; i < kWords; i += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      cs_step(t, h, a.w, bw[u]);
      cs_step(t, h, pw, t[0] * kN0);
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        t[j] = t[j + 1];
        h[j] = h[j + 1];
      }
      t[kWords] = h[kWords] = 0;
    }
#pragma unroll
    for (int j = 0; j + 2 < kWords; ++j) bw[j] = bw[j + 2];
  }""")]
# CIOS with a carry chain through the words: per b_i the low halves into
# t[0..11], the high halves into t[1..12], q = t_0·n0, q·p likewise.
CHAIN_BODY = r"""
#define TC_CC(name, op)                                                   \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,        \
                                           uint32_t c) {                  \
    uint32_t r;                                                           \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                             \
  }
TC_CC(mad_lo_cc, "mad.lo.cc.u32")
TC_CC(madc_lo_cc, "madc.lo.cc.u32")
TC_CC(mad_hi_cc, "mad.hi.cc.u32")
TC_CC(madc_hi_cc, "madc.hi.cc.u32")
TC_CC(madc_hi, "madc.hi.u32")
__device__ __forceinline__ void fp_mul_body(Fp& r, const Fp& a,
                                            const Fp& b) {
  uint32_t t[kWords + 1];
#pragma unroll
  for (int j = 0; j <= kWords; ++j) t[j] = 0;
  Chain c;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t bi = b.w[i];
    t[0] = mad_lo_cc(a.w[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < kWords; ++j) t[j] = madc_lo_cc(a.w[j], bi, t[j]);
    t[kWords] = c.addc(0u, 0u);
    t[1] = mad_hi_cc(a.w[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < kWords - 1; ++j)
      t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1]);
    t[kWords] = madc_hi(a.w[kWords - 1], bi, t[kWords]);
    const uint32_t q = t[0] * kN0;
    t[0] = mad_lo_cc(q, p_word(0), t[0]);
#pragma unroll
    for (int j = 1; j < kWords; ++j) t[j] = madc_lo_cc(q, p_word(j), t[j]);
    t[kWords] = c.addc(t[kWords], 0u);
    t[1] = mad_hi_cc(q, p_word(0), t[1]);
#pragma unroll
    for (int j = 1; j < kWords - 1; ++j)
      t[j + 1] = madc_hi_cc(q, p_word(j), t[j + 1]);
    t[kWords] = madc_hi(q, p_word(kWords - 1), t[kWords]);
#pragma unroll
    for (int j = 0; j < kWords; ++j) t[j] = t[j + 1];
    t[kWords] = 0;
  }
  uint32_t d[kWords];
  d[0] = c.sub_cc(t[0], p_word(0));
#pragma unroll
  for (int j = 1; j < kWords; ++j) d[j] = c.subc_cc(t[j], p_word(j));
  const uint32_t borrow = c.subc(0u, 0u);
#pragma unroll
  for (int j = 0; j < kWords; ++j) r.w[j] = borrow ? t[j] : d[j];
}
"""
G1_2 = [("struct Step4Blocks<tc::Fq> {\n  static constexpr int value = 3;",
         "struct Step4Blocks<tc::Fq> {\n  static constexpr int value = 2;")]
VARIANTS = {
    "kernel": [],
    "g1_2_blocks": G1_2,
    "inlined": G1_2 + INLINE,
    "inlined_rolled2": G1_2 + ROLLED2,
    "carry_chain": G1_2 + INLINE + ["chain"],
}


def patched(csrc, patches):
    """(ladder.cu, ladder_engine.cuh) texts with the patches applied."""
    cu = open(os.path.join(csrc, "ladder.cu")).read()
    eng = open(os.path.join(csrc, "ladder_engine.cuh")).read()
    for p in patches:
        if p == "chain":
            a = eng.index("__device__ __forceinline__ void fp_mul_body(")
            b = eng.index("// The product's one copy in the kernel")
            eng = eng[:a] + CHAIN_BODY + "\n" + eng[b:]
            continue
        old, new = p
        if old in cu:
            cu = cu.replace(old, new)
        elif old in eng:
            eng = eng.replace(old, new)
        else:
            raise RuntimeError(f"patch anchor not found: {old[:60]!r}")
    return cu, eng


def sass_counts(cuobjdump, so):
    """{kernel: SASS instruction count} of the step4 kernels, from
    cuobjdump -sass."""
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    out = {}
    for f in re.split(r"\n\s+Function : ", text)[1:]:
        name = f.split("\n", 1)[0].strip()
        if "step4" not in name:
            continue
        n = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?[A-Z]",
                           f))
        out[cs._demangle(name)] = n
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("b13_variants: no CUDA device", file=sys.stderr)
        return 2
    from threshold_crypto_tpu_torch import _build
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

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
        cu, eng = patched(_build.CSRC, patches)
        open(os.path.join(d, "ladder.cu"), "w").write(cu)
        open(os.path.join(d, "ladder_engine.cuh"), "w").write(eng)
        so = os.path.join(d, "libladder.so")
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", so,
               os.path.join(d, "ladder.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    libs, res = {}, {"card": card, "variants": {}}
    for name, (p, so) in procs.items():
        log, _ = p.communicate(timeout=1500)
        if p.returncode != 0:
            print(log[-4000:], flush=True)
            raise RuntimeError(f"nvcc failed for variant {name}")
        report = cs.print_ptxas(name, log)
        lib = ctypes.CDLL(so)
        for fn in ("tc_g1_step4", "tc_g2_step4"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * 4 + \
                [ctypes.c_int] * 2 + [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        sass = sass_counts(cuobjdump, so)
        print(f"  SASS instructions: {sass}", flush=True)
        res["variants"][name] = {
            "ptxas": {k: v for k, v in report.items() if "step4" in k},
            "sass": sass, "ms": {}}
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)

    def run(lib, g2, acc, table, digits):
        out = torch.empty_like(acc)
        err = getattr(lib, f"tc_g{1 + g2}_step4")(
            acc.data_ptr(), table.data_ptr(), digits.data_ptr(),
            out.data_ptr(), acc.shape[1], digits.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch error {err}")
        return out

    n = ccv.LADDER_CHUNK
    dkg = (ccv.packed_infinity(False, n, dev),
           cs.random_packed(15 * 3, n, gen, dev),
           torch.randint(0, 16, (64, n), generator=gen, device=dev,
                         dtype=torch.int32))
    shapes = {"dkg G1 2^19 x 64": (False, *dkg, 2),
              "encrypt G1 4096 x 64": (
                  False, *cs.ladder_path_inputs(False, "step4", cs.ENC_N,
                                                gen, dev), 10),
              "hash G2 8192 x 127": (
                  True, *cs.ladder_path_inputs(True, "step4", cs.HASH_N, gen,
                                               dev), 5)}
    checks = [(g2, cs.ladder_special(g2, "step4", cs.LANES, gen, dev))
              for g2 in (False, True)]
    checks += [(v[0], v[1:4]) for v in shapes.values()]
    for g2, args in checks:
        want = run(libs["kernel"], g2, *args)
        for name, lib in libs.items():
            if not torch.equal(run(lib, g2, *args), want):
                raise RuntimeError(f"variant {name} differs from the kernel")
    torch.cuda.synchronize()
    print("every variant bit-exact with the kernel (special lanes, the "
          "paths' digits, the DKG shape)", flush=True)
    res["bound_ms"] = {}
    order = list(libs) + list(libs)[::-1]
    for sname, (g2, acc, table, digits, reps) in shapes.items():
        bound = cs.ladder_bound(g2, "step4", digits, cardd)[0]
        res["bound_ms"][sname] = bound
        for name in order:
            ms = cs.cuda_time_ms(
                lambda: run(libs[name], g2, acc, table, digits), reps)
            res["variants"][name]["ms"].setdefault(sname, []).append(ms)
        print(f"{sname} (bound {bound:.3f} ms): " + ", ".join(
            f"{nm} {min(v['ms'][sname]):.3f} ms "
            f"({min(v['ms'][sname]) / bound:.2f}x)"
            for nm, v in res["variants"].items()), flush=True)
    line = json.dumps(res)
    with open(os.path.join(bdir, "b13_variants.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
