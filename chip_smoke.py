#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (threshold_crypto_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each announced on a flushed line before it starts:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every kernel source of the package with nvcc (sm_90a), with the
   registers and spills that ptxas reports;
3. kernels: each kernel on the card against its plain PyTorch version on the
   same inputs, bit-exact, at the shapes of the main path, timed with CUDA
   events beside the plain version;
4. slice: ``ops.verify_batch`` on 8192 lanes (16,384 pairs) of keys,
   messages and signatures made on the host from a seed; the result must
   equal the mask known from construction lane for lane; a 256-lane
   slice is timed the same way (a call that takes as long on 1/32 of the
   data is host-bound) and must agree through the plain versions on the card;
5. one JSON line of kernel numbers, then the device line, last.

Any mismatch or exception ends the run with a non-zero exit and no result
line. Without a CUDA card, or without the package beside this file, it exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time

SEED = 20260417
N_MESSAGES = 16
# The per-pair batch of the JAX package's bench (bench.py, per_pair_batch).
LANES = 8192
# The card's memory rate and 32-bit integer multiply-add issue rate per SM
# and clock: H100 SXM data sheet (3.35 TB/s) and the CUDA C++ Programming
# Guide's throughput table for compute capability 9.0 (64 results/clk/SM).
MEM_BYTES_PER_S = 3.35e12
IMAD_PER_CLK_PER_SM = 64


def phase(msg):
    print(f"== {msg}", flush=True)


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean device time of one fn() over reps launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def random_fq_lanes(spec, n, rng):
    """int32[n, L] canonical limbs: random below p's top limb, so < p."""
    import numpy as np
    import torch

    limbs = rng.integers(0, 1 << 16, size=(n, spec.L), dtype=np.int64)
    limbs[:, -1] = rng.integers(0, spec.p_limbs[-1], size=n)
    return torch.from_numpy(limbs.astype(np.int32))


def with_edges(spec, x, values):
    """Overwrite the first lanes of x with the given field values (raw
    limbs, each < p: 0, 1, p−1 and their Montgomery forms)."""
    import torch
    from threshold_crypto_tpu_torch.device import mont

    edges = torch.from_numpy(mont.stack_mont(spec, values))
    x[: len(values)] = edges.to(x.device)
    return x


def edge_values(spec):
    r_inv = pow(spec.r_mont, -1, spec.p)
    # raw limb values 0, 1, p-1 (stack_mont multiplies by R, so pre-divide)
    raw = [0, 1, spec.p - 1]
    return [v * r_inv % spec.p for v in raw] + raw


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def mul_bound_ms(n, L, sm_count, clock_hz):
    """Least time for n Montgomery products of L 16-bit limbs: the larger of
    bytes (2 inputs read, 1 output written) over the memory rate and 32-bit
    multiply-add results (each 32×32→64 product is two) over the issue rate."""
    S = L // 2
    bytes_moved = n * 3 * L * 4
    imads = n * (4 * S * S + S)
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = imads / (IMAD_PER_CLK_PER_SM * sm_count * clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def pow_bound_ms(n, L, e, sm_count, clock_hz):
    S = L // 2
    products = e.bit_length() + bin(e).count("1")
    bytes_moved = n * 2 * L * 4 + 4 * e.bit_length()
    imads = n * products * (4 * S * S + S)
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = imads / (IMAD_PER_CLK_PER_SM * sm_count * clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_mul(spec, n, rng, dev, sm_count, clock_hz):
    import torch
    from threshold_crypto_tpu_torch.device import cuda_mont

    a = with_edges(spec, random_fq_lanes(spec, n, rng), edge_values(spec))
    b = with_edges(spec, random_fq_lanes(spec, n, rng),
                   edge_values(spec)[::-1])
    a, b = a.to(dev), b.to(dev)
    got = cuda_mont.mont_mul(spec, a, b)
    torch.cuda.synchronize()
    want = cuda_mont.mul_ref(spec, a, b)
    err = int((got - want).abs().max().item())
    if err != 0 or not torch.equal(got, want):
        fail(f"mont_mul {spec.name}: kernel disagrees with mul_ref at {n} "
             f"lanes (max abs limb error {err})")
    ms = cuda_time_ms(lambda: cuda_mont.mont_mul(spec, a, b), 20)
    plain_ms = cuda_time_ms(lambda: cuda_mont.mul_ref(spec, a, b), 2)
    bound, by = mul_bound_ms(n, spec.L, sm_count, clock_hz)
    print(f"mont_mul {spec.name} lanes={n}: bit-exact; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)
    return dict(lanes=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


def check_pow(spec, n, e, rng, dev, sm_count, clock_hz, n_zero=4):
    import torch
    from threshold_crypto_tpu_torch.device import cuda_mont

    a = with_edges(spec, random_fq_lanes(spec, n, rng), edge_values(spec))
    a[-n_zero:] = 0
    a = a.to(dev)
    got = cuda_mont.mont_pow(spec, a, e)
    torch.cuda.synchronize()
    want = cuda_mont.pow_fixed_ref(spec, a, e)
    err = int((got - want).abs().max().item())
    if err != 0 or not torch.equal(got, want):
        fail(f"mont_pow {spec.name}: kernel disagrees with pow_fixed_ref at "
             f"{n} lanes (max abs limb error {err})")
    if e == spec.p - 2 and bool((got[-n_zero:] != 0).any()):
        fail("mont_pow: inv(0) is not 0")
    ms = cuda_time_ms(lambda: cuda_mont.mont_pow(spec, a, e), 5)
    plain_ms = cuda_time_ms(lambda: cuda_mont.pow_fixed_ref(spec, a, e), 1)
    bound, by = pow_bound_ms(n, spec.L, e, sm_count, clock_hz)
    print(f"mont_pow {spec.name} e=p-2 lanes={n}: bit-exact, zeros -> 0; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
          f"({by})", flush=True)
    return dict(lanes=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------

def build_inputs():
    """Keys, messages and signatures on the host, and the expected mask.

    16 messages H_m = h_m·G2, each with LANES/16 consecutive keys
    pk_{i+1} = pk_i + G1, sig_{i+1} = sig_i + H_m (every lane distinct).
    Lanes ≡ 3 (mod 8) pair their signature with the next message's H (False).
    Four lanes ≡ 5 (mod 8) near the start have an infinite pk, an infinite
    sig (both False), or both (True).
    """
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.params import R

    rnd = random.Random(SEED)
    per = LANES // N_MESSAGES
    hs = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
          for _ in range(N_MESSAGES)]
    pk, h, sig, want = [], [], [], []
    for m in range(N_MESSAGES):
        sk = rnd.randrange(1, R)
        p_i = hcv.G1.mul(hcv.G1.generator, sk)
        s_i = hcv.G2.mul(hs[m], sk)
        for j in range(per):
            lane = m * per + j
            tampered = lane % 8 == 3
            pk.append(p_i)
            sig.append(s_i)
            h.append(hs[(m + 1) % N_MESSAGES] if tampered else hs[m])
            want.append(not tampered)
            p_i = hcv.G1.add(p_i, hcv.G1.generator)
            s_i = hcv.G2.add(s_i, hs[m])
    for lane, kind in ((5, "pk"), (13, "sig"), (21, "both"), (29, "pk")):
        if kind in ("pk", "both"):
            pk[lane] = None
        if kind in ("sig", "both"):
            sig[lane] = None
        want[lane] = kind == "both"
    return pk, h, sig, want


@contextlib.contextmanager
def plain_versions():
    """Route the package's kernel calls to their plain PyTorch versions, for
    the plain-path comparison only."""
    from threshold_crypto_tpu_torch.device import cuda_mont

    saved = cuda_mont.mont_mul, cuda_mont.mont_pow
    cuda_mont.mont_mul = cuda_mont.mul_ref
    cuda_mont.mont_pow = cuda_mont.pow_fixed_ref
    try:
        yield
    finally:
        cuda_mont.mont_mul, cuda_mont.mont_pow = saved


@contextlib.contextmanager
def kernel_event_timer(spans):
    """Bracket every kernel launch with CUDA events (timing run only)."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_mont

    saved = cuda_mont.mont_mul, cuda_mont.mont_pow

    def timed(fn):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            spans.append((start, stop))
            return out
        return run

    cuda_mont.mont_mul, cuda_mont.mont_pow = timed(saved[0]), timed(saved[1])
    try:
        yield
    finally:
        cuda_mont.mont_mul, cuda_mont.mont_pow = saved


def run_slice(dev):
    import torch
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import cuda_mont
    from threshold_crypto_tpu_torch.device import pairing as dpr

    t0 = time.time()
    pk, h, sig, want = build_inputs()
    args = (dpr.g1_affine_from_host(pk, device=dev),
            dpr.g2_affine_from_host(h, device=dev),
            dpr.g2_affine_from_host(sig, device=dev))
    want_t = torch.tensor(want, device=dev)
    print(f"inputs: {LANES} lanes, {sum(want)} expected True, built in "
          f"{time.time() - t0:.1f} s", flush=True)

    def call():
        out = ops.verify_batch(*args)
        torch.cuda.synchronize()
        if out.shape != (LANES,) or not torch.equal(out, want_t):
            bad = (out != want_t).nonzero().flatten()[:8].tolist()
            fail(f"verify_batch disagrees with the constructed mask at lanes "
                 f"{bad}")
        return out

    # The main path's run: counts set to 0 just before, read just after.
    cuda_mont.MUL.reset()
    cuda_mont.POW.reset()
    t0 = time.time()
    call()
    first_s = time.time() - t0
    launches = {"mont_mul": cuda_mont.MUL.launches,
                "mont_pow": cuda_mont.POW.launches}
    widest = {"mont_mul": cuda_mont.MUL.widest,
              "mont_pow": cuda_mont.POW.widest}
    print(f"verify_batch first call {first_s:.2f} s; launches per call "
          f"{launches}; widest launch {widest}", flush=True)
    if min(launches.values()) < 1:
        fail(f"a kernel of the path was not launched: {launches}")

    times = []
    for _ in range(3):
        t0 = time.time()
        call()
        times.append(time.time() - t0)
    wall = statistics.median(times)
    print(f"verify_batch lanes={LANES}: median {wall:.3f} s of {times} -> "
          f"{LANES / wall:.1f} verifications/s", flush=True)

    spans = []
    with kernel_event_timer(spans):
        t0 = time.time()
        call()
        timed_wall = time.time() - t0
    kernel_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    print(f"time split (one call, kernels bracketed by events): wall "
          f"{timed_wall:.3f} s, mont kernels {kernel_s:.3f} s "
          f"({100 * kernel_s / timed_wall:.1f} %), the rest (torch glue, "
          f"launch overhead) {timed_wall - kernel_s:.3f} s", flush=True)

    # The same path on a 256-lane slice: a call that takes about as long on
    # 1/32 of the data is bound by the host's dispatch of its torch ops.
    n_small = 256
    small = tuple(_slice_aff(a, n_small) for a in args)
    small_times = []
    for _ in range(3):
        t0 = time.time()
        out = ops.verify_batch(*small)
        torch.cuda.synchronize()
        small_times.append(time.time() - t0)
        if not torch.equal(out, want_t[:n_small]):
            fail(f"verify_batch at {n_small} lanes disagrees with the mask")
    small_wall = statistics.median(small_times)
    print(f"verify_batch lanes={n_small}: median {small_wall:.3f} s of "
          f"{small_times}; {LANES} lanes take {wall / small_wall:.2f}x as "
          f"long for {LANES // n_small}x the lanes", flush=True)

    with plain_versions():
        t0 = time.time()
        out = ops.verify_batch(*small)
        torch.cuda.synchronize()
    if not torch.equal(out, want_t[:n_small]):
        fail("plain path on the card disagrees with the constructed mask")
    print(f"plain path on the card, {n_small} lanes: agrees "
          f"({time.time() - t0:.1f} s)", flush=True)
    return dict(launches=launches, widest=widest, wall_s=wall,
                per_s=LANES / wall, kernel_s=kernel_s, timed_wall_s=timed_wall)


def _slice_aff(t, n):
    if isinstance(t, tuple):
        return tuple(_slice_aff(x, n) for x in t)
    return t[:n]


# ---------------------------------------------------------------------------

def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from threshold_crypto_tpu_torch import _build
    from threshold_crypto_tpu_torch.device import mont

    phase("card")
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{props.multi_processor_count} SMs, max SM clock {clock_mhz} MHz",
          flush=True)
    clock_hz = clock_mhz * 1e6

    phase("build")
    t0 = time.time()
    logs = _build.build()
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                print(f"  {name}: {m.group(1)}", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)

    phase("kernels against their plain versions (bit-exact)")
    rng = np.random.default_rng(SEED)
    widest_mul = 78 * LANES  # 13 Fq2 (39 Fq) products over 2 pairs
    res_mul = check_mul(mont.FQ, widest_mul, rng, dev,
                        props.multi_processor_count, clock_hz)
    check_mul(mont.FR, widest_mul, rng, dev, props.multi_processor_count,
              clock_hz)
    res_pow = check_pow(mont.FQ, LANES, mont.FQ.p - 2, rng, dev,
                        props.multi_processor_count, clock_hz)
    check_pow(mont.FQ, 4 * LANES, mont.FQ.p - 2, rng, dev,
              props.multi_processor_count, clock_hz)

    phase(f"slice: ops.verify_batch at {LANES} lanes")
    sl = run_slice(dev)
    if sl["widest"] != {"mont_mul": widest_mul, "mont_pow": LANES}:
        fail(f"the kernel checks missed the path's widest launches "
             f"{sl['widest']}")

    src = "threshold_crypto_tpu_torch/csrc/mont.cu"
    kernels = []
    for name, res, replaces in (
        ("mont_mul", res_mul, "threshold_crypto_tpu/device/pallas_mont.py:45"),
        ("mont_pow", res_pow, "threshold_crypto_tpu/device/pallas_mont.py:267"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sl["launches"][name], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": None, "lanes": res["lanes"], "check": "bit-exact",
            "card": card,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
