#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (threshold_crypto_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each announced on a flushed line before it starts:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every kernel source of the package with nvcc (sm_90a), one nvcc
   per source, all started together, and beside them the host library
   ``csrc/tc_native.cpp`` with g++: seconds per source (g++'s too, and the
   library's ABI version), and per kernel the registers, stack frame and
   spills that ptxas reports;
3. kernels: each kernel on the card against its plain PyTorch version on the
   same inputs, bit-exact, at the shapes of the main paths (B1 in Fq and Fr
   at slice 1's widest launch; B2 for p − 2 at 1, 512, 8192 and 32,768 lanes, for (p − 1)/2 at
   the hash path's 65,536 and in Fr for r − 2 at 1 and 4096, beside the
   bound of its own chain's squares and products (and, as history, of the
   square-and-multiply count the kernel before it ran); their
   registers, stack frame and spills; one call of each under torch's sync
   debug mode "error"; B1 refusing a view off a 16-byte line; the tower
   kernels, B17 included, also on zero lanes and infinity points; B14 at
   4096 lanes with a duplicate pair and a zero lane; B16 at window 1 and 3
   on its special lanes, with its registers, stack frame and spills and a
   latency yardstick beside its bound (its general path's products times
   the per-product latency of B2's one-lane chain in this run); B11 also
   on its special lanes, T == Q followed by another add in the window
   among them, against the host's partial sums; B4-B9 and B17, on the
   lane-group engine, also at the RLC check's widths (B4, B5 and B17
   1,024 pair lanes, B6-B9 512), with their registers, stack frame and
   spills (a frame or a spill fails the run), and B3's test entry on the
   register engine with its own (a frame or a spill fails the run); B10
   also
   timed on the table build's first launch, where every lane takes the
   doubling branch), timed with CUDA events beside the plain
   version and the kernel's bound; B13 G1 also at the DKG's launch shape
   (2^19 lanes x 64 digits over the dealing's 3,741 gathered points); B15
   at its three paths' widths (the window-1 MSM's 65,536 lanes x 64 bits,
   ``verify_sig_shares_rlc``'s 262,144 x 64 and the combine's 4096 x 255)
   on special lanes over three bits (2T == ±Q at a later bit, the 4T of
   2T == Q before a next bit and after the last, an infinite accumulator
   then a set bit) and on random bits, each width timed beside its bound,
   the combine's also beside a latency yardstick (its products times one
   thread's product in series, from B16 dblw on one block in this run);
   B10's, B11's, B13's and B15's registers, stack frame and spills, and
   B14's; B19, one level of the pairwise fold, through ``fold_axis`` at
   the folds of the paths (the DKG's [256, 86, 86] over axis 2 and
   [256, 3741] over axis 1, the RLC's 16,384 partial sums in G1 and G2,
   a G2 combine's 86 shares) on special pairs (T == Q, T == −Q, infinity
   on either side, a batch at infinity), against the plain tree, with
   one B19 launch a level and no other launch, each level and the whole
   fold timed beside its bounds, and its registers, stack frame and
   spills;
4. slice 1: ``ops.verify_batch`` on 8192 lanes (16,384 pairs) of keys,
   messages and signatures made on the host from a seed; the result must
   equal the mask known from construction lane for lane, and a 256-lane
   slice must agree through the plain versions on the card;
5. slice 2: ``ops.verify_batch_pallas`` (the megakernel path) on the same
   lanes: equal to the mask and to slice 1 lane for lane, with its launches
   per call (63 / 5 / 290 / 25 / 8 / 1 of B4-B9 and one B2), its time and
   kernel share, and both paths timed in turns in this one run (slice 1,
   slice 2, slice 2, slice 1); then B17 composed: one whole Miller loop
   over slice 2's pairs through the unfused pieces (63 dbl_step and
   f_sqr_fold, 5 add_step and f_fold launches), its f and T equal to the
   B4/B5 loop's bit for bit, both loops timed in turns;
6. slice 3: the RLC path, the system's main path, ``ops.rlc_exponents`` then
   ``ops.verify_sig_shares_rlc_pallas``, at N = 262,144 shares of 16 keys on
   one message (the inputs of ``bench.py``'s ``_make_rlc_batch``, four lanes
   with pk and sig at infinity): the exponents equal the host stream, the
   transcript of the card tensors equals that of their numpy copies, the
   folded MSM sums equal the host oracle's, the batch is accepted and is
   rejected with one signature or one public key replaced; its launches per
   call, the median of 3 calls (exponents included), the kernel share and
   the split of one call into its stages, from CUDA events; and one call
   of its ladder form (``msm="ladder"``, B13) beside it;
7. slice 4: ``ops.verify_with_hash_batch`` at 8192 distinct messages (the
   inputs of ``benches/hash_bench.py``: 16 keys tiled, signatures made on
   the card with the ladder from ``hashing.hash_g2_batch``'s points), 1/8
   of the lanes given another lane's signature and four lanes with pk
   and/or sig at infinity: equal to the mask; 128 sampled hash points,
   every lane that is not ``ok`` and 32 sampled signatures equal to the
   host oracle, the lanes that are not ``ok`` at most 2 %; its launches
   per call, the median of 3 calls, the kernel share and a stage split,
   with the host splice's ms (through the native ``hashing.hash_g2``) for
   its lanes not ``ok``;
8. slice 5: ``ops.encrypt_batch_pallas`` at 4096 lanes (the inputs of
   ``benches/encrypt_bench.py``): every lane passes the ciphertext check
   e(u, H) == e(G1, w), lanes 0, 1 and n − 1 equal the host oracle; its
   launches and the median of 3 calls; then ``msm_pallas(window=1)`` (B15)
   at N = 65,536 with 64-bit scalars in G1 and G2, equal to
   ``msm_pallas_shared`` and the host oracle;
9. slice 6: the two threshold flows at t + 1 = 4096 shares of a
   degree-4095 polynomial made from a seed: ``derive_shares``,
   ``sign_batch``, the RLC check of the signature shares, then
   ``ops.combine_batch`` on its three paths ("pallas": B11; "scalarwise":
   B15; "bitscan": B16; λ on B14), each equal to the host's H·f(0), with its
   launches against ``combine_launches``, the median of 3 calls, the
   kernel share and a stage split; the combined signature accepted by
   ``verify_batch_pallas``; ok False with one x duplicated and with one x
   zero; ``encrypt_begin_batch`` / ``encrypt_finish_batch``,
   ``ciphertext_verify_batch`` (true, and false on a lane with w replaced),
   ``decrypt_share_batch``, ``verify_dec_share_batch`` (true, and false on
   a replaced share) and the G1 combine on each path equal to r·pk;
10. slice 7: the DKG at N = 256 nodes, t = 85 (N = 3t + 1), one dealer's
   bivariate polynomial from a seed with one zero coefficient:
   ``bivar_commit_batch`` (3,741 lanes), ``bivar_row_batch`` and
   ``bivar_commit_row_batch`` for x = 1..256, ``bivar_commit_eval_batch``
   for the pairs (m, 1), then the nodes' checks: the commitment equals the
   host's at 64 sampled coefficients and the zero one (infinity), four
   rows equal host Horner, every row commitment equals its row's
   commitment (two nodes' the host's), every value commitment equals
   f(m, 1)·G1 and a tampered value is rejected on its lane only; launches
   per stage against ``dkg_launches``, the median of 3 dealing calls, the
   kernel share and a stage split; then ``ops.verify_sig_shares_rlc`` (B15
   and the fold) on slice 3's batch, accepting it and rejecting it with one
   signature replaced, and B15's share of one call from CUDA events;
11. slice 8: the public API (``import threshold_crypto_tpu_torch as tc``)
   at N = 256, t = 85: ``SecretKeySet.random`` from a seeded ChaChaRng,
   256 ``SecretKeyShare.sign``, ``verify_signature_shares`` valid and with
   one share replaced, two disjoint 86-share ``combine_signatures`` (equal,
   the master key's signature), encryption, 86 ``decrypt_share`` each
   passing ``verify_decryption_share``, ``decrypt``, a tampered ciphertext
   refused, serde and codec round trips of every type, on the host; then
   the same values through the card's batch ops: the RLC verdicts of
   ``rlc_exponents`` + ``verify_sig_shares_rlc_pallas`` equal the host's,
   ``combine_batch`` on its three paths equals ``combine_signatures``'
   bytes, ``decrypt_share_batch`` the host's decryption shares,
   ``ciphertext_verify_batch`` accepts the ciphertext and rejects the
   tampered one, and ``verify_with_hash_batch`` accepts 256 messages
   signed by the master key; each op's kernels must launch, and the wall
   is split host / card;
12. slice 9: the device-layer leftovers and the parallel layer.
   ``DeviceCurve.msm`` at window 1 over slice 6's 4096 G2 shares and λ
   equals ``combine_batch(path="bitscan")`` and the host's H·f(0);
   ``multi_pairing`` over 512 lanes x 2 of slice 1's pairs is 1 exactly
   where ``pairing_check_pallas`` and the mask say so, and equals the
   host's Fq12 on 4 lanes; each counted on its own. Then the parallel
   layer in worlds of one process over nccl and of two processes sharing
   the card over gloo, each rank a child process
   (``parallel.multihost.run_world``, ``parallel_rank``): the exponents of
   the whole batch, then ``sharded_verify_rlc`` at N = 262,144 (slice 3's
   inputs) with msm "shared" and "scalarwise", accepting the valid batch
   and rejecting one signature replaced, its aggregates equal to the
   single-device ``rlc_aggregate_pallas``; ``sharded_combine`` at t + 1 =
   4096 (slice 6's inputs) equal to ``combine_batch`` and the host's
   H·f(0), ok False with an x duplicated; ``sharded_sign`` /
   ``sharded_verify`` on slice 1's 8192 lanes equal to ``sign_batch`` and
   the mask; each rank's launches, counted over one run of those paths;
   the sharded call's median of 3 (in the world of one in turns with the
   single-device ``verify_sig_shares_rlc_pallas``);
13. one JSON line of kernel numbers (B1-B17), then the device line, last.

Any mismatch or exception ends the run with a non-zero exit and no result
line. Without a CUDA card, or without the package beside this file, it exits
non-zero at once.
"""

from __future__ import annotations

import concurrent.futures
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
# 32-bit IMAD results of one 12-word CIOS Montgomery product (csrc/fq.cuh):
# 2·12² 32×32→64 multiply-adds (two results each) and 12 low multiplies.
FQ_PRODUCT_IMADS = 4 * 12 * 12 + 12
# The megakernel path's launches per call (X_BITS[1:]: 63 bits, five 1s).
PALLAS_LAUNCHES = {"dbl_fold": 63, "add_fold": 5, "cyclo_sqr": 290,
                   "cyclo_sqr_mul": 25, "fq12_mul": 6, "fq12_sqr": 1,
                   "frob_mul": 2, "easy_down": 1, "easy_up": 1,
                   "mont_pow": 1, "mont_mul": 0}
# The RLC path of bench.py (_bench_rlc_pallas): N shares on one message,
# 16 keys tiled, the aggregate check on 512 replicated lanes; four lanes
# with pk and sig at infinity.
RLC_N = 262144
RLC_KEYS = 16
RLC_CHECK_BATCH = 512
RLC_DEAD = (3, 1000, 77777, RLC_N - 1)
RLC_WINDOW, RLC_NBITS = 3, 64
# 32-bit integer results per Keccak-f round as sm_90a can issue them: 3-input
# LOP3 xors for theta's columns (20) and its application (50), 2 funnel
# shifts per 64-bit rotation (5 for theta, 24 for rho: 58), one LOP3 per
# 32-bit half of chi (50), iota (1).
KECCAK_ROUND_OPS = 179
# Fq products that the point formulas of csrc/curve.cuh need per call, G1 /
# G2 (an Fq2 product is 3 Fq products, an Fq2 square 2). The kernels also
# compute the doubling branch on every lane and select it for T == Q, as
# the TPU kernels do; a branch would give the same bits, so the bounds
# count the general path alone. jac_madd: 8 products and 3 squares;
# jac_add: 12 and 4; jac_dbl: 2 and 5.
MADD_FQ_PRODUCTS = (11, 30)
ADD_FQ_PRODUCTS = (16, 44)
DBL_FQ_PRODUCTS = (7, 16)
# B11's accumulators at which the whole RLC call is timed (in turns), to
# weigh cuda_curve.ACCUMULATORS end to end: fewer accumulators mean fewer
# fold levels but fewer blocks for B11.
RLC_A_SWEEP = (8192, 16384, 32768)
# B11's accumulators on its special lanes (``winacc_special_points``).
WINACC_SPECIAL_A = 5
RLC_A_ROUNDS = 5
RLC_KERNELS = ("g1_madd", "g2_madd", "g1_winacc", "g2_winacc", "sha3_chunks",
               "g1_fold_level", "g2_fold_level")
# Slice 4, benches/hash_bench.py: distinct messages, 16 keys tiled; lanes
# ≡ 3 (mod 8) carry the next lane's signature, and four lanes an infinite
# pk, sig or both. The hash points of HASH_SAMPLE lanes and SIG_SAMPLE
# signatures are checked on the host; more than HASH_NOT_OK of the lanes
# left to the host oracle fails the run.
HASH_N = 8192
HASH_KEYS = 16
HASH_INF = ((5, "pk"), (13, "sig"), (21, "both"), (29, "pk"))
HASH_SAMPLE, SIG_SAMPLE = 128, 32
HASH_NOT_OK = 0.02
HASH_ATTEMPTS = 8
# Slice 5, benches/encrypt_bench.py: one key, 16 H(u, v) points tiled.
ENC_N = 4096
# The window-1 MSM (B15): N points of 16 keys tiled, 64-bit scalars.
MSM1_N = 65536
# B13/B15 against their plain versions over many digits: lanes, and the
# lanes the path gives them (the ladders' own shapes).
LADDER_CHECK_LANES = 1024
LADDER_KERNELS = {"g1_step4": "encrypt", "g2_step4": "hash",
                  "g1_step": "msm1", "g2_step": "msm1"}
# B15's widths on its paths (lanes, bits): the window-1 MSM, the scalarwise
# RLC check (verify_sig_shares_rlc) and the scalarwise combine of slice 6.
# At the combine's 4096 lanes 32 blocks run, one an SM: a lane's products
# in series set the pace there.
STEP_WIDTHS = {"msm_pallas(window=1)": (65536, 64),
               "verify_sig_shares_rlc": (262144, 64),
               "combine_batch scalarwise": (4096, 255)}
# One thread's Fq product in series: B16 dblw over one block of 128 lanes,
# LATENCY_WINDOW doublings each.
LATENCY_WINDOW = 64
# Slice 6, the threshold flows at t + 1 = 4096 shares, the north-star size of
# benches/combine_large.py: a degree-4095 secret polynomial from the seed,
# x_i = i + 1, one message hashed on the host.
COMBINE_N = 4096
COMBINE_SEED = 0xC0B1
COMBINE_MSG = b"chip_smoke combine"
# 32-bit IMAD results of one 8-word CIOS Montgomery product (Fr, csrc/fr.cuh).
FR_PRODUCT_IMADS = 4 * 8 * 8 + 8
# B16's table lanes in its check: not a multiple of the 1024-lane block, so
# the last block is ragged.
B16_TABLE_N = COMBINE_N - 100
# The combine call whose launches each of B14 and B16 reports.
COMBINE_KERNELS = {"lagrange_rowprod": "G2 pallas",
                   "g1_selmadd": "G1 bitscan", "g2_selmadd": "G2 bitscan",
                   "g1_dblw": "G1 bitscan", "g2_dblw": "G2 bitscan"}
# Slice 7, the DKG at the committee size of a large threshold-BLS validator
# set: N = 3t + 1 nodes, one dealer's symmetric bivariate polynomial of
# degree t from a seed (one coefficient zero: it commits to infinity);
# node 1 checks the values all N nodes sent it. The commitment is checked
# on the host at DKG_SAMPLE coefficients, the rows of DKG_ROWS_SAMPLE, the
# row commitments of DKG_HOST_NODES; lane DKG_TAMPERED's value is tampered
# with once.
DKG_N = 256
DKG_T = 85
DKG_SEED = 0xD6C
DKG_ZERO_POS = 17
DKG_SAMPLE = 64
DKG_ROWS_SAMPLE = (0, 1, 128, 255)
DKG_HOST_NODES = (0, 255)
DKG_TAMPERED = 100
# Slice 8: the public API (``import threshold_crypto_tpu_torch as tc``) at
# the DKG's committee, N = 256, t = 85; the keys from a seeded ChaChaRng,
# one share of the RLC check replaced by another node's.
API_N, API_T = DKG_N, DKG_T
API_SEED = bytes(range(0x80, 0xA0))
API_MSG = b"chip_smoke slice 8"
API_REPLACED = 3
API_PLAINTEXT = b"chip_smoke slice 8: threshold-encrypted"
# Per device op of slice 8, the kernels that must have launched in it
# (86 shares stay under ops.fr's matrix bound, so B14 must not launch).
TOWER_KERNELS = ("dbl_fold", "add_fold", "cyclo_sqr", "cyclo_sqr_mul",
                 "fq12_mul", "fq12_sqr", "frob_mul", "easy_down", "easy_up")
API_KERNELS = {
    "rlc": ("sha3_chunks", "g1_madd", "g2_madd", "g1_winacc", "g2_winacc",
            "g1_fold_level", "g2_fold_level", "mont_mul",
            "mont_pow") + TOWER_KERNELS,
    "combine pallas": ("g2_madd", "g2_winacc", "g2_fold_level", "mont_mul",
                       "mont_pow"),
    "combine scalarwise": ("g2_step", "g2_fold_level", "mont_mul",
                           "mont_pow"),
    "combine bitscan": ("g2_selmadd", "g2_dblw", "g2_fold_level",
                        "mont_mul", "mont_pow"),
    "decrypt shares": ("g1_madd", "g1_step4"),
    "ciphertext check": ("mont_pow",) + TOWER_KERNELS,
    "verify_with_hash_batch": ("g2_madd", "g2_step4", "mont_pow")
                              + TOWER_KERNELS,
}

# Slice 9: the parallel layer and the device-layer leftovers. The sharded
# RLC check at RLC_N over a world of one process (nccl) and of two sharing
# the card (gloo: nccl refuses two ranks on one card), both MSM forms; the
# sharded combine at slice 6's t + 1 = COMBINE_N; sharded sign / verify on
# slice 1's LANES; DeviceCurve.msm on slice 6's shares; multi_pairing on
# PAIR_N lanes of slice 1's pairs (PAIR_HOST_LANES of them against the
# host's Fq12).
PAR_WORLDS = ((1, "nccl"), (2, "gloo"))
PAR_SEED = b"chip_smoke slice 9"
PAR_TIMED = 3
PAR_REPLACED = 7
PAR_TIMEOUT_S = 600
PAIR_N = 512
PAIR_HOST_LANES = 4
# The kernels every rank's run must launch: B1, B2 (affine, λ, the
# checks), B12 (exponents), B10 + B11 (msm="shared"), B15
# (msm="scalarwise", the combine's partials), B19 (the folds), B14 (λ at
# 4096), B13 (sign); and those of DeviceCurve.msm at window 1 (B2, B1,
# B16, B19) and of multi_pairing (B1, B2).
PARALLEL_KERNELS = ("mont_mul", "mont_pow", "sha3_chunks", "g1_madd",
                    "g2_madd", "g1_winacc", "g2_winacc", "g1_step", "g2_step",
                    "g1_fold_level", "g2_fold_level", "lagrange_rowprod",
                    "g2_step4")
LEFTOVER_KERNELS = {"DeviceCurve.msm": ("mont_mul", "mont_pow", "g2_selmadd",
                                        "g2_dblw", "g2_fold_level"),
                    "multi_pairing": ("mont_mul", "mont_pow")}


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


def bound_ms(bytes_moved, imads, card):
    """The larger of bytes over the memory rate and 32-bit integer results
    (multiply-adds, or for B12 logic and shift operations, issued at the
    same 64 per clock per SM) over the issue rate, in ms, and which of the
    two it is."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = imads / (IMAD_PER_CLK_PER_SM * card["sms"] * card["clock_hz"])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def registry():
    """(module, kernel) for every kernel of the port, module by module:
    B1-B2, B3-B9, B10, B11, B13, B15, B16, B12, B14."""
    from threshold_crypto_tpu_torch.utils import trace

    return trace.kernels()


@contextlib.contextmanager
def kernels_replaced(make):
    """Put make(kernel) in place of every kernel's wrapper (the attribute of
    its module through which every caller reaches it), then restore them."""
    for mod, k in registry():
        setattr(mod, k.launch.__name__, make(k))
    try:
        yield
    finally:
        for mod, k in registry():
            setattr(mod, k.launch.__name__, k.launch)


def plain_versions():
    """Route every kernel call to its plain PyTorch version."""
    return kernels_replaced(lambda k: k.plain)


def kernel_event_timer(spans):
    """Bracket every kernel launch with CUDA events (timing runs only)."""
    import torch

    def timed(k):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = k.launch(*args)
            stop.record()
            spans.append((k.name, start, stop))
            return out
        return run

    return kernels_replaced(timed)


def reset_counts():
    for _, k in registry():
        k.count.reset()


def read_counts():
    return {k.name: k.count.launches for _, k in registry()}


# ---------------------------------------------------------------------------
# Phase 2: the build
# ---------------------------------------------------------------------------

def _demangle(sym):
    """The innermost name of an Itanium-mangled symbol, with a template
    argument if it has one (an int, or a field type of namespace tc):
    '_ZN2tc6fq_mulE...' -> 'fq_mul', '...madd_kernelIN2tc3Fq2EE...' ->
    'madd_kernel<Fq2>'."""
    names, i = [], sym.find("N") + 1 if sym.startswith("_ZN") else 2
    while i < len(sym) and sym[i].isdigit():
        m = re.match(r"\d+", sym[i:])
        n = int(m.group())
        i += len(m.group())
        names.append(sym[i:i + n])
        i += n
    name = names[-1] if names else sym
    field = re.match(r"IN2tc3reg\d+(\w+?)E(?:Li(\d+)E)?E", sym[i:])
    if field:   # a field descriptor of the register engine (B1, B2)
        return f"{name}<{', '.join(g for g in field.groups() if g)}>"
    targ = (re.match(r"ILi(\d+)E", sym[i:])
            or re.match(r"IN2tc\d+(\w+?)EE", sym[i:]))
    return f"{name}<{targ.group(1)}>" if targ else name


def print_ptxas(name, log):
    """nvcc's seconds, then per kernel its registers, stack frame and
    spills, and the device functions' largest stack frame. Returns {kernel
    (demangled): (registers, stack frame, spill stores, spill loads)}."""
    secs = re.search(rf"nvcc {name}\.cu: ([\d.]+) s", log)
    print(f"  {name}.cu: nvcc {secs.group(1) if secs else '?'} s", flush=True)
    frames, regs, entries, current = {}, {}, [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entries.append(m.group(1))
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current:
            frames[current] = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entries:
            regs[entries[-1]] = int(m.group(1))
    report = {}
    for sym in entries:
        frame = frames.get(sym, (0, 0, 0))
        report[_demangle(sym)] = (regs.get(sym), *frame)
        print(f"    {_demangle(sym)}: {regs.get(sym, '?')} registers, "
              f"{frame[0]} bytes stack frame, {frame[1]} bytes spill stores, "
              f"{frame[2]} bytes spill loads", flush=True)
    funcs = {s: f for s, f in frames.items() if s not in entries}
    if funcs:
        big = max(funcs, key=lambda s: funcs[s][0])
        spills = sum(f[1] + f[2] for f in funcs.values())
        print(f"    {len(funcs)} device functions: largest stack frame "
              f"{funcs[big][0]} bytes ({_demangle(big)}), spill bytes "
              f"{spills}", flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

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


def check_mul(spec, n, rng, dev, card):
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
    S = spec.L // 2
    bound, by = bound_ms(n * 3 * spec.L * 4, n * (4 * S * S + S), card)
    print(f"mont_mul {spec.name} lanes={n}: bit-exact; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}), "
          f"{100 * bound / ms:.1f} % of it", flush=True)
    return dict(lanes=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


def chain_products(e):
    """(squares, products) of B2's chain for e (``cuda_mont.pow_chain``'s
    windows), its table of odd powers included: one square and entries − 1
    products build it."""
    from threshold_crypto_tpu_torch.device import cuda_mont

    steps = cuda_mont.pow_windows(e)
    entries = max((v - 1) // 2 for _, v in steps if v is not None) + 1
    squares = sum(sq for sq, _ in steps) + (entries > 1)
    products = sum(v is not None for _, v in steps[1:]) + entries - 1
    return squares, products


def pow_bound(spec, n, e, card):
    """B2's bound for a^e over n lanes, and which of the two it is: each
    base read and each power written once, e's bytes, and the IMAD results
    of the chain ``pow_chain`` builds: a square 3S² + 2S (S(S + 1)/2 word
    products, then S reduction rounds of 2S + 1), a product 4S² + S."""
    S = spec.L // 2
    squares, products = chain_products(e)
    imads = squares * (3 * S * S + 2 * S) + products * (4 * S * S + S)
    return bound_ms(n * 2 * spec.L * 4 + (e.bit_length() + 7) // 8,
                    n * imads, card)


def check_pow(spec, n, e, what, rng, dev, card):
    """B2 at n lanes against pow_fixed_ref (the first lanes the edge values
    and, at 8 lanes or more, four zeros), timed beside its bound (the
    chain's squares and products, ``pow_bound``) and, as history, the
    square-and-multiply count's (a product a bit and a set bit, as the
    kernel before the chain ran)."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_mont

    n_zero = 4 if n >= 8 else 0
    a = random_fq_lanes(spec, n, rng)
    if n >= 8:
        a = with_edges(spec, a, edge_values(spec))
        a[-n_zero:] = 0
    a = a.to(dev)
    got = cuda_mont.mont_pow(spec, a, e)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = cuda_mont.pow_fixed_ref(spec, a, e)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    err = int((got - want).abs().max().item())
    if err != 0 or not torch.equal(got, want):
        fail(f"mont_pow {spec.name}: kernel disagrees with pow_fixed_ref at "
             f"{n} lanes, e = {what} (max abs limb error {err})")
    if e == spec.p - 2 and n_zero and bool((got[-n_zero:] != 0).any()):
        fail("mont_pow: inv(0) is not 0")
    ms = cuda_time_ms(lambda: cuda_mont.mont_pow(spec, a, e), 5)
    bound, by = pow_bound(spec, n, e, card)
    squares, muls = chain_products(e)
    S = spec.L // 2
    bits = e.bit_length() + bin(e).count("1")
    bits_bound = bound_ms(n * 2 * spec.L * 4 + 4 * e.bit_length(),
                          n * bits * (4 * S * S + S), card)[0]
    print(f"mont_pow {spec.name} e={what} lanes={n}: bit-exact"
          f"{', zeros -> 0' if e == spec.p - 2 and n_zero else ''}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}; "
          f"the chain's {squares} squares + {muls} products), "
          f"{ms / bound:.2f}× it; square and multiply ({bits} products) "
          f"{bits_bound:.4f} ms", flush=True)
    return dict(lanes=n, e=what, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, chain_squares=squares,
                chain_products=muls, square_and_multiply_bound_ms=bits_bound)


def check_mont(ptxas, rng, dev, card):
    """B1 and B2 at the paths' widths, both fields: B1 at slice 1's widest
    launch (13 Fq2 products over 2 pairs of 8192 lanes); B2 for p − 2 at
    the RLC path's 1 and RLC_CHECK_BATCH lanes and slice 1's LANES (and 4×),
    for (p − 1)/2 at the hash path's Euler width (HASH_N · HASH_ATTEMPTS),
    and in Fr for r − 2 at 1 and COMBINE_N. Then the kernels' ptxas figures,
    one call of each wrapper under torch's sync debug mode "error" (a
    wrapper that synchronises the stream fails the run), and B1 on a view
    4 bytes off a 16-byte line: the wrapper must raise, ``mont.mul`` must
    give the product. Returns the results of B1 and B2 (their first width
    the kernels line's)."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_mont, mont

    FQ, FR = mont.FQ, mont.FR
    widest_mul = 78 * LANES  # 13 Fq2 (39 Fq) products over 2 pairs
    mul = check_mul(FQ, widest_mul, rng, dev, card)
    mul["widths"] = [dict(mul, field="Fq"),
                     dict(check_mul(FR, widest_mul, rng, dev, card),
                          field="Fr")]
    pows = [(FQ, LANES, FQ.p - 2, "p-2"), (FQ, 1, FQ.p - 2, "p-2"),
            (FQ, RLC_CHECK_BATCH, FQ.p - 2, "p-2"),
            (FQ, 4 * LANES, FQ.p - 2, "p-2"),
            (FQ, HASH_N * HASH_ATTEMPTS, (FQ.p - 1) // 2, "(p-1)/2"),
            (FR, 1, FR.p - 2, "r-2"), (FR, COMBINE_N, FR.p - 2, "r-2")]
    widths = [dict(check_pow(spec, n, e, what, rng, dev, card),
                   field=spec.name) for spec, n, e, what in pows]
    pw = dict(widths[0], widths=widths)
    for res, kernels in ((mul, ("mont_mul_kernel<",)),
                         (pw, ("mont_pow_kernel<", "mont_pow_group_kernel<"))):
        res["ptxas"] = {}
        for name, figures in ptxas.items():
            if name.startswith(kernels):
                res["ptxas"][name] = dict(zip(
                    ("registers", "stack_frame", "spill_stores",
                     "spill_loads"), figures))
                print(f"{name} (mont.cu, the register product): "
                      f"{figures[0]} registers, {figures[1]} bytes stack "
                      f"frame, {figures[2]} bytes spill stores, {figures[3]} "
                      f"bytes spill loads", flush=True)
        if not res["ptxas"]:
            fail(f"no ptxas figures for {kernels}")
    for spec in (FQ, FR):
        a = random_fq_lanes(spec, RLC_CHECK_BATCH, rng).to(dev)
        off = torch.empty(a.numel() + 1, dtype=torch.int32, device=dev)
        off = off[1:].view(a.shape)          # 4 bytes off a 16-byte line
        off.copy_(a)
        try:
            cuda_mont.mont_mul(spec, off, a)
            fail("mont_mul took a tensor that is not 16-byte aligned")
        except ValueError:
            pass
        if not torch.equal(mont.mul(spec, off, a),
                           cuda_mont.mul_ref(spec, a, a)):
            fail("mont.mul of a view off a 16-byte line differs")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cuda_mont.mont_pow(spec, a, spec.p - 2)
            cuda_mont.mont_mul(spec, a, a)
        except RuntimeError as exc:
            fail(f"a B1 / B2 wrapper synchronised the stream: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    print("mont_pow and mont_mul wrappers: no stream synchronisation (torch "
          "sync debug mode 'error'), Fq and Fr; mont_mul refuses a tensor "
          "off a 16-byte line, and mont.mul copies it first (bit-exact)",
          flush=True)
    return mul, pw


def random_packed(k, n, gen, dev):
    """Packed int32[k·24, n] of canonical Fq limbs, made on the card: each
    top limb below p's, so every value is < p."""
    import torch
    from threshold_crypto_tpu_torch.device.mont import FQ

    x = torch.randint(0, 1 << 16, (k, FQ.L, n), generator=gen, device=dev,
                      dtype=torch.int32)
    x[:, -1] = torch.randint(0, FQ.p_limbs[-1], (k, n), generator=gen,
                             device=dev, dtype=torch.int32)
    return x.reshape(k * FQ.L, n)


# Per tower kernel: its operands (packed components each), the components
# of its outputs, and its Fq products per lane (B4: 36 for f², 47 for the
# doubling and its line, 39 for the fold; B5: 41 for the addition and its
# line, 39 for the fold; B6: 9 Fq2 squares of 2; B7: 18 + 54; B8: 18 Fq2
# products of 3; B9: 12 of 3; B17: B4 and B5 cut at the line, dbl_step
# 47, f_sqr_fold 36 + 39, add_step 41, f_fold 39). fq_engine: 12
# components, one product each. The Miller kernels run at slice 2's pair
# width.
TOWER_CHECKS = {
    "fq_engine": ((12, 12), 5 * 12, 12, 16384),
    "dbl_fold": ((12, 6, 2), 12 + 6, 122, 2 * LANES),
    "add_fold": ((12, 6, 4, 2), 12 + 6, 80, 2 * LANES),
    "cyclo_sqr": ((12,), 12, 18, LANES),
    "cyclo_sqr_mul": ((12, 12), 12, 72, LANES),
    "fq12_mul": ((12, 12), 12, 54, LANES),
    "fq12_sqr": ((12,), 12, 36, LANES),
    "dbl_step": ((6, 2), 6 + 6, 47, 2 * LANES),
    "add_step": ((6, 4, 2), 6 + 6, 41, 2 * LANES),
    "f_sqr_fold": ((12, 6), 12, 75, 2 * LANES),
    "f_fold": ((12, 6), 12, 39, 2 * LANES),
}
# B17, the unfused Miller pieces: on no path of the JAX package or the
# port; the composition check drives one whole Miller loop through them.
B17_KERNELS = ("dbl_step", "add_step", "f_sqr_fold", "f_fold")


# The check's kernels are also held at the RLC check's widths: its 2-pair
# check replicated to RLC_CHECK_BATCH lanes runs B4 and B5 on
# 2 × RLC_CHECK_BATCH pair lanes and B6-B9 on RLC_CHECK_BATCH; B17, B4
# and B5 cut at the line, at B4's and B5's. B4-B9 and B17 run on the
# lane-group engine (csrc/tower_group.cuh), B3's test entry on the register
# engine (csrc/ladder_engine.cuh): their kernels' ptxas figures
# (csrc/miller.cu, csrc/fq12.cu), where a stack frame or a spill fails the
# run.
CHECK_WIDTHS = {"dbl_fold": 2 * RLC_CHECK_BATCH,
                "add_fold": 2 * RLC_CHECK_BATCH,
                "cyclo_sqr": RLC_CHECK_BATCH,
                "cyclo_sqr_mul": RLC_CHECK_BATCH,
                "fq12_mul": RLC_CHECK_BATCH,
                "fq12_sqr": RLC_CHECK_BATCH,
                "dbl_step": 2 * RLC_CHECK_BATCH,
                "add_step": 2 * RLC_CHECK_BATCH,
                "f_sqr_fold": 2 * RLC_CHECK_BATCH,
                "f_fold": 2 * RLC_CHECK_BATCH}
GROUP_KERNELS = {"dbl_fold": ("miller.cu", "dbl_fold_kernel"),
                 "add_fold": ("miller.cu", "add_fold_kernel"),
                 "cyclo_sqr": ("fq12.cu", "cyclo_sqr_group_kernel"),
                 "cyclo_sqr_mul": ("fq12.cu", "cyclo_sqr_mul_group_kernel"),
                 "fq12_mul": ("fq12.cu", "fq12_mul_group_kernel"),
                 "fq12_sqr": ("fq12.cu", "fq12_sqr_group_kernel"),
                 "dbl_step": ("miller.cu", "dbl_step_kernel"),
                 "add_step": ("miller.cu", "add_step_kernel"),
                 "f_sqr_fold": ("miller.cu", "f_sqr_fold_kernel"),
                 "f_fold": ("miller.cu", "f_fold_kernel")}
# B3's test entry on the register engine.
ENGINE_KERNEL = ("fq12.cu", "engine_kernel")


def tower_inputs(name, gen, dev, n=None):
    """The kernel's operands at the path's width (or n lanes), with special
    lanes: 0-3 all zero (f = 0, T = 0, P = (0, 0) the infinity point, line
    0), and for the kernels that take T and P, 4-7 an infinity P only and
    8-11 a zero T only."""
    comps, _, _, width = TOWER_CHECKS[name]
    n = n or width
    ins = [random_packed(k, n, gen, dev) for k in comps]
    for x in ins:
        x[:, 0:4] = 0
    if name in ("dbl_fold", "add_fold", "dbl_step", "add_step"):
        ins[-1][:, 4:8] = 0
        ins[0 if name.endswith("step") else 1][:, 8:12] = 0
    return ins


def check_tower(name, gen, dev, card, n=None):
    """The kernel bit-exact against its plain version at the path's width
    (or n lanes), its time and its bound."""
    import torch

    kernel = {k.name: k for _, k in registry()}[name]
    comps, out_comps, products, width = TOWER_CHECKS[name]
    n = n or width
    ins = tower_inputs(name, gen, dev, n)
    extra = (8,) if name == "fq_engine" else ()
    got = kernel.launch(*ins, *extra)
    torch.cuda.synchronize()
    with plain_versions():
        want = kernel.plain(*ins, *extra)
        plain_ms = cuda_time_ms(lambda: kernel.plain(*ins, *extra), 1)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g - w).abs().max().item()) for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{name}: kernel disagrees with its plain version at {n} lanes "
             f"(max abs limb error {err})")
    ms = cuda_time_ms(lambda: kernel.launch(*ins, *extra), 10)
    bytes_moved = (sum(comps) + out_comps) * 24 * 4 * n
    bound, by = bound_ms(bytes_moved, n * products * FQ_PRODUCT_IMADS, card)
    shapes = " ".join(str(list(x.shape)) for x in ins)
    print(f"{name} {shapes}: bit-exact (zero and infinity lanes included); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
          f"({by}), {ms / bound:.1f}x the bound", flush=True)
    return dict(lanes=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


# B18, the final exponentiation's tower steps on the lane-group engine, at
# the pairing check's widths: the RLC check's one lane, the ciphertext
# check's 256, slice 2's 8192 and the strict benchmark's 65,536. Their Fq
# products per lane (tools/tower_group_schedule.py): frob_mul 10 + 54,
# easy_down 36 + 15 + 9 + 2, easy_up 2 + 9 + 36 + 10 + 54; their packed
# components in and out, easy_down's n and easy_up's n⁻¹ one component in
# limb rows. The plain versions run in PLAIN_CHUNK-lane pieces (lanes are
# independent; the whole 65,536 at once would take tens of GB in the plain
# product's int64 columns).
B18_WIDTHS = (1, 256, LANES, 65536)
B18_CHECKS = {"frob_mul": (24, 12, 64), "easy_down": (12, 21, 62),
              "easy_up": (21, 12, 111)}
B18_KERNELS = {"frob_mul": "frob_mul_group_kernel",
               "easy_down": "easy_down_group_kernel",
               "easy_up": "easy_up_group_kernel"}
PLAIN_CHUNK = 8192


def b18_inputs(n, gen, dev):
    """Packed Fq12 a, b over n lanes, made on the card: lanes 0-1 zero,
    2-3 one, 4 every component p − 1 (where n allows), the rest random."""
    import torch
    from threshold_crypto_tpu_torch.device import packed as pk
    from threshold_crypto_tpu_torch.device.mont import FQ

    p_minus_1 = torch.tensor([FQ.p_limbs[0] - 1, *FQ.p_limbs[1:]] * 12,
                             dtype=torch.int32, device=dev)
    out = []
    for _ in range(2):
        x = random_packed(12, n, gen, dev)
        if n >= 8:
            x[:, 0:4] = pk.packed_one12(4, dev)
            x[:, 0:2] = 0
            x[:, 4] = p_minus_1
        out.append(x)
    return out


def plain_in_chunks(fn, args, axes, out_axes):
    """fn's plain version over PLAIN_CHUNK lanes at a time, the pieces
    joined: ``axes`` gives each argument's lane axis (packed: 1, limb rows:
    0, None: not a tensor), ``out_axes`` each output's."""
    import torch

    n = args[0].shape[axes[0]]
    pieces = []
    with plain_versions():
        for lo in range(0, n, PLAIN_CHUNK):
            part = fn(*(a if ax is None else
                        a.narrow(ax, lo, min(PLAIN_CHUNK, n - lo)).contiguous()
                        for a, ax in zip(args, axes)))
            pieces.append(part if isinstance(part, tuple) else (part,))
    return tuple(torch.cat(list(p), dim=ax)
                 for p, ax in zip(zip(*pieces), out_axes))


def check_b18(gen, dev, card, ptxas):
    """B18 at B18_WIDTHS: ``frob_mul`` (k = 1, 2), ``easy_down`` and
    ``easy_up`` bit-exact against their plain versions, and the composed
    easy part (``cuda_tower.p_easy_part``: easy_down, B2, easy_up) against
    the tower's (``easy_part_ref``, its products on the plain versions);
    each kernel's time, the composed easy part's and the bounds; ptxas's
    figures, where a stack frame or a spill fails the run. Returns
    {kernel: result}, each at 65,536 lanes with the other widths under
    "widths", and the easy part's own under "easy_part"."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_tower as ctw
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.device.mont import FQ

    results = {name: {"widths": []} for name in B18_CHECKS}
    easy = []
    for n in B18_WIDTHS:
        a, b = b18_inputs(n, gen, dev)
        norm, inter = ctw.easy_down(a)
        ninv = mont.inv(FQ, norm)
        runs = {"frob_mul": [((a, b, k), (1, 1, None), (1,)) for k in (1, 2)],
                "easy_down": [((a,), (1,), (0, 1))],
                "easy_up": [((inter, ninv), (1, 0), (1,))]}
        for name, cases in runs.items():
            kernel = getattr(ctw, name)
            plain = getattr(ctw, name + "_ref")
            comps, out_comps, products = B18_CHECKS[name]
            for args, axes, out_axes in cases:
                got = kernel(*args)
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                t0 = time.time()
                want = plain_in_chunks(plain, args, axes, out_axes)
                plain_s = time.time() - t0
                err = max(int((g - w).abs().max().item())
                          for g, w in zip(got, want))
                if err or not all(torch.equal(g, w)
                                  for g, w in zip(got, want)):
                    fail(f"{name}{args[2:]}: kernel disagrees with its plain "
                         f"version at {n} lanes (max abs limb error {err})")
                ms = cuda_time_ms(lambda: kernel(*args), 10)
                bound, by = bound_ms((comps + out_comps) * 24 * 4 * n,
                                     n * products * FQ_PRODUCT_IMADS, card)
                k = f" k = {args[2]}" if name == "frob_mul" else ""
                print(f"{name}{k} at {n} lanes: bit-exact (zero, one and "
                      f"p - 1 lanes included); kernel {ms:.4f} ms, plain "
                      f"{1e3 * plain_s:.1f} ms, bound {bound:.4f} ms ({by}), "
                      f"{ms / bound:.1f}x the bound", flush=True)
                results[name]["widths"].append(dict(
                    lanes=n, k=args[2] if k else None, max_abs_err=err,
                    ms=ms, plain_ms=1e3 * plain_s, bound_ms=bound,
                    bound_by=by))
        got = ctw.p_easy_part(a)
        want = plain_in_chunks(ctw.easy_part_ref, (a,), (1,), (1,))[0]
        if not torch.equal(got, want):
            fail(f"the easy part (easy_down, B2, easy_up) disagrees with the "
                 f"tower's at {n} lanes")
        ms = cuda_time_ms(lambda: ctw.p_easy_part(a), 10)
        tower_ms = cuda_time_ms(lambda: ctw.easy_part_ref(a), 2)
        bound = (sum(w["bound_ms"] for name in ("easy_down", "easy_up")
                     for w in results[name]["widths"][-1:])
                 + pow_bound(FQ, n, FQ.p - 2, card)[0])
        print(f"the easy part at {n} lanes: equals the tower's; easy_down, "
              f"B2, easy_up {ms:.4f} ms, the tower on B1/B2 {tower_ms:.3f} ms, "
              f"bound {bound:.4f} ms, {ms / bound:.1f}x the bound",
              flush=True)
        easy.append(dict(lanes=n, ms=ms, tower_ms=tower_ms, bound_ms=bound))
        del a, b, norm, inter, ninv
        torch.cuda.empty_cache()
    for name, fn in B18_KERNELS.items():
        res = results[name]
        top = res["widths"][-1]
        res.update({k: top[k] for k in ("lanes", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by")})
        figures = ptxas[fn]
        res["ptxas"] = dict(zip(
            ("registers", "stack_frame", "spill_stores", "spill_loads"),
            figures))
        print(f"{name} (fq12.cu {fn}, lane-group engine): {figures[0]} "
              f"registers, {figures[1]} bytes stack frame, {figures[2]} "
              f"bytes spill stores, {figures[3]} bytes spill loads",
              flush=True)
        if any(figures[1:]):
            fail(f"{fn}: a stack frame or spills on the lane-group engine")
    results["easy_up"]["easy_part"] = easy
    return results


# ---------------------------------------------------------------------------
# Phases 4 and 5: the slices
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


def _slice_aff(t, n):
    if isinstance(t, tuple):
        return tuple(_slice_aff(x, n) for x in t)
    return t[:n]


def timed_call(fn, args, want, what):
    """One synchronised call, checked lane for lane; returns (out, s)."""
    import torch

    t0 = time.time()
    out = fn(*args)
    torch.cuda.synchronize()
    secs = time.time() - t0
    if out.shape != want.shape or not torch.equal(out, want):
        bad = (out != want).nonzero().flatten()[:8].tolist()
        fail(f"{what} disagrees with the constructed mask at lanes {bad}")
    return out, secs


def run_path(fn, what, args, want_t, expect=None):
    """The path's counted run (counts set to 0 just before, read just
    after), then the median of 3 calls, the kernel share of one call
    (every launch bracketed by CUDA events) and the plain versions on the
    card at 256 lanes."""
    import torch

    reset_counts()
    out, first_s = timed_call(fn, args, want_t, what)
    launches = read_counts()
    from threshold_crypto_tpu_torch.device import cuda_mont
    widest = {"mont_mul": cuda_mont.MUL.widest,
              "mont_pow": cuda_mont.POW.widest}
    print(f"{what} first call {first_s:.2f} s; launches per call "
          f"{launches}; widest B1/B2 launch {widest}", flush=True)
    if expect is not None:
        got = {k: launches[k] for k in expect}
        if got != expect:
            fail(f"{what}: launches per call {got}, expected {expect}")
    elif min(launches["mont_mul"], launches["mont_pow"]) < 1:
        fail(f"a kernel of the path was not launched: {launches}")

    times = [timed_call(fn, args, want_t, what)[1] for _ in range(3)]
    wall = statistics.median(times)
    print(f"{what} lanes={LANES}: median {wall:.3f} s of "
          f"{[round(t, 3) for t in times]} -> {LANES / wall:.1f} "
          f"verifications/s", flush=True)

    spans = []
    with kernel_event_timer(spans):
        _, timed_wall = timed_call(fn, args, want_t, what)
    kernel_s = sum(a.elapsed_time(b) for _, a, b in spans) / 1e3
    print(f"{what} time split (one call, kernels bracketed by events): wall "
          f"{timed_wall:.3f} s, kernels {kernel_s:.3f} s "
          f"({100 * kernel_s / timed_wall:.1f} %), the rest (torch glue, "
          f"launch overhead) {timed_wall - kernel_s:.3f} s", flush=True)

    n_small = 256
    small = tuple(_slice_aff(a, n_small) for a in args)
    with plain_versions():
        _, plain_s = timed_call(fn, small, want_t[:n_small],
                                f"{what} through the plain versions")
    print(f"{what} through the plain versions on the card, {n_small} lanes: "
          f"agrees ({plain_s:.1f} s)", flush=True)
    torch.cuda.synchronize()
    return dict(out=out, launches=launches, widest=widest, wall_s=wall,
                per_s=LANES / wall, kernel_s=kernel_s,
                timed_wall_s=timed_wall)


def run_slices(dev):
    import torch
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import pairing as dpr

    t0 = time.time()
    pk, h, sig, want = build_inputs()
    args = (dpr.g1_affine_from_host(pk, device=dev),
            dpr.g2_affine_from_host(h, device=dev),
            dpr.g2_affine_from_host(sig, device=dev))
    want_t = torch.tensor(want, device=dev)
    print(f"inputs: {LANES} lanes, {sum(want)} expected True, built in "
          f"{time.time() - t0:.1f} s", flush=True)

    phase(f"slice 1: ops.verify_batch at {LANES} lanes")
    old = run_path(ops.verify_batch, "verify_batch", args, want_t)

    phase(f"slice 2: ops.verify_batch_pallas at {LANES} lanes "
          f"(the megakernel path)")
    new = run_path(ops.verify_batch_pallas, "verify_batch_pallas", args,
                   want_t, expect=PALLAS_LAUNCHES)
    if not torch.equal(new["out"], old["out"]):
        fail("verify_batch_pallas and verify_batch disagree")
    print(f"verify_batch_pallas equals verify_batch on all {LANES} lanes",
          flush=True)

    turns = []
    for fn, what in ((ops.verify_batch, "verify_batch"),
                     (ops.verify_batch_pallas, "verify_batch_pallas"),
                     (ops.verify_batch_pallas, "verify_batch_pallas"),
                     (ops.verify_batch, "verify_batch")):
        turns.append((what, timed_call(fn, args, want_t, what)[1]))
    old_s = [s for w, s in turns if w == "verify_batch"]
    new_s = [s for w, s in turns if w == "verify_batch_pallas"]
    print(f"in turns (verify_batch, pallas, pallas, verify_batch): "
          f"{[round(s, 3) for _, s in turns]} s; verify_batch mean "
          f"{statistics.mean(old_s):.3f} s, verify_batch_pallas mean "
          f"{statistics.mean(new_s):.3f} s, "
          f"{statistics.mean(old_s) / statistics.mean(new_s):.1f}x",
          flush=True)
    return old, new, args


# ---------------------------------------------------------------------------
# Phase 3, continued: the RLC path's kernels B10-B12
# ---------------------------------------------------------------------------

def timed_once(fn, *args):
    """(fn(*args), its device time in ms), one call bracketed by events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def compare(name, got, want, what):
    """Bit-exact or fail; returns the max abs error (0)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g.long() - w.long()).abs().max().item())
              for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{name}: kernel disagrees with its plain version {what} "
             f"(max abs limb error {err})")
    return err


def madd_inputs(g2, n, gen, dev):
    """acc [3k·24, n] Jacobian and q [2k·24, n] affine, random canonical
    values with special lanes: 0-3 T at infinity (Z = 0), 4-7 T == Q
    (Z = 1), 8-11 T == −Q, 12-15 everything zero."""
    import torch
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.device import packed as pk
    from threshold_crypto_tpu_torch.device.mont import FQ

    k = 2 if g2 else 1
    rows = k * FQ.L
    acc = random_packed(3 * k, n, gen, dev)
    q = random_packed(2 * k, n, gen, dev)
    acc[2 * rows:, 0:4] = 0
    acc[:2 * rows, 4:12] = q[:, 4:12]
    acc[2 * rows:, 4:12] = pk._one_rows(k, 8, dev)
    y = torch.stack(pk.unpack(q[rows:, 8:12].contiguous(), k))
    acc[rows:2 * rows, 8:12] = pk.pack(list(mont.neg(FQ, y)))
    acc[:, 12:16] = 0
    q[:, 12:16] = 0
    return acc, q


def check_madd(g2, gen, dev, card):
    """B10 at the path's width, N = 262,144 lanes, against its plain
    version (run over blocks of 16,384 lanes, which it treats alike); then
    timed on the table build's first launch (acc = Q with Z = 1: every lane
    takes the doubling branch), held against the plain version on its
    first 16,384 lanes."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import packed as pk

    name = "g2_madd" if g2 else "g1_madd"
    kernel = {k.name: k for _, k in registry()}[name]
    n, k = RLC_N, 2 if g2 else 1
    acc, q = madd_inputs(g2, n, gen, dev)
    got = kernel.launch(acc, q)
    torch.cuda.synchronize()
    step = 16384
    with plain_versions():
        parts, plain_ms = [], 0.0
        for s in range(0, n, step):
            out, ms = timed_once(kernel.plain, acc[:, s:s + step].contiguous(),
                                 q[:, s:s + step].contiguous())
            parts.append(out)
            plain_ms += ms
    err = compare(name, got, torch.cat(parts, 1), f"at {n} lanes")
    pts = ccv.unpack_jac(got[:, :12], g2)
    z = pts[2] if not g2 else torch.cat(pts[2], -1)
    if bool(z[8:12].any()) or not bool(z[4:8].any()):
        fail(f"{name}: T == -Q lanes are not at infinity, or T == Q lanes "
             f"are")
    ms = cuda_time_ms(lambda: kernel.launch(acc, q), 10)
    products = MADD_FQ_PRODUCTS[k - 1]
    bound, by = bound_ms(n * 8 * k * 96, n * products * FQ_PRODUCT_IMADS,
                         card)
    print(f"{name} acc {list(acc.shape)} q {list(q.shape)}: bit-exact (T at "
          f"infinity, T == Q, T == -Q and zero lanes included); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
          f"({by}), {ms / bound:.1f}x the bound", flush=True)
    first = torch.cat([q, pk._one_rows(k, n, dev)])
    got = kernel.launch(first, q)
    with plain_versions():
        want = kernel.plain(first[:, :step].contiguous(),
                            q[:, :step].contiguous())
    compare(name, got[:, :step].contiguous(), want,
            "on the table build's first launch")
    ms_dbl = cuda_time_ms(lambda: kernel.launch(first, q), 10)
    print(f"{name} on the table build's first launch (acc = Q, Z = 1, every "
          f"lane doubles): bit-exact on {min(step, n)} lanes; kernel "
          f"{ms_dbl:.4f} ms",
          flush=True)
    return dict(lanes=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, ms_all_doubling=ms_dbl)


def winacc_inputs(g2, n, gen, dev):
    """A table of 7 random entries [7·3k·24, n], with entry 2 at infinity
    on lanes 0-63, and 22 random digits 0-7 per lane, all 0 on lanes
    100-109 (as the driver sets dead lanes)."""
    import torch
    from threshold_crypto_tpu_torch.device.mont import FQ

    k = 2 if g2 else 1
    table = random_packed(7 * 3 * k, n, gen, dev)
    e2z = (2 * 3 * k + 2 * k) * FQ.L
    table[e2z:e2z + k * FQ.L, 0:64] = 0
    digits = torch.randint(0, 8, (22, n), generator=gen, device=dev,
                           dtype=torch.int32)
    digits[:, 100:110] = 0
    return table, digits


def winacc_special_points(host, rnd):
    """B11's special lanes: host table entries [7][17] (None: infinity) and
    digits [2][17] of the Horner loop at A = WINACC_SPECIAL_A = 5
    (accumulator j owns lanes j, j + 5, j + 10, j + 15; the last block
    ragged), with the host's partial sums:
    acc 0, window 0: lane 0 adds P, lane 5 adds P again (T == Q), lane 10
    adds more at once, so a doubling deferred past it would be wrong;
    acc 1: lane 1 adds P in window 0 (the other lanes digit 0), then, after
    three doublings, 8P in window 1 (T == Q) before lane 6 adds more;
    acc 2, window 0: P, then −P (T == −Q: infinity), then Q onto infinity;
    acc 3: every digit 0 (dead lanes); acc 4: an entry at infinity onto
    infinity (the first add), then Q, then an entry at infinity onto Q;
    lanes 10 and 11 of window 1 carry digits 9 and −1, outside 1..7, which
    read entry 0."""
    from threshold_crypto_tpu_torch.host.params import R

    n, ndig, A = 17, 2, WINACC_SPECIAL_A
    entries = [[host.mul(host.generator, rnd.randrange(1, R))
                for _ in range(n)] for _ in range(7)]
    digits = [[rnd.randrange(1, 8) for _ in range(n)] for _ in range(ndig)]

    def put(w, lane, pt, d=None):
        d = d or digits[w][lane]
        digits[w][lane] = d
        entries[d - 1][lane] = pt

    p0 = entries[digits[0][0] - 1][0]
    put(0, 5, p0)
    for lane in (6, 11, 16):
        digits[0][lane] = 0
    p1 = entries[digits[0][1] - 1][1]
    put(1, 1, host.mul(p1, 8), d=digits[0][1] % 7 + 1)
    p2 = entries[digits[0][2] - 1][2]
    put(0, 7, host.neg(p2))
    for w in range(ndig):
        for lane in (3, 8, 13):
            digits[w][lane] = 0
    put(0, 4, None)
    put(0, 14, None)
    digits[1][10], digits[1][11] = 9, -1

    sums = [None] * A
    for w in range(ndig):
        sums = [None if s is None else host.mul(s, 8) for s in sums]
        for lane in range(n):
            d = digits[w][lane]
            if d != 0:
                q = entries[d - 1 if 1 <= d <= 7 else 0][lane]
                sums[lane % A] = host.add(sums[lane % A], q)
    return entries, digits, sums


def winacc_bound(g2, table, digits, accs, window, card):
    """bound_ms of one B11 launch: per nonzero digit the general path of
    the complete add, per accumulator and window `window` doublings; bytes:
    the table and the digits read once, the accumulators written once."""
    k = 2 if g2 else 1
    nonzero = int((digits != 0).sum().item())
    products = (nonzero * ADD_FQ_PRODUCTS[k - 1]
                + accs * digits.shape[0] * window * DBL_FQ_PRODUCTS[k - 1])
    bytes_moved = (table.numel() + digits.numel() + 3 * k * 24 * accs) * 4
    return bound_ms(bytes_moved, products * FQ_PRODUCT_IMADS, card)


def check_winacc(g2, gen, dev, card):
    """B11 over all 22 windows at the chosen A: bit-exact against its plain
    version (a sequential loop over blocks of A lanes) at N = 2A, so every
    accumulator owns two lanes, and on the special lanes of
    ``winacc_special_points``, whose partial sums must equal the host's;
    timed at the path's N = 262,144, and at two other A beside the chosen
    one."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host import curve as hcv

    name = "g2_winacc" if g2 else "g1_winacc"
    kernel = {k.name: k for _, k in registry()}[name]
    A = ccv.ACCUMULATORS
    table, digits = winacc_inputs(g2, 2 * A, gen, dev)
    got = kernel.launch(table, digits, A, RLC_WINDOW)
    torch.cuda.synchronize()
    with plain_versions():
        want, plain_ms = timed_once(kernel.plain, table, digits, A,
                                    RLC_WINDOW)
    err = compare(name, got, want, f"at N = {2 * A}, A = {A}")
    del table, digits, want
    curve, host = (dcv.G2, hcv.G2) if g2 else (dcv.G1, hcv.G1)
    entries, digs, sums = winacc_special_points(host,
                                                random.Random(0xB11 + g2))
    table = torch.cat([_host_packed(curve, e, dev) for e in entries])
    digits = torch.tensor(digs, dtype=torch.int32, device=dev)
    got = kernel.launch(table, digits, WINACC_SPECIAL_A, RLC_WINDOW)
    torch.cuda.synchronize()
    with plain_versions():
        want = kernel.plain(table, digits, WINACC_SPECIAL_A, RLC_WINDOW)
    err = max(err, compare(name, got, want, "on the special lanes"))
    if curve.to_host_affine(ccv.unpack_jac(got, g2)) != sums:
        fail(f"{name}: the partial sums of the special lanes are not the "
             f"host's")
    del table, digits, want
    table, digits = winacc_inputs(g2, RLC_N, gen, dev)
    ms = cuda_time_ms(lambda: kernel.launch(table, digits, A, RLC_WINDOW), 2)
    others = {a: cuda_time_ms(lambda: kernel.launch(table, digits, a,
                                                    RLC_WINDOW), 1)
              for a in (A // 2, 2 * A)}
    nonzero = int((digits != 0).sum().item())
    bound, by = winacc_bound(g2, table, digits, A, RLC_WINDOW, card)
    print(f"{name} table {list(table.shape)} digits {list(digits.shape)} "
          f"A={A}: bit-exact at N={2 * A} (plain {plain_ms:.1f} ms) and on "
          f"the special lanes (T == Q then another add in its window, "
          f"T == -Q, infinity, digits 0 and outside 1..7); kernel "
          f"{ms:.3f} ms at N={RLC_N} ({nonzero} nonzero digits), bound "
          f"{bound:.3f} ms ({by}), {ms / bound:.1f}x the bound; at "
          f"A={A // 2}: {others[A // 2]:.3f} ms, A={2 * A}: "
          f"{others[2 * A]:.3f} ms", flush=True)
    return dict(lanes=RLC_N, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                plain_lanes=2 * A, bound_ms=bound, bound_by=by,
                accumulators=A, ms_other_accumulators=others)


def rlc_chunks(n):
    """B12's chunks per RLC call: the full 2176-byte chunks of the six
    [n, 24] limb leaves (pk x, y; sig x0, x1, y0, y1)."""
    return 6 * (n * 24 * 4 // 2176)


def check_sha3(gen, dev, card):
    """B12 at the path's K chunks against its plain version, and a sample
    of chunks against hashlib."""
    import hashlib

    import torch
    from threshold_crypto_tpu_torch.device import keccak as dk

    K = rlc_chunks(RLC_N)
    words = torch.randint(-2 ** 31, 2 ** 31, (K, 544), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    words[0] = 0
    words[1] = -1
    got = dk.sha3_chunks(words)
    torch.cuda.synchronize()
    with plain_versions():
        want, plain_ms = timed_once(dk.sha3_256_chunks, words)
    err = compare("sha3_chunks", got, want, f"at K = {K}")
    sample = list(range(0, K, K // 61))[:64]
    w_np, g_np = words[sample].cpu().numpy(), got[sample].cpu().numpy()
    for i in range(len(sample)):
        if g_np[i].tobytes() != hashlib.sha3_256(w_np[i].tobytes()).digest():
            fail(f"sha3_chunks: chunk {sample[i]} differs from hashlib")
    ms = cuda_time_ms(lambda: dk.sha3_chunks(words), 10)
    bound, by = bound_ms(K * (2176 + 32), K * 17 * 24 * KECCAK_ROUND_OPS,
                         card)
    print(f"sha3_chunks words {list(words.shape)}: bit-exact, {len(sample)} "
          f"chunks equal to hashlib; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {bound:.4f} ms ({by}), "
          f"{ms / bound:.1f}x the bound", flush=True)
    return dict(lanes=K, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


# ---------------------------------------------------------------------------
# Phase 3, continued: the ladder kernels B13 and B15
# ---------------------------------------------------------------------------

def _host_packed(curve, pts, dev, affine=False):
    """Host points (None = infinity) as packed Jacobian (Z = 1, or Z = 0 at
    infinity) or affine columns on the card."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    jac = curve.from_host_affine(pts, device=dev)
    return ccv.pack_point(jac[:2] if affine else jac)


def ladder_special(g2, kind, n, gen, dev):
    """Inputs of B13 (kind "step4": acc, table [15·3k·24, n], digits [1, n])
    or B15 ("step": acc, q [2k·24, n], bits [1, n]): random canonical
    values, and host points on lanes 0-15: 0-3 an infinite accumulator,
    4-7 digit (bit) 0, 8-11 table[d − 1] == 16T (Q == 2T), 12-15
    table[d − 1] == −16T (Q == −2T)."""
    import torch
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.params import R

    k = 2 if g2 else 1
    rows = 3 * k * 24
    curve, host = (dcv.G2, hcv.G2) if g2 else (dcv.G1, hcv.G1)
    rnd = random.Random(0x1AD + g2)
    ts = [None] * 4 + [host.mul(host.generator, rnd.randrange(1, R))
                       for _ in range(12)]
    acc = random_packed(3 * k, n, gen, dev)
    acc[:, :16] = _host_packed(curve, ts, dev)
    top = 16 if kind == "step4" else 2
    digits = torch.randint(0, top, (1, n), generator=gen, device=dev,
                           dtype=torch.int32)
    digits[0, :16] = torch.tensor(
        [rnd.randrange(1, top) if not 4 <= i < 8 else 0 for i in range(16)],
        dtype=torch.int32, device=dev)
    if kind == "step4":
        other = random_packed(15 * 3 * k, n, gen, dev)
        for i in range(8, 16):
            q = host.mul(ts[i], 16)
            d = int(digits[0, i])
            other[(d - 1) * rows:d * rows, i] = _host_packed(
                curve, [q if i < 12 else host.neg(q)], dev)[:, 0]
    else:
        other = random_packed(2 * k, n, gen, dev)
        for i in range(8, 16):
            q = host.double(ts[i])
            other[:, i] = _host_packed(curve, [q if i < 12 else host.neg(q)],
                                       dev, affine=True)[:, 0]
    return acc, other, digits


def step_special_points(host, rnd):
    """B15's special lanes over three bits (MSB first), as host points:
    (T, Q, bits [3][16], the host's result) for 16 lanes. 0-1 Q = 4T,
    bits 011 (2T == Q at the second bit, then a set bit: 20T); 2-3 Q = 4T,
    bits 010 (then a clear bit: 16T); 4-5 Q = 8T, bits 001 (2T == Q at the
    last bit: 16T); 6-7 Q = −4T, bits 011 (2T == −Q at the second bit,
    then Q from infinity); 8-9 T at infinity, bits 011 (Q, then 3Q);
    10-11 bits 000 (8T); 12-13 Q = −2T, bits 100 (infinity, kept); 14-15
    a random Q, bits 111 (8T + 7Q)."""
    from threshold_crypto_tpu_torch.host.params import R

    ts = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(16)]
    ts[8] = ts[9] = None
    qs = [host.mul(host.generator, rnd.randrange(1, R)) for _ in range(16)]
    bits, want = [], []
    for i in range(16):
        t, case = ts[i], i // 2
        if case in (0, 1):
            qs[i] = host.mul(t, 4)
        elif case == 2:
            qs[i] = host.mul(t, 8)
        elif case == 3:
            qs[i] = host.neg(host.mul(t, 4))
        elif case == 6:
            qs[i] = host.neg(host.double(t))
        bits.append(["011", "010", "001", "011", "011", "000", "100",
                     "111"][case])
        q = qs[i]
        want.append([host.mul(t, 20), host.mul(t, 16), host.mul(t, 16), q,
                     host.mul(q, 3), host.mul(t, 8), None,
                     host.add(host.mul(t, 8), host.mul(q, 7))][case])
    return ts, qs, [[int(b[k]) for b in bits] for k in range(3)], want


def step_special(g2, n, gen, dev):
    """B15's operands at n lanes over three bits: ``step_special_points``
    on lanes 0-15 (Z = 1, Q affine), random canonical values and bits
    elsewhere; and the host's results of lanes 0-15."""
    import torch
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host import curve as hcv

    k = 2 if g2 else 1
    curve, host = (dcv.G2, hcv.G2) if g2 else (dcv.G1, hcv.G1)
    ts, qs, bits16, want = step_special_points(host,
                                               random.Random(0xB15 + g2))
    acc = random_packed(3 * k, n, gen, dev)
    acc[:, :16] = _host_packed(curve, ts, dev)
    q = random_packed(2 * k, n, gen, dev)
    q[:, :16] = _host_packed(curve, qs, dev, affine=True)
    bits = torch.randint(0, 2, (3, n), generator=gen, device=dev,
                         dtype=torch.int32)
    bits[:, :16] = torch.tensor(bits16, dtype=torch.int32, device=dev)
    return acc, q, bits, want


def ladder_path_inputs(g2, kind, n, gen, dev, nbits=64):
    """The operands a path gives the kernel: the infinite accumulator the
    drivers start from, a random table (or affine Q), and the digits or
    bits: G2 step4 the hash ladder's 127 digits of H2 (every lane the
    same), G1 step4 the encrypt ladder's 64 random base-16 digits, step
    ``nbits`` random bits (the window-1 MSM's and the RLC check's 64, the
    combine's 255); lanes 0-3 dead (digit 0)."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.host.params import H2

    k = 2 if g2 else 1
    acc = ccv.packed_infinity(g2, n, dev)
    if kind == "step4":
        other = random_packed(15 * 3 * k, n, gen, dev)
        if g2:
            digs = torch.tensor(ccv.fixed_digits(H2), dtype=torch.int32,
                                device=dev)
            digits = digs[:, None].repeat(1, n)
        else:
            digits = torch.randint(0, 16, (64, n), generator=gen, device=dev,
                                   dtype=torch.int32)
    else:
        other = random_packed(2 * k, n, gen, dev)
        digits = torch.randint(0, 2, (nbits, n), generator=gen, device=dev,
                               dtype=torch.int32)
    digits[:, :4] = 0
    return acc, other, digits.contiguous()


def ladder_bound(g2, kind, digits, card):
    """bound_ms of one ladder launch on these digits: per lane and digit
    4 doublings (B13) or one (B15), and per nonzero digit the general path
    of the complete add (B13) or mixed add (B15); bytes: the accumulator in
    and out, the digits, and each (lane, table entry) pair the digits use
    (B13) or the affine Q (B15)."""
    D, n = digits.shape
    k = 2 if g2 else 1
    nonzero = int((digits != 0).sum().item())
    dbl = DBL_FQ_PRODUCTS[k - 1]
    if kind == "step4":
        products = D * n * 4 * dbl + nonzero * ADD_FQ_PRODUCTS[k - 1]
        pairs = sum(int((digits == e).any(0).sum().item())
                    for e in range(1, 16))
        bytes_moved = (2 * 3 * k * 96 * n + 4 * D * n + 3 * k * 96 * pairs)
    else:
        products = D * n * dbl + nonzero * MADD_FQ_PRODUCTS[k - 1]
        bytes_moved = (2 * 3 * k * 96 + 2 * k * 96) * n + 4 * D * n
    return bound_ms(bytes_moved, products * FQ_PRODUCT_IMADS, card)


def check_ladder(g2, kind, gen, dev, card):
    """B13 ("step4") or B15 ("step") against its plain version: one step
    at LANES lanes with the special lanes, then the path's digits over
    LADDER_CHECK_LANES lanes (the plain version is a loop of stacked ops);
    timed at the path's width and digits."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv

    from threshold_crypto_tpu_torch.device import packed as pk

    name = f"g{1 + g2}_{kind}"
    kernel = {k.name: k for _, k in registry()}[name]
    k = 2 if g2 else 1
    rows = 3 * k * 24
    acc, other, digits = ladder_special(g2, kind, LANES, gen, dev)
    got = kernel.launch(acc, other, digits)
    torch.cuda.synchronize()
    with plain_versions():
        want = kernel.plain(acc, other, digits)
    err = compare(name, got, want, f"at {LANES} lanes, one step")
    curve = dcv.G2 if g2 else dcv.G1
    pts = curve.to_host_affine(ccv.unpack_jac(got[:, :16], g2))
    if any(p is not None for p in pts[12:16]):
        fail(f"{name}: 16T == -Q (2T == -Q) lanes are not at infinity")
    for i in range(4):
        d = int(digits[0, i])
        first = other[(d - 1) * rows:d * rows, i] if kind == "step4" else \
            torch.cat([other[:, i], pk._one_rows(k, 1, dev)[:, 0]])
        if not torch.equal(got[:, i], first):
            fail(f"{name}: the step from infinity is not table[d-1] (Q)")

    m = LADDER_CHECK_LANES
    acc, other, digits = ladder_path_inputs(g2, kind, m, gen, dev)
    got = kernel.launch(acc, other, digits)
    torch.cuda.synchronize()
    with plain_versions():
        want, plain_ms = timed_once(kernel.plain, acc, other, digits)
    err = max(err, compare(name, got, want,
                           f"over {digits.shape[0]} digits at {m} lanes"))
    del acc, other, digits, got, want
    if kind == "step":
        return check_step_widths(g2, kernel, gen, dev, card, err, plain_ms,
                                 m)
    n = {"hash": HASH_N, "encrypt": ENC_N}[LADDER_KERNELS[name]]
    acc, other, digits = ladder_path_inputs(g2, kind, n, gen, dev)
    ms = cuda_time_ms(lambda: kernel.launch(acc, other, digits), 3)
    bound, by = ladder_bound(g2, kind, digits, card)
    print(f"{name} acc {list(acc.shape)} {list(other.shape)} digits "
          f"{list(digits.shape)}: bit-exact (one step with infinity, digit "
          f"0, 16T == +-Q / 2T == +-Q lanes at {LANES} lanes; "
          f"{digits.shape[0]} steps at {m} lanes, plain {plain_ms:.1f} ms); "
          f"kernel {ms:.4f} ms at {n} lanes, bound {bound:.4f} ms ({by}), "
          f"{ms / bound:.1f}x the bound", flush=True)
    return dict(lanes=n, digits=digits.shape[0], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, plain_lanes=m, bound_ms=bound,
                bound_by=by)


def thread_product_latency_ms(g2, gen, dev):
    """One thread's Fq product in series on the register engine: B16 dblw
    over one block of 128 lanes, LATENCY_WINDOW doublings a lane (7 Fq
    products each in G1, 16 in G2), timed with CUDA events, over its
    products."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    k = 2 if g2 else 1
    acc = random_packed(3 * k, 128, gen, dev)
    dblw = ccv.g2_dblw if g2 else ccv.g1_dblw
    ms = cuda_time_ms(lambda: dblw(acc, LATENCY_WINDOW), 5)
    return ms / (LATENCY_WINDOW * DBL_FQ_PRODUCTS[k - 1])


def check_step_widths(g2, kernel, gen, dev, card, err, plain_ms, m):
    """B15 at each of STEP_WIDTHS: the three-bit special lanes of
    ``step_special`` (lanes 0-15 equal to the host's points) and the
    path's random bits, each bit-exact with the plain version on the first
    m lanes, and the kernel timed on the path's bits beside its bound and
    a latency yardstick (each lane's mean products times
    ``thread_product_latency_ms``), which sets the pace where one block
    runs on an SM."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv

    name = kernel.name
    k = 2 if g2 else 1
    curve = dcv.G2 if g2 else dcv.G1
    latency = thread_product_latency_ms(g2, gen, dev)
    print(f"{name}: one thread's Fq product in series (B16 dblw, one "
          f"block, {LATENCY_WINDOW} doublings): {1e3 * latency:.3f} us",
          flush=True)
    widths = []
    for where, (n, nbits) in STEP_WIDTHS.items():
        acc, q, bits, host_want = step_special(g2, n, gen, dev)
        got = kernel.launch(acc, q, bits)
        torch.cuda.synchronize()
        with plain_versions():
            want = kernel.plain(acc[:, :m].contiguous(),
                                q[:, :m].contiguous(),
                                bits[:, :m].contiguous())
        err = max(err, compare(name, got[:, :m], want,
                               f"special lanes over 3 bits at {n} lanes, "
                               f"first {m}"))
        if curve.to_host_affine(ccv.unpack_jac(got[:, :16], g2)) != \
                host_want:
            fail(f"{name}: a special lane differs from the host's point")
        del acc, q, bits, got, want
        acc, q, bits = ladder_path_inputs(g2, "step", n, gen, dev, nbits)
        got = kernel.launch(acc, q, bits)
        torch.cuda.synchronize()
        with plain_versions():
            want, at_plain_ms = timed_once(
                kernel.plain, acc[:, :m].contiguous(), q[:, :m].contiguous(),
                bits[:, :m].contiguous())
        err = max(err, compare(name, got[:, :m], want,
                               f"over {nbits} bits at {n} lanes, first {m}"))
        ms = cuda_time_ms(lambda: kernel.launch(acc, q, bits), 3)
        bound, by = ladder_bound(g2, "step", bits, card)
        set_bits = int((bits != 0).sum().item())
        products = (nbits * n * DBL_FQ_PRODUCTS[k - 1]
                    + set_bits * MADD_FQ_PRODUCTS[k - 1])
        yardstick = products / n * latency
        widths.append(dict(where=where, lanes=n, bits=nbits, ms=ms,
                           bound_ms=bound, bound_by=by, plain_ms=at_plain_ms,
                           plain_lanes=m, latency_ms=yardstick))
        print(f"{name} at {where}'s width, {n} lanes x {nbits} bits: "
              f"bit-exact on the special lanes (host points) and the path's "
              f"bits (first {m} lanes, plain {at_plain_ms:.1f} ms); kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), {ms / bound:.2f}x "
              f"the bound; latency yardstick {yardstick:.4f} ms "
              f"({ms / yardstick:.2f}x)", flush=True)
        del acc, q, bits, got, want
        torch.cuda.empty_cache()
    first = widths[0]
    return dict(lanes=first["lanes"], digits=first["bits"], max_abs_err=err,
                ms=first["ms"], plain_ms=plain_ms, plain_lanes=m,
                bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                widths=widths, product_latency_ms=latency)


def check_ladder_dkg(gen, dev, card):
    """B13 G1 at the DKG's launch shape (``scalar_mul_gathered``): one
    ``LADDER_CHUNK``-lane launch from infinity, 64 random base-16 digits
    (lanes 0-3 dead), over the table of the dealing's (t+1)(t+2)/2
    commitment points, random canonical entries, gathered to the lanes at
    random; bit-exact with the plain version on its first
    LADDER_CHECK_LANES lanes, and timed with CUDA events beside
    ``ladder_bound`` on its digits."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    kernel = {k.name: k for _, k in registry()}["g1_step4"]
    n, npts = ccv.LADDER_CHUNK, (DKG_T + 1) * (DKG_T + 2) // 2
    points = random_packed(ccv.STEP4_ENTRIES * 3, npts, gen, dev)
    index = torch.randint(0, npts, (n,), generator=gen, device=dev)
    table = points[:, index].contiguous()
    del points
    digits = torch.randint(0, 16, (64, n), generator=gen, device=dev,
                           dtype=torch.int32)
    digits[:, :4] = 0
    digits = digits.contiguous()
    acc = ccv.packed_infinity(False, n, dev)
    got = kernel.launch(acc, table, digits)
    torch.cuda.synchronize()
    m = LADDER_CHECK_LANES
    with plain_versions():
        want = kernel.plain(acc[:, :m].contiguous(),
                            table[:, :m].contiguous(),
                            digits[:, :m].contiguous())
    err = compare("g1_step4", got[:, :m], want,
                  f"at the DKG shape, first {m} lanes")
    ms = cuda_time_ms(lambda: kernel.launch(acc, table, digits), 3)
    bound, by = ladder_bound(False, "step4", digits, card)
    print(f"g1_step4 at the DKG shape: {n} lanes x 64 digits over {npts} "
          f"gathered points: bit-exact on {m} lanes; kernel {ms:.3f} ms, "
          f"bound {bound:.3f} ms ({by}), {ms / bound:.2f}x the bound",
          flush=True)
    return dict(lanes=n, digits=64, points=npts, max_abs_err=err, ms=ms,
                bound_ms=bound, bound_by=by)


# ---------------------------------------------------------------------------
# Phase 6: slice 3, the RLC path
# ---------------------------------------------------------------------------

def rlc_launches(n):
    """Launches of one RLC call: 2 B12 (level 1 and 2 of the transcript),
    6 + 6 B10, 1 + 1 B11, B19 for the folds (one launch a level, ⌈log₂ A⌉
    levels per group), the megakernel check's B4-B9, 4 B2 (the inverses of
    jacobian_to_affine on both sums and on H, and the easy part) and 16 B1
    (the affine conversions 4 + 6 + 6); the check's easy part and
    Frobenius products are B18's."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    levels = (min(ccv.ACCUMULATORS, n) - 1).bit_length()
    expect = dict(PALLAS_LAUNCHES)
    expect.update({"sha3_chunks": 2, "g1_madd": 6, "g2_madd": 6,
                   "g1_winacc": 1, "g2_winacc": 1, "mont_pow": 4,
                   "g1_fold_level": levels, "g2_fold_level": levels,
                   "mont_mul": 16})
    return expect


def rlc_inputs(dev):
    """bench.py's _make_rlc_batch: 16 keys and one H from its seed, made on
    the host and tiled to RLC_N lanes on the card; lanes RLC_DEAD get pk and
    sig at infinity (coordinates 0, as the host builders give them)."""
    import torch
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import pairing as dpr
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.params import R

    rnd = random.Random(0xA66)
    sks = [rnd.randrange(1, R) for _ in range(RLC_KEYS)]
    h = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    pk = [hcv.G1.mul(hcv.G1.generator, s) for s in sks]
    sig = [hcv.G2.mul(h, s) for s in sks]
    reps = RLC_N // RLC_KEYS

    def tile(tree):
        return dcv.tree_map(
            lambda a: a.repeat((reps,) + (1,) * (a.dim() - 1)), tree)

    pk_aff = tile(dpr.g1_affine_from_host(pk, device=dev))
    sig_aff = tile(dpr.g2_affine_from_host(sig, device=dev))
    dead = torch.tensor(RLC_DEAD, device=dev)
    for aff in (pk_aff, sig_aff):
        aff[2][dead] = True
        for c in dcv.leaves(aff[:2]):
            c[dead] = 0
    h_jac = dcv.G2.from_host_affine([h], device=dev)
    return pk_aff, sig_aff, h_jac, pk, sig


def rlc_call(pk_aff, sig_aff, h_jac, seed, msm="shared"):
    """One RLC verification as bench.py times it: exponents, then the
    check. Returns (ok, r, seconds), synchronised."""
    import torch
    from threshold_crypto_tpu_torch import ops

    torch.cuda.synchronize()
    t0 = time.time()
    r = ops.rlc_exponents(RLC_N, seed, pk_aff=pk_aff, sig_aff=sig_aff)
    ok = bool(ops.verify_sig_shares_rlc_pallas(
        pk_aff, h_jac, sig_aff, r, check_batch=RLC_CHECK_BATCH, msm=msm))
    torch.cuda.synchronize()
    return ok, r, time.time() - t0


def host_affine(aff, g2):
    """A [1]-batched affine tuple on the card -> the host point (or None)."""
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.device import tower as tw
    from threshold_crypto_tpu_torch.device.mont import FQ

    x, y, inf = aff
    if bool(inf[0]):
        return None
    if g2:
        return (tw.fq2_to_host(x)[0], tw.fq2_to_host(y)[0])
    return (mont.unstack_mont(FQ, x)[0], mont.unstack_mont(FQ, y)[0])


@contextlib.contextmanager
def stage_timer(spans):
    """The program's own spans over the block (``utils/trace.py``: the
    stages of the entry points, the pairing, ladder and MSM drivers, the
    folds, the Fr layer, the transcript and the hash chain): after it,
    ``spans`` holds their records, device times from CUDA events."""
    from threshold_crypto_tpu_torch.utils import trace

    trace.clear()
    try:
        with trace.enabled():
            yield
        spans.extend(trace.records())
    finally:
        trace.clear()


def print_split(what, spans, wall_s):
    """Sum the spans' device ms by their path of names from the outermost
    span, print the paths as a tree (children in the order they first
    ran) beside the call's wall, the outermost spans' sum set against it.
    Returns {"a / b / c": ms}."""
    paths, split = {}, {}
    for r in spans:
        paths[r["id"]] = paths.get(r["parent"], ()) + (r["name"],)
        split[paths[r["id"]]] = split.get(paths[r["id"]], 0.0) + \
            r["device_ms"]
    order = {p: k for k, p in enumerate(split)}
    top = sum(v for p, v in split.items() if len(p) == 1)
    print(f"{what} stages of one call (the program's spans, CUDA events; "
          f"wall {wall_s * 1e3:.1f} ms, outside the stages "
          f"{wall_s * 1e3 - top:.1f} ms):", flush=True)
    tree = sorted(split, key=lambda p: [order[p[:k + 1]]
                                        for k in range(len(p))])
    for p in tree:
        print(f"  {'  ' * (len(p) - 1)}{p[-1]}: {split[p]:.1f} ms",
              flush=True)
    return {" / ".join(p): split[p] for p in tree}


def kernel_split(what, spans, wall_s):
    """Sum the kernel spans by kernel and print the kernel share, then each
    kernel's device time in the call, its launches and the time a launch,
    the most first."""
    per_kernel, launches = {}, {}
    for name, start, stop in spans:
        per_kernel[name] = per_kernel.get(name, 0.0) + start.elapsed_time(stop)
        launches[name] = launches.get(name, 0) + 1
    kernel_s = sum(per_kernel.values()) / 1e3
    print(f"{what} time split (one call, kernels bracketed by events): wall "
          f"{wall_s:.3f} s, kernels {kernel_s:.3f} s "
          f"({100 * kernel_s / wall_s:.1f} %), the rest "
          f"{wall_s - kernel_s:.3f} s; per kernel (ms in the call, launches, "
          f"ms a launch): " + ", ".join(
              f"{k} {v:.3f} / {launches[k]} / {v / launches[k]:.4f}"
              for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])),
          flush=True)
    return kernel_s, per_kernel


def run_rlc(dev, results):
    """Slice 3: drive the RLC path at RLC_N and check it."""
    import numpy as np
    import torch
    from threshold_crypto_tpu_torch import convert, ops
    from threshold_crypto_tpu_torch.device import keccak
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.params import R
    from threshold_crypto_tpu_torch.ops import threshold as tops

    t0 = time.time()
    pk_aff, sig_aff, h_jac, pk, sig = rlc_inputs(dev)
    print(f"inputs: {RLC_N} shares of {RLC_KEYS} keys on one message, lanes "
          f"{list(RLC_DEAD)} with pk and sig at infinity, built in "
          f"{time.time() - t0:.1f} s", flush=True)

    from threshold_crypto_tpu_torch.device import cuda_mont

    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    reset_counts()
    ok, r, first_s = rlc_call(pk_aff, sig_aff, h_jac, b"\x01" * 32)
    launches = read_counts()
    widest_fold = ccv.G2_FOLD_LEVEL.widest
    print(f"rlc first call {first_s:.2f} s; launches per call {launches}; "
          f"widest B19 launch {widest_fold} lanes (the G2 fold's first "
          f"level); widest B1 launch {cuda_mont.MUL.widest} lanes",
          flush=True)
    expect = rlc_launches(RLC_N)
    got = {k: launches[k] for k in expect}
    if got != expect:
        fail(f"rlc: launches per call {got}, expected {expect}")
    if min(launches[k] for k in expect) < 1:
        fail(f"a kernel of the RLC path was not launched: {launches}")
    if not ok:
        fail("rlc: the valid batch was rejected")

    # 1. the exponents equal the host stream
    host_r = ops.rlc_exponents(RLC_N, b"\x01" * 32, pk_aff=pk_aff,
                               sig_aff=sig_aff, on_device=False)
    if not torch.equal(r, host_r):
        fail("rlc: device exponents differ from the host stream")
    # 2. the transcript of the card tensors equals that of numpy copies
    leaves = dcv.leaves((pk_aff, sig_aff))
    if keccak.transcript_digests(leaves) != keccak.transcript_digests(
            [convert.to_jax(x) for x in leaves]):
        fail("rlc: transcript digests differ between card and host leaves")
    # 3. the folded sums equal the host oracle's
    k = r[:, :4].long().cpu().numpy().astype(np.uint64)
    ks = k[:, 0] | (k[:, 1] << 16) | (k[:, 2] << 32) | (k[:, 3] << 48)
    live = ~pk_aff[2].cpu().numpy()
    sums = [sum(int(v) for v in ks[j::RLC_KEYS][live[j::RLC_KEYS]]) % R
            for j in range(RLC_KEYS)]
    want_pk = want_sig = None
    for j in range(RLC_KEYS):
        want_pk = hcv.G1.add(want_pk, hcv.G1.mul(pk[j], sums[j]))
        want_sig = hcv.G2.add(want_sig, hcv.G2.mul(sig[j], sums[j]))
    pk_a, sg_a = tops.rlc_aggregate_pallas(pk_aff, sig_aff, r)
    if (host_affine(pk_a, False), host_affine(sg_a, True)) != (want_pk,
                                                               want_sig):
        fail("rlc: the MSM sums differ from the host oracle")
    print("exponents equal the host stream on all lanes; transcript digests "
          "of card and numpy leaves equal; G1 and G2 sums equal the host "
          "oracle's", flush=True)
    # 4. tampered batches are rejected
    for what, lane in (("sig", 7), ("pk", 10)):
        bad = dcv.tree_map(lambda a: a.clone(),
                           sig_aff if what == "sig" else pk_aff)
        for c in dcv.leaves(bad[:2]):
            c[lane] = c[lane + 1]      # the next key's point
        pk_t, sig_t = (pk_aff, bad) if what == "sig" else (bad, sig_aff)
        if rlc_call(pk_t, sig_t, h_jac, b"\x02" * 32)[0]:
            fail(f"rlc: a batch with one {what} replaced was accepted")
    print("the batch with one sig replaced and the one with one pk replaced "
          "are rejected", flush=True)

    times = [rlc_call(pk_aff, sig_aff, h_jac, bytes([i + 3]) * 32)[2]
             for i in range(3)]
    wall = statistics.median(times)
    print(f"rlc N={RLC_N}: median {wall:.3f} s of "
          f"{[round(t, 3) for t in times]} -> {RLC_N / wall:.1f} share "
          f"verifications/s (exponent derivation included)", flush=True)

    per_a = rlc_accumulator_sweep(pk_aff, sig_aff, h_jac)
    ladder = rlc_ladder_calls(pk_aff, sig_aff, h_jac)

    spans = []
    with kernel_event_timer(spans):
        _, _, kwall = rlc_call(pk_aff, sig_aff, h_jac, b"\x07" * 32)
    kernel_s, per_kernel = kernel_split("rlc", spans, kwall)

    stages = []
    with stage_timer(stages):
        _, _, swall = rlc_call(pk_aff, sig_aff, h_jac, b"\x08" * 32)
    split = print_split("rlc", stages, swall)
    return dict(launches=launches, widest_fold=widest_fold, wall_s=wall,
                per_s=RLC_N / wall, kernel_s=kernel_s, timed_wall_s=kwall,
                split_ms=split,
                kernel_ms=per_kernel, wall_s_per_accumulators=per_a,
                ladder=ladder)


def rlc_ladder_calls(pk_aff, sig_aff, h_jac):
    """The ladder form (msm="ladder": B10 tables, one B13 launch per group,
    the fold of N lanes) on the valid batch, in turns with the shared form
    (shared, ladder, ladder, shared): both accept; and on the batch with
    one signature replaced, which it rejects. Returns its seconds."""
    from threshold_crypto_tpu_torch.device import curve as dcv

    reset_counts()
    turns = []
    for i, msm in enumerate(("shared", "ladder", "ladder", "shared")):
        ok, _, s = rlc_call(pk_aff, sig_aff, h_jac, bytes([32 + i]) * 32,
                            msm=msm)
        if not ok:
            fail(f"rlc: the {msm} form rejected the valid batch")
        turns.append((msm, s))
    launches = {k: v for k, v in read_counts().items()
                if k.startswith(("g1_step", "g2_step"))}
    if launches != {"g1_step4": 2, "g2_step4": 2, "g1_step": 0,
                    "g2_step": 0}:
        fail(f"rlc ladder form: B13/B15 launches {launches}")
    bad = dcv.tree_map(lambda a: a.clone(), sig_aff)
    for c in dcv.leaves(bad[:2]):
        c[7] = c[8]
    if rlc_call(pk_aff, bad, h_jac, b"\x30" * 32, msm="ladder")[0]:
        fail("rlc: the ladder form accepted a batch with one sig replaced")
    shared = [s for m, s in turns if m == "shared"]
    ladder = [s for m, s in turns if m == "ladder"]
    print(f"rlc ladder form (msm='ladder') at N={RLC_N}: accepts the valid "
          f"batch, rejects one sig replaced; in turns (shared, ladder, "
          f"ladder, shared) {[round(s, 3) for _, s in turns]} s: shared "
          f"mean {statistics.mean(shared):.3f} s, ladder mean "
          f"{statistics.mean(ladder):.3f} s", flush=True)
    return dict(turns=turns, ladder_s=statistics.mean(ladder),
                shared_s=statistics.mean(shared))


def rlc_accumulator_sweep(pk_aff, sig_aff, h_jac):
    """Time the whole RLC call at each A of RLC_A_SWEEP, in turns (forward,
    then backward, ...), RLC_A_ROUNDS calls each; every call must accept
    the valid batch. Returns {A: median seconds}."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    chosen = ccv.ACCUMULATORS
    times = {a: [] for a in RLC_A_SWEEP}
    try:
        for rnd in range(RLC_A_ROUNDS):
            order = RLC_A_SWEEP if rnd % 2 == 0 else RLC_A_SWEEP[::-1]
            for a in order:
                ccv.ACCUMULATORS = a
                ok, _, s = rlc_call(pk_aff, sig_aff, h_jac,
                                    bytes([16 + rnd]) * 32)
                if not ok:
                    fail(f"rlc: the valid batch was rejected at A = {a}")
                times[a].append(s)
    finally:
        ccv.ACCUMULATORS = chosen
    per_a = {a: statistics.median(t) for a, t in times.items()}
    print(f"rlc call by B11's accumulators A (median of {RLC_A_ROUNDS} in "
          f"turns; the path runs A = {chosen}): "
          + ", ".join(f"A={a}: {per_a[a]:.4f} s of "
                      f"{[round(t, 4) for t in times[a]]}"
                      for a in RLC_A_SWEEP), flush=True)
    return per_a


# ---------------------------------------------------------------------------
# Phase 7: slice 4, distinct-message verify with the device hash_g2
# ---------------------------------------------------------------------------

def _pow_products(e):
    """Fq2 products of ``hash2g2.fq2_pow_fixed``: a square per bit after the
    first, a multiply per set bit after the first."""
    return e.bit_length() - 1 + bin(e).count("1") - 1


def hash_launches():
    """Launches of one ``verify_with_hash_batch`` call: the residue test's
    B2 (one Euler power over the N·A candidates) and its three stacked
    products (x², x³, the norm), the square root's two fq2_pow_fixed plus
    three products, the root's order (one), the cofactor ladder (14 B10 for
    the table, one B13), the affine conversion (one B2, six products) and
    the megakernel check (B4-B9, B18, one B2)."""
    from threshold_crypto_tpu_torch.host.params import P

    expect = dict(PALLAS_LAUNCHES)
    expect.update({
        "mont_pow": 3, "g2_madd": 14, "g2_step4": 1,
        "mont_mul": (3 + _pow_products((P - 3) // 4) + 2
                     + _pow_products((P - 1) // 2) + 1 + 1 + 6)})
    return expect


def encrypt_launches():
    """Launches of one ``encrypt_batch_pallas`` call: three ladders, each
    its table (14 B10) and one B13; no product outside the kernels."""
    return {"g1_madd": 28, "g2_madd": 14, "g1_step4": 2, "g2_step4": 1,
            "mont_mul": 0, "mont_pow": 0}


def tile_to(tree, n):
    """A point tuple of k lanes tiled to n lanes (k divides n)."""
    from threshold_crypto_tpu_torch.device import curve as dcv

    return dcv.tree_map(
        lambda a: a.repeat((n // a.shape[0],) + (1,) * (a.dim() - 1)), tree)


def host_walk_ok(msg, attempts, n_words):
    """The host sampler's walk: does one of its first ``attempts``
    candidates land within ``n_words`` stream words? (What the device
    chain's ``ok`` says.)"""
    from threshold_crypto_tpu_torch import hashing
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.chacha import ChaChaRng
    from threshold_crypto_tpu_torch.host.sampling import fq2_random

    class Counted(ChaChaRng):
        used = 0

        def next_u32(self):
            self.used += 1
            return super().next_u32()

    rng = Counted(hashing.sha3_256(msg))
    for _ in range(attempts):
        x = fq2_random(rng)
        greatest = rng.next_u32() % 2 != 0
        if rng.used > n_words:
            return False
        if hcv.G2.get_point_from_x(x, greatest) is not None:
            return True
    return False


def g2_host_points(aff, lanes):
    """The host points of some lanes of a G2 affine tuple on the card."""
    from threshold_crypto_tpu_torch.device import tower as tw

    idx = list(lanes)
    x = tw.fq2_to_host((aff[0][0][idx], aff[0][1][idx]))
    y = tw.fq2_to_host((aff[1][0][idx], aff[1][1][idx]))
    inf = aff[2][idx].tolist()
    return [None if i else (a, b) for a, b, i in zip(x, y, inf)]


def hash_inputs(dev):
    """benches/hash_bench.py's inputs: HASH_N messages b"bench-msg-%d", 16
    keys (seed 0xD15C) tiled, signatures sk·H(m) made on the card with the
    ladder (``scalar_mul_pallas``, B13) from ``hashing.hash_g2_batch``'s
    points. Then lanes ≡ 3 (mod 8) take the next lane's signature and the
    HASH_INF lanes get pk, sig or both at infinity; the mask says which
    lanes must verify."""
    import torch
    from threshold_crypto_tpu_torch import hashing
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import pairing as dpr
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.params import R
    from threshold_crypto_tpu_torch.ops import threshold as tops

    msgs = [b"bench-msg-%d" % i for i in range(HASH_N)]
    rnd = random.Random(0xD15C)
    sks = [rnd.randrange(1, R) for _ in range(HASH_KEYS)]
    t0 = time.time()
    h_pts = [h.v for h in hashing.hash_g2_batch(msgs, attempts=HASH_ATTEMPTS,
                                                device=dev)]
    hash_s = time.time() - t0
    pk_aff = tile_to(dpr.g1_affine_from_host(
        [hcv.G1.mul(hcv.G1.generator, s) for s in sks], device=dev), HASH_N)
    sk_limbs = dcv.fr_limbs_from_ints(sks, dev).repeat(HASH_N // HASH_KEYS, 1)
    sig0 = tops.jacobian_to_affine(dcv.G2, ccv.scalar_mul_pallas(
        dcv.G2, dpr.g2_affine_from_host(h_pts, device=dev), sk_limbs))
    src = torch.arange(HASH_N, device=dev)
    src[3::8] += 1
    sig_aff = dcv.tree_map(lambda a: a[src].contiguous(), sig0)
    want = [i % 8 != 3 for i in range(HASH_N)]
    for lane, kind in HASH_INF:
        for aff, hit in ((pk_aff, kind in ("pk", "both")),
                         (sig_aff, kind in ("sig", "both"))):
            if hit:
                aff[2][lane] = True
                for c in dcv.leaves(aff[:2]):
                    c[lane] = 0
        want[lane] = kind == "both"
    return msgs, sks, h_pts, pk_aff, sig0, sig_aff, want, hash_s


def hash_call(pk_aff, msgs, sig_aff, want_t):
    """One synchronised ``verify_with_hash_batch`` call, checked against
    the mask; returns seconds."""
    import torch
    from threshold_crypto_tpu_torch import ops

    torch.cuda.synchronize()
    t0 = time.time()
    out = ops.verify_with_hash_batch(pk_aff, msgs, sig_aff,
                                     attempts=HASH_ATTEMPTS)
    secs = time.time() - t0
    if out.tolist() != want_t:
        bad = [i for i, (a, b) in enumerate(zip(out.tolist(), want_t))
               if a != b][:8]
        fail(f"verify_with_hash_batch disagrees with the mask at lanes {bad}")
    return secs


def run_hash(dev):
    """Slice 4: drive ``verify_with_hash_batch`` at HASH_N and check it."""
    from threshold_crypto_tpu_torch import hashing
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import hash2g2
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.ops import threshold as tops

    t0 = time.time()
    msgs, sks, h_pts, pk_aff, sig0, sig_aff, want, hash_s = hash_inputs(dev)
    print(f"inputs: {HASH_N} distinct messages, {HASH_KEYS} keys tiled, "
          f"{want.count(False)} lanes expected False; hash_g2_batch "
          f"{hash_s:.2f} s, built in {time.time() - t0:.1f} s", flush=True)

    # the device chain against the host oracle
    jac, ok = hash2g2.hash_g2_device(hashing.digest_words(msgs, dev),
                                     attempts=HASH_ATTEMPTS)
    h_aff = tops.jacobian_to_affine(dcv.G2, jac)
    okh = ok.cpu().tolist()
    not_ok = [i for i, k in enumerate(okh) if not k]
    print(f"hash_g2_device: {len(not_ok)} of {HASH_N} lanes not ok "
          f"({100 * len(not_ok) / HASH_N:.2f} %; about 2^-{HASH_ATTEMPTS} "
          f"expected) -> host oracle", flush=True)
    if len(not_ok) > HASH_NOT_OK * HASH_N:
        fail(f"hash_g2_device left {len(not_ok)} lanes to the host, over "
             f"{100 * HASH_NOT_OK:.0f} %")
    sample = list(range(0, HASH_N, HASH_N // HASH_SAMPLE))[:HASH_SAMPLE]
    t0 = time.time()
    for i, got in zip(sample, g2_host_points(h_aff, sample)):
        want_pt = hashing.hash_g2(msgs[i]).v
        if (okh[i] and got != want_pt) or h_pts[i] != want_pt:
            fail(f"hash_g2: lane {i} differs from the host oracle")
    for i in not_ok:
        if h_pts[i] != hashing.hash_g2(msgs[i]).v:
            fail(f"hash_g2_batch: lane {i} (not ok) differs from the host "
                 f"oracle")
    for i in sorted(set(not_ok) | set(sample)):
        if host_walk_ok(msgs[i], HASH_ATTEMPTS,
                        hash2g2.DEFAULT_WORDS) != okh[i]:
            fail(f"hash_g2_device: ok of lane {i} is not the host walk's")
    for i in sample[:SIG_SAMPLE]:
        if g2_host_points(sig0, [i])[0] != hcv.G2.mul(h_pts[i],
                                                      sks[i % HASH_KEYS]):
            fail(f"signature of lane {i} differs from the host oracle")
    print(f"{len(sample)} sampled hash points and all {len(not_ok)} lanes "
          f"not ok equal the host oracle, ok equals the host walk on them, "
          f"{SIG_SAMPLE} sampled signatures equal host mul "
          f"({time.time() - t0:.1f} s)", flush=True)

    reset_counts()
    first_s = hash_call(pk_aff, msgs, sig_aff, want)
    launches = read_counts()
    print(f"verify_with_hash_batch first call {first_s:.2f} s; launches per "
          f"call {launches}", flush=True)
    expect = hash_launches()
    got = {k: launches[k] for k in expect}
    if got != expect:
        fail(f"verify_with_hash_batch: launches per call {got}, expected "
             f"{expect}")
    times = [hash_call(pk_aff, msgs, sig_aff, want) for _ in range(3)]
    wall = statistics.median(times)
    print(f"verify_with_hash_batch N={HASH_N}: median {wall:.3f} s of "
          f"{[round(t, 3) for t in times]} -> {HASH_N / wall:.1f} "
          f"verifications/s (digests, hash, splice and check included)",
          flush=True)

    spans = []
    with kernel_event_timer(spans):
        kwall = hash_call(pk_aff, msgs, sig_aff, want)
    kernel_s, per_kernel = kernel_split("verify_with_hash_batch", spans, kwall)

    stages = []
    with stage_timer(stages):
        swall = hash_call(pk_aff, msgs, sig_aff, want)
    split = print_split("verify_with_hash_batch", stages, swall)
    splice_ms = sum(r["device_ms"] for r in stages
                    if r["name"] == "ops.splice_host_hashes")
    print(f"host splice (native hashing.hash_g2): {splice_ms:.1f} ms for "
          f"{len(not_ok)} lanes not ok "
          f"({splice_ms / max(len(not_ok), 1):.2f} ms a lane)", flush=True)
    return dict(launches=launches, wall_s=wall, per_s=HASH_N / wall,
                kernel_s=kernel_s, timed_wall_s=kwall, split_ms=split,
                kernel_ms=per_kernel, not_ok=len(not_ok),
                splice_ms=splice_ms)


# ---------------------------------------------------------------------------
# Phase 8: slice 5, batched encrypt, and the window-1 MSM
# ---------------------------------------------------------------------------

def run_encrypt(dev):
    """Slice 5: ``encrypt_batch_pallas`` at ENC_N lanes, the inputs of
    benches/encrypt_bench.py (seed 0xE2C: one key, 16 H(u, v) tiled, r in
    [1, R)); every lane passes the ciphertext check e(u, H) == e(G1, w)
    (``verify_batch_pallas(u, H, w)``), lanes 0, 1, n − 1 equal host mul."""
    import torch
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import pairing as dpr
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.params import R

    n = ENC_N
    rnd = random.Random(0xE2C)
    pk_host = hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R))
    huv_hosts = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
                 for _ in range(16)]
    rs = [rnd.randrange(1, R) for _ in range(n)]
    pk_aff = dcv.tree_map(lambda a: a.expand((n,) + a.shape[1:]),
                          dpr.g1_affine_from_host([pk_host], device=dev))
    huv_aff = tile_to(dpr.g2_affine_from_host(huv_hosts, device=dev), n)
    r = dcv.fr_limbs_from_ints(rs, dev)

    def call():
        torch.cuda.synchronize()
        t0 = time.time()
        out = ops.encrypt_batch_pallas(pk_aff, r, huv_aff)
        torch.cuda.synchronize()
        return out, time.time() - t0

    reset_counts()
    (u, g, w), first_s = call()
    launches = read_counts()
    expect = encrypt_launches()
    if {k: launches[k] for k in expect} != expect:
        fail(f"encrypt_batch_pallas: launches per call {launches}, expected "
             f"{expect}")
    print(f"encrypt_batch_pallas first call {first_s:.3f} s; launches per "
          f"call {launches}", flush=True)
    u_aff = ops.jacobian_to_affine(dcv.G1, u)
    w_aff = ops.jacobian_to_affine(dcv.G2, w)
    if not bool(ops.verify_batch_pallas(u_aff, huv_aff, w_aff).all()):
        fail("encrypt: a lane fails e(u, H) == e(G1, w)")
    for i in (0, 1, n - 1):
        lane = lambda t: dcv.tree_map(lambda a: a[i:i + 1], t)  # noqa: E731
        if (dcv.G1.to_host_affine(lane(u))[0],
                dcv.G1.to_host_affine(lane(g))[0],
                dcv.G2.to_host_affine(lane(w))[0]) != (
                hcv.G1.mul(hcv.G1.generator, rs[i]),
                hcv.G1.mul(pk_host, rs[i]),
                hcv.G2.mul(huv_hosts[i % 16], rs[i])):
            fail(f"encrypt: lane {i} differs from the host oracle")
    times = [call()[1] for _ in range(3)]
    wall = statistics.median(times)
    print(f"encrypt_batch_pallas N={n}: every lane passes e(u, H) == "
          f"e(G1, w), lanes 0, 1, {n - 1} equal host mul; median "
          f"{wall:.4f} s of {[round(t, 4) for t in times]} -> "
          f"{n / wall:.1f} encryptions/s", flush=True)
    spans = []
    with kernel_event_timer(spans):
        kwall = call()[1]
    kernel_s, per_kernel = kernel_split("encrypt_batch_pallas", spans, kwall)
    return dict(launches=launches, wall_s=wall, per_s=n / wall,
                kernel_s=kernel_s, timed_wall_s=kwall, kernel_ms=per_kernel)


def run_msm1(dev):
    """``msm_pallas(window=1)`` (one B15 launch per group) at MSM1_N lanes of
    16 points tiled with 64-bit scalars, G1 and G2: its folded sum equals
    ``msm_pallas_shared``'s and the host oracle's."""
    import numpy as np
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import pairing as dpr
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.params import R

    rnd = random.Random(0xB15)
    ks = np.random.default_rng(SEED).integers(0, 1 << 63, MSM1_N,
                                              dtype=np.uint64) * 2 + 1
    limbs = np.zeros((MSM1_N, 16), np.int32)
    for j in range(4):
        limbs[:, j] = (ks >> np.uint64(16 * j)) & np.uint64(0xFFFF)
    scalars = torch.from_numpy(limbs).to(dev)
    sums = [sum(int(v) for v in ks[j::16]) % R for j in range(16)]
    cases = []
    for curve, host, from_host in ((dcv.G1, hcv.G1, dpr.g1_affine_from_host),
                                   (dcv.G2, hcv.G2, dpr.g2_affine_from_host)):
        pts = [host.mul(host.generator, rnd.randrange(1, R))
               for _ in range(16)]
        want = None
        for p, k in zip(pts, sums):
            want = host.add(want, host.mul(p, k))
        cases.append((curve, tile_to(from_host(pts, device=dev), MSM1_N),
                      want))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    got = [ccv.msm_pallas(c, aff, scalars, nbits=64, window=1)
           for c, aff, _ in cases]
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = read_counts()
    if (launches["g1_step"], launches["g2_step"]) != (1, 1):
        fail(f"msm_pallas(window=1): launches {launches}")
    for (curve, aff, want), sum_jac in zip(cases, got):
        one = dcv.tree_map(lambda a: a[None], sum_jac)
        shared = dcv.tree_map(lambda a: a[None], ccv.msm_pallas_shared(
            curve, aff, scalars, nbits=64))
        if curve.to_host_affine(one) != [want] or \
                curve.to_host_affine(shared) != [want]:
            fail(f"msm_pallas(window=1) {curve.name}: the sum differs from "
                 f"msm_pallas_shared's or the host oracle's")
    print(f"msm_pallas(window=1) at N={MSM1_N}, 64-bit scalars: G1 and G2 "
          f"sums equal msm_pallas_shared's and the host oracle's; both "
          f"groups {secs:.3f} s (B15 and the fold); launches {launches}",
          flush=True)
    return dict(launches=launches, wall_s=secs)


# ---------------------------------------------------------------------------
# Phase 3, continued: the combine's kernels B14 and B16
# ---------------------------------------------------------------------------

def rowprod_inputs(dev):
    """COMBINE_N distinct random Fr values (Montgomery limbs on the card),
    with lane n − 1 a copy of lane 17 (a duplicate pair) and lane 100
    zero, and the host ints."""
    from threshold_crypto_tpu_torch.host.params import R
    from threshold_crypto_tpu_torch.ops import fr as frops

    rnd = random.Random(0x14)
    vals = [rnd.randrange(1, R) for _ in range(COMBINE_N)]
    vals[-1] = vals[17]
    vals[100] = 0
    return vals, frops.fr_to_device(vals, dev)


def check_rowprod(dev, card):
    """B14 at the combine's N = 4096 with a duplicate pair and a zero lane:
    its partial products and counts bit-exact against its plain version,
    the folded row products and counts against the plain version's single
    sweep, one lane against Python ints; timed beside its bound."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_fr
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.device.mont import FR

    kernel = {k.name: k for _, k in registry()}["lagrange_rowprod"]
    vals, xs = rowprod_inputs(dev)
    n = len(vals)
    got = kernel.launch(xs)
    torch.cuda.synchronize()
    with plain_versions():
        want, plain_ms = timed_once(kernel.plain, xs)
        whole = cuda_fr.lagrange_rowprod_ref(xs)
    err = compare("lagrange_rowprod", got, want,
                  f"at N = {n} ({got[0].shape[0]} chunks)")
    folded = (cuda_fr.fold_products(got[0]), got[1].sum(0, dtype=torch.int32))
    err = max(err, compare("lagrange_rowprod", folded, whole,
                           f"folded, at N = {n}"))
    zc = folded[1].tolist()
    if (zc[17], zc[-1], zc[100]) != (2, 2, 1) or \
            sum(zc) != n + 2:
        fail(f"lagrange_rowprod: zero counts {zc[17]}, {zc[-1]}, {zc[100]} "
             f"(sum {sum(zc)}) on the duplicate pair and the zero lane")
    d = 1
    for v in vals:
        if v != vals[5]:
            d = d * (v - vals[5]) % FR.p
    if mont.unstack_mont(FR, folded[0][5:6]) != [d]:
        fail("lagrange_rowprod: lane 5 differs from Python ints")
    ms = cuda_time_ms(lambda: kernel.launch(xs), 10)
    wrapper_ms = cuda_time_ms(lambda: cuda_fr.lagrange_rowprod(xs), 10)
    products = n * n - sum(zc)
    bytes_moved = n * FR.L * 4 + got[0].numel() * 4 + got[1].numel() * 4
    bound, by = bound_ms(bytes_moved, products * FR_PRODUCT_IMADS, card)
    print(f"lagrange_rowprod xs [{n}, 16] -> {list(got[0].shape)}: bit-exact "
          f"(partials, and folded against one sweep; a duplicate pair and a "
          f"zero lane; lane 5 equals Python ints); kernel {ms:.4f} ms, with "
          f"its fold (B1) {wrapper_ms:.4f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound:.4f} ms ({by}, {products} Fr products), "
          f"{ms / bound:.1f}x the bound", flush=True)
    return dict(lanes=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, ms_with_fold=wrapper_ms)


def b16_inputs(g2, window, n, gen, dev):
    """B16's operands: acc [3k·24, A] (A = ``SHARED_BLOCK``), a table of
    2^w − 1 random entries over n lanes, one window's digits [n]. In every
    block of A lanes, lanes 0-3 have the accumulator at infinity, 4-7 the
    selected entry equal to the accumulator (T == Q), 8-11 its negative
    (T == −Q), 12-15 the selected entry at infinity, 16-19 digit 0."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.device import packed as pk
    from threshold_crypto_tpu_torch.device.mont import FQ

    k = 2 if g2 else 1
    rows, A, nent = k * FQ.L, ccv.SHARED_BLOCK, (1 << window) - 1
    acc = random_packed(3 * k, A, gen, dev)
    acc[2 * rows:, 0:4] = 0
    neg_y = pk.pack(list(mont.neg(FQ, torch.stack(pk.unpack(
        acc[rows:2 * rows, 8:12].contiguous(), k)))))
    table = random_packed(nent * 3 * k, n, gen, dev)
    digits = torch.randint(0, nent + 1, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    for start in range(0, n, A):
        m = min(20, n - start)
        d = torch.randint(1, nent + 1, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
        d[16:] = 0
        digits[start:start + m] = d
        for j in range(min(16, m)):
            e = int(d[j]) - 1
            col = table[e * 3 * rows:(e + 1) * 3 * rows, start + j]
            if 4 <= j < 12:
                col[:] = acc[:, j]
            if 8 <= j < 12:
                col[rows:2 * rows] = neg_y[:, j - 8]
            if 12 <= j < 16:
                col[2 * rows:] = 0
    return acc, table, digits


def product_latency_ms(pow_result):
    """The time of one Fq product in series: B2's one-lane chain for
    p − 2 (``check_pow``'s result at 1 lane, a lane over the 4 threads of
    ``mont_pow_group_kernel``) over its squares and products. B16's
    latency yardstick is its general path's products times this."""
    return pow_result["ms"] / (pow_result["chain_squares"]
                               + pow_result["chain_products"])


def b16_bounds(g2, nonzero, accs, window, card):
    """B16's bounds at one launch over ``accs`` accumulators: selmadd's
    general path on the ``nonzero`` lanes with a digit (the accumulator
    read and written, the digits, one entry a nonzero lane), and dblw's
    ``window`` doublings a lane (the accumulator read and written)."""
    k = 2 if g2 else 1
    rows = 3 * k * 24
    sel = bound_ms(2 * rows * 4 * accs + 4 * accs + rows * 4 * nonzero,
                   nonzero * ADD_FQ_PRODUCTS[k - 1] * FQ_PRODUCT_IMADS, card)
    dbl = bound_ms(2 * rows * 4 * accs, accs * window
                   * DBL_FQ_PRODUCTS[k - 1] * FQ_PRODUCT_IMADS, card)
    return sel, dbl


def check_b16(g2, gen, dev, card, ptxas, product_ms):
    """B16 selmadd and dblw against their plain versions at window 1 and 3
    on the special lanes of ``b16_inputs``, every block of a ragged table
    of B16_TABLE_N lanes (the last block's padding has digit 0); timed at
    the bitscan path's shape (window 1, A = 1024, table 4096 lanes) beside
    the throughput bound and the latency yardstick (the general path's
    products, one after another, at ``product_ms`` each); the kernels'
    ptxas figures (csrc/shared.cu on the register engine)."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    k = 2 if g2 else 1
    reg = {kk.name: kk for _, kk in registry()}
    sel, dbl = reg[f"g{1 + g2}_selmadd"], reg[f"g{1 + g2}_dblw"]
    A, rows = ccv.SHARED_BLOCK, 3 * k * 24
    err = {"selmadd": 0, "dblw": 0}
    for window in (1, 3):
        acc, table, digits = b16_inputs(g2, window, B16_TABLE_N, gen, dev)
        for start in range(0, B16_TABLE_N, A):
            got = sel.launch(acc, table, digits, start)
            torch.cuda.synchronize()
            with plain_versions():
                want = sel.plain(acc, table, digits, start)
            err["selmadd"] = max(err["selmadd"], compare(
                sel.name, got, want, f"at window {window}, block {start}"))
            z = got[2 * rows // 3:]
            live = min(A, B16_TABLE_N - start)
            if bool(z[:, 8:12].any()) or not torch.equal(
                    got[:, 16:20], acc[:, 16:20]) or not torch.equal(
                    got[:, live:], acc[:, live:]):
                fail(f"{sel.name}: T == -Q lanes are not at infinity, or "
                     f"digit-0 or padding lanes changed")
        got = dbl.launch(acc, window)
        torch.cuda.synchronize()
        with plain_versions():
            want = dbl.plain(acc, window)
        err["dblw"] = max(err["dblw"], compare(dbl.name, got, want,
                                               f"at window {window}"))
    acc, table, digits = b16_inputs(g2, 1, COMBINE_N, gen, dev)
    with plain_versions():
        _, sel_plain_ms = timed_once(sel.plain, acc, table, digits, 0)
        _, dbl_plain_ms = timed_once(dbl.plain, acc, 1)
    sel_ms = cuda_time_ms(lambda: sel.launch(acc, table, digits, 0), 20)
    dbl_ms = cuda_time_ms(lambda: dbl.launch(acc, 1), 20)
    nonzero = int((digits[:A] != 0).sum().item())
    sel_bound, dbl_bound = b16_bounds(g2, nonzero, A, 1, card)
    sel_lat = ADD_FQ_PRODUCTS[k - 1] * product_ms
    dbl_lat = DBL_FQ_PRODUCTS[k - 1] * product_ms
    print(f"{sel.name} / {dbl.name} acc [{rows}, {A}]: bit-exact at window 1 "
          f"and 3 on every block of a {B16_TABLE_N}-lane table (infinity, "
          f"T == Q, T == -Q, Q at infinity, digit 0 and padding lanes); at "
          f"window 1 selmadd {sel_ms:.4f} ms (plain {sel_plain_ms:.1f} ms, "
          f"bound {sel_bound[0]:.4f} ms, {sel_bound[1]}, {nonzero} nonzero "
          f"digits, {sel_ms / sel_bound[0]:.1f}x; latency yardstick "
          f"{sel_lat:.4f} ms, {sel_ms / sel_lat:.2f}x), dblw {dbl_ms:.4f} ms "
          f"(plain {dbl_plain_ms:.1f} ms, bound {dbl_bound[0]:.4f} ms, "
          f"{dbl_bound[1]}, {dbl_ms / dbl_bound[0]:.1f}x; latency yardstick "
          f"{dbl_lat:.4f} ms, {dbl_ms / dbl_lat:.2f}x)", flush=True)
    figures = {}
    for kind in ("selmadd", "dblw"):
        fn = f"{kind}_kernel<{'Fq2' if g2 else 'Fq'}>"
        figures[kind] = dict(zip(("registers", "stack_frame", "spill_stores",
                                  "spill_loads"), ptxas[fn]))
        print(f"g{1 + g2}_{kind} (shared.cu {fn}, the register engine): "
              f"{ptxas[fn][0]} registers, {ptxas[fn][1]} bytes stack frame, "
              f"{ptxas[fn][2]} bytes spill stores, {ptxas[fn][3]} bytes "
              f"spill loads", flush=True)
    return {sel.name: dict(lanes=A, max_abs_err=err["selmadd"], ms=sel_ms,
                           plain_ms=sel_plain_ms, bound_ms=sel_bound[0],
                           bound_by=sel_bound[1], window=1,
                           latency_ms=sel_lat, ptxas=figures["selmadd"]),
            dbl.name: dict(lanes=A, max_abs_err=err["dblw"], ms=dbl_ms,
                           plain_ms=dbl_plain_ms, bound_ms=dbl_bound[0],
                           bound_by=dbl_bound[1], window=1,
                           latency_ms=dbl_lat, ptxas=figures["dblw"])}


# B19 at the folds of the paths, (G2, batch shape, fold axis, what): the
# DKG's row commitments over j and value commitments over the positions,
# the RLC call's partial sums (cuda_curve.ACCUMULATORS) in both groups,
# and a combine's t + 1 shares in G2. The frozen yardstick counts a
# complete add as 23 / 69 Fq products (G1 / G2; the torch tree computed
# its doubling branch on every lane), the general path needs 16 / 44.
B19_FOLDS = ((False, (DKG_N, DKG_T + 1, DKG_T + 1), 2, "row commitments"),
             (False, (DKG_N, (DKG_T + 1) * (DKG_T + 2) // 2), 1,
              "value commitments"),
             (False, (16384,), 0, "RLC partial sums"),
             (True, (16384,), 0, "RLC partial sums"),
             (True, (DKG_T + 1,), 0, "a combine's shares"))
FROZEN_ADD_FQ_PRODUCTS = (23, 69)


def fold_inputs(g2, shape, axis, gen, dev):
    """A Jacobian batch of ``shape`` of random canonical values, made on
    the card, with special pairs at the first level (entry f and its
    partner f + ⌈m/2⌉ over the fold axis, f = 0..4 where m allows, in
    batch f where the batch has that many): T == Q (the same limbs), T == −Q, T at infinity,
    Q at infinity, both; with 6 batches or more batch 5 all at infinity."""
    import math

    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.device import packed as pk
    from threshold_crypto_tpu_torch.device.mont import FQ

    k = 2 if g2 else 1
    m = shape[axis]
    rest = math.prod(shape) // m
    comps = [c.reshape(m, rest, FQ.L) for c in pk.unpack(
        random_packed(3 * k, m * rest, gen, dev), 3 * k)]
    ys, zs = comps[k:2 * k], comps[2 * k:]
    half = (m + 1) // 2
    for f in range(min(5, m - half)):
        r, q = min(f, rest - 1), f + half
        if f == 0:
            for c in comps:
                c[q, r] = c[f, r]
        elif f == 1:
            for c in comps:
                c[q, r] = c[f, r]
            for y in ys:
                y[q, r] = mont.neg(FQ, y[f, r])
        for z in zs:
            if f in (2, 4):
                z[f, r] = 0
            if f in (3, 4):
                z[q, r] = 0
    if rest > 5:
        for z in zs:
            z[:, 5] = 0
    moved = (m,) + tuple(d for i, d in enumerate(shape) if i != axis)
    comps = [c.reshape(moved + (FQ.L,)).movedim(0, axis) for c in comps]
    if g2:
        return tuple((comps[2 * i], comps[2 * i + 1]) for i in range(3))
    return tuple(comps)


def check_b19(dev, gen, card, ptxas):
    """B19 at B19_FOLDS through ``DeviceCurve.fold_axis``: one B19 launch a
    level and no other launch, the sums bit-exact against the plain tree
    (B19's plain version, the torch tree of stacked complete adds, its
    products on B1 as before B19), each level timed from packed inputs
    beside its bounds (the frozen 23 / 69 Fq products an add, and the
    general path's 16 / 44), the whole fold (its packing and unpacking
    included) and the plain tree; the kernels' ptxas figures. Returns
    {kernel: result}, G1's at the row commitments' fold, G2's at the RLC
    sums', every fold under "folds"."""
    import math

    import torch
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv

    reg = {kk.name: kk for _, kk in registry()}
    results = {}
    for g2, shape, axis, what in B19_FOLDS:
        curve, k = (dcv.G2, 2) if g2 else (dcv.G1, 1)
        kernel = reg[f"g{1 + g2}_fold_level"]
        m = shape[axis]
        rest = math.prod(shape) // m
        levels = (m - 1).bit_length()
        pts = fold_inputs(g2, shape, axis, gen, dev)
        reset_counts()
        got = curve.fold_axis(pts, axis)
        torch.cuda.synchronize()
        launches = {n: c for n, c in read_counts().items() if c}
        if launches != {kernel.name: levels}:
            fail(f"{kernel.name}: fold_axis over {what} launched {launches}, "
                 f"expected {levels} {kernel.name} and nothing else")
        torch.cuda.synchronize()
        t0 = time.time()
        with kernels_replaced(lambda kk: kk.plain if kk is kernel
                              else kk.launch):
            want = curve.fold_axis(pts, axis)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.time() - t0)
        err = compare(kernel.name, tuple(dcv.leaves(got)),
                      tuple(dcv.leaves(want)), f"over {what} {shape}")
        fold_ms = cuda_time_ms(lambda: curve.fold_axis(pts, axis), 3)
        packed = ccv.pack_point(dcv.tree_map(lambda a: a.movedim(axis, 0),
                                             pts))
        level_ms, bounds, general = [], [], []
        for _ in range(levels):
            n = packed.shape[1]
            half = ccv.fold_half(n, rest)
            level_ms.append(cuda_time_ms(
                lambda: kernel.launch(packed, rest), 3))
            moved = (n + half) * 3 * k * 96
            for products, into in ((FROZEN_ADD_FQ_PRODUCTS, bounds),
                                   (ADD_FQ_PRODUCTS, general)):
                into.append(bound_ms(moved, half * products[k - 1]
                                     * FQ_PRODUCT_IMADS, card)[0])
            packed = kernel.launch(packed, rest)
        del packed
        bound, bound_gen = sum(bounds), sum(general)
        print(f"{kernel.name} over {what} {list(shape)}, axis {axis}: "
              f"bit-exact with the plain tree (T == Q, T == -Q and infinity "
              f"pairs), {levels} B19 launches and no other; levels "
              f"{[round(x, 4) for x in level_ms]} ms (sum "
              f"{sum(level_ms):.4f}), whole fold {fold_ms:.4f} ms, plain "
              f"tree {plain_ms:.1f} ms; bound {bound:.4f} ms at "
              f"{FROZEN_ADD_FQ_PRODUCTS[k - 1]} products an add "
              f"({sum(level_ms) / bound:.2f}x), {bound_gen:.4f} ms at the "
              f"general path's {ADD_FQ_PRODUCTS[k - 1]} "
              f"({sum(level_ms) / bound_gen:.2f}x)", flush=True)
        entry = dict(what=what, shape=list(shape), axis=axis, levels=levels,
                     lanes=ccv.fold_half(m * rest, rest), max_abs_err=err,
                     ms=sum(level_ms), level_ms=level_ms, fold_ms=fold_ms,
                     plain_ms=plain_ms, bound_ms=bound, bound_by="operations",
                     bound_ms_general_path=bound_gen)
        res = results.setdefault(kernel.name, dict(folds=[]))
        res["folds"].append(entry)
        if (not g2 and what == "row commitments") or \
                (g2 and what == "RLC partial sums"):
            res.update({key: entry[key] for key in (
                "lanes", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by")})
        del pts, got, want
        torch.cuda.empty_cache()
    for g2 in (False, True):
        fn = f"fold_level_kernel<{'Fq2' if g2 else 'Fq'}>"
        figures = ptxas[fn]
        results[f"g{1 + g2}_fold_level"]["ptxas"] = dict(zip(
            ("registers", "stack_frame", "spill_stores", "spill_loads"),
            figures))
        print(f"g{1 + g2}_fold_level (fold.cu {fn}, the register engine): "
              f"{figures[0]} registers, {figures[1]} bytes stack frame, "
              f"{figures[2]} bytes spill stores, {figures[3]} bytes spill "
              f"loads", flush=True)
    return results


# ---------------------------------------------------------------------------
# Phase 9: slice 6, the threshold flows at t + 1 = COMBINE_N
# ---------------------------------------------------------------------------

def _levels(m):
    """⌈log₂ m⌉: the levels of a pairwise tree over m entries."""
    return (max(m, 1) - 1).bit_length()


def combine_launches(n, path, g2):
    """Launches of one ``combine_batch`` call of n shares: λ (the product
    tree of the x, ⌈log₂ n⌉ B1; for n ≤ 1024 the matrix's row products,
    ⌈log₂ n⌉ B1, above it one B14 and ⌈log₂ S⌉ B1 over its S chunks; the
    denominators, λ and the canonical form, 3 B1; one B2), the shares'
    affine form (one B2, 4 B1 in G1 and 6 in G2), then the path's MSM and
    its fold of ⌈log₂ m⌉ levels, one B19 each: "pallas" 6 B10 and one B11
    (m = min(A, n)), "scalarwise" one B15 (m = n), "bitscan" 255 B16 dblw
    and 255 selmadd per block of min(1024, n) lanes (m = that block)."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import cuda_fr
    from threshold_crypto_tpu_torch.ops import fr as frops

    g = "g2" if g2 else "g1"
    expect = {"lagrange_rowprod": 0, "mont_pow": 2, f"{g}_madd": 0,
              f"{g}_winacc": 0, f"{g}_step": 0, f"{g}_selmadd": 0,
              f"{g}_dblw": 0, f"{g}_fold_level": 0}
    mul = _levels(n) + 3 + (6 if g2 else 4)
    if n <= frops._LAGRANGE_MATRIX_MAX:
        mul += _levels(n)
    else:
        expect["lagrange_rowprod"] = 1
        mul += _levels(-(-n // cuda_fr._chunk(n)))
    if path == "pallas":
        expect.update({f"{g}_madd": 6, f"{g}_winacc": 1})
        m = min(ccv.ACCUMULATORS, n)
    elif path == "scalarwise":
        expect[f"{g}_step"] = 1
        m = n
    else:
        m = min(ccv.SHARED_BLOCK, n)
        expect.update({f"{g}_dblw": 255,
                       f"{g}_selmadd": 255 * -(-n // m)})
    expect["mont_mul"] = mul
    expect[f"{g}_fold_level"] = _levels(m)
    return expect


def horner_host(coeffs, x):
    """f(x) mod r on the host (Horner over Python ints)."""
    from threshold_crypto_tpu_torch.host.params import R

    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def host_points(curve, jac, lanes):
    """Host affine points of some lanes of a Jacobian tuple on the card."""
    from threshold_crypto_tpu_torch.device import curve as dcv

    idx = list(lanes)
    return curve.to_host_affine(dcv.tree_map(lambda a: a[idx], jac))


def one_point(curve, pt):
    """An unbatched Jacobian point on the card -> its host affine point."""
    from threshold_crypto_tpu_torch.device import curve as dcv

    return curve.to_host_affine(dcv.tree_map(lambda a: a[None], pt))[0]


def combine_call(curve, shares, xs, path):
    """One synchronised ``combine_batch`` call: (point, ok, seconds)."""
    import torch
    from threshold_crypto_tpu_torch import ops

    torch.cuda.synchronize()
    t0 = time.time()
    pt, ok = ops.combine_batch(curve, shares, xs, path=path)
    torch.cuda.synchronize()
    return pt, bool(ok), time.time() - t0


def run_combine_path(curve, shares, xs, path, want):
    """One path of the combine: its counted call (launches against
    ``combine_launches``), the median of 3 calls, the kernel share and the
    stage split of one call each; every call must give ``want``."""
    what = f"combine_batch({curve.name}, {path})"
    reset_counts()
    pt, ok, first_s = combine_call(curve, shares, xs, path)
    launches = read_counts()
    expect = combine_launches(xs.shape[0], path, curve.name == "G2")
    got = {k: launches[k] for k in expect}
    if got != expect:
        fail(f"{what}: launches per call {got}, expected {expect}")
    if not ok or one_point(curve, pt) != want:
        fail(f"{what}: not ok, or the point differs from the host's")
    times = []
    for _ in range(3):
        pt, ok, s = combine_call(curve, shares, xs, path)
        if not ok or one_point(curve, pt) != want:
            fail(f"{what}: a timed call gave another point")
        times.append(s)
    wall = statistics.median(times)
    spans = []
    with kernel_event_timer(spans):
        _, _, kwall = combine_call(curve, shares, xs, path)
    kernel_s, per_kernel = kernel_split(what, spans, kwall)
    stages = []
    with stage_timer(stages):
        _, _, swall = combine_call(curve, shares, xs, path)
    split = print_split(what, stages, swall)
    print(f"{what} at t+1 = {xs.shape[0]}: equals the host's point; first "
          f"call {first_s:.3f} s; median {wall:.4f} s of "
          f"{[round(t, 4) for t in times]}; launches per call "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return dict(launches=launches, wall_s=wall, times_s=times,
                kernel_s=kernel_s, timed_wall_s=kwall, kernel_ms=per_kernel,
                split_ms=split)


def combine_shares(dev, timed=lambda label, fn, *args: fn(*args)):
    """Slice 6's keys and signature shares: t + 1 = COMBINE_N shares of a
    degree COMBINE_N − 1 polynomial from its seed, x_i = i + 1:
    ``derive_shares`` on the card, then ``sign_batch`` of the host's
    hash_g2 of one message (each through ``timed(label, fn, *args)``).
    Returns a dict: coeffs, xs, sk_mont, sk (canonical), h_host, h_jac,
    sig (Jacobian [COMBINE_N]) and rnd, the seed's generator after the
    coefficients."""
    from threshold_crypto_tpu_torch import hashing, ops
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host.params import R
    from threshold_crypto_tpu_torch.ops import fr as frops

    n = COMBINE_N
    rnd = random.Random(COMBINE_SEED)
    coeffs = [rnd.randrange(R) for _ in range(n)]
    xs = frops.fr_to_device(range(1, n + 1), dev)
    sk_mont = timed("derive_shares", ops.derive_shares,
                    frops.fr_to_device(coeffs, dev), xs)
    sk = frops.fr_to_plain(sk_mont)
    h_host = hashing.hash_g2(COMBINE_MSG).v
    h_jac = dcv.G2.from_host_affine([h_host], device=dev)
    sig = timed("sign_batch", ops.sign_batch, tile_to(h_jac, n), sk)
    return dict(coeffs=coeffs, xs=xs, sk_mont=sk_mont, sk=sk, h_host=h_host,
                h_jac=h_jac, sig=sig, rnd=rnd)


def run_combine(dev):
    """Slice 6: both threshold flows at t + 1 = COMBINE_N shares from one
    degree-(COMBINE_N − 1) secret polynomial made from a seed, x_i = i + 1.

    Signatures: shares by ``derive_shares`` on the card, pk shares G1·skᵢ,
    signature shares ``sign_batch`` of the host's hash_g2 of one message;
    the RLC share check accepts them; ``combine_batch`` on each path gives
    the host's H·f(0), which ``verify_batch_pallas`` accepts against
    G1·f(0); ok is False with one x duplicated and with one x zero.
    Decryption: one key G1·f(0) broadcast, ``encrypt_begin_batch`` /
    ``encrypt_finish_batch`` with a host G2 point standing in for H(u, v);
    ``ciphertext_verify_batch`` true on every lane and false on the lane
    whose w is replaced; the decryption shares of lane 0's u pass
    ``verify_dec_share_batch`` but for the one replaced; their combine on
    each path equals g = r·pk of lane 0."""
    import torch
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.host.params import R
    from threshold_crypto_tpu_torch.ops import fr as frops
    from threshold_crypto_tpu_torch.ops import threshold as tops

    n = COMBINE_N
    probe = (0, 1, n // 3, n - 1)
    timings = {}

    def timed(label, fn, *args):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        timings[label] = time.time() - t0
        return out

    # keys and signature shares
    inp = combine_shares(dev, timed)
    coeffs, xs, sk_mont, sk, h_host, h_jac, sig, rnd = (inp[k] for k in (
        "coeffs", "xs", "sk_mont", "sk", "h_host", "h_jac", "sig", "rnd"))
    secret = coeffs[0]
    sk_host = [horner_host(coeffs, x + 1) for x in probe]
    if frops.fr_from_device(sk_mont[list(probe)]) != sk_host:
        fail("derive_shares: shares differ from host Horner")
    pk_jac = timed("pk shares (ladder)", ccv.scalar_mul_pallas, dcv.G1,
                   tops._gen_g1((n,), dev), sk)
    pk_aff = ops.jacobian_to_affine(dcv.G1, pk_jac)
    sig_aff = ops.jacobian_to_affine(dcv.G2, sig)
    if host_points(dcv.G1, pk_jac, probe) != [
            hcv.G1.mul(hcv.G1.generator, s) for s in sk_host] or \
            host_points(dcv.G2, sig, probe) != [hcv.G2.mul(h_host, s)
                                                for s in sk_host]:
        fail("pk or signature shares differ from host mul")
    r = ops.rlc_exponents(n, b"combine", pk_aff=pk_aff, sig_aff=sig_aff)
    if not bool(ops.verify_sig_shares_rlc_pallas(pk_aff, h_jac, sig_aff, r)):
        fail("the RLC check rejected the signature shares")
    print(f"keys: {n} shares of a degree-{n - 1} polynomial "
          f"(derive_shares {timings['derive_shares']:.2f} s), pk and "
          f"signature shares equal host mul on lanes {list(probe)}, the RLC "
          f"check accepts the {n} signature shares", flush=True)

    want_sig = hcv.G2.mul(h_host, secret)
    paths = {}
    for path in tops.COMBINE_PATHS:
        paths[f"G2 {path}"] = run_combine_path(dcv.G2, sig, xs, path,
                                               want_sig)
    pt, _, _ = combine_call(dcv.G2, sig, xs, "pallas")
    master = dcv.G1.from_host_affine([hcv.G1.mul(hcv.G1.generator, secret)],
                                     device=dev)
    if not bool(ops.verify_batch_pallas(
            ops.jacobian_to_affine(dcv.G1, master), ops.jacobian_to_affine(
                dcv.G2, h_jac), ops.jacobian_to_affine(
                dcv.G2, dcv.tree_map(lambda a: a[None], pt)))[0]):
        fail("verify_batch_pallas rejects the combined signature")
    for what, lane, value in (("duplicated", n - 1, 17), ("zero", 100, -1)):
        bad = xs.clone()
        bad[lane] = 0 if value < 0 else xs[value]
        if combine_call(dcv.G2, sig, bad, "pallas")[1]:
            fail(f"combine_batch: ok with one x {what}")
    print(f"the three paths give the host's H*f(0); verify_batch_pallas "
          f"accepts it against G1*f(0); ok is False with one x duplicated "
          f"and with one x zero", flush=True)

    # decryption
    pk_host = hcv.G1.mul(hcv.G1.generator, secret)
    huv_host = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    rs = [rnd.randrange(1, R) for _ in range(n)]
    r_plain = dcv.fr_limbs_from_ints(rs, dev)
    u, g = timed("encrypt_begin_batch", ops.encrypt_begin_batch, tile_to(
        dcv.G1.from_host_affine([pk_host], device=dev), n), r_plain)
    huv_jac = tile_to(dcv.G2.from_host_affine([huv_host], device=dev), n)
    w = timed("encrypt_finish_batch", ops.encrypt_finish_batch, huv_jac,
              r_plain)
    if (host_points(dcv.G1, u, probe), host_points(dcv.G1, g, probe),
            host_points(dcv.G2, w, probe)) != (
            [hcv.G1.mul(hcv.G1.generator, rs[i]) for i in probe],
            [hcv.G1.mul(pk_host, rs[i]) for i in probe],
            [hcv.G2.mul(huv_host, rs[i]) for i in probe]):
        fail("encrypt: u, g or w differ from host mul")
    u_aff = ops.jacobian_to_affine(dcv.G1, u)
    w_aff = ops.jacobian_to_affine(dcv.G2, w)
    huv_aff = ops.jacobian_to_affine(dcv.G2, huv_jac)
    ct_ok = timed("ciphertext_verify_batch", ops.ciphertext_verify_batch,
                  u_aff, w_aff, huv_aff)
    w_bad = dcv.tree_map(lambda a: a.clone(), w_aff)
    for c in dcv.leaves(w_bad[:2]):
        c[5] = c[6]
    ct_bad = ops.ciphertext_verify_batch(u_aff, w_bad, huv_aff)
    if not bool(ct_ok.all()) or ct_bad.nonzero().numel() != n - 1 \
            or bool(ct_bad[5]):
        fail("ciphertext_verify_batch: a valid lane failed, or the lane "
             "with w replaced passed")
    lane0 = lambda t: dcv.tree_map(lambda a: a[:1], t)  # noqa: E731
    d = timed("decrypt_share_batch", ops.decrypt_share_batch,
              tile_to(lane0(u), n), sk)
    d_aff = ops.jacobian_to_affine(dcv.G1, d)
    w0 = tile_to(lane0(w_aff), n)
    ds_ok = timed("verify_dec_share_batch", ops.verify_dec_share_batch,
                  d_aff, huv_aff, pk_aff, w0)
    d_bad = dcv.tree_map(lambda a: a.clone(), d_aff)
    for c in dcv.leaves(d_bad[:2]):
        c[9] = c[10]
    ds_bad = ops.verify_dec_share_batch(d_bad, huv_aff, pk_aff, w0)
    if not bool(ds_ok.all()) or ds_bad.nonzero().numel() != n - 1 \
            or bool(ds_bad[9]):
        fail("verify_dec_share_batch: a valid share failed, or the replaced "
             "share passed")
    want_g = hcv.G1.mul(pk_host, rs[0])
    if host_points(dcv.G1, g, [0]) != [want_g]:
        fail("encrypt: g of lane 0 differs from r*pk")
    for path in tops.COMBINE_PATHS:
        reset_counts()
        pt, ok, s = combine_call(dcv.G1, d, xs, path)
        launches = read_counts()
        expect = combine_launches(n, path, False)
        if {k: launches[k] for k in expect} != expect:
            fail(f"combine_batch(G1, {path}): launches {launches}, expected "
                 f"{expect}")
        if not ok or one_point(dcv.G1, pt) != want_g:
            fail(f"combine_batch(G1, {path}) differs from g = r*pk")
        paths[f"G1 {path}"] = dict(launches=launches, wall_s=s)
    print(f"decryption: ciphertext_verify_batch true on all {n} lanes and "
          f"false on the lane with w replaced; verify_dec_share_batch true "
          f"on all {n} shares and false on the one replaced; combine_batch "
          f"(G1) on each path equals g = r*pk ("
          + ", ".join(f"{p} {paths['G1 ' + p]['wall_s']:.3f} s"
                      for p in tops.COMBINE_PATHS) + ")", flush=True)
    print("threshold batch ops, one call each: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()),
          flush=True)
    return dict(paths=paths, timings=timings,
                inputs=dict(sig=sig, xs=xs, want=want_sig))


# ---------------------------------------------------------------------------
# Phase 5, continued: B17 composed into a whole Miller loop
# ---------------------------------------------------------------------------

def run_b17_composition(args, dev):
    """One whole packed Miller loop over slice 2's pairs (2·LANES lanes: the
    (pk, H) and (−G1, sig) pairs of ``verify_batch_pallas``) through B17
    against B4 and B5 (all on the lane-group engine of tower_group.cuh,
    B17 their schedules cut at the line):
    on each of the 63 bits of |x| after the first ``p_dbl_step`` then
    ``p_f_sqr_fold``, on its five 1-bits ``p_add_step`` then ``p_f_fold``
    (136 launches, counted). f and T equal the B4/B5 loop's bit for bit,
    and f equals ``miller_loop_packed``'s; both loops timed in turns
    (fused, split, split, fused) with CUDA events."""
    import torch
    from threshold_crypto_tpu_torch.device import cuda_tower as ctw
    from threshold_crypto_tpu_torch.device import packed as pk
    from threshold_crypto_tpu_torch.device import pairing as dpr
    from threshold_crypto_tpu_torch.ops import threshold as tops

    pk_aff, h_aff, sig_aff = args
    neg_gen = tops._neg_gen_g1((pk_aff[2].shape[0],), dev)
    P = pk.pack(dpr._flatten_aff(tops._pair2(pk_aff, neg_gen))[0])
    Q = pk.pack(dpr._flatten_aff(tops._pair2(h_aff, sig_aff))[0])
    n = P.shape[1]

    def start():
        return pk.packed_one12(n, dev), torch.cat([Q, pk.packed_one2(n, dev)])

    def fused():
        f, T = start()
        for bit in dpr.X_BITS[1:]:
            f, T = ctw.p_dbl_fold(f, T, P)
            if bit:
                f, T = ctw.p_add_fold(f, T, Q, P)
        return f, T

    def split():
        f, T = start()
        for bit in dpr.X_BITS[1:]:
            T, line = ctw.p_dbl_step(T, P)
            f = ctw.p_f_sqr_fold(f, line)
            if bit:
                T, line = ctw.p_add_step(T, Q, P)
                f = ctw.p_f_fold(f, line)
        return f, T

    reset_counts()
    f_split, T_split = split()
    torch.cuda.synchronize()
    launches = read_counts()
    bits = dpr.X_BITS[1:]
    expect = {"dbl_step": len(bits), "f_sqr_fold": len(bits),
              "add_step": sum(bits), "f_fold": sum(bits)}
    if {k: v for k, v in launches.items() if v} != expect:
        fail(f"B17 composition: launches {launches}, expected {expect}")
    f_fused, T_fused = fused()
    if not (torch.equal(f_split, f_fused) and torch.equal(T_split, T_fused)
            and torch.equal(f_split, dpr.miller_loop_packed(P, Q))):
        fail("B17 composition: f or T differs from the B4/B5 Miller loop")
    turns = [(what, timed_once(fn)[1]) for what, fn in (
        ("fused", fused), ("split", split), ("split", split),
        ("fused", fused))]
    ms = {w: statistics.mean(t for v, t in turns if v == w)
          for w in ("fused", "split")}
    print(f"B17 composition at {n} lanes: 63 x (dbl_step, f_sqr_fold) and "
          f"5 x (add_step, f_fold), {sum(expect.values())} launches; f and "
          f"T equal the B4/B5 loop's bit for bit, f equals "
          f"miller_loop_packed's; in turns (fused, split, split, fused) "
          f"{[round(t, 3) for _, t in turns]} ms: split {ms['split']:.3f} ms "
          f"against fused {ms['fused']:.3f} ms "
          f"({ms['split'] / ms['fused']:.2f}x)", flush=True)
    return dict(launches=launches, lanes=n, split_ms=ms["split"],
                fused_ms=ms["fused"], turns_ms=turns)


# ---------------------------------------------------------------------------
# Phase 10: slice 7, the DKG at a 256-node committee
# ---------------------------------------------------------------------------

def dkg_launches(n, t):
    """Launches per stage of one ``dkg_call`` for n nodes at threshold t:
    every ladder over affine points lifted with one B2 and 4 B1, its
    1P..15P table (14 B10) and one B13 per ``LADDER_CHUNK`` lanes; each
    fold level one B19; ``G1.eq`` 3 B1.

    commit: the npos fixed-base ladders; rows: t products for the powers
    and one for the coefficient × power grid; row commitments: the powers,
    their canonical form, n(t+1)² ladders over the commitment and a fold
    of ⌈log₂(t+1)⌉ levels; value commitments: the powers of x and y (2t),
    the stacked scalars and their canonical form (2), n·npos ladders and a
    fold of ⌈log₂ npos⌉ levels; row check: the rows' canonical form, their
    n(t+1) commitments and the comparison; value check: the powers of y,
    the row sums' product, their canonical form, n commitments and the
    comparison."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    npos = (t + 1) * (t + 2) // 2

    def ladders(lanes, muls, chunked=True, folds=0):
        steps = -(-lanes // ccv.LADDER_CHUNK) if chunked else 1
        return {"mont_mul": muls + 4, "mont_pow": 1, "g1_madd": 14,
                "g1_step4": steps, "g1_fold_level": folds}

    return {
        "commit": ladders(npos, 0, chunked=False),
        "rows": {"mont_mul": t + 1, "mont_pow": 0, "g1_madd": 0,
                 "g1_step4": 0, "g1_fold_level": 0},
        "row commitments": ladders(n * (t + 1) ** 2, t + 1,
                                   folds=_levels(t + 1)),
        "value commitments": ladders(n * npos, 2 * t + 2,
                                     folds=_levels(npos)),
        "row check": ladders(n * (t + 1), 1 + 3, chunked=False),
        "value check": ladders(n, t + 2 + 3, chunked=False),
    }


def dkg_inputs(dev, n=None, t=None, zero_pos=None):
    """One dealer's symmetric bivariate polynomial of degree t from
    DKG_SEED (coefficient zero_pos, by default DKG_ZERO_POS, set to 0), as
    canonical and Montgomery limbs; nodes x = 1..n; node 1 the checker
    (y = 1)."""
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host.params import R
    from threshold_crypto_tpu_torch.ops import fr as frops

    n, t = n or DKG_N, t or DKG_T
    zero_pos = DKG_ZERO_POS if zero_pos is None else zero_pos
    rnd = random.Random(DKG_SEED)
    coeffs = [rnd.randrange(R) for _ in range((t + 1) * (t + 2) // 2)]
    coeffs[zero_pos] = 0
    return dict(coeffs=coeffs, t=t, n=n, zero_pos=zero_pos,
                plain=dcv.fr_limbs_from_ints(coeffs, dev),
                mont=frops.fr_to_device(coeffs, dev),
                xs=frops.fr_to_device(range(1, n + 1), dev),
                ys=frops.fr_to_device([1] * n, dev))


def dkg_row_check(rows, rowc, t):
    """bool[n, t+1]: every node's row commitments equal the commitments of
    its own row (the protocol's ``commit.row(m) == row.commitment()``)."""
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.ops import fr as frops
    from threshold_crypto_tpu_torch.ops import threshold as tops

    own = tops.commit_batch(frops.fr_to_plain(rows).reshape(
        -1, rows.shape[-1]))
    return dcv.G1.eq(rowc, dcv.tree_map(
        lambda a: a.reshape(rows.shape[0], t + 1, a.shape[-1]), own))


def dkg_value_check(rows, ev, ys, t, tamper=None):
    """bool[n]: each value f(x_m, y_m) (node m's row at y_m; with
    ``tamper`` = lane, that lane's value plus one) commits to the
    commitment's C(x_m, y_m) (``commit.evaluate(m, s) == val·G1``)."""
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.ops import fr as frops
    from threshold_crypto_tpu_torch.ops import threshold as tops

    spow = tops.powers_batch(ys, t)                          # [n, t+1]
    vals = frops.sum_leading(mont.mul(mont.FR, rows, spow).movedim(1, 0))
    if tamper is not None:
        vals[tamper] = mont.add(mont.FR, vals[tamper],
                                mont.one(mont.FR, (), vals.device))
    return dcv.G1.eq(ev, tops.commit_batch(frops.fr_to_plain(vals)))


def dkg_call(inp, after=None):
    """One dealing, dealt and checked: the four DKG ops, then the nodes'
    row and value checks, synchronised. ``after(stage)`` runs after each
    of the six stages (``dkg_launches``' keys). Returns (outputs,
    seconds)."""
    import torch
    from threshold_crypto_tpu_torch.ops import threshold as tops
    from threshold_crypto_tpu_torch.utils import trace

    t, xs, ys = inp["t"], inp["xs"], inp["ys"]
    done = after or (lambda stage: None)

    def stage(name, fn, *args):
        with trace.span(f"dkg {name}"):
            out = fn(*args)
        done(name)
        return out

    torch.cuda.synchronize()
    t0 = time.time()
    commit = stage("commit", tops.bivar_commit_batch, inp["plain"])
    rows = stage("rows", tops.bivar_row_batch, inp["mont"], xs, t)
    rowc = stage("row commitments", tops.bivar_commit_row_batch, commit, xs,
                 t)
    ev = stage("value commitments", tops.bivar_commit_eval_batch, commit,
               xs, ys, t)
    row_ok = stage("row check", dkg_row_check, rows, rowc, t)
    val_ok = stage("value check", dkg_value_check, rows, ev, ys, t)
    torch.cuda.synchronize()
    return (dict(commit=commit, rows=rows, rowc=rowc, ev=ev, row_ok=row_ok,
                 val_ok=val_ok), time.time() - t0)


def bivar_host(coeffs, t, x, y):
    """f(x, y) mod r on the host."""
    from threshold_crypto_tpu_torch.host.params import R
    from threshold_crypto_tpu_torch.poly import coeff_pos

    return sum(coeffs[coeff_pos(i, j)] * pow(x, i, R) * pow(y, j, R)
               for i in range(t + 1) for j in range(t + 1)) % R


def row_host(coeffs, t, x):
    """Node x's row on the host: Σ_j c[pos(i, j)]·x^j mod r, per i."""
    from threshold_crypto_tpu_torch.host.params import R
    from threshold_crypto_tpu_torch.poly import coeff_pos

    return [sum(coeffs[coeff_pos(i, j)] * pow(x, j, R)
                for j in range(t + 1)) % R for i in range(t + 1)]


def run_dkg(dev, card):
    """Slice 7: one dealer's part of the DKG at DKG_N nodes, threshold
    DKG_T (N = 3t + 1): ``bivar_commit_batch`` (npos = (t+1)(t+2)/2
    lanes), ``bivar_row_batch`` and ``bivar_commit_row_batch`` for x =
    1..N, ``bivar_commit_eval_batch`` for the pairs (m, 1) (node 1 checking
    the values the N nodes sent it), then the nodes' checks on the card.

    Checks: the commitment equals host mul on DKG_SAMPLE sampled
    coefficients and on the zero one (infinity); four sampled rows equal
    Python-int Horner mod r; every row commitment equals the commitment
    of its node's row, and two nodes' equal the host's G1·row; every value
    commitment equals f(m, 1)·G1, three of them the host's, and a value
    tampered with is rejected on its lane only; launches per stage equal
    ``dkg_launches``. Then the median of 3 whole calls, the kernel share,
    a stage split, and the B13 launches of one call each timed beside its
    bound (``ladder_bound`` on its digits)."""
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.ops import fr as frops

    t0 = time.time()
    inp = dkg_inputs(dev)
    n, t, coeffs = inp["n"], inp["t"], inp["coeffs"]
    npos = len(coeffs)
    print(f"inputs: degree {t}, {npos} coefficients (coefficient "
          f"{DKG_ZERO_POS} zero), {n} nodes, built in "
          f"{time.time() - t0:.1f} s", flush=True)

    per_stage = {}

    def count(stage):
        per_stage[stage] = read_counts()
        reset_counts()

    reset_counts()
    out, first_s = dkg_call(inp, after=count)
    expect = dkg_launches(n, t)
    for stage, want in expect.items():
        got = {k: v for k, v in per_stage[stage].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            fail(f"dkg {stage}: launches {got}, expected {want}")
    launches = {k: sum(c[k] for c in per_stage.values())
                for k in per_stage["commit"]}
    print(f"dkg first call {first_s:.2f} s; launches per stage "
          f"{ {st: {k: v for k, v in c.items() if v} for st, c in per_stage.items()} }",
          flush=True)

    # 1. the commitment against the host oracle
    rnd = random.Random(DKG_SEED + 1)
    sample = sorted(set(rnd.sample(range(npos), DKG_SAMPLE))
                    | {DKG_ZERO_POS})
    if host_points(dcv.G1, out["commit"], sample) != [
            hcv.G1.mul(hcv.G1.generator, coeffs[i]) for i in sample] or \
            host_points(dcv.G1, out["commit"], [DKG_ZERO_POS]) != [None]:
        fail("dkg: the commitment differs from host mul")
    # 2. sampled rows against Python-int Horner
    rows_host = {m: row_host(coeffs, t, m + 1) for m in DKG_ROWS_SAMPLE}
    for m, want in rows_host.items():
        if frops.fr_from_device(out["rows"][m]) != want:
            fail(f"dkg: node {m + 1}'s row differs from the host's")
    # 3. row commitments: every lane against the node's own row, two nodes
    #    against the host
    if not bool(out["row_ok"].all()):
        bad = (~out["row_ok"]).nonzero()[:4].tolist()
        fail(f"dkg: row commitments differ from the rows' at {bad}")
    for m in DKG_HOST_NODES:
        node = dcv.tree_map(lambda a: a[m], out["rowc"])
        if host_points(dcv.G1, node, range(t + 1)) != [
                hcv.G1.mul(hcv.G1.generator, c) for c in rows_host[m]]:
            fail(f"dkg: node {m + 1}'s row commitments differ from the "
                 f"host's")
    # 4. value commitments: every lane, three against the host, one
    #    tampered value rejected on its lane only
    if not bool(out["val_ok"].all()):
        fail("dkg: a value commitment differs from f(m, 1)*G1")
    lanes = (0, DKG_TAMPERED, n - 1)
    if host_points(dcv.G1, out["ev"], lanes) != [
            hcv.G1.mul(hcv.G1.generator, bivar_host(coeffs, t, m + 1, 1))
            for m in lanes]:
        fail("dkg: value commitments differ from the host's")
    bad = dkg_value_check(out["rows"], out["ev"], inp["ys"], t,
                          tamper=DKG_TAMPERED)
    if (~bad).nonzero().flatten().tolist() != [DKG_TAMPERED]:
        fail("dkg: the tampered value was not rejected on its lane alone")
    print(f"dkg checks: the commitment equals host mul on {len(sample)} "
          f"sampled coefficients (the zero one at infinity); rows of nodes "
          f"{[m + 1 for m in DKG_ROWS_SAMPLE]} equal host Horner; all "
          f"{n * (t + 1)} row commitments equal their rows' commitments, "
          f"nodes {[m + 1 for m in DKG_HOST_NODES]} the host's; all {n} "
          f"value commitments equal f(m, 1)*G1 (3 the host's), the value "
          f"tampered on lane {DKG_TAMPERED} is rejected there only",
          flush=True)

    times = []
    for _ in range(3):
        o, secs = dkg_call(inp)
        if not (bool(o["row_ok"].all()) and bool(o["val_ok"].all())):
            fail("dkg: a timed call failed its checks")
        times.append(secs)
    wall = statistics.median(times)
    print(f"dkg at N = {n}, t = {t}: median {wall:.3f} s of "
          f"{[round(x, 3) for x in times]} -> {1 / wall:.3f} dealings "
          f"dealt and checked per second", flush=True)
    spans = []
    with kernel_event_timer(spans):
        _, kwall = dkg_call(inp)
    kernel_s, per_kernel = kernel_split("dkg", spans, kwall)
    stages = []
    with stage_timer(stages):
        _, swall = dkg_call(inp)
    split = print_split("dkg", stages, swall)

    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    b13, step4 = [], ccv.p_step4

    def timed_step4(g2, acc, table, digits):
        out, ms = timed_once(step4, g2, acc, table, digits)
        b13.append((digits.shape[1], ms,
                    ladder_bound(g2, "step4", digits, card)[0]))
        return out

    ccv.p_step4 = timed_step4
    try:
        dkg_call(inp)
    finally:
        ccv.p_step4 = step4
    b13_ms, b13_bound = sum(x[1] for x in b13), sum(x[2] for x in b13)
    print(f"dkg B13: {len(b13)} launches over "
          f"{sum(x[0] for x in b13)} lanes ({[x[0] for x in b13]}) x 64 "
          f"digits, {b13_ms:.1f} ms ({[round(x[1], 2) for x in b13]}), "
          f"bound {b13_bound:.1f} ms (operations), "
          f"{b13_ms / b13_bound:.1f}x the bound", flush=True)
    return dict(launches=launches, launches_per_stage=per_stage,
                wall_s=wall, times_s=times, per_s=1 / wall,
                kernel_s=kernel_s, timed_wall_s=kwall, kernel_ms=per_kernel,
                split_ms=split, b13_ms=b13_ms, b13_bound_ms=b13_bound,
                b13_launches=b13)


def rlc_scalarwise_launches(n):
    """Launches of one ``verify_sig_shares_rlc`` call: per group one B15
    and the affine lift of the points (one B2; 4 B1 in G1, 6 in G2), a
    fold of ⌈log₂ n⌉ levels (one B19 each), then the affine sums and H
    and the megakernel check as in ``rlc_launches`` (3 B2, 16 B1, B4-B9,
    B18 and the easy part's B2)."""
    expect = dict(PALLAS_LAUNCHES)
    expect.update({"g1_step": 1, "g2_step": 1, "mont_pow": 2 + 4,
                   "g1_fold_level": _levels(n), "g2_fold_level": _levels(n),
                   "mont_mul": 4 + 6 + 16})
    return expect


def run_rlc_scalarwise(dev):
    """``verify_sig_shares_rlc`` (its MSMs as per-lane bit ladders, B15,
    and the fold) once on slice 3's batch, valid (accepted, launches
    against ``rlc_scalarwise_launches``) and with one signature replaced
    (rejected), each call timed."""
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import curve as dcv

    pk_aff, sig_aff, h_jac, _, _ = rlc_inputs(dev)
    r = ops.rlc_exponents(RLC_N, b"\x09" * 32, pk_aff=pk_aff,
                          sig_aff=sig_aff)
    reset_counts()
    ok, secs = timed_once(ops.verify_sig_shares_rlc, pk_aff, h_jac, sig_aff,
                          r)
    launches = read_counts()
    expect = rlc_scalarwise_launches(RLC_N)
    if {k: launches[k] for k in expect} != expect:
        fail(f"verify_sig_shares_rlc: launches {launches}, expected "
             f"{expect}")
    bad = dcv.tree_map(lambda a: a.clone(), sig_aff)
    for c in dcv.leaves(bad[:2]):
        c[7] = c[8]
    rejected, bad_ms = timed_once(ops.verify_sig_shares_rlc, pk_aff, h_jac,
                                  bad, r)
    if not bool(ok) or bool(rejected):
        fail("verify_sig_shares_rlc: the valid batch was rejected or the "
             "batch with one sig replaced accepted")
    spans = []
    with kernel_event_timer(spans):
        ok, kwall = timed_once(ops.verify_sig_shares_rlc, pk_aff, h_jac,
                               sig_aff, r)
    if not bool(ok):
        fail("verify_sig_shares_rlc: the timed call rejected the batch")
    kernel_s, per_kernel = kernel_split("verify_sig_shares_rlc", spans,
                                        kwall / 1e3)
    b15 = per_kernel["g1_step"] + per_kernel["g2_step"]
    print(f"verify_sig_shares_rlc: B15 {b15:.1f} ms of {kwall:.1f} ms "
          f"({100 * b15 / kwall:.1f} %)", flush=True)
    print(f"verify_sig_shares_rlc at N = {RLC_N}: accepts the valid batch "
          f"({secs / 1e3:.3f} s) and rejects the one with a replaced "
          f"signature ({bad_ms / 1e3:.3f} s); launches per call "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return dict(launches=launches, wall_s=secs / 1e3, kernel_s=kernel_s,
                timed_wall_s=kwall / 1e3, kernel_ms=per_kernel, b15_ms=b15)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Slice 8: the public API at N = 256, t = 85, against the batch ops
# ---------------------------------------------------------------------------

def api_host():
    """The host half of slice 8 through the public API: keys from a seeded
    ChaChaRng, API_N signature shares, the RLC share check valid and with
    one share replaced, two disjoint (t + 1)-share combines, threshold
    decryption over t + 1 verified shares, and a serde and codec round
    trip of every public type. Returns what the card half compares."""
    import threshold_crypto_tpu_torch as tc
    from threshold_crypto_tpu_torch import codec_impl
    from threshold_crypto_tpu_torch.poly import (BivarCommitment, BivarPoly,
                                                 Commitment, Poly)
    from threshold_crypto_tpu_torch.utils.rng import ChaChaRng

    rng = ChaChaRng.from_seed(API_SEED)
    times = {}

    def timed(label, fn, *args):
        t0 = time.time()
        out = fn(*args)
        times[label] = times.get(label, 0.0) + time.time() - t0
        return out

    if tc.get_backend().name != "bls12_381":
        fail(f"slice 8: backend {tc.get_backend().name}, not bls12_381")
    sks = timed("keys", tc.SecretKeySet.random, API_T, rng)
    pks = timed("keys", sks.public_keys)
    keys = timed("keys", lambda: [sks.secret_key_share(i)
                                  for i in range(API_N)])
    pk_shares = timed("public key shares", lambda: [
        pks.public_key_share(i) for i in range(API_N)])
    if [k.public_key_share() for k in keys[:4]] != pk_shares[:4]:
        fail("slice 8: public key shares of the set and of the keys differ")
    shares = timed("sign", lambda: {i: keys[i].sign(API_MSG)
                                    for i in range(API_N)})
    bad = dict(shares)
    bad[API_REPLACED] = shares[API_REPLACED + 1]
    rlc_valid = timed("verify_signature_shares", pks.verify_signature_shares,
                      shares, API_MSG, ChaChaRng.from_seed(bytes(32)))
    rlc_bad = timed("verify_signature_shares", pks.verify_signature_shares,
                    bad, API_MSG, ChaChaRng.from_seed(bytes(32)))
    if (rlc_valid, rlc_bad) != (True, False):
        fail(f"verify_signature_shares: valid {rlc_valid}, one share "
             f"replaced {rlc_bad}")
    first = list(range(API_T + 1))
    second = list(range(API_T + 1, 2 * (API_T + 1)))
    sig = timed("combine_signatures", pks.combine_signatures,
                {i: shares[i] for i in first})
    sig2 = timed("combine_signatures", pks.combine_signatures,
                 {i: shares[i] for i in second})
    master = sks.secret_key()
    if sig.to_bytes() != sig2.to_bytes() or sig != master.sign(API_MSG):
        fail("combine_signatures: two disjoint subsets differ, or differ "
             "from the master key's signature")
    if not timed("verify", pks.public_key().verify, sig, API_MSG):
        fail("the master key rejects the combined signature")

    ct = timed("encrypt", pks.public_key().encrypt, API_PLAINTEXT, rng)
    dec = {}
    for i in first:
        d = timed("decrypt_share", keys[i].decrypt_share, ct)
        if d is None or not timed("verify_decryption_share",
                                  pk_shares[i].verify_decryption_share,
                                  d, ct):
            fail(f"decryption share {i} missing or rejected")
        dec[i] = d
    if timed("decrypt", pks.decrypt, dec, ct) != API_PLAINTEXT:
        fail("threshold decryption gives another plaintext")
    tampered = tc.Ciphertext(ct.u, bytes([ct.v[0] ^ 1]) + ct.v[1:], ct.w)
    if tampered.verify() or keys[0].decrypt_share(tampered) is not None:
        fail("a tampered ciphertext passed")

    def round_trip():
        poly = Poly.random(3, rng)
        bivar = BivarPoly.random(2, rng).commitment()
        objs = [(tc.PublicKey, master.public_key()),
                (tc.PublicKeyShare, pk_shares[7]), (tc.Signature, sig),
                (tc.SignatureShare, shares[7]),
                (tc.DecryptionShare, dec[0]), (tc.Ciphertext, ct),
                (tc.PublicKeySet, pks), (Commitment, poly.commitment()),
                (BivarCommitment, bivar)]
        for cls, obj in objs:
            if tc.deserialize(cls, tc.serialize(obj)) != obj:
                fail(f"serde round trip of {cls.__name__}")
        for cls, obj in ((tc.SecretKey, master), (tc.SecretKeyShare, keys[9]),
                         (tc.SecretKeySet, sks), (Poly, poly)):
            if tc.deserialize(cls, tc.serialize(tc.SerdeSecret(obj))) != obj:
                fail(f"serde round trip of SerdeSecret({cls.__name__})")
        for cls, obj in objs[:1] + objs[2:3] + objs[4:7]:
            if codec_impl.decode(cls, codec_impl.encode(obj)) != obj:
                fail(f"codec round trip of {cls.__name__}")
        return len(objs) + 4

    n_types = timed("serde and codec", round_trip)
    msgs = [b"chip_smoke slice 8 message %d" % i for i in range(API_N)]
    msg_sigs = timed("sign", lambda: [master.sign(m) for m in msgs])
    return dict(sks=sks, pks=pks, keys=keys, pk_shares=pk_shares,
                shares=shares, bad=bad, rlc=(rlc_valid, rlc_bad),
                first=first, sig=sig, ct=ct, tampered=tampered, dec=dec,
                msgs=msgs, msg_sigs=msg_sigs, master=master,
                host_s=times, n_types=n_types)


def run_api(dev):
    """Slice 8: the public API at N = API_N, t = API_T (``api_host``), then
    the same values through the card's batch ops, their points lifted with
    ``device.pairing``'s ``g1_affine_from_host`` / ``g2_affine_from_host``:
    ``rlc_exponents`` and ``verify_sig_shares_rlc_pallas`` give the host's
    verdicts (valid, one share replaced); ``combine_batch`` on each path
    gives ``combine_signatures``' bytes; ``decrypt_share_batch`` gives the
    host's decryption shares byte for byte; ``ciphertext_verify_batch``
    accepts the ciphertext and rejects the tampered one;
    ``verify_with_hash_batch`` accepts API_N messages signed by the master
    key. Each op's launches are counted from 0 and its kernels must have
    launched; host and card seconds are reported apart."""
    import torch
    import threshold_crypto_tpu_torch as tc
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import pairing as dpr
    from threshold_crypto_tpu_torch.ops import fr as frops

    t0 = time.time()
    h = api_host()
    host_s = time.time() - t0
    print(f"host, the public API: {API_N} keys of a degree-{API_T} "
          f"polynomial, {API_N} signature shares, verify_signature_shares "
          f"valid {h['rlc'][0]} and with share {API_REPLACED} replaced "
          f"{h['rlc'][1]}, two disjoint {API_T + 1}-share combines equal "
          f"(and equal the master key's signature, which verifies), "
          f"{API_T + 1} decryption shares verified and decrypted, a "
          f"tampered ciphertext refused, serde and codec round trips of "
          f"{h['n_types']} types; {host_s:.1f} s: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in h["host_s"].items()), flush=True)

    b = tc.get_backend()
    card_s, launches = {}, {}

    def on_card(label, fn, *args, **kw):
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        card_s[label] = card_s.get(label, 0.0) + time.time() - t1
        counts = read_counts()
        missing = [k for k in API_KERNELS.get(label, ()) if not counts[k]]
        if missing:
            fail(f"slice 8 {label}: no launch of {missing}")
        if counts["lagrange_rowprod"]:
            fail(f"slice 8 {label}: B14 launched under the matrix bound")
        per = launches.setdefault(label, dict.fromkeys(counts, 0))
        for k, v in counts.items():
            per[k] += v
        return out

    def lift(label, fn, pts):
        return on_card(label, fn, pts, device=dev)

    n, used = API_N, h["first"]
    pk_aff = lift("lift", dpr.g1_affine_from_host,
                  [p.pk.el.v for p in h["pk_shares"]])
    sig_aff = lift("lift", dpr.g2_affine_from_host,
                   [h["shares"][i].sig.el.v for i in range(n)])
    bad_aff = lift("lift", dpr.g2_affine_from_host,
                   [h["bad"][i].sig.el.v for i in range(n)])
    h_jac = on_card("lift", dcv.G2.from_host_affine,
                    [tc.hash_g2(API_MSG).v], device=dev)

    def rlc(sigs):
        r = ops.rlc_exponents(n, API_SEED, pk_aff=pk_aff, sig_aff=sigs,
                              h_jac=h_jac)
        return bool(ops.verify_sig_shares_rlc_pallas(pk_aff, h_jac, sigs, r))

    verdicts = (on_card("rlc", rlc, sig_aff), on_card("rlc", rlc, bad_aff))
    if verdicts != h["rlc"]:
        fail(f"verify_sig_shares_rlc_pallas {verdicts} differs from "
             f"verify_signature_shares {h['rlc']}")

    xs = frops.fr_to_device([tc.into_fr_plus_1(i) for i in used], dev)
    shares_jac = on_card("lift", dcv.G2.from_host_affine,
                         [h["shares"][i].sig.el.v for i in used], device=dev)
    want = h["sig"].to_bytes()
    for path in ("pallas", "scalarwise", "bitscan"):
        pt, ok = on_card(f"combine {path}", ops.combine_batch, dcv.G2,
                         shares_jac, xs, path=path)
        if not bool(ok) or b.G2(one_point(dcv.G2, pt)).to_compressed() \
                != want:
            fail(f"combine_batch(G2, {path}) differs from "
                 f"combine_signatures")

    ct = h["ct"]
    m = len(used)
    u_jac = tile_to(dcv.G1.from_host_affine([ct.u.v], device=dev), m)
    sk_plain = dcv.fr_limbs_from_ints([h["keys"][i].sk.fr for i in used],
                                      dev)
    d = on_card("decrypt shares", ops.decrypt_share_batch, u_jac, sk_plain)
    got = [b.G1(p).to_compressed() for p in dcv.G1.to_host_affine(d)]
    if got != [h["dec"][i].to_bytes() for i in used]:
        fail("decrypt_share_batch differs from decrypt_share")

    u_aff = dpr.g1_affine_from_host([ct.u.v, ct.u.v], device=dev)
    w_aff = dpr.g2_affine_from_host([ct.w.v, ct.w.v], device=dev)
    huv_aff = dpr.g2_affine_from_host(
        [tc.hash_g1_g2(ct.u, ct.v).v,
         tc.hash_g1_g2(ct.u, h["tampered"].v).v], device=dev)
    ct_ok = on_card("ciphertext check", ops.ciphertext_verify_batch, u_aff,
                    w_aff, huv_aff)
    if ct_ok.tolist() != [True, False]:
        fail(f"ciphertext_verify_batch {ct_ok.tolist()}: the ciphertext and "
             f"its tampered copy should give [True, False]")

    mpk_aff = tile_to(dpr.g1_affine_from_host(
        [h["master"].public_key().el.v], device=dev), n)
    msig_aff = dpr.g2_affine_from_host([s.el.v for s in h["msg_sigs"]],
                                       device=dev)
    vwh = on_card("verify_with_hash_batch", ops.verify_with_hash_batch,
                  mpk_aff, h["msgs"], msig_aff)
    if not vwh.all():
        fail(f"verify_with_hash_batch rejects "
             f"{int((~vwh).sum())} of {n} master-key signatures")

    total = {}
    for per_op in launches.values():
        for k, v in per_op.items():
            total[k] = total.get(k, 0) + v
    card_total = sum(card_s.values())
    print(f"card, the batch ops on the same values: RLC verdicts "
          f"{verdicts} equal the host's; combine_batch on pallas, "
          f"scalarwise and bitscan equals combine_signatures' bytes; "
          f"decrypt_share_batch equals the {m} host decryption shares; "
          f"ciphertext_verify_batch [True, False]; verify_with_hash_batch "
          f"accepts all {n}; {card_total:.2f} s: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in card_s.items()), flush=True)
    print(f"slice 8 wall: host {host_s:.1f} s, card {card_total:.2f} s; "
          f"launches " + "; ".join(
              f"{op}: " + ", ".join(f"{k} {v}" for k, v in per.items() if v)
              for op, per in launches.items()), flush=True)
    return dict(launches=total, launches_by_op=launches, host_s=host_s,
                card_s=card_total, card_by_op=card_s,
                host_by_step=h["host_s"])


# ---------------------------------------------------------------------------
# Slice 9: the parallel layer (ranks as child processes) and the device-layer
# leftovers
# ---------------------------------------------------------------------------

def sign_inputs(dev):
    """Slice 1's lanes (``build_inputs``) on the card, with a secret key a
    lane from the seed: (pk, H, sig) affine, H Jacobian, sk, the mask."""
    import torch
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import pairing as dpr
    from threshold_crypto_tpu_torch.host.params import R

    pk, h, sig, want = build_inputs()
    h_aff = dpr.g2_affine_from_host(h, device=dev)
    rnd = random.Random(SEED + 9)
    sk = dcv.fr_limbs_from_ints([rnd.randrange(R) for _ in range(LANES)],
                                dev)
    return (dpr.g1_affine_from_host(pk, device=dev), h_aff,
            dpr.g2_affine_from_host(sig, device=dev),
            ops.affine_to_jacobian(dcv.G2, h_aff), sk,
            torch.tensor(want, device=dev))


def parallel_rank(mesh):
    """One rank of slice 9's world (``multihost.run_world`` runs it in a
    child process). Every rank builds the whole batches, the counts are
    set to 0, then every sharded path runs once: the RLC check (exponents
    of the whole batch, then the blocks; both MSM forms; the valid batch
    and one signature replaced) with its aggregates, the combine (and a
    duplicate x), sign and verify; the counts are read. Then the checks
    against the single-device ops and the host, and the timed calls.
    Returns JSON data; raises on any mismatch."""
    import torch
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.host import curve as hcv
    from threshold_crypto_tpu_torch.ops import threshold as tops
    from threshold_crypto_tpu_torch.parallel import mesh as pm
    from threshold_crypto_tpu_torch.parallel import sharded

    dev, tag = mesh.device, f"world {mesh.world} ({mesh.backend})"
    t0 = time.time()
    pk_aff, sig_aff, h_jac, _, _ = rlc_inputs(dev)
    bad = dcv.tree_map(lambda a: a.clone(), sig_aff)
    for c in dcv.leaves(bad[:2]):
        c[PAR_REPLACED] = c[PAR_REPLACED + 1]      # the next key's signature
    inp = combine_shares(dev)
    c_sig, xs = inp["sig"], inp["xs"]
    c_want = hcv.G2.mul(inp["h_host"], inp["coeffs"][0])
    s_pk, s_h, s_sig, s_hjac, s_sk, s_want = sign_inputs(dev)
    torch.cuda.synchronize()
    print(f"{tag} rank {mesh.rank}: inputs (the whole batches) in "
          f"{time.time() - t0:.1f} s", flush=True)

    def rlc_blocks(s, seed):
        r = ops.rlc_exponents(RLC_N, seed, pk_aff=pk_aff, sig_aff=s)
        return r, pm.shard_batch(mesh, (pk_aff, s, r))

    reset_counts()
    verdicts, aggregates = {}, {}
    for msm in ("shared", "scalarwise"):
        for what, s in (("valid", sig_aff), ("tampered", bad)):
            r, (pk_m, s_m, r_m) = rlc_blocks(s, PAR_SEED)
            verdicts[f"{msm} {what}"] = bool(sharded.sharded_verify_rlc(
                mesh, pk_m, h_jac, s_m, r_m, msm=msm))
            if what == "valid":
                aggregates[msm] = (r, sharded.sharded_rlc_aggregate(
                    mesh, pk_m, s_m, r_m, msm=msm))
    pt, ok = sharded.sharded_combine(mesh, dcv.G2,
                                     pm.shard_batch(mesh, c_sig), xs)
    dup = xs.clone()
    dup[-1] = dup[0]
    _, ok_dup = sharded.sharded_combine(mesh, dcv.G2,
                                        pm.shard_batch(mesh, c_sig), dup)
    sig_m = sharded.sharded_sign(mesh, *pm.shard_batch(mesh, (s_hjac, s_sk)))
    mask_m = sharded.sharded_verify(mesh, *pm.shard_batch(
        mesh, (s_pk, s_h, s_sig)))
    torch.cuda.synchronize()
    launches = read_counts()
    missing = [k for k in PARALLEL_KERNELS if launches[k] < 1]
    if missing:
        fail(f"{tag} rank {mesh.rank}: kernels of the path not launched "
             f"{missing}: {launches}")

    # the checks, against the single-device ops and the host
    if verdicts != {"shared valid": True, "shared tampered": False,
                    "scalarwise valid": True, "scalarwise tampered": False}:
        fail(f"{tag}: sharded RLC verdicts {verdicts}")
    for msm, (r, (a_pk, a_sig)) in aggregates.items():
        if not torch.equal(r, ops.rlc_exponents(
                RLC_N, PAR_SEED, pk_aff=pk_aff, sig_aff=sig_aff,
                on_device=False)):
            fail(f"{tag}: exponents differ from the host stream")
        w_pk, w_sig = tops.rlc_aggregate_pallas(pk_aff, sig_aff, r)
        if (host_affine(a_pk, False), host_affine(a_sig, True)) != (
                host_affine(w_pk, False), host_affine(w_sig, True)):
            fail(f"{tag}: msm={msm} aggregate differs from the "
                 f"single-device rlc_aggregate_pallas")
    want_pt, want_ok = ops.combine_batch(dcv.G2, c_sig, xs)
    if not (bool(ok) and bool(want_ok)) or bool(ok_dup) or \
            not one_point(dcv.G2, pt) == one_point(dcv.G2, want_pt) == c_want:
        fail(f"{tag}: sharded_combine differs from combine_batch or the "
             f"host's H*f(0), or ok is wrong (ok {bool(ok)}, duplicate x "
             f"{bool(ok_dup)})")
    got_sig = pm.gather_batch(mesh, sig_m)
    want_sig = ops.sign_batch(s_hjac, s_sk)
    if not all(torch.equal(a, b) for a, b in zip(dcv.leaves(got_sig),
                                                dcv.leaves(want_sig))):
        fail(f"{tag}: sharded_sign differs from sign_batch")
    if not torch.equal(pm.gather_batch(mesh, mask_m), s_want):
        fail(f"{tag}: sharded_verify differs from the constructed mask")
    print(f"{tag} rank {mesh.rank}: RLC verdicts {verdicts}; both "
          f"aggregates equal the single-device rlc_aggregate_pallas, the "
          f"exponents the host stream; sharded_combine equals combine_batch "
          f"and the host's H*f(0), ok False with x duplicated; "
          f"sharded_sign equals sign_batch and sharded_verify the mask on "
          f"{LANES} lanes; launches {launches}", flush=True)

    # timing: the sharded call (msm="shared", exponents given) and, in a
    # world of one, the single-device call in turns with it
    r, (pk_m, s_m, r_m) = rlc_blocks(sig_aff, PAR_SEED)

    def call(fn, *args, **kw):
        torch.cuda.synchronize()
        t = time.time()
        if not bool(fn(*args, **kw)):
            fail(f"{tag}: a timed call rejected the valid batch")
        torch.cuda.synchronize()
        return time.time() - t

    sharded_call = (sharded.sharded_verify_rlc, mesh, pk_m, h_jac, s_m, r_m)
    single_call = (ops.verify_sig_shares_rlc_pallas, pk_aff, h_jac, sig_aff,
                   r)
    turns = {"sharded": [], "single": []}
    for i in range(PAR_TIMED):
        order = ("sharded", "single") if i % 2 == 0 else ("single",
                                                           "sharded")
        for what in order:
            if what == "single" and mesh.world > 1:
                continue
            args = sharded_call if what == "sharded" else single_call
            kw = {"msm": "shared"}
            if what == "single":
                kw["check_batch"] = RLC_CHECK_BATCH
            turns[what].append(call(*args, **kw))
    torch.cuda.synchronize()
    t = time.time()
    sharded.sharded_rlc_aggregate(mesh, pk_m, s_m, r_m, msm="shared")
    torch.cuda.synchronize()
    agg_s = time.time() - t
    return {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend,
            "launches": launches, "verdicts": verdicts,
            "sharded_s": turns["sharded"], "single_s": turns["single"],
            "aggregate_s": agg_s}


def run_parallel():
    """Slice 9's worlds: each rank a child process on the card
    (``multihost.run_world``); every rank must exit 0 in time."""
    import statistics as st

    from threshold_crypto_tpu_torch.parallel import multihost

    here = os.path.dirname(os.path.abspath(__file__))
    worlds = {}
    for n, backend in PAR_WORLDS:
        t0 = time.time()
        res = multihost.run_world("chip_smoke:parallel_rank", n,
                                  device="cuda", backend=backend,
                                  timeout_s=PAR_TIMEOUT_S, path=[here],
                                  echo=True)
        label = (f"world {n} over {backend}" if n == 1 else
                 f"world {n} over {backend}: {n} processes on one card, "
                 f"not a scaling figure")
        r0 = res[0]
        line = (f"sharded_verify_rlc at N = {RLC_N} (msm='shared', "
                f"exponents given), {label}: median "
                f"{st.median(r0['sharded_s']):.3f} s of "
                f"{[round(x, 3) for x in r0['sharded_s']]}; its aggregate "
                f"alone {r0['aggregate_s']:.3f} s")
        if r0["single_s"]:
            line += (f"; in turns, the single-device "
                     f"verify_sig_shares_rlc_pallas median "
                     f"{st.median(r0['single_s']):.3f} s of "
                     f"{[round(x, 3) for x in r0['single_s']]}")
        print(line + f" (the world's run {time.time() - t0:.1f} s with "
              f"start-up and inputs)", flush=True)
        worlds[n] = res
    return worlds


def run_leftovers(dev, combined, pair_args, mask):
    """Slice 9's device layer: ``DeviceCurve.msm`` at window 1 over slice
    6's shares and λ (equal to ``combine_batch(path="bitscan")`` and the
    host's H·f(0)), and ``multi_pairing`` over PAIR_N lanes of slice 1's
    pairs (its Fq12 is 1 exactly where ``pairing_check_pallas`` and the
    mask say so; PAIR_HOST_LANES lanes equal the host's multi_pairing);
    each counted on its own. mask: slice 1's output, equal to the
    constructed mask."""
    import torch
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import pairing as dpr
    from threshold_crypto_tpu_torch.device import tower as tw
    from threshold_crypto_tpu_torch.host import pairing as hpr
    from threshold_crypto_tpu_torch.ops import fr as frops
    from threshold_crypto_tpu_torch.ops import threshold as tops

    sig, xs, want = (combined["inputs"][k] for k in ("sig", "xs", "want"))
    lam = frops.fr_to_plain(frops.lagrange_coeffs_at_zero(xs)[0])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    pt = dcv.G2.msm(sig, lam, nbits=255, window=1)
    torch.cuda.synchronize()
    msm_s = time.time() - t0
    counts = {"DeviceCurve.msm": read_counts()}
    bitscan, _ = ops.combine_batch(dcv.G2, sig, xs, path="bitscan")
    if not one_point(dcv.G2, pt) == one_point(dcv.G2, bitscan) == want:
        fail("DeviceCurve.msm differs from combine_batch(bitscan) or the "
             "host's H*f(0)")

    pk_aff, h_aff, sig_aff = (_slice_aff(a, PAIR_N) for a in pair_args)
    neg = tops._neg_gen_g1((PAIR_N,), dev)
    p, q = tops._pair2(pk_aff, neg), tops._pair2(h_aff, sig_aff)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    f = dpr.multi_pairing(p, q)
    torch.cuda.synchronize()
    mp_s = time.time() - t0
    counts["multi_pairing"] = read_counts()
    verdict = tw.fq12_is_one(f)
    if not torch.equal(verdict, dpr.pairing_check_pallas(p, q)) or \
            not torch.equal(verdict, mask[:PAIR_N]):
        fail("multi_pairing's verdicts differ from pairing_check_pallas or "
             "the mask")
    def host(curve, pairs, k):      # pair k of the first lanes, on the host
        return curve.to_host_affine(ops.affine_to_jacobian(curve, dcv.tree_map(
            lambda a: a[k, :PAIR_HOST_LANES], pairs)))

    ps = [host(dcv.G1, p, k) for k in range(2)]
    qs = [host(dcv.G2, q, k) for k in range(2)]
    want_f = [hpr.multi_pairing([(ps[0][i], qs[0][i]), (ps[1][i], qs[1][i])])
              for i in range(PAIR_HOST_LANES)]
    got_f = tw.fq12_to_host_batch(dcv.tree_map(lambda a: a[:PAIR_HOST_LANES],
                                               f))
    if got_f != want_f:
        fail("multi_pairing differs from the host's Fq12")
    for what, kernels in LEFTOVER_KERNELS.items():
        missing = [k for k in kernels if counts[what][k] < 1]
        if missing:
            fail(f"{what}: kernels not launched {missing}")
    print(f"DeviceCurve.msm (G2, {COMBINE_N} lanes, window 1, 255 bits) "
          f"equals combine_batch(bitscan) and the host's H*f(0) "
          f"({msm_s:.3f} s, launches "
          f"{ {k: v for k, v in counts['DeviceCurve.msm'].items() if v} }); "
          f"multi_pairing on {PAIR_N} lanes x 2 pairs agrees with "
          f"pairing_check_pallas and the mask, and on {PAIR_HOST_LANES} "
          f"lanes with the host's Fq12 ({mp_s:.3f} s, launches "
          f"{ {k: v for k, v in counts['multi_pairing'].items() if v} })",
          flush=True)
    return dict(counts=counts, msm_s=msm_s, multi_pairing_s=mp_s)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from threshold_crypto_tpu_torch import _build
    from threshold_crypto_tpu_torch.device import mont

    t_start = time.time()
    phase("card")
    card_line = nvidia_smi("name,power.limit")
    print(card_line, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{props.multi_processor_count} SMs, max SM clock {clock_mhz} MHz",
          flush=True)
    card = {"sms": props.multi_processor_count, "clock_hz": clock_mhz * 1e6}

    phase("build")
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(_build.build_native)
        logs = _build.build()
        native_log = native.result()
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s (one nvcc per "
          f"source, all started together)", flush=True)
    abi = _build.native_library().tc_native_abi_version()
    print(f"host library: {native_log.strip().splitlines()[-1]} (beside "
          f"the nvcc builds), {os.path.basename(_build.native_path())}, ABI "
          f"version {abi}", flush=True)
    ptxas = {}
    for name in sorted(logs):
        ptxas.update(print_ptxas(name, logs[name]))

    phase("kernels against their plain versions (bit-exact)")
    rng = np.random.default_rng(SEED)
    widest_mul = 78 * LANES  # 13 Fq2 (39 Fq) products over 2 pairs
    results = dict(zip(("mont_mul", "mont_pow"),
                       check_mont(ptxas, rng, dev, card)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for name in TOWER_CHECKS:
        results[name] = check_tower(name, gen, dev, card)
    for name, n in CHECK_WIDTHS.items():
        at = check_tower(name, gen, dev, card, n)
        results[name].update(
            lanes_check_width=n, ms_check_width=at["ms"],
            plain_ms_check_width=at["plain_ms"],
            bound_ms_check_width=at["bound_ms"])
        if name not in GROUP_KERNELS:
            continue
        source, fn = GROUP_KERNELS[name]
        figures = ptxas[fn]
        results[name]["ptxas"] = dict(zip(
            ("registers", "stack_frame", "spill_stores", "spill_loads"),
            figures))
        print(f"{name} ({source} {fn}, lane-group engine): {figures[0]} "
              f"registers, {figures[1]} bytes stack frame, {figures[2]} "
              f"bytes spill stores, {figures[3]} bytes spill loads",
              flush=True)
        if any(figures[1:]):
            fail(f"{fn}: a stack frame or spills on the lane-group engine")
    results.update(check_b18(gen, dev, card, ptxas))
    source, fn = ENGINE_KERNEL
    figures = ptxas[fn]
    results["fq_engine"]["ptxas"] = dict(zip(
        ("registers", "stack_frame", "spill_stores", "spill_loads"), figures))
    print(f"fq_engine ({source} {fn}, the register engine): {figures[0]} "
          f"registers, {figures[1]} bytes stack frame, {figures[2]} bytes "
          f"spill stores, {figures[3]} bytes spill loads", flush=True)
    if any(figures[1:]):
        fail(f"{fn}: a stack frame or spills on the register engine")
    for g2 in (False, True):
        results["g2_madd" if g2 else "g1_madd"] = check_madd(g2, gen, dev,
                                                             card)
    for g2 in (False, True):
        results["g2_winacc" if g2 else "g1_winacc"] = check_winacc(
            g2, gen, dev, card)
    results["sha3_chunks"] = check_sha3(gen, dev, card)
    for kind in ("step4", "step"):
        for g2 in (False, True):
            results[f"g{1 + g2}_{kind}"] = check_ladder(g2, kind, gen, dev,
                                                         card)
    results["g1_step4"]["dkg_shape"] = check_ladder_dkg(gen, dev, card)
    for kind, source in (("step4", "ladder.cu"), ("step", "ladder.cu"),
                         ("winacc", "msm.cu"), ("madd", "msm.cu")):
        for g2 in (False, True):
            figures = ptxas[f"{kind}_kernel<{'Fq2' if g2 else 'Fq'}>"]
            results[f"g{1 + g2}_{kind}"]["ptxas"] = dict(zip(
                ("registers", "stack_frame", "spill_stores", "spill_loads"),
                figures))
            print(f"g{1 + g2}_{kind} ({source} {kind}_kernel): {figures[0]} "
                  f"registers, {figures[1]} bytes stack frame, {figures[2]} "
                  f"bytes spill stores, {figures[3]} bytes spill loads",
                  flush=True)
    torch.cuda.empty_cache()
    results["lagrange_rowprod"] = check_rowprod(dev, card)
    figures = ptxas["lagr_kernel"]
    results["lagrange_rowprod"]["ptxas"] = dict(zip(
        ("registers", "stack_frame", "spill_stores", "spill_loads"), figures))
    print(f"lagrange_rowprod (fr.cu lagr_kernel): {figures[0]} registers, "
          f"{figures[1]} bytes stack frame, {figures[2]} bytes spill stores, "
          f"{figures[3]} bytes spill loads", flush=True)
    product_ms = product_latency_ms(next(
        w for w in results["mont_pow"]["widths"]
        if w["lanes"] == 1 and w["field"] == "Fq"))
    print(f"one Fq product in series (B2's one-lane chain): "
          f"{1e3 * product_ms:.3f} us", flush=True)
    for g2 in (False, True):
        results.update(check_b16(g2, gen, dev, card, ptxas, product_ms))
    torch.cuda.empty_cache()
    results.update(check_b19(dev, gen, card, ptxas))

    old, new, pair_args = run_slices(dev)
    composed = run_b17_composition(pair_args, dev)
    if old["widest"] != {"mont_mul": widest_mul, "mont_pow": LANES}:
        fail(f"the kernel checks missed the path's widest launches "
             f"{old['widest']}")
    path_bound = sum(results[k]["bound_ms"] * new["launches"][k]
                     for k in TOWER_CHECKS if k != "fq_engine")
    print(f"the megakernel path: kernels {new['kernel_s']:.3f} s of "
          f"{new['timed_wall_s']:.3f} s; bound of its B4-B9 launches "
          f"{path_bound:.3f} ms", flush=True)

    phase(f"slice 3: the RLC path at N = {RLC_N} (ops.rlc_exponents -> "
          f"ops.verify_sig_shares_rlc_pallas)")
    rlc = run_rlc(dev, results)
    rlc_bound = sum(results[k]["bound_ms"] * rlc["launches"][k]
                    for k in ("g1_madd", "g2_madd", "g1_winacc", "g2_winacc",
                              "sha3_chunks"))
    print(f"the RLC path: kernels {rlc['kernel_s']:.3f} s of "
          f"{rlc['timed_wall_s']:.3f} s; bound of its B10-B12 launches "
          f"{rlc_bound:.3f} ms", flush=True)
    torch.cuda.empty_cache()

    phase(f"slice 4: ops.verify_with_hash_batch at {HASH_N} distinct "
          f"messages (device hash_g2: ChaCha, candidates, B2, B10 + B13)")
    hashed = run_hash(dev)
    torch.cuda.empty_cache()
    phase(f"slice 5: ops.encrypt_batch_pallas at {ENC_N} lanes (B10 + B13), "
          f"and msm_pallas(window=1) at {MSM1_N} (B15)")
    paths = {"hash": hashed, "encrypt": run_encrypt(dev),
             "msm1": run_msm1(dev)}
    torch.cuda.empty_cache()
    phase(f"slice 6: the threshold flows at t+1 = {COMBINE_N} "
          f"(ops.combine_batch on B14 and B11 / B15 / B16, sign, encrypt, "
          f"decrypt shares and their checks)")
    combined = run_combine(dev)
    torch.cuda.empty_cache()
    phase(f"slice 7: the DKG at N = {DKG_N}, t = {DKG_T} "
          f"(ops.bivar_commit_batch, bivar_row_batch, "
          f"bivar_commit_row_batch, bivar_commit_eval_batch on B1, B2, B10, "
          f"B13), and ops.verify_sig_shares_rlc at N = {RLC_N} (B15)")
    dkg = run_dkg(dev, card)
    torch.cuda.empty_cache()
    rlc_sw = run_rlc_scalarwise(dev)
    torch.cuda.empty_cache()
    phase(f"slice 8: the public API at N = {API_N}, t = {API_T} "
          f"(SecretKeySet, signature and decryption shares, combines, serde "
          f"and codec on the host), held against the batch ops on the card")
    api = run_api(dev)
    torch.cuda.empty_cache()
    phase(f"slice 9: the device-layer leftovers (DeviceCurve.msm at "
          f"{COMBINE_N} lanes, multi_pairing at {PAIR_N}) and the parallel "
          f"layer (sharded RLC at N = {RLC_N}, combine at t+1 = "
          f"{COMBINE_N}, sign / verify at {LANES}; worlds of 1 over nccl "
          f"and 2 over gloo on this card, each rank a child process)")
    leftovers = run_leftovers(dev, combined, pair_args, old["out"])
    del combined["inputs"]
    torch.cuda.empty_cache()
    worlds = run_parallel()

    kernels = []
    for mod, k in registry():
        res = results[k.name]
        # B1/B2: launches of slice 1, where they carry the path; B3-B9:
        # of slice 2 (B3's test entry has none on any path); B10-B12: of
        # slice 3; B13: of slice 4 (G2, the cofactor ladder) and 5 (G1);
        # B15: of the window-1 MSM; B14: of slice 6's G2 combine; B16: of
        # its bitscan combines; B17: of the composition check, the one run
        # that drives it. Every kernel's launches on the RLC, hash,
        # encrypt, combine and DKG paths beside them.
        path = (old if k.name.startswith("mont_") else
                rlc if k.name in RLC_KERNELS else
                paths[LADDER_KERNELS[k.name]] if k.name in LADDER_KERNELS
                else combined["paths"][COMBINE_KERNELS[k.name]]
                if k.name in COMBINE_KERNELS else
                composed if k.name in B17_KERNELS else new)
        entry = {
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": path["launches"][k.name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
            "lanes": res["lanes"], "check": "bit-exact", "card": card_line,
        }
        if k.name.startswith("mont_"):
            entry["launches_megakernel_path"] = new["launches"][k.name]
        entry["launches_rlc_path"] = rlc["launches"][k.name]
        entry["launches_hash_path"] = hashed["launches"][k.name]
        entry["launches_encrypt_path"] = paths["encrypt"]["launches"][k.name]
        entry["launches_combine_paths"] = {
            p: c["launches"][k.name] for p, c in combined["paths"].items()}
        entry["launches_dkg_path"] = dkg["launches"][k.name]
        entry["launches_rlc_scalarwise"] = rlc_sw["launches"][k.name]
        entry["launches_api_path"] = api["launches"][k.name]
        entry["launches_parallel_paths"] = {
            f"world {n}, rank {r['rank']}": r["launches"][k.name]
            for n, res in worlds.items() for r in res}
        entry["launches_device_leftovers"] = {
            what: c[k.name] for what, c in leftovers["counts"].items()}
        if "ms_with_fold" in res:
            entry["ms_with_fold"] = res["ms_with_fold"]
        if "ms_all_doubling" in res:
            entry["ms_all_doubling"] = res["ms_all_doubling"]
        if "digits" in res:
            entry["digits"] = res["digits"]
        if "plain_lanes" in res:
            entry["plain_lanes"] = res["plain_lanes"]
        for key in ("dkg_shape", "ptxas", "widths", "lanes_check_width",
                    "ms_check_width", "plain_ms_check_width",
                    "bound_ms_check_width", "latency_ms",
                    "product_latency_ms", "folds"):
            if key in res:
                entry[key] = res[key]
        if "accumulators" in res:
            entry["accumulators"] = res["accumulators"]
            entry["ms_other_accumulators"] = res["ms_other_accumulators"]
        kernels.append(entry)
    print(f"whole run {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
