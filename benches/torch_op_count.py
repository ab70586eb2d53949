"""Count the torch ops and kernel launches of one call of each path.

    python benches/torch_op_count.py

Runs ``threshold_crypto_tpu_torch.ops.verify_batch``,
``ops.verify_batch_pallas`` (the megakernel path), the RLC path
(``ops.rlc_exponents`` then ``ops.verify_sig_shares_rlc_pallas``),
``ops.verify_with_hash_batch``, ``ops.encrypt_batch_pallas``,
``ops.combine_batch`` and the DKG batch ops on the CPU, where the kernels'
plain versions stand in for them, under a dispatch counter, and prints one
JSON line per path: the torch ops the call issues
outside the kernels' plain versions (on the card each is one launch of a
PyTorch kernel, the host overhead that sets the pace of a host-bound call),
and the launches each kernel would get.

The hash line runs one message: on the CPU ``batch_inv_field`` takes a
product tree above one lane, where the card takes one B2 at any width, so
only at one lane do the launches equal ``chip_smoke.hash_launches``, which
the line checks. It splits the ops by stage, and counts the candidate
extraction again on the streams of ``chip_smoke``'s 8192 messages, since
its loop runs until the slowest lane is done. The host splice issues no
torch ops; the line gives the host oracle's seconds per message on this
CPU instead (no lane of the counted call is spliced).

The combine line runs ``ops.combine_batch`` in G2 on each of its three
paths at COMBINE_T1 shares, with ``batch_inv_field`` as the card runs it
(one ``f.inv``, one B2), so that its launches equal
``chip_smoke.combine_launches``, which the line checks; at that size λ
takes the N×N matrix form, and once more with the matrix bound lowered
below N, B14's route. It splits the ops by stage, and gives the fold's
levels at 4096 shares and its ops extrapolated there (levels × the
counted ops of one level; the rest of the call is counted at
COMBINE_T1).

The DKG line runs ``chip_smoke.dkg_call``, one dealing dealt and checked
(``bivar_commit_batch``, ``bivar_row_batch``, ``bivar_commit_row_batch``,
``bivar_commit_eval_batch`` and the nodes' row and value checks), at
N = 3t + 1 nodes for t = 2 and t = DKG_MID, by stage, with
``batch_inv_field`` as the card runs it; its launches are checked against
``chip_smoke.dkg_launches``, and its torch ops extrapolated to slice 7's
t = 85 (see ``dkg_line``).

The per-pair counts depend on the code path only, not on the lane count.
The RLC path's run at RLC_N shares differs from one at 262,144 in what
depends on N and the accumulators A = min(``cuda_curve.ACCUMULATORS``, N):
the fold's ⌈log₂ A⌉ levels per group (each one complete add, 5 B1
launches and a fixed number of torch ops), and B12's launches (2 once the
transcript has 64 chunks or more, which RLC_N = 256 reaches). The line
gives the fold levels and checks the launches against
``chip_smoke.rlc_launches``, the count the card run checks at 262,144.
Its ``torch_ops_at_262144_extrapolated`` is not counted: it is the count at
RLC_N plus the extra fold levels at 262,144 times the counted ops of one
level.
"""

from __future__ import annotations

import json
import os
import random
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from threshold_crypto_tpu_torch import ops  # noqa: E402
from threshold_crypto_tpu_torch.device import cuda_curve  # noqa: E402
from threshold_crypto_tpu_torch.device import cuda_fr  # noqa: E402
from threshold_crypto_tpu_torch.device import cuda_mont  # noqa: E402
from threshold_crypto_tpu_torch.device import cuda_tower  # noqa: E402
from threshold_crypto_tpu_torch.device import curve as dcv  # noqa: E402
from threshold_crypto_tpu_torch.device import keccak  # noqa: E402
from threshold_crypto_tpu_torch.device import pairing as dpr  # noqa: E402
from threshold_crypto_tpu_torch.host import curve as hcv  # noqa: E402
from threshold_crypto_tpu_torch.host.params import R  # noqa: E402

LANES = 2
# The RLC call: shares (16 keys tiled) and check lanes. The check's counts
# do not depend on its lanes; 2 keep the CPU run short.
RLC_N, RLC_CHECK = 256, 2
# The combine call's shares on the CPU, and the share count of slice 6.
COMBINE_T1, COMBINE_FULL = 16, 4096
# The middle degree of the DKG line (N = 3t + 1 nodes).
DKG_MID = 8


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def count(fn, args, stages=()):
    """(torch ops outside the plain versions, launches per kernel, ops per
    stage) of one fn(*args) call; a plain version called inside another (a
    product in the power's chain or a tower kernel) is part of that one
    launch. stages: (module, attribute, label) of functions whose ops are
    also summed by label."""
    counter = _Counter()
    launches = {}
    saved = []
    per_stage = {}

    def in_stage(label, f):
        def run(*a, **kw):
            before = counter.ops
            try:
                return f(*a, **kw)
            finally:
                per_stage[label] = (per_stage.get(label, 0) + counter.ops
                                    - before)
        return run

    for mod, name, label in stages:
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, in_stage(label, getattr(mod, name)))

    def as_kernel(name, plain):
        def run(*a):
            if counter.paused:
                return plain(*a)
            launches[name] = launches.get(name, 0) + 1
            counter.paused = True
            try:
                return plain(*a)
            finally:
                counter.paused = False
        return run

    for mod in (cuda_mont, cuda_tower, cuda_curve, keccak, cuda_fr):
        for k in mod.KERNELS:
            saved.append((mod, k.plain.__name__, k.plain))
            setattr(mod, k.plain.__name__, as_kernel(k.name, k.plain))
    try:
        with counter:
            ok = fn(*args)
    finally:
        for mod, name, plain in saved:
            setattr(mod, name, plain)
    if not bool(ok.all()):
        raise SystemExit(f"{fn.__name__} rejected valid lanes")
    return counter.ops, launches, per_stage


def rlc_call(pk_aff, h_jac, sig_aff):
    """One RLC verification as bench.py times it: exponents, then check."""
    r = ops.rlc_exponents(RLC_N, b"\x01" * 32, pk_aff=pk_aff,
                          sig_aff=sig_aff)
    return ops.verify_sig_shares_rlc_pallas(pk_aff, h_jac, sig_aff, r,
                                            check_batch=RLC_CHECK)


def main():
    torch.set_num_threads(1)

    rnd = random.Random(3)
    h = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    sks = [rnd.randrange(1, R) for _ in range(LANES)]
    pk = dpr.g1_affine_from_host(
        [hcv.G1.mul(hcv.G1.generator, s) for s in sks], device="cpu")
    hs = dpr.g2_affine_from_host([h] * LANES, device="cpu")
    sig = dpr.g2_affine_from_host([hcv.G2.mul(h, s) for s in sks],
                                  device="cpu")

    for fn in (ops.verify_batch, ops.verify_batch_pallas):
        n_ops, launches, _ = count(fn, (pk, hs, sig))
        print(json.dumps({"path": fn.__name__, "lanes": LANES,
                          "torch_ops": n_ops, "kernel_launches": launches}))

    keys = [rnd.randrange(1, R) for _ in range(16)]
    pk16 = [hcv.G1.mul(hcv.G1.generator, s) for s in keys]
    sig16 = [hcv.G2.mul(h, s) for s in keys]
    rlc_pk = dpr.g1_affine_from_host(pk16 * (RLC_N // 16), device="cpu")
    rlc_sig = dpr.g2_affine_from_host(sig16 * (RLC_N // 16), device="cpu")
    h_jac = dcv.G2.from_host_affine([h], device="cpu")
    n_ops, launches, _ = count(rlc_call, (rlc_pk, h_jac, rlc_sig))
    expect = chip_smoke.rlc_launches(RLC_N)
    if {k: launches.get(k, 0) for k in expect} != expect:
        raise SystemExit(f"RLC launches {launches}, expected {expect}")
    levels = (min(cuda_curve.ACCUMULATORS, RLC_N) - 1).bit_length()
    full = (min(cuda_curve.ACCUMULATORS, 262144) - 1).bit_length()
    # one fold level: one complete add per group
    level_ops = sum(
        count(lambda p: (c.add(p, p), torch.ones(()))[1],
              (c.from_host_affine([c.gen_affine_host] * 2, device="cpu"),))[0]
        for c in (dcv.G1, dcv.G2))
    print(json.dumps({"path": "rlc_exponents+verify_sig_shares_rlc_pallas",
                      "shares": RLC_N, "check_batch": RLC_CHECK,
                      "fold_levels_per_group": levels, "torch_ops": n_ops,
                      "kernel_launches": launches,
                      "torch_ops_per_fold_level": level_ops,
                      "torch_ops_at_262144_extrapolated": n_ops + (full - levels)
                      * level_ops,
                      "kernel_launches_at_262144": chip_smoke.rlc_launches(
                          262144)}))
    hash_line()
    encrypt_line()
    combine_line()
    dkg_line()


def hash_line():
    """``verify_with_hash_batch`` on one message, by stage."""
    import time

    from threshold_crypto_tpu_torch import hashing
    from threshold_crypto_tpu_torch.device import hash2g2
    from threshold_crypto_tpu_torch.ops import threshold as tops

    msg = b"bench-msg-0"
    sk = random.Random(0xD15C).randrange(1, R)
    h = hashing.hash_g2(msg).v
    pk = dpr.g1_affine_from_host([hcv.G1.mul(hcv.G1.generator, sk)],
                                 device="cpu")
    sig = dpr.g2_affine_from_host([hcv.G2.mul(h, sk)], device="cpu")
    stages = [
        (hashing, "digest_words", "host digests"),
        (hash2g2, "_chacha_words_multikey", "ChaCha streams"),
        (hash2g2, "extract_candidates", "candidate extraction"),
        (hash2g2, "residue_test", "residue test"),
        (hash2g2, "fq2_sqrt", "Fq2 sqrt (two fq2_pow_fixed)"),
        (cuda_curve, "scalar_mul_fixed_pallas", "table + cofactor ladder"),
        (tops, "splice_host_hashes", "host splice"),
        (tops, "jacobian_to_affine", "affine"),
        (tops, "verify_batch_pallas", "check"),
    ]
    n_ops, launches, per_stage = count(
        ops.verify_with_hash_batch, (pk, [msg], sig), stages)
    expect = chip_smoke.hash_launches()
    if {k: launches.get(k, 0) for k in expect} != expect:
        raise SystemExit(f"hash launches {launches}, expected {expect}")
    msgs = [b"bench-msg-%d" % i for i in range(chip_smoke.HASH_N)]
    words = hash2g2._chacha_words_multikey(
        hashing.digest_words(msgs, "cpu"), hash2g2.DEFAULT_WORDS)
    counter = _Counter()
    with counter:
        hash2g2.extract_candidates(words, chip_smoke.HASH_ATTEMPTS)
    t0 = time.time()
    for m in msgs[:8]:
        hashing.hash_g2(m)
    oracle_s = (time.time() - t0) / 8
    print(json.dumps({"path": "verify_with_hash_batch", "lanes": 1,
                      "torch_ops": n_ops, "kernel_launches": launches,
                      "torch_ops_by_stage": per_stage,
                      f"extraction_torch_ops_at_{chip_smoke.HASH_N}":
                          counter.ops,
                      "host_oracle_s_per_message_this_cpu": oracle_s}))


def encrypt_line():
    """``encrypt_batch_pallas`` on two lanes."""
    rnd = random.Random(0xE2C)
    pk_pt = hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R))
    huv = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
           for _ in range(LANES)]
    r = dcv.fr_limbs_from_ints(
        [rnd.randrange(1, R) for _ in range(LANES)], "cpu")

    def call(pk_aff, r, huv_aff):
        ops.encrypt_batch_pallas(pk_aff, r, huv_aff)
        return torch.ones(())

    n_ops, launches, _ = count(call, (
        dpr.g1_affine_from_host([pk_pt] * LANES, device="cpu"), r,
        dpr.g2_affine_from_host(huv, device="cpu")))
    expect = chip_smoke.encrypt_launches()
    if {k: launches.get(k, 0) for k in expect} != expect:
        raise SystemExit(f"encrypt launches {launches}, expected {expect}")
    print(json.dumps({"path": "encrypt_batch_pallas", "lanes": LANES,
                      "torch_ops": n_ops, "kernel_launches": launches}))


def combine_line():
    """``combine_batch`` in G2 on each path, by stage."""
    from threshold_crypto_tpu_torch.ops import fr as frops
    from threshold_crypto_tpu_torch.ops import threshold as tops

    rnd = random.Random(0xC0B1)
    n = COMBINE_T1
    shares = dcv.G2.from_host_affine(
        [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
         for _ in range(n)], device="cpu")
    xs = frops.fr_to_device(range(1, n + 1), "cpu")
    stages = [
        (frops, "lagrange_coeffs_at_zero", "lambda"),
        (frops, "fr_to_plain", "canonical lambda"),
        (tops, "jacobian_to_affine", "affine"),
        (cuda_curve, "p_madd", "table (B10)"),
        (cuda_curve, "p_winacc", "Horner (B11)"),
        (cuda_curve, "p_step", "bit ladders (B15)"),
        (cuda_curve, "p_dblw", "dblw (B16)"),
        (cuda_curve, "p_selmadd", "selmadd (B16)"),
        (dcv.G2, "fold_sum", "fold"),
    ]
    saved_inv = tops.batch_inv_field
    tops.batch_inv_field = lambda f, a: f.inv(a)   # the card's one B2
    saved_max = frops._LAGRANGE_MATRIX_MAX
    out = {}
    try:
        for path, matrix_max in (("pallas", saved_max),
                                 ("scalarwise", saved_max),
                                 ("bitscan", saved_max),
                                 ("pallas", n // 2)):
            frops._LAGRANGE_MATRIX_MAX = matrix_max
            n_ops, launches, per_stage = count(
                lambda *a: ops.combine_batch(*a, path=path)[1],
                (dcv.G2, shares, xs), stages)
            expect = chip_smoke.combine_launches(n, path, True)
            if {k: launches.get(k, 0) for k in expect} != expect:
                raise SystemExit(f"combine {path} launches {launches}, "
                                 f"expected {expect}")
            key = path if matrix_max >= n else f"{path} (lambda on B14)"
            out[key] = {"torch_ops": n_ops, "kernel_launches": launches,
                        "torch_ops_by_stage": per_stage}
    finally:
        tops.batch_inv_field = saved_inv
        frops._LAGRANGE_MATRIX_MAX = saved_max
        if "fold_sum" in vars(dcv.G2):
            del dcv.G2.fold_sum
    level_ops = count(lambda p: (dcv.G2.add(p, p), torch.ones(()))[1],
                      (dcv.G2.from_host_affine([dcv.G2.gen_affine_host] * 2,
                                               device="cpu"),))[0]
    full = {"pallas": min(cuda_curve.ACCUMULATORS, COMBINE_FULL),
            "scalarwise": COMBINE_FULL,
            "bitscan": min(cuda_curve.SHARED_BLOCK, COMBINE_FULL)}
    print(json.dumps({
        "path": "combine_batch (G2)", "shares": n, "paths": out,
        "torch_ops_per_fold_level": level_ops,
        f"fold_levels_at_{COMBINE_FULL}": {
            p: (m - 1).bit_length() for p, m in full.items()},
        f"fold_torch_ops_at_{COMBINE_FULL}_extrapolated": {
            p: (m - 1).bit_length() * level_ops for p, m in full.items()},
        f"kernel_launches_at_{COMBINE_FULL}": {
            p: chip_smoke.combine_launches(COMBINE_FULL, p, True)
            for p in full}}))


def dkg_line():
    """One dealing call of ``chip_smoke.dkg_call`` (the four DKG ops and the
    nodes' checks) at N = 3t + 1 nodes for t = 2 and t = DKG_MID, with
    ``batch_inv_field`` as the card runs it (one B2); launches per stage
    checked against ``chip_smoke.dkg_launches``. The torch ops are
    extrapolated to t = 85: the count less its fold levels is fitted
    linearly in t between the two points (the powers are t sequential
    products), and the folds' ⌈log₂(t+1)⌉ + ⌈log₂ npos⌉ levels at t = 85
    are added at the counted ops of one G1 complete add."""
    from threshold_crypto_tpu_torch.ops import threshold as tops

    def levels(m):
        return (m - 1).bit_length()

    def fold_levels(t):
        return levels(t + 1) + levels((t + 1) * (t + 2) // 2)

    level_ops = count(lambda p: (dcv.G1.add(p, p), torch.ones(()))[1],
                      (dcv.G1.from_host_affine([dcv.G1.gen_affine_host] * 2,
                                               device="cpu"),))[0]
    saved_inv, saved_sync = tops.batch_inv_field, torch.cuda.synchronize
    tops.batch_inv_field = lambda f, a: f.inv(a)   # the card's one B2
    torch.cuda.synchronize = lambda *a, **k: None  # no card to wait for
    out = {}
    try:
        for t in (2, DKG_MID):
            n = 3 * t + 1
            inp = chip_smoke.dkg_inputs("cpu", n=n, t=t, zero_pos=1)
            per_stage = {}

            def call(inp):
                o, _ = chip_smoke.dkg_call(inp)
                return o["row_ok"].all() & o["val_ok"].all()

            stages = [(tops, name, label) for name, label in (
                ("bivar_commit_batch", "commit"),
                ("bivar_row_batch", "rows"),
                ("bivar_commit_row_batch", "row commitments"),
                ("bivar_commit_eval_batch", "value commitments"))] + [
                (chip_smoke, "dkg_row_check", "row check"),
                (chip_smoke, "dkg_value_check", "value check"),
                (dcv.G1, "fold_axis", "folds")]
            n_ops, launches, per_stage = count(call, (inp,), stages)
            expect = chip_smoke.dkg_launches(n, t)
            total = {}
            for want in expect.values():
                for k, v in want.items():
                    total[k] = total.get(k, 0) + v
            if {k: launches.get(k, 0) for k in total} != total:
                raise SystemExit(f"dkg t={t} launches {launches}, expected "
                                 f"{total}")
            out[t] = {"nodes": n, "torch_ops": n_ops,
                      "kernel_launches": launches,
                      "torch_ops_by_stage": per_stage}
    finally:
        tops.batch_inv_field = saved_inv
        torch.cuda.synchronize = saved_sync
        if "fold_axis" in vars(dcv.G1):
            del dcv.G1.fold_axis
    rest = {t: out[t]["torch_ops"] - fold_levels(t) * level_ops for t in out}
    per_t = (rest[DKG_MID] - rest[2]) / (DKG_MID - 2)
    full = chip_smoke.DKG_T
    print(json.dumps({
        "path": "dkg dealing call (chip_smoke.dkg_call)", "by_degree": out,
        "torch_ops_per_fold_level": level_ops,
        f"torch_ops_at_t{full}_extrapolated": round(
            rest[2] + per_t * (full - 2) + fold_levels(full) * level_ops),
        f"fold_levels_at_t{full}": fold_levels(full),
        f"kernel_launches_at_t{full}": chip_smoke.dkg_launches(
            chip_smoke.DKG_N, full)}))


if __name__ == "__main__":
    main()
