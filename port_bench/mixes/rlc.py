"""RLC verification of a whole validator set's signature shares on one
message: ``ops.rlc_exponents`` (a fresh transcript seed each call), then
``ops.verify_sig_shares_rlc_pallas`` over every share, one caller waiting
for each verdict.

Every signer has its own key: sk_i from the seed on the device, pk_i =
sk_i·G1 and sig_i = sk_i·H made at set-up by the program's ladders, H =
k_H·G2 with k_H from the seed. In one call of every ``tamper_every`` (its
phase from the seed) one share, drawn from the seed, carries another
signer's signature, and that call must reject.

The reference (after the window): every call's verdict against the
construction; on the calls of ``deep`` (drawn from the seed among the first
``tamper_every``, the first tampered call among them) the exponents from the
transcript of the inputs' bytes (SHA3, ChaCha20) and both MSM sums, which
must be (Σ r_i·sk_i)·G1 and (Σ r_i·sk_i')·H with sk_i' the key behind
lane i's signature; and ``input_sample`` lanes' pk and sig on the host.
"""

from __future__ import annotations

import contextlib
import operator

import numpy as np

from ..reference import curve as rcv
from ..reference import limbs
from ..reference import transcript
from ..reference.params import R
from . import common

TX = "threshold_crypto_tpu_torch.ops.threshold"


def _program():
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.ops import threshold as tops
    return tops, dcv, ccv


def setup(ctx):
    tops, dcv, ccv = _program()
    cfg, trf, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    n = int(cfg["signers"])
    sk = common.random_scalars(n, common.generator(seed, dev, "rlc keys"),
                               dev)
    rnd = common.host_rng(seed, "rlc")
    k_h = rnd.randrange(1, R)
    h_host = rcv.G2.mul(rcv.G2.generator, k_h)
    h_jac = dcv.G2.from_host_affine([h_host], device=dev)
    pk_aff = tops.jacobian_to_affine(dcv.G1, tops.commit_batch(sk))
    h_aff = dcv.tree_map(lambda a: a.expand((n,) + a.shape[1:]).contiguous(),
                         tops.jacobian_to_affine(dcv.G2, h_jac))
    sig_aff = tops.jacobian_to_affine(
        dcv.G2, ccv.scalar_mul_pallas(dcv.G2, h_aff, sk))
    del h_aff
    every = int(trf["tamper_every"])
    phase = rnd.randrange(every)
    deep = sorted(rnd.sample([i for i in range(every) if i != phase],
                             int(trf["deep"]) - 1) + [phase])
    return dict(n=n, sk=sk, k_h=k_h, h_host=h_host, h_jac=h_jac,
                pk_aff=pk_aff, sig_aff=sig_aff, every=every, phase=phase,
                deep=deep, seed=seed, check_batch=int(cfg["check_batch"]),
                bits=int(cfg["rlc_scalar_bits"]),
                sample=rnd.sample(range(n), min(n, int(trf["input_sample"]))))


def warm(state):
    return [state["phase"], (state["phase"] + 1) % state["every"]]


def units(state):
    return {"verifies": state["n"]}


def _swap(state, i):
    """(lane j, lane k): call i gives lane j lane k's signature."""
    if i % state["every"] != state["phase"]:
        return None
    j, k = common.host_rng(state["seed"], "rlc swap", i).sample(
        range(state["n"]), 2)
    return j, k


def transcript_seed(state, i):
    return common.derive(state["seed"], "rlc transcript", i)


@contextlib.contextmanager
def _captured(tops, out):
    """Keep the aggregate the entry point computes (its two MSM sums)."""
    inner = tops.rlc_aggregate_pallas

    def keep(*args, **kwargs):
        out.append(inner(*args, **kwargs))
        return out[-1]

    tops.rlc_aggregate_pallas = keep
    try:
        yield
    finally:
        tops.rlc_aggregate_pallas = inner


def op(state, i):
    tops, dcv, _ = _program()
    pk_aff, sig_aff, n = state["pk_aff"], state["sig_aff"], state["n"]
    swap = _swap(state, i)
    if swap is not None:
        j, k = swap
        leaves = dcv.leaves(sig_aff)
        saved = [leaf[j].clone() for leaf in leaves]
        for leaf in leaves:
            leaf[j] = leaf[k]
    agg = []
    with _captured(tops, agg) if i in state["deep"] else \
            contextlib.nullcontext():
        r = tops.rlc_exponents(n, transcript_seed(state, i), pk_aff=pk_aff,
                               sig_aff=sig_aff)
        ok = bool(tops.verify_sig_shares_rlc_pallas(
            pk_aff, state["h_jac"], sig_aff, r,
            check_batch=state["check_batch"], msm="shared"))
    if swap is not None:
        for leaf, old in zip(leaves, saved):
            leaf[j] = old
    rec = {"i": i, "ok": ok, "swap": swap}
    if agg:
        rec["r"], rec["agg"] = r, agg[0]
    return rec


def _exponents_got(r_np) -> np.ndarray:
    """The program's exponents as u64 (limbs 0-3) and whether any higher
    limb is set."""
    v = r_np[:, :4].astype(np.uint64) & np.uint64(0xFFFF)
    got = (v[:, 0] | (v[:, 1] << np.uint64(16)) | (v[:, 2] << np.uint64(32))
           | (v[:, 3] << np.uint64(48)))
    return got, np.any(r_np[:, 4:] != 0, axis=1)


def check(state, records):
    """The reference's comparisons (every number's limit is 0: exact)."""
    _, dcv, _ = _program()
    verdicts_wrong = sum(rec["ok"] != (rec["swap"] is None)
                         for rec in records)
    deep = [rec for rec in records if "agg" in rec]
    pk_np = common.numpy_tree(state["pk_aff"])
    sig_np = common.numpy_tree(state["sig_aff"])
    sk = limbs.ints(state["sk"].cpu().numpy())
    base = None
    exp_wrong = sums_wrong = deep_failed = 0
    for rec in deep:
        before = exp_wrong + sums_wrong
        sig = sig_np
        if rec["swap"] is not None:
            j, k = rec["swap"]
            sig = common.copy_tree(sig_np)
            for leaf in dcv.leaves(sig):
                leaf[j] = leaf[k]
            digests = transcript.digests(dcv.leaves((pk_np, sig)))
        else:
            base = base or transcript.digests(dcv.leaves((pk_np, sig_np)))
            digests = base
        want = transcript.exponents(state["n"], transcript_seed(state, rec["i"]),
                                    digests)
        got, high = _exponents_got(rec["r"].cpu().numpy())
        exp_wrong += int(np.count_nonzero((got != want) | high))
        r = want.tolist()
        s = sum(map(operator.mul, r, sk)) % R
        s_sig = s
        if rec["swap"] is not None:
            j, k = rec["swap"]
            s_sig = (s + r[j] * (sk[k] - sk[j])) % R
        agg_pk, agg_sig = common.numpy_tree(rec["agg"])
        sums_wrong += common.g1_host(agg_pk)[0] != rcv.G1.mul(
            rcv.G1.generator, s)
        sums_wrong += common.g2_host(agg_sig)[0] != rcv.G2.mul(
            rcv.G2.generator, s_sig * state["k_h"] % R)
        deep_failed += exp_wrong + sums_wrong > before
    lanes = state["sample"]
    pk_s = common.g1_host(common.take(pk_np, lanes))
    sig_s = common.g2_host(common.take(sig_np, lanes))
    inputs_wrong = sum(
        (p != rcv.G1.mul(rcv.G1.generator, sk[l]))
        + (q != rcv.G2.mul(state["h_host"], sk[l]))
        for l, p, q in zip(lanes, pk_s, sig_s))
    return {"failed": verdicts_wrong + deep_failed, "checks": [
        common.compare("verdicts_wrong", verdicts_wrong, 0),
        common.compare("deep_calls_missing", 0 if deep else 1, 0),
        common.compare("exponent_lanes_wrong", exp_wrong, 0),
        common.compare("msm_sums_wrong", int(sums_wrong), 0),
        common.compare("input_points_wrong", int(inputs_wrong), 0),
    ]}


@contextlib.contextmanager
def control():
    """The program doing less: both MSMs read only the exponents' low 32
    bits (a 32-bit RLC, the step a later change might be tempted by)."""
    tops, _, _ = _program()
    inner = tops.rlc_aggregate_pallas

    def short(pk_aff, sig_aff, r_plain, nbits=64, msm="shared"):
        return inner(pk_aff, sig_aff, r_plain, nbits=32, msm=msm)

    tops.rlc_aggregate_pallas = short
    try:
        yield
    finally:
        tops.rlc_aggregate_pallas = inner
