"""Strict per-pair verification: ``ops.verify_batch_pallas`` on a batch of
signers' own (pk, H(m), sig) triples, each on its own message; the output
is the mask, one caller waiting for each.

Made at set-up from the seed, on the device by the program's ladders:
sk_i and k_i, pk_i = sk_i·G1, H_i = k_i·G2 (the message's hash point),
sig_i = sk_i·H_i. A seed-drawn eighth of the lanes is checked against the
next lane's message (False); lanes ``infinity`` get an infinite pk, sig or
both (False, False, True). The reference (after the window): every lane of
every call's mask against the construction, and ``input_sample`` lanes'
pk, H and sig against the host's multiplications.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import curve as rcv
from ..reference import limbs
from ..reference.params import R
from . import common


def _program():
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.ops import threshold as tops
    return tops, dcv


def g2_multiples(dcv, k, dev):
    """k_i·G2 per lane, on the program's ladder."""
    return dcv.G2.scalar_mul(dcv.G2.generator((k.shape[0],), dev), k)


def setup(ctx):
    tops, dcv = _program()
    trf, dev, seed = ctx.traffic, ctx.device, ctx.seed
    n = int(trf["batch"])
    gen = common.generator(seed, dev, "strict")
    sk = common.random_scalars(n, gen, dev)
    kh = common.random_scalars(n, gen, dev)
    pk_aff = tops.jacobian_to_affine(dcv.G1, tops.commit_batch(sk))
    h_aff = tops.jacobian_to_affine(dcv.G2, g2_multiples(dcv, kh, dev))
    sig_aff = tops.jacobian_to_affine(dcv.G2, tops.sign_batch(
        tops.affine_to_jacobian(dcv.G2, h_aff), sk))
    rnd = common.host_rng(seed, "strict")
    wrong = sorted(rnd.sample(range(n), n // int(trf["wrong_message_every"])))
    msg = np.arange(n)
    msg[wrong] = (np.asarray(wrong) + 1) % n
    want = np.ones(n, bool)
    want[wrong] = False
    idx = torch.from_numpy(msg).to(dev)
    h_used = dcv.tree_map(lambda a: a[idx].contiguous(), h_aff)
    for lane, kind in trf["infinity"].items():
        lane = int(lane)
        for aff, hit in ((pk_aff, kind in ("pk", "both")),
                         (sig_aff, kind in ("sig", "both"))):
            if hit:
                aff[2][lane] = True
                for c in dcv.leaves(aff[:2]):
                    c[lane] = 0
        want[lane] = kind == "both"
    return dict(n=n, sk=sk, kh=kh, pk_aff=pk_aff, h_aff=h_aff,
                h_used=h_used, sig_aff=sig_aff, want=want, msg=msg,
                sample=rnd.sample(range(n), min(n, int(trf["input_sample"]))),
                infinity={int(k): v for k, v in trf["infinity"].items()})


def warm(state):
    return [0]


def units(state):
    return {"verifies": state["n"]}


def op(state, i):
    tops, _ = _program()
    mask = tops.verify_batch_pallas(state["pk_aff"], state["h_used"],
                                    state["sig_aff"])
    return {"i": i, "mask": mask}


def check(state, records):
    want = state["want"]
    failed = lanes_wrong = 0
    for rec in records:
        got = rec["mask"].cpu().numpy()
        bad = common.mismatches(got, want) if got.shape == want.shape \
            else want.size
        lanes_wrong += bad
        failed += bad > 0
    sk = limbs.ints(state["sk"].cpu().numpy())
    kh = limbs.ints(state["kh"].cpu().numpy())
    lanes = [l for l in state["sample"] if l not in state["infinity"]]
    pk = common.g1_host(common.take(common.numpy_tree(state["pk_aff"]),
                                    lanes))
    h = common.g2_host(common.take(common.numpy_tree(state["h_aff"]), lanes))
    sig = common.g2_host(common.take(common.numpy_tree(state["sig_aff"]),
                                     lanes))
    inputs_wrong = sum(
        (p != rcv.G1.mul(rcv.G1.generator, sk[l]))
        + (q != rcv.G2.mul(rcv.G2.generator, kh[l]))
        + (s != rcv.G2.mul(rcv.G2.generator, sk[l] * kh[l] % R))
        for l, p, q, s in zip(lanes, pk, h, sig))
    return {"failed": failed, "checks": [
        common.compare("mask_lanes_wrong", int(lanes_wrong), 0),
        common.compare("input_points_wrong", int(inputs_wrong), 0),
    ]}


# The program doing less: one bit of |X| fewer in the pairing.
control = common.pairing_one_bit_short
