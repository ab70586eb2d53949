"""One epoch of HoneyBadgerBFT's threshold decryption as one node sees it:
one ciphertext from each of the N proposers. ``ciphertext_verify_batch``
over the N ciphertexts, the node's ``decrypt_share_batch`` over them, then
``verify_dec_share_batch`` over all N × N decryption shares (the node's
own row freshly computed, the others' as received), one epoch after the
other.

Made at set-up from the seed: the key shares sk_m = f(m + 1) of a degree-t
polynomial, pk_m = sk_m·G1; per ciphertext r_i, u_i = r_i·G1, H_i = k_i·G2
(standing in for H(u_i, v_i)) and w_i = r_i·H_i; every node's shares
d_mi = sk_m·u_i on the program's ladder, those of ``bad_nodes`` seed-drawn
nodes plus G1 (their lanes must read False). The node is node 1 (m = 0).

The reference (after the window): every lane of both masks in every epoch
against the construction; the node's own shares of the ``deep`` epochs at
``share_sample`` lanes, and ``input_sample`` ciphertexts, against the
host's multiplications. The deep epochs are drawn from the seed among
the first ``deep_among``.
"""

from __future__ import annotations

import numpy as np

from ..reference import curve as rcv
from ..reference.params import R
from . import common

ME = 0


def _program():
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.ops import threshold as tops
    return tops, dcv


def setup(ctx):
    tops, dcv = _program()
    cfg, trf, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    n, t = int(cfg["nodes"]), int(cfg["threshold"])
    c = n                                    # one ciphertext per proposer
    rnd = common.host_rng(seed, "decrypt")
    poly = common.host_scalars(rnd, t + 1)
    sk = [sum(a * pow(m + 1, k, R) for k, a in enumerate(poly)) % R
          for m in range(n)]
    r = common.host_scalars(rnd, c)
    kh = common.host_scalars(rnd, c)
    bad = sorted(rnd.sample([m for m in range(n) if m != ME],
                            int(trf["bad_nodes"])))
    g1 = lambda ks: tops.commit_batch(common.fr_limbs(ks, dev))  # noqa: E731
    u_jac = g1(r)
    u_aff = tops.jacobian_to_affine(dcv.G1, u_jac)
    huv_aff = tops.jacobian_to_affine(dcv.G2, dcv.G2.scalar_mul(
        dcv.G2.generator((c,), dev), common.fr_limbs(kh, dev)))
    w_aff = tops.jacobian_to_affine(dcv.G2, dcv.G2.scalar_mul(
        dcv.G2.generator((c,), dev),
        common.fr_limbs([a * b % R for a, b in zip(r, kh)], dev)))
    pk_aff = tops.jacobian_to_affine(dcv.G1, g1(sk))
    shares = [(sk[m] * r[i] + (m in bad)) % R
              for m in range(n) for i in range(c)]
    shares_aff = tops.jacobian_to_affine(dcv.G1, g1(shares))    # [n*c]

    def lanes(tree, per_node):
        """[n*c] lanes: a node's value repeated over the c ciphertexts, or
        the ciphertexts' values repeated over the n nodes."""
        if per_node:
            return dcv.tree_map(
                lambda a: a.repeat_interleave(c, 0).contiguous(), tree)
        return dcv.tree_map(
            lambda a: a.repeat((n,) + (1,) * (a.dim() - 1)), tree)

    want = np.ones((n, c), bool)
    want[bad] = False
    return dict(n=n, c=c, sk=sk, r=r, kh=kh, bad=bad, u_jac=u_jac,
                u_aff=u_aff, huv_aff=huv_aff, w_aff=w_aff,
                sk_me=common.fr_limbs([sk[ME]] * c, dev),
                shares_aff=shares_aff, pk_lanes=lanes(pk_aff, True),
                huv_lanes=lanes(huv_aff, False), w_lanes=lanes(w_aff, False),
                want=want.reshape(-1), seed=seed,
                deep=set(common.host_rng(seed, "decrypt deep").sample(
                    range(int(trf["deep_among"])), int(trf["deep"]))),
                trf=trf)


def warm(state):
    return [0]


def units(state):
    return {"verifies": state["c"] + state["n"] * state["c"]}


def op(state, i):
    tops, dcv = _program()
    c = state["c"]
    ct_ok = tops.ciphertext_verify_batch(state["u_aff"], state["w_aff"],
                                         state["huv_aff"])
    mine = tops.jacobian_to_affine(
        dcv.G1, tops.decrypt_share_batch(state["u_jac"], state["sk_me"]))
    shares = state["shares_aff"]
    for leaf, new in zip(dcv.leaves(shares), dcv.leaves(mine)):
        leaf[ME * c:(ME + 1) * c] = new
    ok = tops.verify_dec_share_batch(shares, state["huv_lanes"],
                                     state["pk_lanes"], state["w_lanes"])
    rec = {"i": i, "ct_ok": ct_ok, "ok": ok}
    if i in state["deep"]:
        rec["mine"] = dcv.tree_map(lambda a: a.clone(), mine)
    return rec


def check(state, records):
    n, c, trf = state["n"], state["c"], state["trf"]
    lanes_wrong = failed = 0
    for rec in records:
        bad = (common.mismatches(rec["ct_ok"].cpu().numpy(), np.ones(c, bool))
               + common.mismatches(rec["ok"].cpu().numpy(), state["want"]))
        lanes_wrong += bad
        failed += bad > 0
    rnd = common.host_rng(state["seed"], "decrypt reference")
    deep = [rec for rec in records if "mine" in rec]
    g = rcv.G1.generator
    shares_wrong = 0
    for rec in deep:
        idx = rnd.sample(range(c), int(trf["share_sample"]))
        got = common.g1_host(common.take(common.numpy_tree(rec["mine"]), idx))
        bad = sum(p != rcv.G1.mul(g, state["sk"][ME] * state["r"][i] % R)
                  for p, i in zip(got, idx))
        shares_wrong += bad
        failed += bad > 0
    idx = rnd.sample(range(c), int(trf["input_sample"]))
    u = common.g1_host(common.take(common.numpy_tree(state["u_aff"]), idx))
    h = common.g2_host(common.take(common.numpy_tree(state["huv_aff"]), idx))
    w = common.g2_host(common.take(common.numpy_tree(state["w_aff"]), idx))
    inputs_wrong = sum(
        (a != rcv.G1.mul(g, state["r"][i]))
        + (b != rcv.G2.mul(rcv.G2.generator, state["kh"][i]))
        + (d != rcv.G2.mul(rcv.G2.generator,
                           state["r"][i] * state["kh"][i] % R))
        for i, a, b, d in zip(idx, u, h, w))
    return {"failed": failed, "checks": [
        common.compare("mask_lanes_wrong", int(lanes_wrong), 0),
        common.compare("deep_epochs_missing", 0 if deep else 1, 0),
        common.compare("own_shares_wrong", int(shares_wrong), 0),
        common.compare("input_points_wrong", int(inputs_wrong), 0),
    ]}


# The program doing less: one bit of |X| fewer in the pairing.
control = common.pairing_one_bit_short
