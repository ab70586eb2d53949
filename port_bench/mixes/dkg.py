"""One dealing of a SyncKeyGen round, dealt and checked, one after the
other: a fresh symmetric bivariate polynomial of degree t from the seed
(made on the device; coefficient ``zero_pos`` zero, so it commits to
infinity), then ``bivar_commit_batch``, ``bivar_row_batch`` and
``bivar_commit_row_batch`` for x = 1..N, ``bivar_commit_eval_batch`` for
the values node 1 was sent (the pairs (m, 1)), and the nodes' checks: every
row commitment against the commitment of its row, every value against its
commitment. In one dealing of every ``tamper_every`` (phase from the seed)
the value of a seed-drawn node is tampered with (plus one) and must be
rejected on its lane alone.

The reference (after the window): both checks' every lane in every
dealing; on the dealings of ``deep`` the commitment at ``coeff_sample``
positions (and the zero one), the rows of ``node_sample`` nodes by Horner,
their row commitments at ``row_sample`` positions and their value
commitments f(m, 1)·G1, all on the host from the coefficients.
"""

from __future__ import annotations

import contextlib

import numpy as np

from ..reference import curve as rcv
from ..reference import limbs
from ..reference.params import R
from . import common


def _program():
    from threshold_crypto_tpu_torch.device import curve as dcv
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.ops import fr as frops
    from threshold_crypto_tpu_torch.ops import threshold as tops
    return tops, dcv, mont, frops


def coeff_pos(i: int, j: int) -> int:
    """The symmetric triangular layout of the coefficients (i <= j)."""
    if j < i:
        i, j = j, i
    return i + j * (j + 1) // 2


def setup(ctx):
    _, _, _, frops = _program()
    cfg, trf, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    n, t = int(cfg["nodes"]), int(cfg["threshold"])
    rnd = common.host_rng(seed, "dkg")
    every = int(trf["tamper_every"])
    phase = rnd.randrange(every)
    deep = sorted(rnd.sample([i for i in range(every) if i != phase],
                             int(trf["deep"]) - 1) + [phase])
    return dict(n=n, t=t, npos=(t + 1) * (t + 2) // 2, seed=seed, dev=dev,
                xs=frops.fr_to_device(range(1, n + 1), dev),
                ys=frops.fr_to_device([1] * n, dev),
                zero_pos=int(trf["zero_pos"]), every=every, phase=phase,
                deep=deep, trf=trf)


def warm(state):
    return [state["phase"], (state["phase"] + 1) % state["every"]]


def units(state):
    return {"dealings": 1}


def tampered_lane(state, i):
    if i % state["every"] != state["phase"]:
        return None
    return common.host_rng(state["seed"], "dkg tamper", i).randrange(
        state["n"])


def row_check(rows, rowc, t):
    """bool[n, t+1]: every node's row commitments equal the commitments of
    its own row (``commit.row(m) == row.commitment()``)."""
    tops, dcv, _, frops = _program()
    own = tops.commit_batch(frops.fr_to_plain(rows).reshape(
        -1, rows.shape[-1]))
    return dcv.G1.eq(rowc, dcv.tree_map(
        lambda a: a.reshape(rows.shape[0], t + 1, a.shape[-1]), own))


def value_check(rows, ev, ys, t, tamper=None):
    """bool[n]: each value f(x_m, y_m) (node m's row at y_m; lane ``tamper``
    plus one) commits to C(x_m, y_m) (``commit.evaluate(m, s) ==
    val·G1``)."""
    tops, dcv, mont, frops = _program()
    spow = tops.powers_batch(ys, t)
    vals = frops.sum_leading(mont.mul(mont.FR, rows, spow).movedim(1, 0))
    if tamper is not None:
        vals[tamper] = mont.add(mont.FR, vals[tamper],
                                mont.one(mont.FR, (), vals.device))
    return dcv.G1.eq(ev, tops.commit_batch(frops.fr_to_plain(vals)))


def op(state, i):
    tops, _, _, frops = _program()
    t, xs, ys = state["t"], state["xs"], state["ys"]
    gen = common.generator(state["seed"], state["dev"], "dkg", i)
    plain = common.random_scalars(state["npos"], gen, state["dev"])
    plain[state["zero_pos"]] = 0
    commit = tops.bivar_commit_batch(plain)
    rows = tops.bivar_row_batch(frops.fr_from_plain(plain), xs, t)
    rowc = tops.bivar_commit_row_batch(commit, xs, t)
    ev = tops.bivar_commit_eval_batch(commit, xs, ys, t)
    tamper = tampered_lane(state, i)
    rec = {"i": i, "tamper": tamper, "row_ok": row_check(rows, rowc, t),
           "val_ok": value_check(rows, ev, ys, t, tamper)}
    if i in state["deep"]:
        rec.update(plain=plain, commit=commit, rows=rows, rowc=rowc, ev=ev)
    return rec


def _jac_points(jac, lanes):
    x, y, z = (c.cpu().numpy().reshape(-1, limbs.FQ_L) for c in jac)
    return common.jac_host(rcv.G1, (x[lanes], y[lanes], z[lanes]), False)


def check(state, records):
    n, t, trf = state["n"], state["t"], state["trf"]
    checks_wrong = failed = 0
    for rec in records:
        want_val = np.ones(n, bool)
        if rec["tamper"] is not None:
            want_val[rec["tamper"]] = False
        bad = (int((~rec["row_ok"]).sum())
               + common.mismatches(rec["val_ok"].cpu().numpy(), want_val))
        checks_wrong += bad
        failed += bad > 0
    rnd = common.host_rng(state["seed"], "dkg reference")
    deep = [rec for rec in records if "plain" in rec]
    commit_wrong = rows_wrong = rowc_wrong = ev_wrong = 0
    g = rcv.G1.generator
    for rec in deep:
        before = commit_wrong + rows_wrong + rowc_wrong + ev_wrong
        c = limbs.ints(rec["plain"].cpu().numpy())
        pos = sorted(set(rnd.sample(range(state["npos"]),
                                    int(trf["coeff_sample"])))
                     | {state["zero_pos"]})
        got = _jac_points(rec["commit"], pos)
        commit_wrong += sum(p != rcv.G1.mul(g, c[q]) for p, q in zip(got, pos))
        nodes = rnd.sample(range(n), int(trf["node_sample"]))
        rows = rec["rows"].cpu().numpy()
        for m in nodes:
            x = m + 1
            row = [sum(c[coeff_pos(i, j)] * pow(x, j, R)
                       for j in range(t + 1)) % R for i in range(t + 1)]
            rows_wrong += common.mismatches(limbs.fr_mont(rows[m]), row)
            idx = rnd.sample(range(t + 1), int(trf["row_sample"]))
            got = _jac_points(rec["rowc"], [m * (t + 1) + i for i in idx])
            rowc_wrong += sum(p != rcv.G1.mul(g, row[i])
                              for p, i in zip(got, idx))
            f_x1 = sum(row) % R                       # f(x, 1) = Σ_i row_i
            ev_wrong += _jac_points(rec["ev"], [m])[0] != rcv.G1.mul(g, f_x1)
        failed += commit_wrong + rows_wrong + rowc_wrong + ev_wrong > before
    return {"failed": failed, "checks": [
        common.compare("check_lanes_wrong", int(checks_wrong), 0),
        common.compare("deep_dealings_missing", 0 if deep else 1, 0),
        common.compare("commitments_wrong", int(commit_wrong), 0),
        common.compare("row_values_wrong", int(rows_wrong), 0),
        common.compare("row_commitments_wrong", int(rowc_wrong), 0),
        common.compare("value_commitments_wrong", int(ev_wrong), 0),
    ]}


@contextlib.contextmanager
def control():
    """The program doing less: every ladder of the dealing (the commitment,
    the row and value commitments, the nodes' checks) runs over its
    scalars' low 128 bits."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv

    saved = ccv.scalar_mul_gathered, ccv.scalar_mul_pallas

    def gathered(curve, points_aff, index, scalars, nbits=255):
        return saved[0](curve, points_aff, index, scalars, nbits=128)

    def ladder(curve, points_aff, scalars, nbits=255, window=4):
        return saved[1](curve, points_aff, scalars, nbits=128, window=window)

    ccv.scalar_mul_gathered, ccv.scalar_mul_pallas = gathered, ladder
    try:
        yield
    finally:
        ccv.scalar_mul_gathered, ccv.scalar_mul_pallas = saved
