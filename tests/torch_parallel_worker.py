"""One rank of the gloo worlds of ``tests/test_torch_parallel.py``.

``multihost.run_world("torch_parallel_worker:world_checks", n, ...)`` runs
``world_checks(mesh, **scenario)`` in each of n CPU processes. Every rank
builds the same global batches on the host from the scenario's seeds,
keeps its block (``shard_batch``), runs the sharded ops and returns what
the test compares against the port's single-device ops, the JAX package
and the host oracle: host affine points as ints, exponents as limbs,
verdicts as bools.
"""

import random

import torch

from threshold_crypto_tpu_torch import ops, serde_impl
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R
from threshold_crypto_tpu_torch.ops import fr as frops
from threshold_crypto_tpu_torch.parallel import mesh as pm
from threshold_crypto_tpu_torch.parallel import multihost as mh
from threshold_crypto_tpu_torch.parallel import sharded

DEV = "cpu"


def combine_inputs(n, seed):
    """(H, f(0), shares H·f(x_i), x_i = i + 1) of a degree-3 polynomial."""
    rnd = random.Random(seed)
    coeffs = [rnd.randrange(R) for _ in range(4)]
    f = lambda x: sum(c * pow(x, k, R) for k, c in enumerate(coeffs)) % R  # noqa: E731
    h = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    return h, f(0), [hcv.G2.mul(h, f(x)) for x in range(1, n + 1)]


def rlc_inputs(n, seed, dead=()):
    """(pk, H, sig, sig with lane 2 replaced by lane 1's): n shares of one
    message; lanes ``dead`` have pk and sig at infinity."""
    rnd = random.Random(seed)
    sks = [rnd.randrange(1, R) for _ in range(n)]
    h = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))
    pk = [None if i in dead else hcv.G1.mul(hcv.G1.generator, s)
          for i, s in enumerate(sks)]
    sig = [None if i in dead else hcv.G2.mul(h, s)
           for i, s in enumerate(sks)]
    bad = list(sig)
    bad[2] = sig[1]
    return pk, h, sig, bad


def _point(curve, pt):
    return curve.to_host_affine(dcv.tree_map(lambda a: a[None], pt))[0]


def _aff_point(aff, g2):
    x, y, inf = aff
    if bool(inf[0]):
        return None
    c = dcv.G2 if g2 else dcv.G1
    return c.to_host_affine((x, y, c.f.one((1,), "cpu")))[0]


def _combine(mesh, n, seed):
    h, secret, shares = combine_inputs(n, seed)
    xs = pm.replicate(mesh, frops.fr_to_device(range(1, n + 1), DEV))
    mine = pm.shard_batch(mesh, dcv.G2.from_host_affine(shares, device=DEV))
    pt, ok = sharded.sharded_combine(mesh, dcv.G2, mine, xs)
    # a duplicate x (G1 shares: the flag comes from the x alone)
    dup = xs.clone()
    dup[n - 1] = dup[0]
    g1 = pm.shard_batch(mesh, dcv.G1.from_host_affine(
        [hcv.G1.mul(hcv.G1.generator, i + 5) for i in range(n)], device=DEV))
    _, ok_dup = sharded.sharded_combine(mesh, dcv.G1, g1, dup)
    try:
        sharded.sharded_combine(mesh, dcv.G1, g1, xs[:n - 1])
        odd = "no error"
    except ValueError as e:
        odd = str(e)
    return {"point": _point(dcv.G2, pt), "ok": bool(ok),
            "ok_duplicate": bool(ok_dup), "odd_batch": odd}


def _rlc(mesh, n, seed, msm, dead):
    pk, h, sig, bad = rlc_inputs(n, seed, dead)
    pk_g = dpr.g1_affine_from_host(pk, device=DEV)
    h_jac = dcv.G2.from_host_affine([h], device=DEV)
    out = {}
    for what, s in (("valid", sig), ("tampered", bad)):
        sig_g = dpr.g2_affine_from_host(s, device=DEV)
        # the exponents of the whole batch, before the blocks
        r = ops.rlc_exponents(n, b"\x11" * 32, pk_aff=pk_g, sig_aff=sig_g)
        pk_m, sig_m, r_m = pm.shard_batch(mesh, (pk_g, sig_g, r))
        out[what] = bool(sharded.sharded_verify_rlc(
            mesh, pk_m, h_jac, sig_m, r_m, msm=msm))
        if what == "valid":
            out["r"] = r.tolist()
            a_pk, a_sig = sharded.sharded_rlc_aggregate(
                mesh, pk_m, sig_m, r_m, msm=msm)
            out["aggregate"] = [_aff_point(a_pk, False),
                                _aff_point(a_sig, True)]
    return out


def _fold_cases(mesh):
    """The cross-rank fold on chosen partials, G1 and G2: one rank's
    partial at infinity, equal partials (T == Q), opposite partials
    (T == −Q, a sum at infinity)."""
    out = {}
    for curve, host in ((dcv.G1, hcv.G1), (dcv.G2, hcv.G2)):
        p = host.mul(host.generator, 1234567 + mesh.rank)
        q = host.mul(host.generator, 1234567)
        cases = {
            "one_infinite": None if mesh.rank % 2 else p,
            "equal": q,
            "opposite": host.neg(q) if mesh.rank % 2 else q,
        }
        for name, mine in cases.items():
            jac = dcv.tree_map(lambda a: a[0],
                               curve.from_host_affine([mine], device=DEV))
            out[f"{curve.name} {name}"] = _point(
                curve, sharded.fold_partials(mesh, curve, jac))
    return out


def _runtime(mesh):
    """world(), the mesh, shard/gather, the dealer's broadcast of a
    serialized key set, its ValueErrors on rank 0, and the replicated-state
    guard (passing on equal state, raising on every rank on divergence)."""
    import threshold_crypto_tpu_torch as tc
    from threshold_crypto_tpu_torch.utils.rng import ChaChaRng

    out = {"world": list(mh.world()), "mesh_size": int(mesh.devices.size)}
    n = 4 * mesh.world
    x = torch.arange(n * 3, dtype=torch.int32).reshape(n, 3)
    flags = torch.arange(n) % 3 == 0
    mine = pm.shard_batch(mesh, (x, [flags]))
    back = pm.gather_batch(mesh, mine)
    out["shard_gather"] = bool(torch.equal(back[0], x)
                               and torch.equal(back[1][0], flags)
                               and mine[0].shape[0] == 4)
    expect = tc.SecretKeySet.random(1, ChaChaRng(b"\x2a" * 32)).public_keys()
    if mesh.rank == 0:
        payload = serde_impl.serialize(expect)
        errors = []
        for data, max_len in ((None, 4096), (payload, 8)):
            try:
                mh.broadcast_bytes(data, max_len=max_len)
            except ValueError as e:
                errors.append(str(e))
        out["rank0_errors"] = errors
        got = mh.broadcast_bytes(payload, max_len=4096)
    else:
        got = mh.broadcast_bytes(None, max_len=4096)
    out["broadcast_equal"] = serde_impl.deserialize(tc.PublicKeySet,
                                                    got) == expect
    out["payload"] = got.hex()
    mh.assert_equal_across_hosts({"pk": torch.frombuffer(
        bytearray(got), dtype=torch.uint8)}, "public key set")
    try:
        mh.assert_equal_across_hosts([x + (mesh.rank == 1)], "shares")
        out["divergence"] = "not raised"
    except AssertionError as e:
        out["divergence"] = str(e)
    return out


def world_checks(mesh, combine_n, combine_seed, rlc_n, rlc_seed, rlc_msm,
                 rlc_dead=(), fold_cases=False, runtime=False):
    out = {"rank": mesh.rank,
           "combine": _combine(mesh, combine_n, combine_seed),
           "rlc": _rlc(mesh, rlc_n, rlc_seed, rlc_msm, tuple(rlc_dead))}
    if fold_cases:
        out["fold"] = _fold_cases(mesh)
    if runtime:
        out["runtime"] = _runtime(mesh)
    return out
