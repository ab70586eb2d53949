"""The port's parallel layer in gloo worlds of CPU processes, held against
the port's single-device ops, the JAX package and its host oracle.

Worlds of 2 and 4 processes (``multihost.run_world``, one CPU thread each;
``tests/torch_parallel_worker.py``) and ``dryrun_multichip(2)`` run at once,
while this process computes the single-device references:

* ``sharded_combine`` equals ``ops.combine_batch`` and the JAX host
  oracle's H·f(0); ok is False on a duplicate x; a batch that does not
  divide the world raises ValueError;
* ``sharded_verify_rlc`` accepts the valid batch and rejects one replaced
  signature (world 2 on B15's ladders, world 4 on the shared-window MSM
  with one rank's lanes at infinity); its exponents equal the JAX
  ``ops.rlc_exponents`` of the whole batch, its aggregate equals the port's
  single-device ``rlc_aggregate_pallas`` and the host's MSM;
* the cross-rank fold on an infinite partial, T == Q and T == −Q;
* the runtime: ``world()``, shard / gather, ``broadcast_bytes`` of a
  serialized key set (and rank 0's ValueErrors), and
  ``assert_equal_across_hosts`` raising on divergence;
* the world-size-1 degradation, in this process.

The slow test holds world 2 against the JAX ``parallel.sharded_*`` on its
8-device CPU mesh, in a child process with XLA's fusion pass off.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from threshold_crypto_tpu.host import curve as jhcv
from threshold_crypto_tpu.host.params import R
from threshold_crypto_tpu.ops import threshold as jops
from threshold_crypto_tpu_torch import ops
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.ops import fr as frops
from threshold_crypto_tpu_torch.ops import threshold as tops
from threshold_crypto_tpu_torch.parallel import dryrun
from threshold_crypto_tpu_torch.parallel import mesh as pm
from threshold_crypto_tpu_torch.parallel import multihost as mh

import torch_parallel_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLDS = {
    2: dict(combine_n=4, combine_seed=0x9A11, rlc_n=4, rlc_seed=0x9A12,
            rlc_msm="scalarwise", fold_cases=True, runtime=True),
    4: dict(combine_n=8, combine_seed=0x9A13, rlc_n=8, rlc_seed=0x9A14,
            rlc_msm="shared", rlc_dead=[4, 5], fold_cases=True),
}


def _tuple(v):
    """JSON lists back to the host points' nested tuples."""
    return tuple(_tuple(x) for x in v) if isinstance(v, list) else v


def _aff(pts, g2):
    return (dpr.g2_affine_from_host if g2 else dpr.g1_affine_from_host)(
        pts, device="cpu")


def _references(n, sc):
    """The port's single-device values for one world's scenario."""
    _, _, shares = worker.combine_inputs(sc["combine_n"], sc["combine_seed"])
    xs = frops.fr_to_device(range(1, sc["combine_n"] + 1), "cpu")
    pt, ok = ops.combine_batch(dcv.G2, dcv.G2.from_host_affine(
        shares, device="cpu"), xs)
    pk, _, sig, _ = worker.rlc_inputs(sc["rlc_n"], sc["rlc_seed"],
                                      tuple(sc.get("rlc_dead", ())))
    pk_a, sig_a = _aff(pk, False), _aff(sig, True)
    r = ops.rlc_exponents(sc["rlc_n"], b"\x11" * 32, pk_aff=pk_a,
                          sig_aff=sig_a)
    agg = tops.rlc_aggregate_pallas(pk_a, sig_a, r)
    return {"combine": (worker._point(dcv.G2, pt), bool(ok)),
            "aggregate": [worker._aff_point(agg[0], False),
                          worker._aff_point(agg[1], True)]}


@pytest.fixture(scope="module")
def runs():
    """Each world's per-rank results, the dryrun's, and the single-device
    references computed here meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {n: pool.submit(mh.run_world,
                               "torch_parallel_worker:world_checks", n,
                               device="cpu", kwargs=sc, timeout_s=600,
                               path=[HERE])
                for n, sc in WORLDS.items()}
        futs["dryrun"] = pool.submit(dryrun.dryrun_multichip, 2,
                                     device="cpu")
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            refs = {n: _references(n, sc) for n, sc in WORLDS.items()}
        finally:
            torch.set_num_threads(n_threads)
        out = {k: f.result() for k, f in futs.items()}
    out["refs"] = refs
    return out


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_sharded_combine(runs, n):
    sc = WORLDS[n]
    h, secret, _ = worker.combine_inputs(sc["combine_n"], sc["combine_seed"])
    want = jhcv.G2.mul(h, secret)                      # the JAX host oracle
    for res in runs[n]:
        c = res["combine"]
        assert _tuple(c["point"]) == want
        assert (_tuple(c["point"]), c["ok"]) == (runs["refs"][n]["combine"][0],
                                                 True)
        assert c["ok_duplicate"] is False
        assert "must divide the mesh" in c["odd_batch"]


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_sharded_verify_rlc(runs, n):
    """Verdicts, the exponents (the JAX ``rlc_exponents`` of the whole
    batch), and the aggregate (single-device port, host MSM)."""
    sc = WORLDS[n]
    dead = tuple(sc.get("rlc_dead", ()))
    pk, _, sig, _ = worker.rlc_inputs(sc["rlc_n"], sc["rlc_seed"], dead)
    from threshold_crypto_tpu.device import pairing as jpr

    def host_leaves(tree):       # numpy leaves: the transcript on hashlib
        if isinstance(tree, tuple):
            return tuple(host_leaves(t) for t in tree)
        return np.asarray(tree)

    want_r = np.asarray(jops.rlc_exponents(
        sc["rlc_n"], b"\x11" * 32,
        pk_aff=host_leaves(jpr.g1_affine_from_host(pk)),
        sig_aff=host_leaves(jpr.g2_affine_from_host(sig)), on_device=False))
    r = [int.from_bytes(np.asarray(row, np.uint16).tobytes(), "little")
         for row in want_r]
    live = [i for i in range(sc["rlc_n"]) if i not in dead]
    host = [jhcv.G1.msm([pk[i] for i in live], [r[i] for i in live]),
            jhcv.G2.msm([sig[i] for i in live], [r[i] for i in live])]
    for res in runs[n]:
        got = res["rlc"]
        assert (got["valid"], got["tampered"]) == (True, False)
        assert np.array_equal(np.asarray(got["r"]).astype(np.uint32),
                              want_r)
        agg = [_tuple(a) for a in got["aggregate"]]
        assert agg == runs["refs"][n]["aggregate"] == host


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_cross_rank_fold_cases(runs, n):
    """An infinite partial, equal partials (T == Q) and opposite ones
    (T == −Q, a sum at infinity), G1 and G2, on every rank."""
    for name, host in (("G1", jhcv.G1), ("G2", jhcv.G2)):
        base = 1234567
        live = [r for r in range(n) if r % 2 == 0]
        want = {
            "one_infinite": host.mul(host.generator,
                                     sum(base + r for r in live) % R),
            "equal": host.mul(host.generator, n * base % R),
            "opposite": None,
        }
        for res in runs[n]:
            for case, w in want.items():
                assert _tuple(res["fold"][f"{name} {case}"]) == w, case


def test_runtime_in_a_world_of_two(runs):
    import threshold_crypto_tpu as jtc
    from threshold_crypto_tpu import serde_impl as jserde
    from threshold_crypto_tpu.utils.rng import ChaChaRng as JChaChaRng

    jax_payload = jserde.serialize(
        jtc.SecretKeySet.random(1, JChaChaRng(b"\x2a" * 32)).public_keys())
    for rank, res in enumerate(runs[2]):
        rt = res["runtime"]
        assert rt["world"] == [rank, 2] and rt["mesh_size"] == 2
        assert rt["shard_gather"] and rt["broadcast_equal"]
        assert bytes.fromhex(rt["payload"]) == jax_payload
        assert rt["divergence"] == "shares diverged across hosts"
    assert runs[2][0]["runtime"]["rank0_errors"] == [
        "process 0 must supply data",
        f"payload {len(jax_payload)} exceeds max_len 8"]


def test_dryrun_multichip_two_ranks(runs):
    res = runs["dryrun"]
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["verify"] == [True, True]
        assert r["combine_ok"] and r["rlc_ok"]
    assert res[0]["combined"] == res[1]["combined"]


def test_world_size_one_degrades(monkeypatch):
    """No coordinator: ``initialize`` does nothing, the mesh is this
    process, broadcast is the identity, the guard a no-op, and the sharded
    combine is ``ops.combine_batch``'s point."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mh.initialize(device="cpu") is False
    assert mh.world() == (0, 1)
    mesh = mh.global_mesh(device="cpu")
    assert mesh.devices.size == 1 and mesh.group is None
    payload = b"ciphertext-bytes \x00\x01"
    assert mh.broadcast_bytes(payload) == payload
    with pytest.raises(ValueError, match="process 0 must supply data"):
        mh.broadcast_bytes(None)
    mh.assert_equal_across_hosts({"x": np.arange(3)})
    x = torch.arange(12).reshape(4, 3)
    assert torch.equal(pm.gather_batch(mesh, pm.shard_batch(mesh, x)), x)
    assert pm.batch_spec((x, x)) == (("shares",), ("shares",))
    assert pm.repl_spec([x]) == [()]
    with pytest.raises(ValueError, match="need 2 devices"):
        pm.make_mesh(2, device="cpu")
    pts = [jhcv.G1.mul(jhcv.G1.generator, k) for k in (3, 5)]
    jac = dcv.G1.from_host_affine(pts, device="cpu")
    xs = frops.fr_to_device([1, 2], "cpu")
    from threshold_crypto_tpu_torch.parallel import sharded

    got, ok = sharded.sharded_combine(mesh, dcv.G1, jac, xs)
    want, _ = ops.combine_batch(dcv.G1, jac, xs)
    assert bool(ok)
    assert worker._point(dcv.G1, got) == worker._point(dcv.G1, want) == \
        jhcv.G1.mul(jhcv.G1.generator, (2 * 3 - 5) % R)


# The JAX package's sharded ops on its 8-device CPU mesh, in a child: their
# XLA:CPU compiles (a G2 MSM, a pairing) take minutes with fusion on.
_JAX_CHILD = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch_parallel_worker as worker
from threshold_crypto_tpu import ops, parallel as par
from threshold_crypto_tpu.device import curve as dcv
from threshold_crypto_tpu.device import pairing as dpr
from threshold_crypto_tpu.ops import fr as frops
sc = json.loads(sys.argv[2])
mesh = par.make_mesh(8)
n = sc["combine_n"]
_, _, shares = worker.combine_inputs(n, sc["combine_seed"])
out, ok = par.sharded_combine(
    mesh, dcv.G2, par.shard_batch(mesh, dcv.G2.from_host_affine(shares)),
    par.replicate(mesh, frops.fr_to_device(list(range(1, n + 1)))))
point = dcv.G2.to_host_affine(jax.tree_util.tree_map(lambda a: a[None], out))[0]
pk, h, sig, bad = worker.rlc_inputs(sc["rlc_n"], sc["rlc_seed"])
pk_a = par.shard_batch(mesh, dpr.g1_affine_from_host(pk))
verdicts = []
for s in (sig, bad):
    sig_a = par.shard_batch(mesh, dpr.g2_affine_from_host(s))
    r = ops.rlc_exponents(sc["rlc_n"], b"\\x11" * 32, pk_aff=pk_a, sig_aff=sig_a)
    verdicts.append(bool(par.sharded_verify_rlc(
        mesh, pk_a, dcv.G2.from_host_affine([h]), sig_a, r)))
print(json.dumps({"point": point, "ok": bool(ok), "rlc": verdicts}))
"""


@pytest.mark.slow
def test_world_two_equals_the_jax_sharded_ops():
    sc = dict(combine_n=8, combine_seed=0x9A15, rlc_n=8, rlc_seed=0x9A16,
              rlc_msm="scalarwise")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=8 "
        "--xla_disable_hlo_passes=fusion"))
    proc = subprocess.run([sys.executable, "-c", _JAX_CHILD, HERE,
                           json.dumps(sc)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=7200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for res in mh.run_world("torch_parallel_worker:world_checks", 2,
                            device="cpu", kwargs=sc, timeout_s=900,
                            path=[HERE]):
        assert res["combine"]["point"] == want["point"]
        assert res["combine"]["ok"] == want["ok"] is True
        assert [res["rlc"]["valid"], res["rlc"]["tampered"]] == \
            want["rlc"] == [True, False]
