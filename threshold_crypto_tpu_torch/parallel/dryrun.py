"""``dryrun_multichip``: the whole sharded threshold step, one share per rank.

The port's analog of ``__graft_entry__.dryrun_multichip``: a world of
``n_devices`` processes (``multihost.run_world``), each holding one share of
a deterministic batch made on the host, runs sign → verify → combine → the
sharded RLC check with the share batch split over the mesh, and asserts
what the JAX dryrun asserts: every share verifies, the combine's x are
distinct, and the RLC check accepts the batch.

    python -c "from threshold_crypto_tpu_torch.parallel import dryrun; \\
               print(dryrun.dryrun_multichip(2, device='cpu'))"
"""

from __future__ import annotations

import random

import torch


def example_batch(n: int, device):
    """pk, H, sig (affine) and sk (canonical Fr limbs) of n shares, each on
    its own message, from the JAX dryrun's seed."""
    from ..device import curve as dcv
    from ..device import pairing as dpr
    from ..host import curve as hcv
    from ..host.params import R

    rnd = random.Random(0x5EED)
    sks = [rnd.randrange(1, R) for _ in range(n)]
    hks = [rnd.randrange(1, R) for _ in range(n)]
    h_host = [hcv.G2.mul(hcv.G2.generator, k) for k in hks]
    pk_host = [hcv.G1.mul(hcv.G1.generator, s) for s in sks]
    return (dpr.g1_affine_from_host(pk_host, device=device),
            dpr.g2_affine_from_host(h_host, device=device),
            dcv.fr_limbs_from_ints(sks, device=device))


def run_rank(mesh) -> dict:
    """One rank of the dryrun; returns its verdicts and the combined point
    (host affine coordinates, the same on every rank)."""
    from .. import ops
    from ..device import curve as dcv
    from ..ops import fr as frops
    from . import mesh as pm
    from . import sharded

    n = mesh.world
    pk_g, h_g, sk_g = example_batch(n, mesh.device)
    pk, h_aff, sk = pm.shard_batch(mesh, (pk_g, h_g, sk_g))
    xs = pm.replicate(mesh, frops.fr_to_device(range(1, n + 1), "cpu"))
    h_jac = ops.affine_to_jacobian(dcv.G2, h_aff)

    # sign and verify: per block, no collectives
    sig_jac = sharded.sharded_sign(mesh, h_jac, sk)
    sig_aff = ops.jacobian_to_affine(dcv.G2, sig_jac)
    ok = sharded.sharded_verify(mesh, pk, h_aff, sig_aff)
    # combine: the partial MSMs cross ranks in the fold
    combined, ok_c = sharded.sharded_combine(mesh, dcv.G2, sig_jac, xs)
    # the sharded RLC check of n shares on one message: exponents from the
    # whole batch, then the blocks
    h1 = dcv.tree_map(lambda a: a[:1], ops.affine_to_jacobian(dcv.G2, h_g))
    sig2 = ops.jacobian_to_affine(dcv.G2, sharded.sharded_sign(
        mesh, dcv.tree_map(lambda a: a.expand((sk.shape[0],) + a.shape[1:]),
                           h1), sk))
    sig2_g = pm.gather_batch(mesh, sig2)
    r = ops.rlc_exponents(n, b"\x17" * 32, pk_aff=pk_g, sig_aff=sig2_g)
    ok_rlc = bool(sharded.sharded_verify_rlc(mesh, pk, h1, sig2,
                                             pm.shard_batch(mesh, r)))
    ok_all = pm.gather_batch(mesh, ok)
    for good, what in ((bool(ok_all.all()), "sharded share-verification "
                        f"failed: {ok_all.tolist()}"),
                       (bool(ok_c), "sharded combine flagged duplicate x "
                        "coordinates"),
                       (ok_rlc, "sharded RLC batch verification failed")):
        if not good:
            raise AssertionError(what)
    pt = dcv.G2.to_host_affine(dcv.tree_map(lambda a: a[None], combined))[0]
    return {"rank": mesh.rank, "world": n, "verify": ok_all.tolist(),
            "combine_ok": bool(ok_c), "rlc_ok": ok_rlc, "combined": pt}


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the sharded step in a world of ``n_devices`` processes on this
    host; returns each rank's result and raises if a rank fails. On the
    card, each rank takes ``cuda:{rank % device count}`` over nccl, or over
    gloo where ranks share a card; device="cpu" runs a gloo world on the
    CPU."""
    from . import multihost

    backend = None
    if str(device) != "cpu" and n_devices > torch.cuda.device_count():
        backend = "gloo"
    return multihost.run_world(f"{__name__}:run_rank", n_devices,
                               device=device, backend=backend)
