"""Count the torch ops and kernel launches of one call of each verify path.

    python benches/torch_op_count.py

Runs ``threshold_crypto_tpu_torch.ops.verify_batch`` and
``ops.verify_batch_pallas`` (the megakernel path) on the CPU, where the
kernels' plain versions stand in for them, under a dispatch counter, and
prints one JSON line per path: the torch ops the call issues outside the
kernels' plain versions (on the card each is one launch of a PyTorch
kernel, the host overhead that sets the pace of a host-bound call), and the
launches each kernel would get. The counts depend on the code path only,
not on the lane count.
"""

from __future__ import annotations

import json
import os
import random
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from threshold_crypto_tpu_torch import ops  # noqa: E402
from threshold_crypto_tpu_torch.device import cuda_mont  # noqa: E402
from threshold_crypto_tpu_torch.device import cuda_tower  # noqa: E402
from threshold_crypto_tpu_torch.device import pairing as dpr  # noqa: E402
from threshold_crypto_tpu_torch.host import curve as hcv  # noqa: E402
from threshold_crypto_tpu_torch.host.params import R  # noqa: E402

LANES = 2


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def count(fn, args):
    """(torch ops outside the plain versions, launches per kernel) of one
    fn(*args) call; a plain version called inside another (a product in
    the power's chain or a tower kernel) is part of that one launch."""
    counter = _Counter()
    launches = {}
    saved = []

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

    for mod in (cuda_mont, cuda_tower):
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
    return counter.ops, launches


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
        n_ops, launches = count(fn, (pk, hs, sig))
        print(json.dumps({"path": fn.__name__, "lanes": LANES,
                          "torch_ops": n_ops, "kernel_launches": launches}))


if __name__ == "__main__":
    main()
