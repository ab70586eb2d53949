"""Count the torch ops and kernel launches of one port ``verify_batch`` call.

    python benches/torch_op_count.py

Runs ``threshold_crypto_tpu_torch.ops.verify_batch`` on the CPU (the kernels'
plain versions stand in for them) under a dispatch counter, and prints one
JSON line: the torch ops the call issues outside the two kernels' plain
versions (on the card each is one launch of a PyTorch kernel, the host
overhead that sets the port's pace), and the launches the two kernels would
get. The counts depend on the code path only, not on the lane count.
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

    counter = _Counter()
    launches = {"mont_mul": 0, "mont_pow": 0}
    plain = cuda_mont.mul_ref, cuda_mont.pow_fixed_ref

    def as_kernel(name, fn):
        def run(*a):
            if counter.paused:  # a product inside the power's chain
                return fn(*a)
            launches[name] += 1
            counter.paused = True
            try:
                return fn(*a)
            finally:
                counter.paused = False
        return run

    cuda_mont.mul_ref = as_kernel("mont_mul", plain[0])
    cuda_mont.pow_fixed_ref = as_kernel("mont_pow", plain[1])
    try:
        with counter:
            ok = ops.verify_batch(pk, hs, sig)
    finally:
        cuda_mont.mul_ref, cuda_mont.pow_fixed_ref = plain
    if not bool(ok.all()):
        raise SystemExit("verify_batch rejected valid lanes")
    print(json.dumps({"lanes": LANES, "torch_ops": counter.ops,
                      "kernel_launches": launches}))


if __name__ == "__main__":
    main()
