"""Inputs from the seed, shared by the operation kinds."""

from __future__ import annotations

import contextlib
import hashlib
import random

import numpy as np
import torch

from ..reference import limbs
from ..reference import params

FR_L, FQ_L = 16, 24


def derive(seed: int, *salt) -> bytes:
    """32 bytes of the run's seed and a salt (SHA3-256)."""
    return hashlib.sha3_256(repr((int(seed),) + salt).encode()).digest()


def host_rng(seed: int, *salt) -> random.Random:
    return random.Random(derive(seed, *salt))


def generator(seed: int, device, *salt) -> torch.Generator:
    """A torch generator on ``device`` seeded from the seed and a salt."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(derive(seed, *salt)[:8], "little") >> 1)
    return gen


def random_scalars(n: int, gen, device) -> torch.Tensor:
    """int32[n, 16] canonical Fr limbs of uniform 254-bit scalars (below
    r), made on the device in one call."""
    k = torch.randint(0, 1 << 16, (n, FR_L), generator=gen, device=device,
                      dtype=torch.int32)
    k[:, FR_L - 1] &= 0x3FFF
    return k


def host_scalars(rnd, n: int) -> list:
    """n nonzero scalars mod r from a host RNG."""
    return [rnd.randrange(1, params.R) for _ in range(n)]


def fr_limbs(values, device) -> torch.Tensor:
    """Canonical scalars -> int32[n, 16] limbs on ``device``."""
    return torch.from_numpy(limbs.to_limbs(values, FR_L)).to(device)


def numpy_tree(tree):
    """Nested tuples of tensors -> the same of NumPy arrays (host copies)."""
    if isinstance(tree, tuple):
        return tuple(numpy_tree(t) for t in tree)
    return tree.detach().cpu().numpy()


def copy_tree(tree):
    """A copy of nested tuples of NumPy arrays."""
    if isinstance(tree, tuple):
        return tuple(copy_tree(t) for t in tree)
    return tree.copy()


def take(tree, idx):
    """Lanes ``idx`` of every leaf of nested tuples of arrays or tensors."""
    if isinstance(tree, tuple):
        return tuple(take(t, idx) for t in tree)
    return tree[idx]


def g1_host(aff_np) -> list:
    """A G1 affine tuple of arrays -> host points."""
    x, y, inf = aff_np
    return limbs.g1_affine(x, y, inf)


def g2_host(aff_np) -> list:
    """A G2 affine tuple of arrays -> host points."""
    x, y, inf = aff_np
    return limbs.g2_affine(x, y, inf)


def jac_host(curve, jac_np, g2: bool) -> list:
    """A Jacobian tuple of arrays (Fq2 leaves as pairs in G2) -> host
    affine points."""
    if g2:
        cols = [list(zip(limbs.fq(c[0]), limbs.fq(c[1]))) for c in jac_np]
    else:
        cols = [limbs.fq(c) for c in jac_np]
    return limbs.jacobian(curve, *cols)


def compare(name: str, value, limit) -> dict:
    """One number the run compares, with its limit (correct: value <=
    limit)."""
    return {"name": name, "value": value, "limit": limit}


def mismatches(got, want) -> int:
    return int(np.count_nonzero(np.asarray(got) != np.asarray(want)))


@contextlib.contextmanager
def pairing_one_bit_short():
    """The program doing less: the pairing's Miller loop and its
    exponentiations by X run one bit of |X| fewer."""
    from threshold_crypto_tpu_torch.device import pairing as dpr

    bits = dpr.X_BITS
    dpr.X_BITS = bits[:-1]
    try:
        yield
    finally:
        dpr.X_BITS = bits
