"""Reference-exact random sampling of field and curve elements.

A copy of ``threshold_crypto_tpu/host/sampling.py``. It replicates the
sampling the reference inherits from ``pairing 0.16`` / ``ff 0.6`` so that
``hash_g2`` (``src/lib.rs:691-694``) and deterministic seeded keygen
(``src/lib.rs:1066-1081``) consume the RNG stream identically:

* ``Fq::random`` / ``Fr::random``: fill the 6 (resp. 4) u64 repr limbs from
  ``next_u64`` (little-endian limb order), mask the top REPR_SHAVE_BITS
  (3 for Fq, 1 for Fr), retry until the masked value is < modulus.  The
  accepted limbs are the *Montgomery form*, so the field value is
  ``limbs · R⁻¹ mod p``.
* ``Fq2::random``: c0 then c1.
* ``G1/G2::random``: loop { x = random base-field element; greatest =
  next_u32() odd; get_point_from_x(x, greatest); scale by cofactor; retry
  if identity }.

``g2_random`` is the pure-Python oracle of the native ``hash_g2`` and of
the device chain in ``device/hash2g2.py``.
"""

from __future__ import annotations

from ..utils.rng import RngCore
from . import curve as cv
from .params import (
    FQ_SHAVE_MASK,
    FR_SHAVE_MASK,
    P,
    R,
    R_MONT_FQ_INV,
    R_MONT_FR_INV,
)


def fq_random(rng: RngCore) -> int:
    while True:
        limbs = 0
        for i in range(6):
            limbs |= rng.next_u64() << (64 * i)
        limbs &= FQ_SHAVE_MASK
        if limbs < P:
            return limbs * R_MONT_FQ_INV % P


def fr_random(rng: RngCore) -> int:
    while True:
        limbs = 0
        for i in range(4):
            limbs |= rng.next_u64() << (64 * i)
        limbs &= FR_SHAVE_MASK
        if limbs < R:
            return limbs * R_MONT_FR_INV % R


def fq2_random(rng: RngCore):
    c0 = fq_random(rng)
    c1 = fq_random(rng)
    return (c0, c1)


def _curve_random(rng: RngCore, group: cv.CurveGroup, base_random):
    while True:
        x = base_random(rng)
        greatest = rng.next_u32() % 2 != 0
        pt = group.get_point_from_x(x, greatest)
        if pt is None:
            continue
        pt = group.mul(pt, group.cofactor)
        if pt is not None:
            return pt


def g1_random(rng: RngCore):
    return _curve_random(rng, cv.G1, fq_random)


def g2_random(rng: RngCore):
    return _curve_random(rng, cv.G2, fq2_random)
