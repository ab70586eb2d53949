"""Reference-exact sampling of field and curve elements from a ChaCha stream.

A copy of the parts of ``threshold_crypto_tpu/host/sampling.py`` that
``hash_g2`` needs, drawing from the port's :class:`.chacha.ChaChaRng`:

* ``fq_random``: fill the 6 u64 repr limbs from ``next_u64`` (little-endian
  limb order), mask the top 3 bits, retry until the masked value is < p.
  The accepted limbs are the *Montgomery form*, so the field value is
  ``limbs · R⁻¹ mod p``.
* ``fq2_random``: c0 then c1.
* ``g2_random``: loop { x = fq2_random; greatest = next_u32() odd;
  get_point_from_x(x, greatest); scale by the cofactor; retry if the point
  is the identity }.

It is the host oracle of the device chain in ``device/hash2g2.py``, and the
fallback for the few lanes that chain leaves unresolved.
"""

from __future__ import annotations

from . import curve as cv
from .params import FQ_SHAVE_MASK, P, R_MONT_FQ_INV


def fq_random(rng) -> int:
    while True:
        limbs = 0
        for i in range(6):
            limbs |= rng.next_u64() << (64 * i)
        limbs &= FQ_SHAVE_MASK
        if limbs < P:
            return limbs * R_MONT_FQ_INV % P


def fq2_random(rng):
    c0 = fq_random(rng)
    c1 = fq_random(rng)
    return (c0, c1)


def _curve_random(rng, group: cv.CurveGroup, base_random):
    while True:
        x = base_random(rng)
        greatest = rng.next_u32() % 2 != 0
        pt = group.get_point_from_x(x, greatest)
        if pt is None:
            continue
        pt = group.mul(pt, group.cofactor)
        if pt is not None:
            return pt


def g2_random(rng):
    return _curve_random(rng, cv.G2, fq2_random)
