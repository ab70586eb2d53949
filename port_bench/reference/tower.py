"""Host-side (Python-int) BLS12-381 extension-field tower.

Frozen for the benchmark: a verbatim copy of the port's
``threshold_crypto_tpu_torch/host/tower.py``, kept here so that the
benchmark's reference imports nothing of the program and stays fixed
when the program changes.

Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³-ξ) with ξ = u+1, Fq12 = Fq6[w]/(w²-v).

Elements: Fq = int, Fq2 = (c0, c1), Fq6 = (fq2, fq2, fq2), Fq12 = (fq6, fq6).
A copy of ``threshold_crypto_tpu/host/tower.py``; the device tower embeds its
Frobenius constants, and the tests use it as an oracle.
"""

from __future__ import annotations

from .params import P

# ---------------------------------------------------------------------------
# Fq
# ---------------------------------------------------------------------------

def fq_add(a, b):
    return (a + b) % P


def fq_sub(a, b):
    return (a - b) % P


def fq_mul(a, b):
    return a * b % P


def fq_neg(a):
    return -a % P


def fq_inv(a):
    return pow(a, -1, P)


def fq_sqrt(a):
    """sqrt in Fq (p ≡ 3 mod 4): a^((p+1)/4), or None if a is not a QR."""
    if a == 0:
        return 0
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2 + 1)
# ---------------------------------------------------------------------------
FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = (1, 1)  # Fq6/Fq12 tower non-residue xi = 1 + u


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    t2 = (a0 + a1) * (b0 + b1)
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sqr(a):
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fq2_scale(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fq2_conj(a):
    return (a[0], -a[1] % P)


def fq2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = pow(norm, -1, P)
    return (a0 * ninv % P, -a1 * ninv % P)


def fq2_is_zero(a):
    return a[0] % P == 0 and a[1] % P == 0


def fq2_pow(a, e):
    result = FQ2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        e >>= 1
    return result


def fq2_cmp(a, b):
    """Lexicographic ordering as in pairing 0.16's Fq2: c1 first, then c0."""
    if a[1] != b[1]:
        return -1 if a[1] < b[1] else 1
    if a[0] != b[0]:
        return -1 if a[0] < b[0] else 1
    return 0


def fq2_sqrt(a):
    """sqrt in Fq2 for p ≡ 3 mod 4 (Adj–Rodríguez-Henríquez alg. 9).

    Returns one square root or None.  Root *choice* is normalized by callers
    (compressed-point sort flag / `greatest` bit), so any valid root works.
    """
    if fq2_is_zero(a):
        return FQ2_ZERO
    a1 = fq2_pow(a, (P - 3) // 4)
    x0 = fq2_mul(a1, a)
    alpha = fq2_mul(a1, x0)  # a^((p-1)/2)
    # norm = alpha^(p+1) = alpha^p * alpha; alpha^p = conj(alpha)
    norm = fq2_mul(fq2_conj(alpha), alpha)
    if norm == (P - 1, 0) or norm == (-1 % P, 0):
        return None
    if alpha == (P - 1, 0):
        x = fq2_mul((0, 1), x0)  # multiply by u (= sqrt(-1))
    else:
        b = fq2_pow(fq2_add(FQ2_ONE, alpha), (P - 1) // 2)
        x = fq2_mul(b, x0)
    return x if fq2_sqr(x) == (a[0] % P, a[1] % P) else None


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------
FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def _mul_by_xi(a):
    # (c0 + c1 u) * (1 + u) = (c0 - c1) + (c0 + c1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, _mul_by_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), _mul_by_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2
    return (_mul_by_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), _mul_by_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(_mul_by_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_add(_mul_by_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))), fq2_mul(a0, c0))
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v)
# ---------------------------------------------------------------------------
FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    """Conjugation = Frobenius^6 (negate the w-part).  For elements of the
    cyclotomic subgroup this equals inversion."""
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    t = fq6_inv(fq6_sub(fq6_sqr(a0), fq6_mul_by_v(fq6_sqr(a1))))
    return (fq6_mul(a0, t), fq6_neg(fq6_mul(a1, t)))


def fq12_pow(a, e):
    if e < 0:
        return fq12_pow(fq12_inv(a), -e)
    result = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


def fq12_is_one(a):
    return a == FQ12_ONE or (
        a[0][0] == (1 % P, 0)
        and all(fq2_is_zero(c) for c in (a[0][1], a[0][2], *a[1]))
    )


# ---------------------------------------------------------------------------
# Frobenius maps.  Coefficients derived at import (no transcription).
# FROB12_C1[i] = xi^((p^i - 1)/6)         (multiplies the w-part)
# FROB6_C1[i]  = xi^((p^i - 1)/3)         (multiplies the v-part in Fq6)
# FROB6_C2[i]  = xi^(2 (p^i - 1)/3)       (multiplies the v^2-part in Fq6)
# ---------------------------------------------------------------------------

def _derive_frob():
    c12, c61, c62 = [], [], []
    for i in range(12):
        e = pow(P, i) - 1
        assert e % 6 == 0
        c12.append(fq2_pow(XI, e // 6))
        c61.append(fq2_pow(XI, e // 3))
        c62.append(fq2_pow(XI, 2 * e // 3))
    return c12, c61, c62


FROB12_C1, FROB6_C1, FROB6_C2 = _derive_frob()


def fq2_frob(a, power):
    """(a0 + a1 u)^(p^i): u^p = -u since p ≡ 3 mod 4."""
    return a if power % 2 == 0 else fq2_conj(a)


def fq6_frob(a, power):
    c0 = fq2_frob(a[0], power)
    c1 = fq2_mul(fq2_frob(a[1], power), FROB6_C1[power % 12])
    c2 = fq2_mul(fq2_frob(a[2], power), FROB6_C2[power % 12])
    return (c0, c1, c2)


def fq12_frob(a, power):
    c0 = fq6_frob(a[0], power)
    c1 = fq6_frob(a[1], power)
    c1 = tuple(fq2_mul(x, FROB12_C1[power % 12]) for x in c1)
    return (c0, c1)
