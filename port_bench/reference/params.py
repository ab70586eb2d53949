"""BLS12-381 curve parameters for the PyTorch port.

Frozen for the benchmark: a verbatim copy of the port's
``threshold_crypto_tpu_torch/host/params.py``, kept here so that the
benchmark's reference imports nothing of the program and stays fixed
when the program changes.

A copy of ``threshold_crypto_tpu/host/params.py``: the port imports nothing
of the JAX package, so it keeps its own copy of this pure-Python module.
Everything derivable is derived from the BLS parameter ``X`` and checked
against the published values at import time.

  * G1 ⊂ E(Fp):  y² = x³ + 4        — public keys
  * G2 ⊂ E'(Fp2): y² = x³ + 4(u+1)  — signatures / message hashes
  * Fr — scalar field (255 bits), secret keys.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# The BLS parameter. Everything else follows from it.
# ---------------------------------------------------------------------------
X = -0xD201000000010000

# Scalar field modulus r = X^4 - X^2 + 1 (cyclotomic polynomial Φ12 at X).
R = X**4 - X**2 + 1
# Base field modulus p = (X - 1)^2 * r / 3 + X.
P = (X - 1) ** 2 * R // 3 + X

# Known published values (IETF RFC 9380 §4.2.1, zkcrypto/bls12_381) -- the
# derivation above must reproduce them exactly.
assert R == 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
assert P == int(
    "1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F624"
    "1EABFFFEB153FFFFB9FEFFFFFFFFAAAB",
    16,
)

P_BITS = P.bit_length()   # 381
R_BITS = R.bit_length()   # 255
assert P_BITS == 381 and R_BITS == 255

# Curve constants: E: y^2 = x^3 + 4, twist E': y^2 = x^3 + 4(u+1) over
# Fp2 = Fp[u]/(u^2+1).
B_G1 = 4
B_G2 = (4, 4)  # 4 * (1 + u)

# Cofactors, derived from X (Hasse bound checked below).
H1 = (X - 1) ** 2 // 3
H2 = (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) // 9
assert (X - 1) ** 2 % 3 == 0
assert (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) % 9 == 0
assert H1 == 0x396C8C005555E1568C00AAAB0000AAAB

# Hasse sanity: |#E - (q+1)| <= 2 sqrt(q) for #E(Fp) = h1*r, #E'(Fp2) = h2*r.
def _isqrt(n: int) -> int:
    import math
    return math.isqrt(n)

assert abs(H1 * R - (P + 1)) <= 2 * _isqrt(P)
assert abs(H2 * R - (P * P + 1)) <= 2 * _isqrt(P * P)

# ---------------------------------------------------------------------------
# Generators (standards-track values; RFC 9380 §4.2.1 / zkcrypto).  They are
# validated below: on curve, and of order exactly r.
# ---------------------------------------------------------------------------
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# On-curve checks (subgroup/order checks live in tests, needing curve ops).
assert (G1_GEN[1] ** 2 - (G1_GEN[0] ** 3 + B_G1)) % P == 0


def _fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


_x2 = _fq2_mul(G2_GEN[0], G2_GEN[0])
_x3 = _fq2_mul(_x2, G2_GEN[0])
_y2 = _fq2_mul(G2_GEN[1], G2_GEN[1])
assert _y2 == _fq2_add(_x3, B_G2)

# ---------------------------------------------------------------------------
# Montgomery parameters for the limb backends and for replicating
# ``pairing 0.16``'s random sampling (repr limbs ARE the Montgomery form).
# ---------------------------------------------------------------------------
R_MONT_FQ = (1 << 384) % P       # R for Fq (6x64 / 24x16 limbs)
R_MONT_FQ_INV = pow(R_MONT_FQ, -1, P)
R_MONT_FR = (1 << 256) % R       # R for Fr (4x64 / 16x16 limbs)
R_MONT_FR_INV = pow(R_MONT_FR, -1, R)

# Repr shave bits (mask of the random u64-limb sampling): 384-381 / 256-255.
FQ_SHAVE_MASK = (1 << 381) - 1
FR_SHAVE_MASK = (1 << 255) - 1

# ---------------------------------------------------------------------------
# Final exponentiation decomposition.
#
# full exponent = (p^12 - 1) / r = (p^6 - 1)(p^2 + 1) * hard,
# hard = (p^4 - p^2 + 1) / r.  We use the standard BLS12 lattice form
#   3 * hard = (X-1)^2 (X + p) (X^2 + p^2 - 1) + 3
# so all implementations raise to 3*(full exponent); since 3 ∤ r and GT values
# are only ever compared for equality,
# the extra cube is harmless and saves a large generic exponentiation.
# ---------------------------------------------------------------------------
HARD_EXP = (P**4 - P**2 + 1) // R
assert (P**4 - P**2 + 1) % R == 0
assert (X - 1) ** 2 * (X + P) * (X**2 + P**2 - 1) + 3 == 3 * HARD_EXP

# |X| bits for Miller loop / x-exponentiation (64-bit, very low Hamming weight)
X_ABS = -X
X_BITS = [int(b) for b in bin(X_ABS)[2:]]  # MSB first, 64 entries
assert len(X_BITS) == 64 and sum(X_BITS) == 6
