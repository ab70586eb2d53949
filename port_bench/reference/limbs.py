"""The program's number layout, read back to Python ints: 16-bit limbs,
least significant first, Fq in 24 limbs and Fr in 16, field elements in
Montgomery form (x·2^384 mod p) and scalars canonical."""

from __future__ import annotations

import numpy as np

from .params import P, R

FQ_L, FR_L = 24, 16
_RINV_Q = pow(1 << (16 * FQ_L), -1, P)
_R_Q = (1 << (16 * FQ_L)) % P
_R_R = (1 << (16 * FR_L)) % R


def ints(arr) -> list:
    """int32[..., L] limbs -> flat list of the integers they spell."""
    a = np.ascontiguousarray(np.asarray(arr), dtype=np.int32)
    rows = a.reshape(-1, a.shape[-1]).astype("<u2")
    width = 2 * a.shape[-1]
    raw = rows.tobytes()
    return [int.from_bytes(raw[i:i + width], "little")
            for i in range(0, len(raw), width)]


def fq(arr) -> list:
    """Montgomery Fq limbs -> flat list of field elements."""
    return [x * _RINV_Q % P for x in ints(arr)]


def fr_mont(arr) -> list:
    """Montgomery Fr limbs (x·2^256 mod r) -> flat list of scalars."""
    rinv = pow(_R_R, -1, R)
    return [x * rinv % R for x in ints(arr)]


def to_limbs(values, width: int) -> np.ndarray:
    """Canonical ints -> int32[len(values), width] 16-bit limbs."""
    raw = b"".join(int(v).to_bytes(2 * width, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").astype(np.int32).reshape(
        len(values), width)


def fq_mont_limbs(values) -> np.ndarray:
    """Field elements -> int32[len(values), 24] Montgomery limbs."""
    return to_limbs([v % P * _R_Q % P for v in values], FQ_L)


def g1_affine(x, y, inf) -> list:
    """Arrays of an affine G1 batch -> host points (None at infinity)."""
    xs, ys, infs = fq(x), fq(y), np.asarray(inf).reshape(-1).tolist()
    return [None if i else (a, b) for a, b, i in zip(xs, ys, infs)]


def g2_affine(x, y, inf) -> list:
    """Arrays of an affine G2 batch (x = (x0, x1), y likewise) -> host
    points."""
    x0, x1, y0, y1 = (fq(c) for c in (*x, *y))
    infs = np.asarray(inf).reshape(-1).tolist()
    return [None if i else ((a, b), (c, d))
            for a, b, c, d, i in zip(x0, x1, y0, y1, infs)]


def jacobian(curve, X, Y, Z) -> list:
    """Host lists of Jacobian coordinates (elements of the curve's field)
    -> affine host points, infinity where Z = 0."""
    return [curve._to_affine(j) for j in zip(X, Y, Z)]
