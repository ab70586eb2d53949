"""Polynomial bookkeeping of the port.

So far the one piece the DKG batch ops need: ``coeff_pos``, the position of a
coefficient of a symmetric bivariate polynomial in its triangular layout
(the counterpart of ``threshold_crypto_tpu/poly.py``'s, with the same
overflow rule). ``Poly``, ``BivarPoly`` and ``BivarCommitment`` come with
the host and protocol layers.
"""

from __future__ import annotations

_USIZE_MAX = (1 << 64) - 1


def coeff_pos(i: int, j: int):
    """Position of coefficient (i, j) in the symmetric triangular layout;
    None if it overflows usize (``src/poly.rs:749-753``)."""
    if j < i:
        i, j = j, i
    # The reference's checked usize arithmetic: j + 1, j·(j + 1) and the
    # final sum must each fit in 64 bits.
    if j + 1 > _USIZE_MAX or j * (j + 1) > _USIZE_MAX:
        return None
    pos = i + j * (j + 1) // 2
    if pos > _USIZE_MAX:
        return None
    return pos
