"""Index → field-element conversion, mirroring the reference's
``src/into_fr.rs``; a copy of ``threshold_crypto_tpu/into_fr.py``.

Fr values are plain Python ints in ``[0, backend.r)``.  Accepted inputs:
* non-negative ints (the u64/usize impls): value reduced into the field,
* negative ints (the i32/i64 impls): ``-((-x) mod r)`` i.e. negate in-field,
* ints already in the field pass through unchanged (the `Fr` impl).
"""

from __future__ import annotations

from .backend import get_backend


def into_fr(x) -> int:
    r = get_backend().r
    if isinstance(x, bool):
        raise TypeError("bool is not a valid Fr index")
    if not isinstance(x, int):
        raise TypeError(f"cannot convert {type(x).__name__} to Fr")
    if x >= 0:
        return x % r
    return -((-x) % r) % r


def into_fr_plus_1(x) -> int:
    """index i → Fr(i+1), so f(0) (the master secret) is never dealt
    (``src/lib.rs:769-773``)."""
    r = get_backend().r
    return (into_fr(x) + 1) % r
