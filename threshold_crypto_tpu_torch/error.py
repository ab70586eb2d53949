"""Crypto errors, mirroring the reference's ``src/error.rs``; a copy of
``threshold_crypto_tpu/error.py``."""

from __future__ import annotations


class ThresholdCryptoError(Exception):
    """Base class for protocol errors (the reference's `Error` enum)."""


class NotEnoughShares(ThresholdCryptoError):
    """Not enough signature shares (`src/error.rs:9-11`)."""

    def __str__(self):
        return "Not enough signature shares"


class DuplicateEntry(ThresholdCryptoError):
    """Shares contain a duplicated index (`src/error.rs:12-14`)."""

    def __str__(self):
        return "Signature shares contain a duplicated index"


class DegreeTooHigh(ThresholdCryptoError):
    """Polynomial degree does not fit (`src/error.rs:15-17`)."""

    def __str__(self):
        return "The degree is too high for the coefficients to be indexed by usize."


# Re-exported from backend for a single import point.
from .backend import FromBytesError  # noqa: E402,F401
