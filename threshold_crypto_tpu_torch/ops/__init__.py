"""Batched protocol operations on the device stack."""

from .threshold import verify_batch, verify_batch_pallas

__all__ = ["verify_batch", "verify_batch_pallas"]
