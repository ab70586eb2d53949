"""Batched protocol operations on the device stack."""

from .threshold import verify_batch

__all__ = ["verify_batch"]
