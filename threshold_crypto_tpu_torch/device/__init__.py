"""Batched BLS12-381 arithmetic on torch tensors."""
