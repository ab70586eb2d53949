"""Batched protocol operations on the device stack."""

from .threshold import (affine_to_jacobian, batch_inv_field,
                        encrypt_batch_pallas, jacobian_to_affine,
                        rlc_exponents, verify_batch, verify_batch_pallas,
                        verify_sig_shares_rlc_pallas, verify_with_hash_batch)

__all__ = ["affine_to_jacobian", "batch_inv_field", "encrypt_batch_pallas",
           "jacobian_to_affine", "rlc_exponents", "verify_batch",
           "verify_batch_pallas", "verify_sig_shares_rlc_pallas",
           "verify_with_hash_batch"]
