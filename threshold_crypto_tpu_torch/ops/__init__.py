"""Batched protocol operations on the device stack."""

from .threshold import (affine_to_jacobian, batch_inv_field,
                        jacobian_to_affine, rlc_exponents,
                        verify_batch, verify_batch_pallas,
                        verify_sig_shares_rlc_pallas)

__all__ = ["affine_to_jacobian", "batch_inv_field", "jacobian_to_affine",
           "rlc_exponents", "verify_batch", "verify_batch_pallas",
           "verify_sig_shares_rlc_pallas"]
