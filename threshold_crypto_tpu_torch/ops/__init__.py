"""Batched protocol operations on the device stack: the names of the JAX
package's ``ops`` but its jit, AOT-cache and stepwise wrappers, which have
no counterpart (``ops/threshold.py``)."""

from . import fr  # noqa: F401
from . import threshold  # noqa: F401
from .fr import (fr_from_device, fr_from_plain, fr_to_device, fr_to_plain,
                 interpolate_at_zero, lagrange_coeffs_at_zero, poly_eval)
from .threshold import (affine_to_jacobian, batch_inv_field,
                        bivar_commit_batch, bivar_commit_eval_batch,
                        bivar_commit_row_batch, bivar_row_batch,
                        ciphertext_verify_batch, combine_batch, commit_batch,
                        decrypt_share_batch, derive_shares,
                        encrypt_batch, encrypt_batch_pallas,
                        encrypt_begin_batch, encrypt_finish_batch,
                        jacobian_to_affine, powers_batch, rlc_exponents,
                        sign_batch, verify_batch, verify_batch_pallas,
                        verify_dec_share_batch, verify_sig_shares_rlc,
                        verify_sig_shares_rlc_pallas,
                        verify_with_hash_batch)

__all__ = ["affine_to_jacobian", "batch_inv_field", "bivar_commit_batch",
           "bivar_commit_eval_batch", "bivar_commit_row_batch",
           "bivar_row_batch", "ciphertext_verify_batch", "combine_batch",
           "commit_batch", "decrypt_share_batch", "derive_shares",
           "encrypt_batch", "encrypt_batch_pallas", "encrypt_begin_batch",
           "encrypt_finish_batch", "fr_from_device", "fr_from_plain",
           "fr_to_device", "fr_to_plain", "interpolate_at_zero",
           "jacobian_to_affine", "lagrange_coeffs_at_zero", "poly_eval",
           "powers_batch", "rlc_exponents", "sign_batch", "verify_batch",
           "verify_batch_pallas", "verify_dec_share_batch",
           "verify_sig_shares_rlc", "verify_sig_shares_rlc_pallas",
           "verify_with_hash_batch"]
