"""threshold_crypto_tpu_torch — the PyTorch/CUDA port of threshold_crypto_tpu.

A second package beside the JAX one, for one NVIDIA H100 (sm_90a). It
imports torch, numpy and the standard library, never JAX and nothing of
``threshold_crypto_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU the kernels' plain PyTorch versions run
in their place.

What is ported so far: BLS verification on the BLS12-381 stack of
:mod:`.device` (Montgomery field arithmetic, the Fq2/Fq6/Fq12 tower, G1/G2
Jacobian curves, the Miller loop and the final exponentiation), the hash to
G2, batched encryption, the threshold combine and the DKG, on these paths:
:func:`threshold_crypto_tpu_torch.ops.verify_batch` (strict per-pair
verify, the tower as stacked field products, kernels B1 and B2 in
``csrc/mont.cu``), :func:`threshold_crypto_tpu_torch.ops.verify_batch_pallas`
(the megakernel path: whole Miller iterations and Fq12 steps as one launch
each, kernels B4-B9 in ``csrc/miller.cu`` and ``csrc/fq12.cu`` on the
lane-group engine of ``csrc/tower_group.cuh``), and the RLC
batch verification of N shares on one message,
:func:`threshold_crypto_tpu_torch.ops.rlc_exponents` then
:func:`threshold_crypto_tpu_torch.ops.verify_sig_shares_rlc_pallas` (the
transcript hash B12 in ``csrc/keccak.cu``, the shared-window MSMs B10 and
B11 in ``csrc/msm.cu``, and one check through ``verify_batch_pallas``),
:func:`threshold_crypto_tpu_torch.ops.verify_with_hash_batch` (N signatures
on N distinct messages, the hash chain of :mod:`.device.hash2g2` with its
cofactor on the ladder kernel B13 of ``csrc/ladder.cu``) and
:func:`threshold_crypto_tpu_torch.ops.encrypt_batch_pallas` (three per-lane
ladders on B13; B15, the bit ladder, runs ``msm_pallas(window=1)``), and
:func:`threshold_crypto_tpu_torch.ops.combine_batch` (λ from
:mod:`.ops.fr`, above 1024 shares on the all-pairs kernel B14 of
``csrc/fr.cu``; the 255-bit MSM on B11, B15 or B16 of ``csrc/shared.cu``)
with the sign, encrypt, decryption-share and check batch ops around it,
and the DKG batch ops :func:`threshold_crypto_tpu_torch.ops.bivar_commit_batch`,
:func:`~threshold_crypto_tpu_torch.ops.bivar_row_batch`,
:func:`~threshold_crypto_tpu_torch.ops.bivar_commit_row_batch` and
:func:`~threshold_crypto_tpu_torch.ops.bivar_commit_eval_batch` (a dealer's
commitment, rows, row commitments and value checks on the 255-bit ladders
B10/B13 and B1), with :func:`threshold_crypto_tpu_torch.ops.verify_sig_shares_rlc`
(the RLC check on per-lane bit ladders, B15). Every TPU kernel of the JAX
package has its counterpart; the last, B17 (the unfused Miller pieces in
``csrc/miller.cu``), is on no entry point's path, as in the JAX package.
"""
