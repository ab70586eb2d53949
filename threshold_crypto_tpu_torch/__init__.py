"""threshold_crypto_tpu_torch — the PyTorch/CUDA port of threshold_crypto_tpu.

A second package beside the JAX one, for one NVIDIA H100 (sm_90a). It
imports torch, numpy and the standard library, never JAX and nothing of
``threshold_crypto_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU the kernels' plain PyTorch versions run
in their place.

The public API is the JAX package's (``import threshold_crypto_tpu_torch as
tc``): keys, shares, signatures and ciphertexts (``SecretKey``,
``SecretKeySet``, ``PublicKeySet``, ``Ciphertext``, ...), ``interpolate``,
the hashes ``hash_g2``, ``hash_g1_g2``, ``xor_with_hash`` and ``sha3_256``,
bincode ``serialize`` / ``deserialize`` with ``SerdeSecret``, the errors,
and the backend switch (``set_backend``, ``get_backend``, ``using``:
"bls12_381" or the insecure "mock"), the port's own state. These
scalar-path objects run on the host: the Python-int curves, codecs and
pairing of :mod:`.host`, and the g++-built native library of :mod:`.native`
(SHA3, ChaCha20, one message's hash to G2), built into ``_build/`` at its
first use. Their group elements hold host affine points (``.v``), which
``device.pairing.g1_affine_from_host`` / ``g2_affine_from_host`` lift to
the card for the batched ops below, which compute the same values.

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

from .backend import FromBytesError, get_backend, set_backend, using
from .error import (
    DegreeTooHigh,
    DuplicateEntry,
    NotEnoughShares,
    ThresholdCryptoError,
)
from .hashing import hash_g1_g2, hash_g2, sha3_256, xor_with_hash
from .into_fr import into_fr, into_fr_plus_1
from .lib import (
    Ciphertext,
    DecryptionShare,
    PublicKey,
    PublicKeySet,
    PublicKeyShare,
    SecretKey,
    SecretKeySet,
    SecretKeyShare,
    Signature,
    SignatureShare,
    interpolate,
)
from .lib import PK_SIZE as _pk_size_fn
from .lib import SIG_SIZE as _sig_size_fn
from .serde_impl import SerdeSecret, deserialize, serialize

# Constant-style accessors (sizes depend on the active backend, like the
# reference's cfg-gated PK_SIZE/SIG_SIZE consts).
PK_SIZE = 48
SIG_SIZE = 96


def pk_size() -> int:
    return _pk_size_fn()


def sig_size() -> int:
    return _sig_size_fn()


__all__ = [
    "Ciphertext",
    "DecryptionShare",
    "DegreeTooHigh",
    "DuplicateEntry",
    "FromBytesError",
    "NotEnoughShares",
    "PK_SIZE",
    "PublicKey",
    "PublicKeySet",
    "PublicKeyShare",
    "SIG_SIZE",
    "SecretKey",
    "SecretKeySet",
    "SecretKeyShare",
    "SerdeSecret",
    "Signature",
    "SignatureShare",
    "ThresholdCryptoError",
    "deserialize",
    "get_backend",
    "hash_g1_g2",
    "hash_g2",
    "interpolate",
    "into_fr",
    "into_fr_plus_1",
    "pk_size",
    "serialize",
    "set_backend",
    "sha3_256",
    "sig_size",
    "using",
    "xor_with_hash",
]

__version__ = "0.1.0"
