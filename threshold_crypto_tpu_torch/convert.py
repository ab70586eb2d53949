"""Carry the JAX package's state across to the port and back.

The system has no weights; its state is field elements and points. The JAX
package holds an affine point as a pytree ``(x, y, inf)`` of ``uint32[..., 24]``
Montgomery limb arrays (G1: x, y Fq; G2: x, y Fq2 pairs) and a bool array
(``threshold_crypto_tpu/device/pairing.py``, ``g1_affine_from_host``). Here
those arrive as numpy arrays and become the port's int32 tensors with the
same values; ``to_jax`` turns any such tuple back into numpy arrays that
are bit-exact with the JAX package's. ``fq12_from_jax`` / ``fq12_to_jax``
carry Fq12 values (the pairing's GT elements) the same way,
``g1_jac_from_jax`` / ``g2_jac_from_jax`` Jacobian points (``device/curve.py``
pytrees), ``fr_from_jax`` / ``fr_to_jax`` Fr limbs (the MSM scalars and RLC
exponents, ``uint32[..., 16]``), and ``msm_table_from_jax`` /
``msm_table_to_jax`` the table of an MSM or a ladder: its Jacobian
entries 1P..(2^w−1)P (15 for the ladder kernel B13) as the port's packed
``int32[entries·3k·24, N]``, and ``words_from_jax`` / ``words_to_jax`` the
u32 words of the hash chain (``uint32[N, 8]`` digests, ``uint32[N, S]``
ChaCha streams, ``uint32[N, A, 12]`` candidate draws) as the port's int64
tensors. The chain's ``nvalid`` is int32 in both packages, and its
``greatest`` flags bool: ``torch.from_numpy`` and ``.numpy()`` carry them.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import mont


def _limbs(arr, device, L=mont.FQ.L):
    arr = np.asarray(arr)
    if arr.dtype != np.uint32 or arr.ndim < 1 or arr.shape[-1] != L:
        raise ValueError(
            f"expected uint32[..., {L}] limbs, got {arr.dtype}{arr.shape}"
        )
    if (arr > 0xFFFF).any():
        raise ValueError("limbs must be 16-bit")
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def _inf(arr, device):
    return torch.from_numpy(np.asarray(arr, dtype=bool).copy()).to(device)


def g1_from_jax(x, y, inf, device="cuda"):
    """JAX G1 affine (x, y, inf) as numpy arrays -> the port's tuple."""
    device = mont.device_of(device)
    return (_limbs(x, device), _limbs(y, device), _inf(inf, device))


def g2_from_jax(x, y, inf, device="cuda"):
    """JAX G2 affine ((x0, x1), (y0, y1), inf) as numpy arrays -> the port's
    tuple."""
    device = mont.device_of(device)
    return (
        (_limbs(x[0], device), _limbs(x[1], device)),
        (_limbs(y[0], device), _limbs(y[1], device)),
        _inf(inf, device),
    )


def g1_jac_from_jax(X, Y, Z, device="cuda"):
    """JAX G1 Jacobian (X, Y, Z) as numpy arrays -> the port's tuple."""
    device = mont.device_of(device)
    return tuple(_limbs(c, device) for c in (X, Y, Z))


def g2_jac_from_jax(X, Y, Z, device="cuda"):
    """JAX G2 Jacobian ((X0, X1), (Y0, Y1), (Z0, Z1)) -> the port's tuple."""
    device = mont.device_of(device)
    return tuple((_limbs(c[0], device), _limbs(c[1], device))
                 for c in (X, Y, Z))


def fr_from_jax(limbs, device="cuda"):
    """uint32[..., 16] Fr limbs (canonical or Montgomery) -> int32 tensor."""
    return _limbs(limbs, mont.device_of(device), mont.FR.L)


def fr_to_jax(limbs):
    """int32[..., 16] Fr limbs -> uint32 numpy, as the JAX package holds
    them."""
    return to_jax(limbs)


def msm_table_from_jax(entries, device="cuda"):
    """The JAX table entries 1P..(2^w−1)P (a list of G1 or G2 Jacobian
    pytrees of uint32[N, 24] arrays, as ``pallas_curve`` builds them before
    packing) -> the port's packed table."""
    device = mont.device_of(device)
    comps = [_limbs(c, device) for e in entries for c in _flat(e)]
    return torch.cat([c.reshape(-1, mont.FQ.L).T for c in comps]).contiguous()


def msm_table_to_jax(table, g2: bool):
    """The port's packed table -> the list of its Jacobian entries as numpy
    pytrees (G2 coordinates as (c0, c1) pairs)."""
    L = mont.FQ.L
    comps = [table[i * L:(i + 1) * L].T for i in range(table.shape[0] // L)]
    k = 6 if g2 else 3
    out = []
    for e in range(len(comps) // k):
        c = comps[e * k:(e + 1) * k]
        pt = (((c[0], c[1]), (c[2], c[3]), (c[4], c[5])) if g2
              else (c[0], c[1], c[2]))
        out.append(to_jax(pt))
    return out


def words_from_jax(words, device="cuda"):
    """uint32[...] words (digests, ChaCha streams, candidate draws) ->
    int64 tensor with the same values."""
    words = np.asarray(words)
    if words.dtype != np.uint32:
        raise ValueError(f"expected uint32 words, got {words.dtype}")
    return torch.from_numpy(words.astype(np.int64)).to(
        mont.device_of(device))


def words_to_jax(words):
    """int64 word tensor (values < 2³²) -> uint32 numpy, as the JAX package
    holds them."""
    arr = words.detach().cpu().numpy()
    if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
        raise ValueError("words must lie in [0, 2^32)")
    return arr.astype(np.uint32)


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def fq12_from_jax(tree, device="cuda"):
    """The JAX package's Fq12 pytree (((c0, c1) × 3) × 2 of uint32[..., 24]
    arrays, or the same 12 arrays flat in ``pallas_tower.flat12`` order) ->
    the port's nested Fq12 tuple."""
    device = mont.device_of(device)
    comps = _flat(tree)
    if len(comps) != 12:
        raise ValueError(f"an Fq12 has 12 components, got {len(comps)}")
    it = iter(_limbs(c, device) for c in comps)
    return tuple(tuple((next(it), next(it)) for _ in range(3))
                 for _ in range(2))


def fq12_to_jax(f):
    """The port's nested Fq12 tuple -> the JAX package's nested pytree of
    uint32[..., 24] numpy arrays (flat12 order when flattened)."""
    comps = _flat(f)
    if len(comps) != 12:
        raise ValueError(f"an Fq12 has 12 components, got {len(comps)}")
    return to_jax(tuple(tuple((comps[6 * i + 2 * j], comps[6 * i + 2 * j + 1])
                              for j in range(3)) for i in range(2)))


def to_jax(tree):
    """The port's tensors (nested tuples) -> numpy arrays in the JAX layout:
    limbs as uint32, flags as bool."""
    if isinstance(tree, tuple):
        return tuple(to_jax(t) for t in tree)
    arr = tree.detach().cpu().numpy()
    return arr if arr.dtype == np.bool_ else arr.astype(np.uint32)
