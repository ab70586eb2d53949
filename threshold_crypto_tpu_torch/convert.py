"""Carry the JAX package's state across to the port and back.

The system has no weights; its state is field elements and points. The JAX
package holds an affine point as a pytree ``(x, y, inf)`` of ``uint32[..., 24]``
Montgomery limb arrays (G1: x, y Fq; G2: x, y Fq2 pairs) and a bool array
(``threshold_crypto_tpu/device/pairing.py``, ``g1_affine_from_host``). Here
those arrive as numpy arrays and become the port's int32 tensors with the
same values; ``to_jax`` turns any such tuple back into numpy arrays that
are bit-exact with the JAX package's. ``fq12_from_jax`` / ``fq12_to_jax``
carry Fq12 values (the pairing's GT elements) the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import mont


def _limbs(arr, device):
    arr = np.asarray(arr)
    if arr.dtype != np.uint32 or arr.ndim < 1 or arr.shape[-1] != mont.FQ.L:
        raise ValueError(
            f"expected uint32[..., {mont.FQ.L}] limbs, got {arr.dtype}{arr.shape}"
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
