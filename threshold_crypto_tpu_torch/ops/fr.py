"""Batched scalar-field (Fr) operations of the threshold protocols.

The counterpart of ``threshold_crypto_tpu/ops/fr.py``:

* ``fr_to_device`` / ``fr_from_device`` (host ints <-> int32[N, 16]
  Montgomery limbs), ``fr_to_plain`` / ``fr_from_plain`` (one B1 product
  each, by 1 or by R²);
* ``poly_eval``: Horner over the coefficient axis for a batch of points
  (D B1 products and D additions), the keygen share derivation;
* ``lagrange_coeffs_at_zero``: the λᵢ of in-exponent interpolation, with
  one batched inversion (``batch_inv``);
* ``interpolate_at_zero``: Σ λᵢ·yᵢ by an additive tree (``sum_leading``).

Values are int32[..., 16] Montgomery Fr limbs unless named plain.

Routing of λ by N, as in the JAX package (``_LAGRANGE_MATRIX_MAX``): up to
1024 shares the N×N difference matrix (``_lagrange_matrix``); above, the
all-pairs kernel B14 (``device.cuda_fr.lagrange_rowprod``, on the CPU its
plain version) in ``_lagrange_pallas``. The JAX package has a third form
for N > 1024 off its Pallas path, the chunked ``_lagrange_scan``, chosen
with the environment switch ``TC_TPU_LAGRANGE``. The port has neither: above
1024 it always takes B14's route, whose plain version is a chunked sweep of
the scan's shape.
"""

from __future__ import annotations

import torch

from ..device import cuda_fr
from ..device import mont
from ..device.mont import FR
from ..utils import trace


class FrOps:
    """Fr as a field namespace for ``ops.threshold.batch_inv_field``."""

    @staticmethod
    def mul(a, b):
        return mont.mul(FR, a, b)

    @staticmethod
    def inv(a):
        return mont.inv(FR, a)

    @staticmethod
    def select(cond, a, b):
        return mont.select(cond, a, b)

    @staticmethod
    def is_zero(a):
        return mont.is_zero(FR, a)

    @staticmethod
    def shape(a):
        return a.shape[:-1]

    @staticmethod
    def one(shape, device):
        return mont.one(FR, shape, device)

    @staticmethod
    def zero(shape, device):
        return mont.zero(FR, shape, device)


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------

def fr_to_device(xs, device="cuda"):
    """Host ints -> int32[N, 16] Montgomery-form limbs on ``device``."""
    return torch.from_numpy(mont.stack_mont(FR, list(xs))).to(
        mont.device_of(device))


def fr_from_device(arr) -> list:
    """Montgomery-form limbs -> host ints."""
    return mont.unstack_mont(FR, arr)


def fr_to_plain(a):
    """Montgomery form -> canonical plain limbs (for ``scalar_digits``):
    one Montgomery product by the literal 1."""
    return mont.mul(FR, a, mont.const_limbs(FR, 1, a.device))


def fr_from_plain(a):
    """Canonical plain limbs -> Montgomery form (a product by R²)."""
    return mont.mul(FR, a, mont.const_limbs(FR, FR.r2, a.device))


def batch_inv(a):
    """Batched Fr inversion, zero mapping to zero: on the card one B2
    launch (``mont.inv``), on the CPU the product tree of
    ``ops.threshold.batch_inv_field``."""
    from .threshold import batch_inv_field  # ops.threshold imports this

    return batch_inv_field(FrOps, a)


# ---------------------------------------------------------------------------
# Batched polynomial evaluation (keygen share derivation)
# ---------------------------------------------------------------------------

def poly_eval(coeffs, xs):
    """Horner: f(x) for every x of the batch.

    coeffs: int32[D+1, 16] Montgomery Fr limbs, row k the coefficient of
    x^k; xs: int32[..., 16] Montgomery limbs (any batch shape). Returns
    int32[..., 16]: D products and D additions over the whole batch.
    """
    shape = xs.shape[:-1] + (FR.L,)
    rev = coeffs.flip(0)
    acc = rev[0].expand(shape).contiguous()
    for c in rev[1:]:
        acc = mont.add(FR, mont.mul(FR, acc, xs), c.expand(shape))
    return acc


# ---------------------------------------------------------------------------
# Batched Lagrange machinery (threshold combine / interpolation)
# ---------------------------------------------------------------------------

# Product over the leading axis by a pairwise tree: ⌈log₂ N⌉ stacked
# products, an odd level carrying its last entry up (B14's fold of its
# chunks). The JAX package pairs neighbours; any pairing gives the same
# canonical product.
_prod_leading = cuda_fr.fold_products


# Above this share count the N×N difference matrix gives way to B14.
_LAGRANGE_MATRIX_MAX = 1024


@trace.traced("fr.lagrange")
def lagrange_coeffs_at_zero(xs):
    """λᵢ = Π_{j≠i} x_j / (x_j − x_i) for a batch of distinct x.

    xs: int32[N, 16] Montgomery Fr limbs. Returns (lam int32[N, 16],
    ok bool[]): ok is False iff some x_i == x_j (i ≠ j) or some x_i == 0,
    the reference's DuplicateEntry. One batched inversion for all N.
    """
    if xs.shape[0] <= _LAGRANGE_MATRIX_MAX:
        return _lagrange_matrix(xs)
    return _lagrange_pallas(xs)


def _finish(xs, prod_all, row_prod, dup):
    """λ from the row products: den_i = x_i·Π_{j≠i}(x_j − x_i), one batched
    inversion, λ_i = Π_j x_j / den_i."""
    den = mont.mul(FR, xs, row_prod)
    zero_x = mont.is_zero(FR, xs).any()
    with trace.span("fr.lagrange.inv"):
        den_inv = batch_inv(den)
    lam = mont.mul(FR, prod_all.expand_as(den_inv), den_inv)
    return lam, ~(dup | zero_x)


def _lagrange_pallas(xs):
    """The kernel form: the O(N²) denominator sweep in B14; the duplicate
    flag from its zero count (exactly 1, the diagonal, on every lane iff
    the x are distinct)."""
    with trace.span("fr.lagrange.tree"):
        prod_all = _prod_leading(xs)
    with trace.span("fr.lagrange.rowprod"):
        row_prod, zcnt = cuda_fr.lagrange_rowprod(xs.contiguous())
    return _finish(xs, prod_all, row_prod, (zcnt != 1).any())


def _lagrange_matrix(xs):
    """The N×N difference matrix: diffs[i, j] = x_j − x_i with the diagonal
    set to 1, its row products over j."""
    n, dev = xs.shape[0], xs.device
    with trace.span("fr.lagrange.tree"):
        prod_all = _prod_leading(xs)
    with trace.span("fr.lagrange.rowprod"):
        diffs = mont.sub(FR, xs[None, :, :], xs[:, None, :])  # [i, j, L]
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        dup = (mont.is_zero(FR, diffs) & ~eye).any()
        diffs = mont.select(eye, mont.one(FR, (n, n), dev), diffs)
        row_prod = _prod_leading(diffs.movedim(1, 0))         # over j
    return _finish(xs, prod_all, row_prod, dup)


def interpolate_at_zero(xs, ys):
    """Lagrange interpolation of scalar samples at x = 0: Σ λᵢ·yᵢ.

    xs, ys: int32[N, 16] Montgomery Fr limbs. Returns (value int32[16],
    ok bool[]).
    """
    lam, ok = lagrange_coeffs_at_zero(xs)
    return sum_leading(mont.mul(FR, lam, ys)), ok


@trace.traced("fr.sum_leading")
def sum_leading(a):
    """Σ over the leading axis, mod r, by a pairwise tree of additions
    (⌈log₂ N⌉ levels, an odd level carrying its last entry up)."""
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        a = torch.cat([mont.add(FR, a[:half], a[half:2 * half]),
                       a[2 * half:]])
    return a[0]
