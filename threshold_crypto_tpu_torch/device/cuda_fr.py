"""The Fr kernel of ``csrc/fr.cu``: B14 ``lagrange_rowprod``, its wrapper,
its plain version and dispatch.

B14 is the counterpart of ``threshold_crypto_tpu/device/pallas_fr.py``
``_mk_lagr_kernel`` (:244, launched by ``_rowprod_call`` :266; wrapper
``lagrange_rowprod`` :323): for every i of N Montgomery Fr values x,
Π_{j≠i}(x_j − x_i) mod r and zcnt[i] = #{j : x_j == x_i}, the diagonal
included, so zcnt == 1 everywhere exactly when the x are distinct. Those
are the Lagrange denominators of ``ops.fr.lagrange_coeffs_at_zero`` above
1024 shares.

The kernel splits the j range into S = ⌈N / chunk⌉ chunks (``_chunk``: a
multiple of 128, at most ``MAX_SPLITS`` chunks) and writes one partial
product and count per chunk: its wrapper is ``rowprod_partials``.
``lagrange_rowprod`` folds the partial products with ⌈log₂ S⌉ B1 products
(``mont.mul``) and sums the counts. Products of the same multiset give the
same canonical value in any order, so every partial product is bit-exact
with its plain version's, and the folded one with the TPU kernel's. The
TPU kernel padded N to a multiple of 1024 with dead lanes; here N is exact,
so the count covers every j.

The wrapper checks its operand, allocates its outputs with ``torch.empty``,
launches on the current stream and counts its launches in ``ROWPROD``.
``rowprod_partials_ref`` is the same function in plain PyTorch, and
``lagrange_rowprod_ref`` the folded one in one sweep: chunks of
``REF_CHUNK`` j values, each one stacked subtraction and a product tree
(``mont.mul_ref`` materialises 16×16 int64 column terms per lane, so a
chunk of 32 j against 4096 i stays near 300 MB). ``p_rowprod_partials``
sends a CUDA tensor to the kernel and a CPU tensor to its plain version.
"""

from __future__ import annotations

import torch

from . import mont
from .cuda_mont import Kernel, KernelCount, launch
from .mont import FR

ROWPROD = KernelCount()
# Threads per block of the kernel: the i lanes of a block, and the j values
# it stages in shared memory at a time.
TILE = 128
# The j chunks the kernel splits into at most: 32 for N ≥ 4096, so that
# N = 4096 runs 32 × 32 blocks on the 132 SMs.
MAX_SPLITS = 32
# The j values of one step of the plain version.
REF_CHUNK = 32


def _chunk(n: int) -> int:
    """j values per chunk: a multiple of TILE, at most MAX_SPLITS chunks."""
    return TILE * max(1, -(-n // (TILE * MAX_SPLITS)))


def _check_xs(xs):
    if xs.device.type != "cuda" or xs.dtype != torch.int32 \
            or xs.dim() != 2 or xs.shape[1] != FR.L \
            or not xs.is_contiguous():
        raise ValueError(f"xs must be a contiguous int32[N, {FR.L}] CUDA "
                         f"tensor, got {xs.dtype}{tuple(xs.shape)} on "
                         f"{xs.device}")


def fold_products(parts):
    """Π over the leading axis of int32[S, ..., 16] Montgomery Fr values by
    a pairwise tree: ⌈log₂ S⌉ stacked products."""
    while parts.shape[0] > 1:
        half = parts.shape[0] // 2
        head = mont.mul(FR, parts[:half], parts[half:2 * half])
        parts = torch.cat([head, parts[2 * half:]])
    return parts[0]


def rowprod_partials(xs_mont):
    """Kernel B14: xs_mont int32[N, 16] Montgomery Fr limbs -> (prod
    int32[S, N, 16], cnt int32[S, N]): for each chunk s of the j range and
    each lane i, Π(x_j − x_i) over the j of the chunk with x_j ≠ x_i
    (Montgomery form), and the number of j of the chunk with x_j == x_i."""
    _check_xs(xs_mont)
    n = xs_mont.shape[0]
    chunk = _chunk(n)
    splits = max(1, -(-n // chunk))
    prod = torch.empty((splits, n, FR.L), dtype=torch.int32,
                       device=xs_mont.device)
    cnt = torch.empty((splits, n), dtype=torch.int32, device=xs_mont.device)
    if n:
        launch("fr", "tc_lagrange_rowprod", ROWPROD, (xs_mont, prod, cnt), n,
               chunk, lanes=n)
    return prod, cnt


def _sweep_ref(xs_mont, xj_all):
    """(Π over the j of xj_all of x_j − x_i with zeros as 1, zero count)
    per lane i, REF_CHUNK j values at a time: their stacked differences,
    zero count and product tree, multiplied into the running product."""
    n, dev = xs_mont.shape[0], xs_mont.device
    one = mont.one(FR, (n,), dev)
    acc = one.clone()
    zcnt = torch.zeros(n, dtype=torch.int32, device=dev)
    for j0 in range(0, xj_all.shape[0], REF_CHUNK):
        xj = xj_all[j0:j0 + REF_CHUNK]
        diff = mont.sub(FR, xj[:, None, :], xs_mont[None, :, :])
        isz = mont.is_zero(FR, diff)
        zcnt += isz.sum(0, dtype=torch.int32)
        factors = mont.select(isz, one.expand_as(diff), diff)
        acc = mont.mul(FR, acc, fold_products(factors))
    return acc, zcnt


def rowprod_partials_ref(xs_mont):
    """B14 in plain PyTorch: the kernel's chunks of the j range, each swept
    by ``_sweep_ref``."""
    chunk = _chunk(xs_mont.shape[0])
    parts = [_sweep_ref(xs_mont, xs_mont[j0:j0 + chunk])
             for j0 in range(0, max(1, xs_mont.shape[0]), chunk)]
    return (torch.stack([p for p, _ in parts]),
            torch.stack([c for _, c in parts]))


def p_rowprod_partials(xs_mont):
    if mont.on_card(xs_mont):
        return rowprod_partials(xs_mont)
    return rowprod_partials_ref(xs_mont)


def lagrange_rowprod(xs_mont):
    """The counterpart of ``pallas_fr.lagrange_rowprod``: xs_mont
    int32[N, 16] Montgomery Fr limbs -> (row_prod int32[N, 16],
    Π_{j≠i}(x_j − x_i) in Montgomery form; zcnt int32[N], the j with
    x_j == x_i, the diagonal included). One B14 launch (on the CPU its
    plain version), then ⌈log₂ S⌉ B1 products over the chunks' partial
    products and a sum of their counts."""
    prod, cnt = p_rowprod_partials(xs_mont)
    return fold_products(prod), cnt.sum(0, dtype=torch.int32)


def lagrange_rowprod_ref(xs_mont):
    """``lagrange_rowprod`` in plain PyTorch, in one sweep over all j."""
    return _sweep_ref(xs_mont, xs_mont)


KERNELS = (
    Kernel("lagrange_rowprod", rowprod_partials, rowprod_partials_ref,
           ROWPROD, "threshold_crypto_tpu_torch/csrc/fr.cu",
           "threshold_crypto_tpu/device/pallas_fr.py:244"),
)
