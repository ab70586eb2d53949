"""The MSM kernels of ``csrc/msm.cu`` (wrappers, plain versions, dispatch)
and the shared-window MSM driver that runs them.

Each kernel is the counterpart of one Pallas kernel of
``threshold_crypto_tpu/device/pallas_curve.py``, in a G1 and a G2 form:

* B10 ``g1_madd`` / ``g2_madd`` (``_mk_madd_kernel`` :397, instances
  ``_k_g1_madd``/``_k_g2_madd`` :451-452): per lane acc ← acc + Q, the
  complete mixed add ``curve.jac_madd`` with acc Jacobian and Q affine. It
  builds the 1P..(2^w−1)P table of the shared MSM.
* B11 ``g1_winacc`` / ``g2_winacc`` (``_mk_winacc_kernel`` :534, launched
  by ``_winacc_impl`` :581): the whole shared-window Horner phase in one
  launch. The TPU kernel walked a sequential (window × block) grid with
  one 1024-lane accumulator in VMEM scratch. CUDA blocks run in no order,
  so here accumulator j (one thread) owns lanes j, j + A, j + 2A, … of the
  N lanes; for each window, MSB first, it doubles itself w times, then adds
  ``table[digit − 1]`` of each lane it owns, in lane order, with the
  complete add ``curve.jac_add`` (a zero digit adds nothing). It writes A
  partial sums; the TPU form is the case A = 1024.

Packed layout (``device/packed.py``): a G1 Jacobian point is int32[72, N]
(X, Y, Z), a G2 one int32[144, N] (X0, X1, Y0, Y1, Z0, Z1); an affine Q
int32[48, N] or [96, N]; the table the entries 1P..(2^w−1)P one after the
other, int32[(2^w−1)·72, N] or [(2^w−1)·144, N]; the digits int32[D, N].

The wrappers check their operands, allocate their outputs with
``torch.empty``, launch on the current stream and count their launches.
The ``*_ref`` functions are the same functions in plain PyTorch (the
formulas of ``device/curve.py`` on the unpacked components, and the same
accumulator-to-lane assignment and order as B11), so the kernels agree
with them bit for bit. ``p_madd`` / ``p_winacc`` send a CUDA tensor to the
kernel and a CPU tensor to its plain version.
"""

from __future__ import annotations

import torch

from . import curve as dcv
from . import mont
from . import packed as pk
from .cuda_mont import Kernel, KernelCount, launch
from .cuda_tower import _check
from .mont import FQ

L = FQ.L
# B11's accumulators at most (one thread each, 128 per block): 128 blocks,
# one on each of 128 of the H100's 132 SMs. Chosen by the time of the
# whole RLC call, not of B11 alone: each halving of A saves one level of
# the torch fold (``fold_sum``), which costs more than B11 gains from the
# second block per SM that A = 32,768 gives it.
ACCUMULATORS = 16384

G1_MADD = KernelCount()
G2_MADD = KernelCount()
G1_WINACC = KernelCount()
G2_WINACC = KernelCount()


def _field(g2: bool):
    return dcv.Fq2Ops if g2 else dcv.FqOps


# ---------------------------------------------------------------------------
# Packed points <-> component tuples
# ---------------------------------------------------------------------------

def unpack_jac(packed, g2: bool):
    """Packed [3k·24, N] -> Jacobian tuple of [N, 24] components."""
    c = pk.unpack(packed, 6 if g2 else 3)
    if g2:
        return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
    return (c[0], c[1], c[2])


def unpack_aff(packed, g2: bool):
    """Packed [2k·24, N] -> (x, y) of [N, 24] components."""
    c = pk.unpack(packed, 4 if g2 else 2)
    return ((c[0], c[1]), (c[2], c[3])) if g2 else (c[0], c[1])


def pack_point(pt):
    """A point tuple of [N, 24] components -> packed [m·24, N]."""
    return pk.pack(dcv.leaves(pt))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _madd(g2, count, acc, q):
    k = 2 if g2 else 1
    n = _check(("acc", acc, 3 * k * L), ("q", q, 2 * k * L))
    out = torch.empty_like(acc)
    if n:
        launch("msm", f"tc_g{1 + g2}_madd", count, (acc, q, out), n,
               lanes=n)
    return out


def g1_madd(acc, q):
    """Kernel B10, G1: acc [72, N] Jacobian + q [48, N] affine."""
    return _madd(False, G1_MADD, acc, q)


def g2_madd(acc, q):
    """Kernel B10, G2: acc [144, N] Jacobian + q [96, N] affine."""
    return _madd(True, G2_MADD, acc, q)


def _winacc(g2, count, table, digits, accumulators, window):
    k = 2 if g2 else 1
    n = _check(("table", table, ((1 << window) - 1) * 3 * k * L))
    if digits.device != table.device or digits.dtype != torch.int32 \
            or digits.dim() != 2 or digits.shape[1] != n \
            or not digits.is_contiguous():
        raise ValueError(f"digits must be a contiguous int32[D, {n}] on the "
                         f"table's device, got {digits.dtype}"
                         f"{tuple(digits.shape)} on {digits.device}")
    if not 1 <= accumulators <= max(n, 1):
        raise ValueError(f"need 1 <= accumulators <= N, got {accumulators}")
    out = torch.empty((3 * k * L, accumulators), dtype=torch.int32,
                      device=table.device)
    launch("msm", f"tc_g{1 + g2}_winacc", count, (table, digits, out), n,
           accumulators, digits.shape[0], window, lanes=accumulators)
    return out


def g1_winacc(table, digits, accumulators, window):
    """Kernel B11, G1: table [(2^w−1)·72, N], digits [D, N] -> the A partial
    sums [72, A]."""
    return _winacc(False, G1_WINACC, table, digits, accumulators, window)


def g2_winacc(table, digits, accumulators, window):
    """Kernel B11, G2: table [(2^w−1)·144, N] -> [144, A]."""
    return _winacc(True, G2_WINACC, table, digits, accumulators, window)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _madd_ref(g2, acc, q):
    return pack_point(dcv.jac_madd(_field(g2), unpack_jac(acc, g2),
                                   unpack_aff(q, g2)))


def g1_madd_ref(acc, q):
    return _madd_ref(False, acc, q)


def g2_madd_ref(acc, q):
    return _madd_ref(True, acc, q)


def _winacc_ref(g2, table, digits, accumulators, window):
    """B11's loop as stacked tensor ops over the A accumulators: per window
    w doublings, then one gated complete add per block of A lanes."""
    F = _field(g2)
    rows = (6 if g2 else 3) * L
    n, A = table.shape[1], accumulators
    nent = (1 << window) - 1
    tab = table.reshape(nent, rows, n)
    acc = dcv.G2.infinity((A,), table.device) if g2 else \
        dcv.G1.infinity((A,), table.device)
    for w in range(digits.shape[0]):
        for _ in range(window):
            acc = dcv.jac_dbl(F, acc)
        for start in range(0, n, A):
            m = min(A, n - start)
            d = torch.nn.functional.pad(digits[w, start:start + m], (0, A - m))
            idx = (d[:m] - 1).clamp(min=0).long()
            lanes = torch.arange(start, start + m, device=table.device)
            q = tab[idx, :, lanes].T                          # [rows, m]
            q = torch.nn.functional.pad(q, (0, A - m))
            s = dcv.jac_add(F, acc, unpack_jac(q.contiguous(), g2))
            acc = dcv.tree_map(lambda a, b: mont.select(d != 0, a, b), s, acc)
    return pack_point(acc)


def g1_winacc_ref(table, digits, accumulators, window):
    return _winacc_ref(False, table, digits, accumulators, window)


def g2_winacc_ref(table, digits, accumulators, window):
    return _winacc_ref(True, table, digits, accumulators, window)


# ---------------------------------------------------------------------------
# Dispatch and the driver
# ---------------------------------------------------------------------------

def p_madd(g2, acc, q):
    if mont.on_card(acc):
        return (g2_madd if g2 else g1_madd)(acc, q)
    return (g2_madd_ref if g2 else g1_madd_ref)(acc, q)


def p_winacc(g2, table, digits, accumulators, window):
    if mont.on_card(table):
        fn = g2_winacc if g2 else g1_winacc
    else:
        fn = g2_winacc_ref if g2 else g1_winacc_ref
    return fn(table, digits, accumulators, window)


def msm_pallas_shared(curve, points_aff, scalars, nbits: int = 64,
                      window: int = 3, accumulators=None):
    """Σ points_i·scalars_i by shared-window Horner accumulation; the
    counterpart of ``pallas_curve.msm_pallas_shared`` (:887).

    curve: ``curve.G1`` / ``curve.G2``; points_aff: the affine tuple
    (x, y, inf) of ``pairing.g1/g2_affine_from_host``; scalars: int32[N, 16]
    canonical limbs. Dead (infinity) lanes get digit 0 and are never
    selected; the affine base lifted to Z = 1 and 2^w − 2 B10 launches make
    the table 1P..(2^w−1)P; one B11 launch makes min(A, N) partial sums
    (A = ``accumulators``, by default ``ACCUMULATORS``); ``fold_sum`` adds
    them up. Returns an unbatched Jacobian point (leaves [24]).
    """
    if accumulators is None:
        accumulators = ACCUMULATORS
    x, y, inf = points_aff
    g2 = curve is dcv.G2
    n = inf.shape[0]
    k = 2 if g2 else 1
    digits = dcv.scalar_digits(scalars, nbits, window)         # [D, N]
    digits = torch.where(inf[None], torch.zeros_like(digits), digits)
    q = pk.pack([*x, *y] if g2 else [x, y])
    base = torch.cat([q, pk._one_rows(k, n, q.device)])        # Z = 1
    entries = [base]
    for _ in range((1 << window) - 2):
        entries.append(p_madd(g2, entries[-1], q))
    table = torch.cat(entries)
    acc = p_winacc(g2, table, digits.contiguous(),
                   min(accumulators, max(n, 1)), window)
    return curve.fold_sum(unpack_jac(acc, g2))


_SRC = "threshold_crypto_tpu_torch/csrc/msm.cu"
_TPU = "threshold_crypto_tpu/device/pallas_curve.py:"
KERNELS = (
    Kernel("g1_madd", g1_madd, g1_madd_ref, G1_MADD, _SRC, _TPU + "397"),
    Kernel("g2_madd", g2_madd, g2_madd_ref, G2_MADD, _SRC, _TPU + "397"),
    Kernel("g1_winacc", g1_winacc, g1_winacc_ref, G1_WINACC, _SRC,
           _TPU + "534"),
    Kernel("g2_winacc", g2_winacc, g2_winacc_ref, G2_WINACC, _SRC,
           _TPU + "534"),
)
