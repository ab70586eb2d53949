"""The curve kernels of ``csrc/msm.cu``, ``csrc/ladder.cu`` and
``csrc/shared.cu`` (wrappers, plain versions, dispatch) and the MSM and
ladder drivers that run them.

Each kernel is the counterpart of one Pallas kernel of
``threshold_crypto_tpu/device/pallas_curve.py``, in a G1 and a G2 form:

* B10 ``g1_madd`` / ``g2_madd`` (``_mk_madd_kernel`` :397, instances
  ``_k_g1_madd``/``_k_g2_madd`` :451-452): per lane acc ← acc + Q, the
  complete mixed add ``curve.jac_madd`` with acc Jacobian and Q affine. It
  builds the tables of the shared MSM and of the ladders.
* B11 ``g1_winacc`` / ``g2_winacc`` (``_mk_winacc_kernel`` :534, launched
  by ``_winacc_impl`` :581): the whole shared-window Horner phase in one
  launch. The TPU kernel walked a sequential (window × block) grid with
  one 1024-lane accumulator in VMEM scratch. CUDA blocks run in no order,
  so here accumulator j (one thread) owns lanes j, j + A, j + 2A, … of the
  N lanes; for each window, MSB first, it doubles itself w times, then adds
  ``table[digit − 1]`` of each lane it owns, in lane order, with the
  complete add ``curve.jac_add`` (a zero digit adds nothing; a digit outside
  1..2^w − 1 reads entry 0, as the TPU's select chain does). It writes A
  partial sums; the TPU form is the case A = 1024. It runs on B13's
  register engine (``csrc/ladder_engine.cuh``).
* B13 ``g1_step4`` / ``g2_step4`` (``_mk_step4_kernel`` :385, instances
  ``_k_g1/g2_msm_step4`` :449-450): per lane and base-16 digit d, T ← 16T,
  then T + table[d − 1] where d ≠ 0 (``curve.msm_step_w4``). The TPU ran
  one launch per digit from a ``lax.scan``; here the digit loop runs inside
  the thread, so a whole ladder is one launch, on the register engine of
  ``csrc/ladder_engine.cuh`` (B10, B15 and B16 run on ``csrc/curve.cuh``).
* B15 ``g1_step`` / ``g2_step`` (``_mk_step_kernel`` :373, instances
  ``_k_g1/g2_msm_step`` :447-448): per lane and bit, T ← 2T (+ Q affine)
  (``curve.msm_step``), the bit loop inside the thread likewise.
* B16 ``g1_selmadd`` / ``g2_selmadd`` (``_mk_selmadd_kernel`` :410) and
  ``g1_dblw`` / ``g2_dblw`` (``_mk_dblw_kernel`` :433), in ``csrc/shared.cu``:
  the two halves of B11 as separate launches, acc + table[d − 1] per
  accumulator lane for one block of lanes and one window (the complete add
  where d ≠ 0), and acc ← 2^w·acc. ``msm_pallas_shared(fused=False)`` runs
  them as the JAX package's DIRECT branch does (:970-983).

Packed layout (``device/packed.py``): a G1 Jacobian point is int32[72, N]
(X, Y, Z), a G2 one int32[144, N] (X0, X1, Y0, Y1, Z0, Z1); an affine Q
int32[48, N] or [96, N]; a table its entries 1P..(2^w−1)P one after the
other, int32[(2^w−1)·72, N] or [(2^w−1)·144, N]; digits or bits int32[D, N]
(B16: one window's digits, int32[N]).

The wrappers check their operands, allocate their outputs with
``torch.empty``, launch on the current stream and count their launches.
The ``*_ref`` functions are the same functions in plain PyTorch (the
formulas of ``device/curve.py`` on the unpacked components, and the same
loops, and for B11 the same accumulator-to-lane assignment and order), so
the kernels agree with them bit for bit. ``p_madd`` / ``p_winacc`` /
``p_step4`` / ``p_step`` / ``p_selmadd`` / ``p_dblw`` send a CUDA tensor to
the kernel and a CPU tensor to its plain version.
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
# The accumulators of the unfused form (B16): the one 1024-lane block of
# the JAX package's DIRECT branch (8 × 128 lanes, ``pallas_tower.py``'s
# TILE_ROWS × LANES).
SHARED_BLOCK = 1024

G1_MADD = KernelCount()
G2_MADD = KernelCount()
G1_WINACC = KernelCount()
G2_WINACC = KernelCount()
G1_STEP4 = KernelCount()
G2_STEP4 = KernelCount()
G1_STEP = KernelCount()
G2_STEP = KernelCount()
G1_SELMADD = KernelCount()
G2_SELMADD = KernelCount()
G1_DBLW = KernelCount()
G2_DBLW = KernelCount()
# Entries of B13's table: 1P..15P.
STEP4_ENTRIES = 15
# Lanes of one B13 launch of ``scalar_mul_gathered``: the gathered table of
# a chunk takes 15 × 288 bytes a lane in G1 (2.3 GB), twice that in G2.
LADDER_CHUNK = 1 << 19


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


def _check_digits(digits, n, device):
    if digits.device != device or digits.dtype != torch.int32 \
            or digits.dim() != 2 or digits.shape[1] != n \
            or not digits.is_contiguous():
        raise ValueError(f"digits must be a contiguous int32[D, {n}] on "
                         f"{device}, got {digits.dtype}"
                         f"{tuple(digits.shape)} on {digits.device}")


def _winacc(g2, count, table, digits, accumulators, window):
    k = 2 if g2 else 1
    n = _check(("table", table, ((1 << window) - 1) * 3 * k * L))
    _check_digits(digits, n, table.device)
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


def _step4(g2, count, acc, table, digits):
    k = 2 if g2 else 1
    n = _check(("acc", acc, 3 * k * L),
               ("table", table, STEP4_ENTRIES * 3 * k * L))
    _check_digits(digits, n, acc.device)
    out = torch.empty_like(acc)
    if n:
        launch("ladder", f"tc_g{1 + g2}_step4", count,
               (acc, table, digits, out), n, digits.shape[0], lanes=n)
    return out


def g1_step4(acc, table, digits):
    """Kernel B13, G1 (``csrc/ladder.cu`` over ``csrc/ladder_engine.cuh``):
    acc [72, N] Jacobian, table [15·72, N] (1P..15P), digits [D, N] base 16
    MSB first -> the acc after D ladder steps."""
    return _step4(False, G1_STEP4, acc, table, digits)


def g2_step4(acc, table, digits):
    """Kernel B13, G2: acc [144, N], table [15·144, N], digits [D, N]."""
    return _step4(True, G2_STEP4, acc, table, digits)


def _step(g2, count, acc, q, bits):
    k = 2 if g2 else 1
    n = _check(("acc", acc, 3 * k * L), ("q", q, 2 * k * L))
    _check_digits(bits, n, acc.device)
    out = torch.empty_like(acc)
    if n:
        launch("ladder", f"tc_g{1 + g2}_step", count, (acc, q, bits, out), n,
               bits.shape[0], lanes=n)
    return out


def g1_step(acc, q, bits):
    """Kernel B15, G1: acc [72, N] Jacobian, q [48, N] affine, bits [D, N]
    MSB first -> the acc after D double-and-add steps."""
    return _step(False, G1_STEP, acc, q, bits)


def g2_step(acc, q, bits):
    """Kernel B15, G2: acc [144, N], q [96, N], bits [D, N]."""
    return _step(True, G2_STEP, acc, q, bits)


def _table_entries(g2, table):
    rows = (6 if g2 else 3) * L
    nent = table.shape[0] // rows
    if nent < 1 or table.shape[0] != nent * rows:
        raise ValueError(f"table must hold whole Jacobian entries of {rows} "
                         f"rows, got {tuple(table.shape)}")
    return nent


def _selmadd(g2, count, acc, table, digits, start):
    k = 2 if g2 else 1
    a = _check(("acc", acc, 3 * k * L))
    n = _check(("table", table, None))
    nent = _table_entries(g2, table)
    if table.device != acc.device:
        raise ValueError("acc and table must be on one device")
    if digits.device != acc.device or digits.dtype != torch.int32 \
            or digits.shape != (n,) or not digits.is_contiguous():
        raise ValueError(f"digits must be a contiguous int32[{n}] on "
                         f"{acc.device}, got {digits.dtype}"
                         f"{tuple(digits.shape)} on {digits.device}")
    if not 0 <= start < max(n, 1):
        raise ValueError(f"start must lie in [0, {n}), got {start}")
    out = torch.empty_like(acc)
    if a:
        launch("shared", f"tc_g{1 + g2}_selmadd", count,
               (acc, table, digits, out), a, n, nent, start, lanes=a)
    return out


def g1_selmadd(acc, table, digits, start):
    """Kernel B16, G1: acc [72, A] + table[d − 1] of lanes start..start+A−1
    (table [nent·72, N], one window's digits [N]; lanes past N add
    nothing) -> the new acc [72, A]."""
    return _selmadd(False, G1_SELMADD, acc, table, digits, start)


def g2_selmadd(acc, table, digits, start):
    """Kernel B16, G2: acc [144, A], table [nent·144, N], digits [N]."""
    return _selmadd(True, G2_SELMADD, acc, table, digits, start)


def _dblw(g2, count, acc, window):
    k = 2 if g2 else 1
    a = _check(("acc", acc, 3 * k * L))
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(acc)
    if a:
        launch("shared", f"tc_g{1 + g2}_dblw", count, (acc, out), a, window,
               lanes=a)
    return out


def g1_dblw(acc, window):
    """Kernel B16, G1: acc [72, A] -> 2^window·acc."""
    return _dblw(False, G1_DBLW, acc, window)


def g2_dblw(acc, window):
    """Kernel B16, G2: acc [144, A] -> 2^window·acc."""
    return _dblw(True, G2_DBLW, acc, window)


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
    w doublings, then one gated complete add per block of A lanes (entry 0
    for a digit outside 1..2^w − 1)."""
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
            dm = d[:m]
            idx = torch.where((dm >= 1) & (dm <= nent), dm - 1,
                              torch.zeros_like(dm)).long()
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


def _step4_ref(g2, acc, table, digits):
    """B13's digit loop as stacked tensor ops: per digit the lane's one
    table entry (entry 0 for a digit outside 1..15), then ``msm_step_w4``."""
    F = _field(g2)
    rows, n = acc.shape
    tab = table.reshape(STEP4_ENTRIES, rows, n)
    lanes = torch.arange(n, device=acc.device)
    T = unpack_jac(acc, g2)
    for d in digits:
        idx = torch.where((d >= 1) & (d <= STEP4_ENTRIES), d - 1,
                          torch.zeros_like(d)).long()
        q = unpack_jac(tab[idx, :, lanes].T.contiguous(), g2)
        T = dcv.msm_step_w4(F, T, q, d)
    return pack_point(T)


def g1_step4_ref(acc, table, digits):
    return _step4_ref(False, acc, table, digits)


def g2_step4_ref(acc, table, digits):
    return _step4_ref(True, acc, table, digits)


def _step_ref(g2, acc, q, bits):
    """B15's bit loop as stacked tensor ops: ``msm_step`` per bit."""
    F = _field(g2)
    T, Q = unpack_jac(acc, g2), unpack_aff(q, g2)
    for b in bits:
        T = dcv.msm_step(F, T, Q, b != 0)
    return pack_point(T)


def g1_step_ref(acc, q, bits):
    return _step_ref(False, acc, q, bits)


def g2_step_ref(acc, q, bits):
    return _step_ref(True, acc, q, bits)


def _selmadd_ref(g2, acc, table, digits, start):
    """B16's selmadd as stacked tensor ops: each accumulator lane's digit
    (0 past the last lane), its one table entry (entry 0 for a digit
    outside 1..nent), one complete add, and the select on d ≠ 0."""
    F = _field(g2)
    rows = (6 if g2 else 3) * L
    a, n = acc.shape[1], table.shape[1]
    nent = table.shape[0] // rows
    m = max(0, min(a, n - start))
    d = torch.zeros(a, dtype=torch.int32, device=acc.device)
    d[:m] = digits[start:start + m]
    idx = torch.where((d >= 1) & (d <= nent), d - 1,
                      torch.zeros_like(d)).long()
    lanes = (start + torch.arange(a, device=acc.device)).clamp(max=n - 1)
    q = table.reshape(nent, rows, n)[idx, :, lanes].T.contiguous()
    T = unpack_jac(acc, g2)
    s = dcv.jac_add(F, T, unpack_jac(q, g2))
    return pack_point(dcv.tree_map(lambda x, y: mont.select(d != 0, x, y),
                                   s, T))


def g1_selmadd_ref(acc, table, digits, start):
    return _selmadd_ref(False, acc, table, digits, start)


def g2_selmadd_ref(acc, table, digits, start):
    return _selmadd_ref(True, acc, table, digits, start)


def _dblw_ref(g2, acc, window):
    T = unpack_jac(acc, g2)
    for _ in range(window):
        T = dcv.jac_dbl(_field(g2), T)
    return pack_point(T)


def g1_dblw_ref(acc, window):
    return _dblw_ref(False, acc, window)


def g2_dblw_ref(acc, window):
    return _dblw_ref(True, acc, window)


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


def p_step4(g2, acc, table, digits):
    if mont.on_card(acc):
        return (g2_step4 if g2 else g1_step4)(acc, table, digits)
    return (g2_step4_ref if g2 else g1_step4_ref)(acc, table, digits)


def p_step(g2, acc, q, bits):
    if mont.on_card(acc):
        return (g2_step if g2 else g1_step)(acc, q, bits)
    return (g2_step_ref if g2 else g1_step_ref)(acc, q, bits)


def p_selmadd(g2, acc, table, digits, start):
    if mont.on_card(acc):
        return (g2_selmadd if g2 else g1_selmadd)(acc, table, digits, start)
    return (g2_selmadd_ref if g2 else g1_selmadd_ref)(acc, table, digits,
                                                      start)


def p_dblw(g2, acc, window):
    if mont.on_card(acc):
        return (g2_dblw if g2 else g1_dblw)(acc, window)
    return (g2_dblw_ref if g2 else g1_dblw_ref)(acc, window)


def packed_infinity(g2: bool, n: int, device):
    """Packed Jacobian infinity over n lanes: X = Y = 1, Z = 0."""
    k = 2 if g2 else 1
    one = pk._one_rows(k, n, device)
    return torch.cat([one, one, torch.zeros_like(one)])


def _ladder_table(curve, points_aff):
    """B13's table 1P..15P of each lane's point: the affine point lifted
    with Z = ``curve.select_z`` (0 on infinity lanes), then 14 B10 mixed
    adds of the affine point. The JAX package builds it with XLA complete
    adds: the same points, in other Jacobian coordinates."""
    x, y, inf = points_aff
    g2 = curve is dcv.G2
    q = pk.pack([*x, *y] if g2 else [x, y])
    z = dcv.select_z(curve, inf)
    entries = [torch.cat([q, pk.pack(list(z) if g2 else [z])])]
    for _ in range(STEP4_ENTRIES - 1):
        entries.append(p_madd(g2, entries[-1], q))
    return torch.cat(entries)


def msm_pallas(curve, points_aff, scalars, nbits: int = 64, window: int = 1,
               fold: bool = True):
    """Σ points_i·scalars_i on the per-lane ladder kernels; the counterpart
    of ``pallas_curve.msm_pallas`` (:678).

    curve: ``curve.G1`` / ``curve.G2``; points_aff: the affine tuple
    (x, y, inf); scalars: int32[N, 16] canonical limbs. window=1: one B15
    launch over the nbits bits (a doubling and a gated mixed add per bit);
    window=4: the 15-entry table (``_ladder_table``, 14 B10 launches) and
    one B13 launch over the ⌈nbits/4⌉ base-16 digits. Dead (infinity) lanes
    get bit or digit 0, so they stay at infinity. Returns the unbatched
    Jacobian sum (``fold_sum``), or with fold=False the per-lane products
    as a Jacobian tuple [N].
    """
    if window not in (1, 4):
        raise ValueError(f"msm_pallas takes window 1 or 4, got {window}")
    x, y, inf = points_aff
    g2 = curve is dcv.G2
    n = inf.shape[0]
    live = (~inf).to(torch.int32)[None]
    acc0 = packed_infinity(g2, n, inf.device)
    if window == 4:
        table = _ladder_table(curve, points_aff)
        digits = dcv.scalar_digits(scalars, nbits, 4) * live
        acc = p_step4(g2, acc0, table, digits.contiguous())
    else:
        q = pk.pack([*x, *y] if g2 else [x, y])
        bits = dcv.scalar_bits(scalars, nbits) * live
        acc = p_step(g2, acc0, q, bits.contiguous())
    jac = unpack_jac(acc, g2)
    return curve.fold_sum(jac) if fold else jac


def scalar_mul_pallas(curve, points_aff, scalars, nbits: int = 255,
                      window: int = 4):
    """Per-lane scalars_i·points_i on the ladder (no fold): the batched
    encryption's three scalar-muls (``pallas_curve.scalar_mul_pallas``
    :786). Returns a Jacobian tuple [N]."""
    return msm_pallas(curve, points_aff, scalars, nbits=nbits, window=window,
                      fold=False)


def scalar_mul_gathered(curve, points_aff, index, scalars, nbits: int = 255):
    """Per-lane scalars_l·points[index_l], for many lanes over few
    distinct points (the DKG's row commitments and value checks): the
    ladder table 1P..15P is built once per distinct point (14 B10 over the
    points), gathered to the lanes, and one B13 per ``LADDER_CHUNK`` lanes
    runs the ⌈nbits/4⌉ base-16 digits. The same per-lane ladder as
    ``scalar_mul_pallas``, so the same Jacobian coordinates.

    points_aff: affine tuple (x, y, inf) [P]; index: int64[N] into the
    points; scalars: int32[N, 16] canonical limbs. Lanes of infinite points
    get digit 0 and stay at infinity. Returns a Jacobian tuple [N].
    """
    g2 = curve is dcv.G2
    n, dev = index.shape[0], index.device
    table = _ladder_table(curve, points_aff)
    live = (~points_aff[2]).to(torch.int32)
    accs = []
    for start in range(0, n, LADDER_CHUNK):
        idx = index[start:start + LADDER_CHUNK]
        digits = dcv.scalar_digits(scalars[start:start + LADDER_CHUNK],
                                   nbits, 4) * live[idx][None]
        accs.append(p_step4(g2, packed_infinity(g2, idx.shape[0], dev),
                            table.index_select(1, idx),
                            digits.contiguous()))
    return unpack_jac(torch.cat(accs, 1), g2)


def fixed_digits(k: int, window: int = 4):
    """The static base-16 digits of k, MSB first, leading zeros dropped
    (one digit 0 for k = 0)."""
    nd = max(1, -(-max(k.bit_length(), 1) // window))
    return [(k >> (window * i)) & ((1 << window) - 1)
            for i in range(nd - 1, -1, -1)]


def scalar_mul_fixed_pallas(curve, points_aff, k: int, window: int = 4):
    """Per-lane k·P_i for one public scalar k of any width
    (``pallas_curve.scalar_mul_fixed_pallas`` :796): one table and one B13
    launch over k's static digits (127 for hash_g2's 507-bit cofactor H2),
    every live lane reading the same table row per digit. Infinity lanes,
    and every lane for k = 0, give infinity. Returns a Jacobian tuple [N].
    """
    if window != 4 or k < 0:
        raise ValueError("scalar_mul_fixed_pallas takes window 4 and k >= 0")
    inf = points_aff[2]
    g2 = curve is dcv.G2
    n = inf.shape[0]
    table = _ladder_table(curve, points_aff)
    digs = torch.tensor(fixed_digits(k, window), dtype=torch.int32,
                        device=inf.device)
    digits = digs[:, None] * (~inf).to(torch.int32)[None]
    acc = p_step4(g2, packed_infinity(g2, n, inf.device), table,
                  digits.contiguous())
    return unpack_jac(acc, g2)


def msm_pallas_shared(curve, points_aff, scalars, nbits: int = 64,
                      window: int = 3, accumulators=None,
                      fused: bool = True):
    """Σ points_i·scalars_i by shared-window Horner accumulation; the
    counterpart of ``pallas_curve.msm_pallas_shared`` (:887).

    curve: ``curve.G1`` / ``curve.G2``; points_aff: the affine tuple
    (x, y, inf) of ``pairing.g1/g2_affine_from_host``; scalars: int32[N, 16]
    canonical limbs. Dead (infinity) lanes get digit 0 and are never
    selected; the affine base lifted to Z = 1 and 2^w − 2 B10 launches make
    the table 1P..(2^w−1)P. fused=True: one B11 launch makes min(A, N)
    partial sums (A = ``accumulators``, by default ``ACCUMULATORS``).
    fused=False, the JAX package's DIRECT branch: min(A, N) accumulators
    (by default ``SHARED_BLOCK``), and per window one B16 dblw launch, then
    one B16 selmadd launch per block of A lanes, the last block's padding
    with digit 0. ``fold_sum`` adds the partial sums up; both forms give
    the same point. Returns an unbatched Jacobian point (leaves [24]).
    """
    if accumulators is None:
        accumulators = ACCUMULATORS if fused else SHARED_BLOCK
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
    digits = digits.contiguous()
    A = min(accumulators, max(n, 1))
    if fused:
        acc = p_winacc(g2, table, digits, A, window)
    else:
        acc = packed_infinity(g2, A, q.device)
        for row in digits:
            acc = p_dblw(g2, acc, window)
            for start in range(0, n, A):
                acc = p_selmadd(g2, acc, table, row, start)
    return curve.fold_sum(unpack_jac(acc, g2))


_SRC = "threshold_crypto_tpu_torch/csrc/msm.cu"
_LADDER = "threshold_crypto_tpu_torch/csrc/ladder.cu"
_SHARED = "threshold_crypto_tpu_torch/csrc/shared.cu"
_TPU = "threshold_crypto_tpu/device/pallas_curve.py:"
KERNELS = (
    Kernel("g1_madd", g1_madd, g1_madd_ref, G1_MADD, _SRC, _TPU + "397"),
    Kernel("g2_madd", g2_madd, g2_madd_ref, G2_MADD, _SRC, _TPU + "397"),
    Kernel("g1_winacc", g1_winacc, g1_winacc_ref, G1_WINACC, _SRC,
           _TPU + "534"),
    Kernel("g2_winacc", g2_winacc, g2_winacc_ref, G2_WINACC, _SRC,
           _TPU + "534"),
    Kernel("g1_step4", g1_step4, g1_step4_ref, G1_STEP4, _LADDER,
           _TPU + "385"),
    Kernel("g2_step4", g2_step4, g2_step4_ref, G2_STEP4, _LADDER,
           _TPU + "385"),
    Kernel("g1_step", g1_step, g1_step_ref, G1_STEP, _LADDER, _TPU + "373"),
    Kernel("g2_step", g2_step, g2_step_ref, G2_STEP, _LADDER, _TPU + "373"),
    Kernel("g1_selmadd", g1_selmadd, g1_selmadd_ref, G1_SELMADD, _SHARED,
           _TPU + "410"),
    Kernel("g2_selmadd", g2_selmadd, g2_selmadd_ref, G2_SELMADD, _SHARED,
           _TPU + "410"),
    Kernel("g1_dblw", g1_dblw, g1_dblw_ref, G1_DBLW, _SHARED, _TPU + "433"),
    Kernel("g2_dblw", g2_dblw, g2_dblw_ref, G2_DBLW, _SHARED, _TPU + "433"),
)
