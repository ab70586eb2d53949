"""The tower kernels of ``csrc/miller.cu`` and ``csrc/fq12.cu``: wrappers,
plain versions and the dispatch between them.

Each kernel is the counterpart of one Pallas megakernel of
``threshold_crypto_tpu/device/pallas_tower.py``:

* B4 ``dbl_fold`` (``_k_dbl_fold``): T ← 2T, f ← f²·l_tangent(P);
* B5 ``add_fold`` (``_k_add_fold``): T ← T + Q, f ← f·l_chord(P);
* B6 ``cyclo_sqr`` (``_k_cyclo_sqr``): Granger–Scott squaring;
* B7 ``cyclo_sqr_mul`` (``_k_cyclo_sqr_mul``): f²·g, cyclotomic square;
* B8 ``fq12_mul`` (``_k_fq12_mul``) and B9 ``fq12_sqr`` (``_k_fq12_sqr``);
  B4-B9 run on the lane-group engine ``csrc/tower_group.cuh``;
* B17, the unfused Miller pieces: ``dbl_step`` (``_k_dbl_step``: T ← 2T and
  the tangent line out), ``add_step`` (``_k_add_step``: T ← T + Q and the
  chord line out), ``f_sqr_fold`` (``_k_f_sqr_fold``: f²·line) and
  ``f_fold`` (``_k_f_fold``: f·line), also on the lane-group engine, each
  B4's or B5's schedule cut at the line. A step then its fold is B4 or B5
  bit for bit. No JAX path calls them, so they are on no entry point's
  path; ``chip_smoke.py`` drives a whole Miller loop through them;
* B18, the final exponentiation's tower steps, also on the lane-group
  engine: ``frob_mul`` (a·σ_k(b), k = 1, 2: the hard part's two Frobenius
  products), and the easy part f^((p^6 − 1)(p² + 1)) as ``easy_down``
  (f down the tower to one Fq value n a lane, and what the ascent needs)
  and ``easy_up`` (from n⁻¹, one B2 inversion between them, back up to
  conj(f)·f⁻¹ and its product with its p²-Frobenius). The JAX package runs
  these steps through XLA's tower (``threshold_crypto_tpu/device/
  pairing.py`` ``_easy_part``, ``_packed_frob``): no Pallas kernel;
* ``fq_engine`` is the test entry of B3, the field engine
  (``_k_mul16``/``_k_mul13``, ``k_add``, ``k_sub``, ``k_neg``,
  ``k_small``), on the register engine ``csrc/ladder_engine.cuh`` that
  every redesigned kernel runs on: it has no launch on any path.

They take and return the packed layout of :mod:`.packed`, contiguous
``int32[k·24, N]`` CUDA tensors (f: k = 12, T: 6, Q: 4, P: 2, a line
(c0, c1, c4): 6, in ``_k_dbl_step``'s plane order; ``easy_down``'s
values s, m, c0-c2, tt: 20), save that the easy part's one Fq value a lane
is ``int32[N, 24]``, the layout of :mod:`.mont` that B2 takes, and allocate
their outputs with ``torch.empty``, launch on the current stream and do not
synchronise. Each wrapper counts its own launches (``DBL_FOLD`` …).

The ``*_ref`` functions are the same functions in plain PyTorch: they
unpack, run the port's tower (:mod:`.tower`, whose products go to
:func:`.mont.mul`) and the Miller step formulas, and pack again. The
``p_*`` functions send a CUDA tensor to the kernel and a CPU tensor to its
plain version; ``KERNELS`` lists every kernel with its plain version.
"""

from __future__ import annotations

import torch

from . import mont
from . import packed as pk
from . import tower as tw
from .cuda_mont import Kernel, KernelCount, launch
from .mont import FQ

# Packed rows of an Fq12 f, a point T, an affine Q, a G1 point P, a line and
# the easy part's values between its two kernels.
F, T_, Q_, P_, LINE, EASY = (k * FQ.L for k in (12, 6, 4, 2, 6, 20))

ENGINE = KernelCount()
DBL_FOLD = KernelCount()
ADD_FOLD = KernelCount()
CYCLO_SQR = KernelCount()
CYCLO_SQR_MUL = KernelCount()
FQ12_MUL = KernelCount()
FQ12_SQR = KernelCount()
DBL_STEP = KernelCount()
ADD_STEP = KernelCount()
F_SQR_FOLD = KernelCount()
F_FOLD = KernelCount()
FROB_MUL = KernelCount()
EASY_DOWN = KernelCount()
EASY_UP = KernelCount()


def _check(*operands):
    """(name, tensor, rows) per operand: each a contiguous int32[rows, N]
    CUDA tensor (rows None: any multiple of 24), one N and one device for
    all. Returns N."""
    first = operands[0][1]
    for name, x, rows in operands:
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if x.dim() != 2 or x.shape[0] != (rows or x.shape[0]) \
                or x.shape[0] % FQ.L:
            raise ValueError(f"{name} must be [{rows or 'm·24'}, N], got "
                             f"{tuple(x.shape)}")
        if x.shape[1] != first.shape[1] or x.device != first.device:
            raise ValueError("operands must have one lane count and device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return first.shape[1]


def _launch(lib, fn, count, ins, outs, n, *extra):
    """Launch ``fn`` of library ``lib`` on the current stream and count it."""
    if n == 0:
        return
    launch(lib, fn, count, (*ins, *outs), *extra, n, lanes=n)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def dbl_fold(f, T, P):
    """Kernel B4: (f²·l_tangent, 2T) on packed f [288, N], T [144, N],
    P [48, N]."""
    n = _check(("f", f, F), ("T", T, T_), ("P", P, P_))
    fo, To = torch.empty_like(f), torch.empty_like(T)
    _launch("miller", "tc_dbl_fold", DBL_FOLD, (f, T, P), (fo, To), n)
    return fo, To


def add_fold(f, T, Q, P):
    """Kernel B5: (f·l_chord, T + Q) with Q [96, N] affine."""
    n = _check(("f", f, F), ("T", T, T_), ("Q", Q, Q_), ("P", P, P_))
    fo, To = torch.empty_like(f), torch.empty_like(T)
    _launch("miller", "tc_add_fold", ADD_FOLD, (f, T, Q, P), (fo, To), n)
    return fo, To


def cyclo_sqr(f):
    """Kernel B6: Granger–Scott square of packed f [288, N]."""
    n = _check(("f", f, F))
    fo = torch.empty_like(f)
    _launch("fq12", "tc_cyclo_sqr", CYCLO_SQR, (f,), (fo,), n)
    return fo


def cyclo_sqr_mul(f, g):
    """Kernel B7: cyclotomic f² · g."""
    n = _check(("f", f, F), ("g", g, F))
    fo = torch.empty_like(f)
    _launch("fq12", "tc_cyclo_sqr_mul", CYCLO_SQR_MUL, (f, g), (fo,), n)
    return fo


def fq12_mul(a, b):
    """Kernel B8: a · b."""
    n = _check(("a", a, F), ("b", b, F))
    fo = torch.empty_like(a)
    _launch("fq12", "tc_fq12_mul", FQ12_MUL, (a, b), (fo,), n)
    return fo


def fq12_sqr(a):
    """Kernel B9: a²."""
    n = _check(("a", a, F))
    fo = torch.empty_like(a)
    _launch("fq12", "tc_fq12_sqr", FQ12_SQR, (a,), (fo,), n)
    return fo


def dbl_step(T, P):
    """Kernel B17 ``dbl_step``: (2T, the tangent line at P) on packed
    T [144, N], P [48, N]; the line [144, N]."""
    n = _check(("T", T, T_), ("P", P, P_))
    To, line = torch.empty_like(T), torch.empty_like(T)
    _launch("miller", "tc_dbl_step", DBL_STEP, (T, P), (To, line), n)
    return To, line


def add_step(T, Q, P):
    """Kernel B17 ``add_step``: (T + Q, the chord line at P), Q [96, N]
    affine."""
    n = _check(("T", T, T_), ("Q", Q, Q_), ("P", P, P_))
    To, line = torch.empty_like(T), torch.empty_like(T)
    _launch("miller", "tc_add_step", ADD_STEP, (T, Q, P), (To, line), n)
    return To, line


def f_sqr_fold(f, line):
    """Kernel B17 ``f_sqr_fold``: f²·line, f [288, N], line [144, N]."""
    n = _check(("f", f, F), ("line", line, LINE))
    fo = torch.empty_like(f)
    _launch("miller", "tc_f_sqr_fold", F_SQR_FOLD, (f, line), (fo,), n)
    return fo


def f_fold(f, line):
    """Kernel B17 ``f_fold``: f·line."""
    n = _check(("f", f, F), ("line", line, LINE))
    fo = torch.empty_like(f)
    _launch("miller", "tc_f_fold", F_FOLD, (f, line), (fo,), n)
    return fo


def frob_mul(a, b, k: int):
    """Kernel B18 ``frob_mul``: a·σ_k(b) for packed a, b [288, N], σ_k the
    p^k-Frobenius, k = 1 or 2."""
    n = _check(("a", a, F), ("b", b, F))
    if k not in (1, 2):
        raise ValueError(f"frob_mul takes k = 1 or 2, got {k}")
    fo = torch.empty_like(a)
    _launch("fq12", "tc_frob_mul", FROB_MUL, (a, b), (fo,), n, k)
    return fo


def easy_down(f):
    """Kernel B18 ``easy_down``: packed f [288, N] down the tower to
    (n int32[N, 24], the values s, m, c0-c2, tt [480, N] that ``easy_up``
    takes); f⁻¹ needs n⁻¹ alone."""
    n = _check(("f", f, F))
    norm = torch.empty((n, FQ.L), dtype=f.dtype, device=f.device)
    inter = torch.empty((EASY, n), dtype=f.dtype, device=f.device)
    _launch("fq12", "tc_easy_down", EASY_DOWN, (f,), (norm, inter), n)
    return norm, inter


def easy_up(inter, ninv):
    """Kernel B18 ``easy_up``: ``easy_down``'s values [480, N] and n⁻¹
    int32[N, 24] -> the easy part's packed Fq12 [288, N]."""
    n = _check(("inter", inter, EASY))
    if (ninv.device != inter.device or ninv.dtype != torch.int32
            or tuple(ninv.shape) != (n, FQ.L) or not ninv.is_contiguous()):
        raise ValueError(f"ninv must be a contiguous int32 [{n}, {FQ.L}] "
                         f"tensor on {inter.device}, got {ninv.dtype} "
                         f"{tuple(ninv.shape)} on {ninv.device}")
    fo = torch.empty((F, n), dtype=inter.dtype, device=inter.device)
    _launch("fq12", "tc_easy_up", EASY_UP, (inter, ninv), (fo,), n)
    return fo


def fq_engine(a, b, k: int):
    """The engine's test entry: stacked Fq values a, b [m·24, N] ->
    int32[5, m·24, N] holding a·b, a + b, a − b, −a and k·a (k ≥ 1)."""
    n = _check(("a", a, None), ("b", b, None))
    if a.shape != b.shape:
        raise ValueError("a and b must have one shape")
    if k < 1:
        raise ValueError("k must be at least 1")
    out = torch.empty((5,) + tuple(a.shape), dtype=a.dtype, device=a.device)
    _launch("fq12", "tc_fq_engine", ENGINE, (a, b), (out,), n,
            a.shape[0] // FQ.L, k)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _point(T):
    return tuple(pk.unpack_fq2s(T, 3))


def dbl_fold_ref(f, T, P):
    xp, yp = pk.unpack(P, 2)
    To, line = tw.dbl_step(_point(T), xp, yp)
    fo = tw.fq12_mul_by_014(tw.fq12_sqr(pk.unpack12(f)), *line)
    return pk.pack12(fo), pk.pack_fq2s(To)


def add_fold_ref(f, T, Q, P):
    xp, yp = pk.unpack(P, 2)
    To, line = tw.add_step(_point(T), tuple(pk.unpack_fq2s(Q, 2)), xp, yp)
    fo = tw.fq12_mul_by_014(pk.unpack12(f), *line)
    return pk.pack12(fo), pk.pack_fq2s(To)


def cyclo_sqr_ref(f):
    return pk.pack12(tw.fq12_cyclo_sqr(pk.unpack12(f)))


def cyclo_sqr_mul_ref(f, g):
    return pk.pack12(tw.fq12_mul(tw.fq12_cyclo_sqr(pk.unpack12(f)),
                                 pk.unpack12(g)))


def fq12_mul_ref(a, b):
    return pk.pack12(tw.fq12_mul(pk.unpack12(a), pk.unpack12(b)))


def fq12_sqr_ref(a):
    return pk.pack12(tw.fq12_sqr(pk.unpack12(a)))


def dbl_step_ref(T, P):
    To, line = tw.dbl_step(_point(T), *pk.unpack(P, 2))
    return pk.pack_fq2s(To), pk.pack_fq2s(line)


def add_step_ref(T, Q, P):
    To, line = tw.add_step(_point(T), tuple(pk.unpack_fq2s(Q, 2)),
                           *pk.unpack(P, 2))
    return pk.pack_fq2s(To), pk.pack_fq2s(line)


def f_sqr_fold_ref(f, line):
    return pk.pack12(tw.fq12_mul_by_014(tw.fq12_sqr(pk.unpack12(f)),
                                        *pk.unpack_fq2s(line, 3)))


def f_fold_ref(f, line):
    return pk.pack12(tw.fq12_mul_by_014(pk.unpack12(f),
                                        *pk.unpack_fq2s(line, 3)))


def frob_mul_ref(a, b, k: int):
    return pk.pack12(tw.fq12_mul(pk.unpack12(a),
                                 tw.fq12_frob(pk.unpack12(b), k)))


def easy_down_ref(f):
    a0, a1 = pk.unpack12(f)
    a01 = tw.fq6_add(a0, a1)
    sq0, sq1, sq01 = (tw.fq6_sqr(x) for x in (a0, a1, a01))
    v_sq1 = tw.fq6_mul_by_v(sq1)
    t = tw.fq6_sub(sq0, v_sq1)                         # f·conj(f)
    s = tw.fq6_add(sq0, v_sq1)                         # conj(f)² = s + m·w
    m = tw.fq6_sub(tw.fq6_add(sq0, sq1), sq01)
    c, tt = tw.fq6_inv_parts(t)
    return tw.fq2_norm(tt), pk.pack_fq2s([*s, *m, *c, tt])


def easy_up_ref(inter, ninv):
    x = pk.unpack_fq2s(inter, 10)
    s, m, c, tt = x[0:3], x[3:6], x[6:9], x[9]
    tinv = tw.fq2_conj(tw.fq2_scale_fq(tt, ninv))
    tmp = tuple(tw.fq2_mul_many([(ci, tinv) for ci in c]))
    x = (tw.fq6_mul(s, tmp), tw.fq6_mul(m, tmp))      # conj(f)·f⁻¹
    return pk.pack12(tw.fq12_mul(tw.fq12_frob(x, 2), x))


def easy_part_ref(f):
    return pk.pack12(tw.fq12_easy_part(pk.unpack12(f)))


def fq_engine_ref(a, b, k: int):
    m = a.shape[0] // FQ.L
    x = torch.stack(pk.unpack(a, m))                           # [m, N, 24]
    y = torch.stack(pk.unpack(b, m))
    outs = (mont.mul(FQ, x, y), mont.add(FQ, x, y), mont.sub(FQ, x, y),
            mont.neg(FQ, x), mont.mul_small(FQ, x, k))
    return torch.stack([pk.pack(list(o)) for o in outs])


# ---------------------------------------------------------------------------
# Dispatch: kernel on the card, plain version on the CPU
# ---------------------------------------------------------------------------

def p_dbl_fold(f, T, P):
    return (dbl_fold if mont.on_card(f) else dbl_fold_ref)(f, T, P)


def p_add_fold(f, T, Q, P):
    return (add_fold if mont.on_card(f) else add_fold_ref)(f, T, Q, P)


def p_cyclo_sqr(f):
    return (cyclo_sqr if mont.on_card(f) else cyclo_sqr_ref)(f)


def p_cyclo_sqr_mul(f, g):
    return (cyclo_sqr_mul if mont.on_card(f) else cyclo_sqr_mul_ref)(f, g)


def p_fq12_mul(a, b):
    return (fq12_mul if mont.on_card(a) else fq12_mul_ref)(a, b)


def p_fq12_sqr(a):
    return (fq12_sqr if mont.on_card(a) else fq12_sqr_ref)(a)


def p_dbl_step(T, P):
    return (dbl_step if mont.on_card(T) else dbl_step_ref)(T, P)


def p_add_step(T, Q, P):
    return (add_step if mont.on_card(T) else add_step_ref)(T, Q, P)


def p_f_sqr_fold(f, line):
    return (f_sqr_fold if mont.on_card(f) else f_sqr_fold_ref)(f, line)


def p_f_fold(f, line):
    return (f_fold if mont.on_card(f) else f_fold_ref)(f, line)


def p_frob_mul(a, b, k: int):
    return (frob_mul if mont.on_card(a) else frob_mul_ref)(a, b, k)


def p_easy_part(f):
    """The final exponentiation's easy part on packed f [288, N]: on the
    card ``easy_down``, one B2 inversion of its n (zero to zero) and
    ``easy_up``; on the CPU the tower (``easy_part_ref``)."""
    if not mont.on_card(f):
        return easy_part_ref(f)
    norm, inter = easy_down(f)
    return easy_up(inter, mont.inv(FQ, norm))


_SRC = "threshold_crypto_tpu_torch/csrc/"
_TPU = "threshold_crypto_tpu/device/pallas_tower.py:"
# B18 replaces no Pallas kernel: the JAX package's XLA tower steps.
_XLA = "threshold_crypto_tpu/device/pairing.py:"
KERNELS = (
    Kernel("fq_engine", fq_engine, fq_engine_ref, ENGINE, _SRC + "fq12.cu",
           _TPU + "140"),
    Kernel("dbl_fold", dbl_fold, dbl_fold_ref, DBL_FOLD, _SRC + "miller.cu",
           _TPU + "906"),
    Kernel("add_fold", add_fold, add_fold_ref, ADD_FOLD, _SRC + "miller.cu",
           _TPU + "918"),
    Kernel("cyclo_sqr", cyclo_sqr, cyclo_sqr_ref, CYCLO_SQR,
           _SRC + "fq12.cu", _TPU + "956"),
    Kernel("cyclo_sqr_mul", cyclo_sqr_mul, cyclo_sqr_mul_ref, CYCLO_SQR_MUL,
           _SRC + "fq12.cu", _TPU + "932"),
    Kernel("fq12_mul", fq12_mul, fq12_mul_ref, FQ12_MUL, _SRC + "fq12.cu",
           _TPU + "960"),
    Kernel("fq12_sqr", fq12_sqr, fq12_sqr_ref, FQ12_SQR, _SRC + "fq12.cu",
           _TPU + "964"),
    Kernel("dbl_step", dbl_step, dbl_step_ref, DBL_STEP, _SRC + "miller.cu",
           _TPU + "886"),
    Kernel("add_step", add_step, add_step_ref, ADD_STEP, _SRC + "miller.cu",
           _TPU + "895"),
    Kernel("f_sqr_fold", f_sqr_fold, f_sqr_fold_ref, F_SQR_FOLD,
           _SRC + "miller.cu", _TPU + "940"),
    Kernel("f_fold", f_fold, f_fold_ref, F_FOLD, _SRC + "miller.cu",
           _TPU + "948"),
    Kernel("frob_mul", frob_mul, frob_mul_ref, FROB_MUL, _SRC + "fq12.cu",
           _XLA + "269"),
    Kernel("easy_down", easy_down, easy_down_ref, EASY_DOWN,
           _SRC + "fq12.cu", _XLA + "257"),
    Kernel("easy_up", easy_up, easy_up_ref, EASY_UP, _SRC + "fq12.cu",
           _XLA + "257"),
)
