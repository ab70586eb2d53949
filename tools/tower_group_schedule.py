#!/usr/bin/env python3
"""The static schedules of B4 (``dbl_fold``), B5 (``add_fold``), B6
(``cyclo_sqr``), B7 (``cyclo_sqr_mul``), B8 (``fq12_mul``), B9
(``fq12_sqr``), B17's four pieces (``dbl_step``, ``f_sqr_fold``,
``add_step``, ``f_fold``) and B18's (``frob_mul`` at p and p², the final
exponentiation's easy part as ``easy_down`` and ``easy_up``) on the
lane-group tower engine, and the tables of ``csrc/tower_group.cuh``.

    python3 tools/tower_group_schedule.py           # print the table block
    python3 tools/tower_group_schedule.py --write   # write it into the header
    python3 tools/tower_group_schedule.py --check   # exit 1 if it differs

A schedule is the formulas of ``csrc/tower.cuh`` (the JAX package's, with
Fq2 squares as two products) written over symbolic Fq values. Every Fq
value the engine keeps is one slot of a lane's shared-memory scratch, and
everything between two products is linear over Fq with small integer
coefficients (adds, subs, doublings, ξ·x = (x0 − x1, x0 + x1)), so a value
is a linear form: a sum of c·slot. The schedule is a list of phases:

* a product phase: Fq products dst = A·B whose operands A and B are
  linear forms over earlier slots (the Karatsuba sums and differences,
  formed as the operands are loaded);
* a linear phase: dst = a linear form over earlier slots (the fins of the
  products: Karatsuba's t0 − t1 and t2 − t0 − t1, ``_fq6_mul_fin``,
  ``_sparse01_fin``, the Granger-Scott 3t ∓ 2z, the outputs).

No op of a phase reads a slot that another op of the same phase writes,
so the ops of a phase may run in any order or in parallel, and a phase
ends at a barrier. The slots are allocated by liveness (first fit): a slot
is free for a phase's outputs once every op that reads its value has run
in an earlier phase. The inputs take the first slots, in the packed
components' order (B4: f 0-11, T 12-17, P 18-19; B5: f 0-11, T 12-17,
Q 18-21, P 22-23; B6: f 0-11; B7: f 0-11, g 12-23; B8: a 0-11, b 12-23;
B9: a 0-11; ``dbl_step``: T 0-5, P 6-7; ``add_step``: T 0-5, Q 6-9,
P 10-11; ``f_sqr_fold`` and ``f_fold``: f 0-11, the line 12-17).

B4 follows the JAX package's four product layers (`pallas_tower.dbl_fold`:
48, 19, 16 and 39 Fq products), B5 `add_step`'s four (6, 14, 9, 12) with
the line product's 39 in the third, B6 its one layer of 18, B7 B6's layer
and then `fq12_mul`'s 54 (`pallas_tower.fq12_mul`), B8 those 54 alone,
B9 `fq12_sqr`'s 36 (B4's first layer without the doubling). B17 is B4
and B5 cut where the line is written: ``dbl_step`` B4's layers 1-3
without f² (12, 19, 16), ``f_sqr_fold`` f² (B9's 36) and B4's layer 4
(39), ``add_step`` B5's layers without the line product (6, 14, 9, 12),
``f_fold`` that product (39); B4 and B5 are built from the same pieces.
The engine deals
the ops of each phase round-robin over the G threads of a lane's group:
thread g runs ops g, g + G, …; the product phases' ops are all one
product, the linear phases' are sorted by their cost, largest first. Each
form carries its reduction steps (`reduction`): the engine sums a form
unreduced and reduces it only as far as its use needs.

B18 multiplies by the Frobenius constants of the tower
(``host/tower.py`` ``FROB12_C1``, ``FROB6_C1``, ``FROB6_C2``): a product's
second operand may be one constant (`Const`), read from the header's
``kTowerConsts`` (the constants in Montgomery form, R = 2^384) in place of
a form over slots. ``frob_mul`` is a·σ_k(b): one product phase of the
constants (10 Fq products: each constant is real, imaginary or c·(1 ± u),
two products an Fq2), then B8's 54.
``easy_down`` takes f = (a0, a1) down the tower to the one Fq value n a
lane whose inverse the easy part needs (62 products in four phases: a0²,
a1², (a0 + a1)²; ``fq6_inv``'s c0, c1, c2; tt; tt's norm) and keeps what
the ascent needs: s = a0² + v·a1², m = −2·a0·a1 (conj(f)² = s + m·w),
c0, c1, c2 and tt. ``easy_up`` goes back up with n⁻¹ (111 products in
five phases: tt⁻¹; the Fq6 inverse tmp; x = conj(f)·f⁻¹ = conj(f)²·tmp;
σ_2(x); x·σ_2(x)). Their inputs: ``frob_mul`` a 0-11, b 12-23;
``easy_down`` f 0-11; ``easy_up`` s 0-5, m 6-11, c0-c2 12-17, tt 18-19,
n⁻¹ 20 (``easy_down``'s outputs after n, in order).

The table block is C++ between the marker lines of the header.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from threshold_crypto_tpu_torch.host import tower as htw  # noqa: E402
from threshold_crypto_tpu_torch.host.params import P  # noqa: E402

HEADER = os.path.join(ROOT, "threshold_crypto_tpu_torch", "csrc",
                      "tower_group.cuh")
BEGIN = "// BEGIN SCHEDULE TABLES (tools/tower_group_schedule.py --write)"
END = "// END SCHEDULE TABLES"


# ---------------------------------------------------------------------------
# Linear forms over nodes
# ---------------------------------------------------------------------------

class Lin:
    """Σ coef·node over Fq: a dict {node: nonzero int}."""

    __slots__ = ("c",)

    def __init__(self, c=None):
        self.c = {k: v for k, v in (c or {}).items() if v}

    def __add__(self, o):
        c = dict(self.c)
        for k, v in o.c.items():
            c[k] = c.get(k, 0) + v
        return Lin(c)

    def __neg__(self):
        return Lin({k: -v for k, v in self.c.items()})

    def __sub__(self, o):
        return self + (-o)

    def __rmul__(self, k: int):
        return Lin({n: k * v for n, v in self.c.items()})


class Const:
    """A constant Fq value as a product's second operand: entry `index` of
    the header's ``kTowerConsts``."""

    __slots__ = ("index",)

    def __init__(self, value):
        self.index = CONSTS.index(value % P)


# Fq2 = (re, im), Fq6 = 3 Fq2, Fq12 = 2 Fq6, as tuples of Lin.
def add2(a, b):
    return (a[0] + b[0], a[1] + b[1])


def sub2(a, b):
    return (a[0] - b[0], a[1] - b[1])


def small2(k, a):
    return (k * a[0], k * a[1])


def xi(a):
    """ξ·a = (1 + u)·a = (a0 − a1, a0 + a1)."""
    return (a[0] - a[1], a[0] + a[1])


def add6(a, b):
    return tuple(add2(x, y) for x, y in zip(a, b))


def sub6(a, b):
    return tuple(sub2(x, y) for x, y in zip(a, b))


def mul_by_v(a):
    return (xi(a[2]), a[0], a[1])


# ---------------------------------------------------------------------------
# Products: an Fq2 product is a request of Fq pairs and a fin over them
# ---------------------------------------------------------------------------

def mul2(a, b):
    """Karatsuba: t0 = a0·b0, t1 = a1·b1, t2 = (a0+a1)(b0+b1);
    (t0 − t1, t2 − t0 − t1)."""
    return ([(a[0], b[0]), (a[1], b[1]), (a[0] + a[1], b[0] + b[1])],
            lambda t: (t[0] - t[1], t[2] - t[0] - t[1]))


def sqr2(a):
    """a² = ((a0+a1)(a0−a1), 2·a0·a1)."""
    return ([(a[0] + a[1], a[0] - a[1]), (a[0], a[1])],
            lambda t: (t[0], 2 * t[1]))


def scale2(a, k):
    """a·k for an Fq k."""
    return [(a[0], k), (a[1], k)], lambda t: (t[0], t[1])


def mul2_const(a, c):
    """a·c for a constant c = (c0, c1) of σ_k: every one is c0 times 1, u,
    1 + u or 1 − u, so 2 Fq products against c0 or c1: (a0·c0, a1·c0),
    (−a1·c1, a0·c1), (c0·(a0 − a1), c0·(a0 + a1)) or
    (c0·(a0 + a1), c0·(a1 − a0))."""
    c0, c1 = c
    if c1 == 0:
        return [(a[0], Const(c0)), (a[1], Const(c0))], lambda t: (t[0], t[1])
    if c0 == 0:
        return ([(a[1], Const(c1)), (a[0], Const(c1))],
                lambda t: (-t[0], t[1]))
    if c1 in (c0, P - c0):
        s = 1 if c1 == c0 else -1
        return ([(a[0] - s * a[1], Const(c0)), (a[0] + s * a[1], Const(c0))],
                lambda t: (t[0], s * t[1]))
    raise ValueError(f"no 2-product form for the constant {c}")


def fq6_sqr_reqs(a):
    """An Fq6 square as `_fq6_mul_parts(a, a)` with every Fq2 product a
    square (12 Fq); `fq6_mul_fin` finishes it."""
    return [sqr2(a[0]), sqr2(a[1]), sqr2(a[2]), sqr2(add2(a[1], a[2])),
            sqr2(add2(a[0], a[1])), sqr2(add2(a[0], a[2]))]


def fq6_mul_reqs(a, b):
    """`_fq6_mul_parts`: t_i = a_i·b_i, m12, m01, m02."""
    return [mul2(a[0], b[0]), mul2(a[1], b[1]), mul2(a[2], b[2]),
            mul2(add2(a[1], a[2]), add2(b[1], b[2])),
            mul2(add2(a[0], a[1]), add2(b[0], b[1])),
            mul2(add2(a[0], a[2]), add2(b[0], b[2]))]


def fq6_mul_fin(t):
    t0, t1, t2, m12, m01, m02 = t
    c0 = add2(t0, xi(sub2(m12, add2(t1, t2))))
    c1 = add2(sub2(m01, add2(t0, t1)), xi(t2))
    c2 = add2(sub2(m02, add2(t0, t2)), t1)
    return (c0, c1, c2)


def sparse01_reqs(a, b0, b1):
    return [mul2(a[0], b0), mul2(a[1], b1), mul2(a[2], b1),
            mul2(add2(a[0], a[1]), add2(b0, b1)), mul2(a[2], b0)]


def sparse01_fin(t):
    t0, t1, t2b1, tss, t2b0 = t
    return (add2(t0, xi(t2b1)), sub2(tss, add2(t0, t1)), add2(t2b0, t1))


# ---------------------------------------------------------------------------
# Building a schedule
# ---------------------------------------------------------------------------

class Schedule:
    def __init__(self, name, n_inputs):
        self.name = name
        self.n_inputs = n_inputs
        self.phases = []     # (kind, [(node, A, B or None)])
        self.n_nodes = n_inputs
        self.outputs = []    # nodes, in the order of the output components

    def inputs(self):
        return [Lin({i: 1}) for i in range(self.n_inputs)]

    def _new(self):
        self.n_nodes += 1
        return self.n_nodes - 1

    def products(self, reqs):
        """One product phase over the Fq2 requests; returns their fins."""
        ops, outs = [], []
        for pairs, fin in reqs:
            t = []
            for a, b in pairs:
                node = self._new()
                ops.append((node, a, b))
                t.append(Lin({node: 1}))
            outs.append(fin(t))
        self.phases.append(("product", ops))
        return outs

    def linear(self, forms):
        """One linear phase materialising the Fq forms; returns them as
        single nodes."""
        ops, outs = [], []
        for f in forms:
            node = self._new()
            ops.append((node, f, None))
            outs.append(Lin({node: 1}))
        self.phases.append(("linear", ops))
        return outs

    def linear2(self, values):
        """Materialise Fq2 values."""
        flat = self.linear([c for v in values for c in v])
        return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(values))]

    def output(self, values):
        """The output components, in order: nodes of linear phases."""
        self.outputs = [lin_node(x) for x in values]

    # -- allocation ---------------------------------------------------------

    def allocate(self):
        """slot[node] by liveness, first fit; returns (slots, n_slots)."""
        last = {}
        for p, (_, ops) in enumerate(self.phases):
            for _, a, b in ops:
                for form in (a, b):
                    for node in getattr(form, "c", ()):
                        last[node] = p
        for node in self.outputs:
            last[node] = len(self.phases)
        slot = {i: i for i in range(self.n_inputs)}
        owner = {i: i for i in range(self.n_inputs)}   # slot -> node
        for p, (_, ops) in enumerate(self.phases):
            free = sorted(s for s, node in owner.items()
                          if last.get(node, -1) < p)
            fresh = len(owner)
            for node, _, _ in ops:
                if free:
                    s = free.pop(0)
                else:
                    s, fresh = fresh, fresh + 1
                slot[node] = s
                owner[s] = node
        return slot, len(owner)

    # -- emission -------------------------------------------------------------

    def tables(self):
        """(terms, ops, phases, out_slots, n_slots): terms as slot << 8 |
        (coef & 0xff); ops as (dst, first term, form A, form B), a form
        word its terms | reduction << 8 (`reduction`), B 0 in a linear op;
        a constant B one term, its index << 8 | 1, and the word
        1 | CONST << 8; phases as (first op, ops)."""
        slot, n_slots = self.allocate()
        terms, ops, phases = [], [], []

        def emit(form, steps):
            if isinstance(form, Const):
                terms.append(form.index << 8 | 1)
                return 1 | CONST << 8
            items = sorted(form.c.items(), key=lambda kv: (slot[kv[0]],
                                                          kv[1]))
            for node, coef in items:
                if not -128 <= coef <= 127:
                    raise ValueError(f"coefficient {coef} out of int8")
                terms.append(slot[node] << 8 | (coef & 0xFF))
            return len(items) | steps << 8

        for kind, pops in self.phases:
            if kind == "linear":
                pops = sorted(pops, key=lambda op: -form_cost(op[1]))
            first = len(ops)
            for node, a, b in pops:
                t0 = len(terms)
                ra, rb = reduction(a, b)
                fa = emit(a, ra)
                fb = emit(b, rb) if b is not None else 0
                ops.append((slot[node], t0, fa, fb))
            phases.append((first, len(pops)))
        return (terms, ops, phases, [slot[n] for n in self.outputs],
                n_slots)

    def product_counts(self):
        return [len(ops) for kind, ops in self.phases if kind == "product"]


def lin_node(x):
    (node, coef), = x.c.items()
    assert coef == 1
    return node


def weight(form):
    """Σ|c| of a form: its value, each term below p, is below weight·p."""
    return sum(abs(c) for c in form.c.values())


# The reduction steps of a form, bits of its word above the term count:
# QSTEP subtracts q·p for an estimate q of the value over p (leaving it
# below 3p), CSUB·n n conditional subtracts of p (n ≤ 3).
QSTEP, CSUB = 1, 2
# The bit of a form's word above its reduction steps that makes it one
# constant of ``kTowerConsts`` (B18's Frobenius constants).
CONST = 8


def reduction(a, b):
    """The reduction steps of the forms of op dst = A·B (b None: dst = A).

    The engine sums a form to a value between 0 and weight·p (both
    included) that is the form mod p. The product (carry-save CIOS,
    R = 2^384) gives the canonical a·b·R⁻¹ for a, b < 2^384 with
    a·b < R·p, since its result is then below 2p before its one
    conditional subtract; R / p > 9.8, so weights whose product is at most
    9 need no step, and a weight above 3 is otherwise brought below 3p by
    QSTEP. A linear op's value is stored, so it must be canonical: a
    single term of coefficient 1 is; otherwise at most weight ≤ 3
    conditional subtracts, above that QSTEP then two."""
    wa = weight(a)
    if b is not None:
        wb = 1 if isinstance(b, Const) else weight(b)
        if wa * wb <= 9:
            return 0, 0
        return (QSTEP if wa > 3 else 0), (QSTEP if wb > 3 else 0)
    if wa == 1 and set(a.c.values()) == {1}:
        return 0, 0
    if wa <= 3:
        return CSUB * wa, 0
    return QSTEP | CSUB * 2, 0


def form_cost(form):
    """Terms of a form, and its reduction: the order of a linear phase's
    ops, costliest first."""
    return len(form.c) + (2 if weight(form) > 3 else 0)


def fq12_from(flat):
    """Flat components (the packed order c[i/6].c[(i/2)%3].c[i%2]) to an
    Fq12 of Fq2 tuples."""
    fq2 = [(flat[2 * i], flat[2 * i + 1]) for i in range(6)]
    return ((fq2[0], fq2[1], fq2[2]), (fq2[3], fq2[4], fq2[5]))


def fq12_flat(f):
    return [c for fq6 in f for fq2 in fq6 for c in fq2]


# ---------------------------------------------------------------------------
# B4 and B6
# ---------------------------------------------------------------------------

def fq12_sqr_reqs(a):
    """`pallas_tower.fq12_sqr`'s 12 Fq2 products (36 Fq): with
    a = (a0, a1), tt = a0·a1 and ss = (a0 + a1)(a0 + v·a1)."""
    a0, a1 = a
    sv = add6(a0, mul_by_v(a1))
    return fq6_mul_reqs(a0, a1) + fq6_mul_reqs(add6(a0, a1), sv)


def fq12_sqr_linear(s, t):
    """f² from `fq12_sqr_reqs`' products in two linear phases, tt and ss,
    then (ss − tt − v·tt, 2tt): two linear phases cost about half the adds
    of one."""
    m = s.linear2(list(fq6_mul_fin(t[0:6])) + list(fq6_mul_fin(t[6:12])))
    tt, ss = tuple(m[:3]), tuple(m[3:])
    m = s.linear2(list(sub6(sub6(ss, tt), mul_by_v(tt))) + list(add6(tt, tt)))
    return (tuple(m[:3]), tuple(m[3:]))


def dbl_layer1_reqs(X, Y, Z):
    """The doubling's first layer: X², Y², Y·Z, X·Y, Z² (12 Fq)."""
    return [sqr2(X), sqr2(Y), mul2(Y, Z), mul2(X, Y), sqr2(Z)]


def dbl_rest(s, X, Y, Z, xp, yp, r):
    """The doubling's layers 2 and 3 over its first layer's fins r; returns
    T' as Fq2 nodes and the line (c0, c1, c4). The doubling's values stay
    forms over layer 1's products (in B4 10 slots fewer at the peak, 68
    against 78)."""
    XX, YY, S, XY, ZZ = r
    W = small2(3, XX)

    # Layer 2: B = XY·S, W², S², XX·X, YY·Z, XX·Z, Y·ZZ.
    B, WW, SS, XXX, YYZ, XXZ, YZZ = s.products(
        [mul2(XY, S), sqr2(W), sqr2(S), mul2(XX, X), mul2(YY, Z),
         mul2(XX, Z), mul2(Y, ZZ)])
    H = sub2(WW, small2(8, B))
    H, D, c0 = s.linear2([H, sub2(small2(4, B), H),
                          sub2(small2(3, XXX), small2(2, YYZ))])

    # Layer 3: 2H·S, W(4B − H), YY·SS, S·SS, and the line's c1 = −3XX·Z·xp,
    # c4 = 2Y·ZZ·yp.
    Xo, WD, YYSS, SSS, c1, c4 = s.products(
        [mul2(small2(2, H), S), mul2(W, D), mul2(YY, SS), mul2(S, SS),
         scale2(small2(-3, XXZ), xp), scale2(small2(2, YZZ), yp)])
    To = s.linear2([Xo, sub2(WD, small2(8, YYSS)), small2(8, SSS)])
    return To, (c0, c1, c4)


def fold_014_reqs(f, c0, c1, c4):
    """`fq12_mul_by_014(f, c0, c1, c4)`'s 13 Fq2 products (39 Fq)."""
    f0, f1 = f
    o = add2(c1, c4)
    return (sparse01_reqs(f0, c0, c1)
            + [mul2(f1[2], c4), mul2(f1[0], c4), mul2(f1[1], c4)]
            + sparse01_reqs(add6(f0, f1), c0, o))


def fold_014_fin(t):
    """`fq12_mul_by_014` after its products (`fold_014_reqs`' fins)."""
    t0 = sparse01_fin(t[0:5])
    t1 = (xi(t[5]), t[6], t[7])
    t3 = sparse01_fin(t[8:13])
    return (add6(t0, mul_by_v(t1)), sub6(t3, add6(t0, t1)))


def b4_schedule():
    """`pallas_tower.dbl_fold` (tower.cuh `dbl_step`, `fq12_sqr`,
    `fq12_mul_by_014`): T ← 2T, f ← f²·l_tangent(P). Inputs f (12), T
    (6), P (2); outputs f (12), then T (6)."""
    s = Schedule("B4", 20)
    x = s.inputs()
    f = fq12_from(x[:12])
    X, Y, Z = (x[12], x[13]), (x[14], x[15]), (x[16], x[17])
    xp, yp = x[18], x[19]

    # Layer 1: the doubling's 5 Fq2 products and f²'s 12.
    r = s.products(dbl_layer1_reqs(X, Y, Z) + fq12_sqr_reqs(f))
    f2 = fq12_sqr_linear(s, r[5:17])
    # Layers 2 and 3: the doubling and its line.
    To, line = dbl_rest(s, X, Y, Z, xp, yp, r[:5])
    # Layer 4: `fq12_mul_by_014(f², c0, c1, c4)`.
    fo = fold_014_fin(s.products(fold_014_reqs(f2, *line)))
    s.output(s.linear(fq12_flat(fo)) + [c for v in To for c in v])
    return s


def b6_schedule():
    """`pallas_tower.fq12_cyclo_sqr` (tower.cuh `fq12_cyclo_sqr`,
    Granger-Scott). With f = ((z0, z4, z3), (z2, z1, z5)), each Fq4 piece
    (x, y) of (z0, z1), (z2, z3), (z4, z5) squares to t0 = x² + ξy²,
    t1 = (x + y)² − x² − y²; the outputs are 3t − 2z for (t0a, z0),
    (t0b, z4), (t0c, z3) and 3t + 2z for (t1a, z1), (t1b, z5),
    (ξ·t1c, z2). Input f (12), output f (12)."""
    s = Schedule("B6", 12)
    s.output(s.linear(fq12_flat(cyclo_sqr_out(s, fq12_from(s.inputs())))))
    return s


def fq12_mul_reqs(a, b):
    """`pallas_tower.fq12_mul`'s 18 Fq2 products: `_fq6_mul_parts` of
    (a0, b0), (a1, b1) and (a0 + a1, b0 + b1)."""
    return (fq6_mul_reqs(a[0], b[0]) + fq6_mul_reqs(a[1], b[1])
            + fq6_mul_reqs(add6(a[0], a[1]), add6(b[0], b[1])))


def fq12_mul_fin(t):
    """`fq12_mul` after its products: c0 = t0 + v·t1, c1 = t3 − t0 − t1."""
    t0 = fq6_mul_fin(t[0:6])
    t1 = fq6_mul_fin(t[6:12])
    t3 = fq6_mul_fin(t[12:18])
    return (add6(t0, mul_by_v(t1)), sub6(t3, add6(t0, t1)))


def cyclo_sqr_out(s, f):
    """B6's Granger-Scott square of f as forms over one product phase of
    18 Fq products (the 9 Fq2 squares) and f."""
    (z0, z4, z3), (z2, z1, z5) = f
    pieces = ((z0, z1), (z2, z3), (z4, z5))
    reqs = []
    for x, y in pieces:
        reqs += [sqr2(x), sqr2(y), sqr2(add2(x, y))]
    sq = s.products(reqs)
    t0, t1 = [], []
    for k in range(3):
        xx, yy, ss = sq[3 * k:3 * k + 3]
        t0.append(add2(xi(yy), xx))
        t1.append(sub2(sub2(ss, xx), yy))

    def minus(t, z):   # 3t − 2z
        return sub2(small2(3, t), small2(2, z))

    def plus(t, z):    # 3t + 2z
        return add2(small2(3, t), small2(2, z))

    return ((minus(t0[0], z0), minus(t0[1], z4), minus(t0[2], z3)),
            (plus(xi(t1[2]), z2), plus(t1[0], z1), plus(t1[1], z5)))


def b7_schedule():
    """`pallas_tower._k_cyclo_sqr_mul`: f²·g, the square B6's, then
    `fq12_mul` (tower.cuh `fq12_mul`): one linear phase makes the square's
    12 components, a product phase of 54 Fq products takes the Karatsuba
    sums of the square and g as operand forms, and a last linear phase
    makes `_fq6_mul_fin` and c0, c1. Inputs f (12), g (12); output f (12)."""
    s = Schedule("B7", 24)
    x = s.inputs()
    sq = fq12_from(s.linear(fq12_flat(cyclo_sqr_out(s, fq12_from(x[:12])))))
    t = s.products(fq12_mul_reqs(sq, fq12_from(x[12:])))
    s.output(s.linear(fq12_flat(fq12_mul_fin(t))))
    return s


def b8_schedule():
    """`pallas_tower._k_fq12_mul` (tower.cuh `fq12_mul`): a·b, B7's second
    half. One product phase of 54 Fq products takes the Karatsuba sums of
    a and b as operand forms, one linear phase makes `_fq6_mul_fin` and
    c0, c1. Inputs a (12), b (12); output a·b (12)."""
    s = Schedule("B8", 24)
    x = s.inputs()
    t = s.products(fq12_mul_reqs(fq12_from(x[:12]), fq12_from(x[12:])))
    s.output(s.linear(fq12_flat(fq12_mul_fin(t))))
    return s


def add_layers12(s, X, Y, Z, x2, y2, xp, yp):
    """`add_step`'s layers 1 and 2: u = y2·Z − Y, v = x2·Z − X, then v²,
    u², and the line (c0 = u·x2 − v·y2, c1 = −u·xp, c4 = v·yp)."""
    # Layer 1: y2·Z, x2·Z; u = y2·Z − Y, v = x2·Z − X.
    yZ, xZ = s.products([mul2(y2, Z), mul2(x2, Z)])
    u, v = s.linear2([sub2(yZ, Y), sub2(xZ, X)])

    # Layer 2: v², u², u·x2, v·y2 and the line's c1 = −u·xp, c4 = v·yp;
    # c0 = u·x2 − v·y2.
    vv, uu, ux2, vy2, c1, c4 = s.products(
        [sqr2(v), sqr2(u), mul2(u, x2), mul2(v, y2),
         scale2(small2(-1, u), xp), scale2(v, yp)])
    (c0,) = s.linear2([sub2(ux2, vy2)])
    return u, v, vv, uu, (c0, c1, c4)


def add_layer3_reqs(v, vv, uu, X, Z):
    """`add_step`'s third layer: v³, Rr = v²·X, u²·Z (9 Fq)."""
    return [mul2(v, vv), mul2(vv, X), mul2(uu, Z)]


def add_A(t):
    """A = u²Z − v³ − 2Rr and Rr − A, flat, from the third layer's fins."""
    vvv, Rr, uuZ = t
    A = sub2(sub2(uuZ, vvv), small2(2, Rr))
    return list(A) + list(sub2(Rr, A))


def add_layer4(s, u, v, vvv, A, RA, Y, Z):
    """`add_step`'s last layer: X' = v·A, Y' = u(Rr − A) − v³·Y,
    Z' = v³·Z; T' as flat nodes."""
    Xo, uRA, vvvY, Zo = s.products([mul2(v, A), mul2(u, RA), mul2(vvv, Y),
                                    mul2(vvv, Z)])
    return s.linear(list(Xo) + list(sub2(uRA, vvvY)) + list(Zo))


def b5_schedule():
    """`pallas_tower.add_fold` (tower.cuh `add_step`, `fq12_mul_by_014`):
    T ← T + Q, f ← f·l_chord(P). Inputs f (12), T (6), Q (4), P (2);
    outputs f (12), then T (6)."""
    s = Schedule("B5", 24)
    x = s.inputs()
    f = fq12_from(x[:12])
    X, Y, Z = (x[12], x[13]), (x[14], x[15]), (x[16], x[17])
    x2, y2 = (x[18], x[19]), (x[20], x[21])
    xp, yp = x[22], x[23]
    u, v, vv, uu, line = add_layers12(s, X, Y, Z, x2, y2, xp, yp)

    # Layer 3: v³, Rr = v²·X, u²·Z, and the 39 products of
    # `fq12_mul_by_014(f, c0, c1, c4)`, which need only f and the line.
    t = s.products(add_layer3_reqs(v, vv, uu, X, Z)
                   + fold_014_reqs(f, *line))
    # f's fin, and A and Rr − A, in one linear phase.
    m = s.linear(fq12_flat(fold_014_fin(t[3:])) + add_A(t[:3]))
    fo, A, RA = m[:12], (m[12], m[13]), (m[14], m[15])

    # Layer 4: X', Y', Z'.
    s.output(fo + add_layer4(s, u, v, t[0], A, RA, Y, Z))
    return s


def b17_dbl_step_schedule():
    """B17 `dbl_step` (`pallas_tower._k_dbl_step`): B4 cut at the line,
    its layers 1-3 without f² (12, 19 and 16 Fq products): T ← 2T and the
    tangent line at P. Inputs T (6), P (2); outputs T (6), then the line
    c0, c1, c4 (6)."""
    s = Schedule("B17 dbl_step", 8)
    x = s.inputs()
    X, Y, Z = (x[0], x[1]), (x[2], x[3]), (x[4], x[5])
    xp, yp = x[6], x[7]
    To, line = dbl_rest(s, X, Y, Z, xp, yp,
                        s.products(dbl_layer1_reqs(X, Y, Z)))
    s.output([c for v in To + list(line) for c in v])
    return s


def b17_f_sqr_fold_schedule():
    """B17 `f_sqr_fold` (`pallas_tower._k_f_sqr_fold`): B4's other half,
    f² (B9's 36 Fq products and B4's two linear phases), then B4's layer 4
    (39) with the line an input: f ← f²·line. Inputs f (12), the line c0,
    c1, c4 (6); output f (12)."""
    s = Schedule("B17 f_sqr_fold", 18)
    x = s.inputs()
    f2 = fq12_sqr_linear(s, s.products(fq12_sqr_reqs(fq12_from(x[:12]))))
    line = ((x[12], x[13]), (x[14], x[15]), (x[16], x[17]))
    fo = fold_014_fin(s.products(fold_014_reqs(f2, *line)))
    s.output(s.linear(fq12_flat(fo)))
    return s


def b17_add_step_schedule():
    """B17 `add_step` (`pallas_tower._k_add_step`): B5 cut at the line, its
    layers 1 and 2, the 9 products of layer 3 that are not the line
    product's, and layer 4 (6, 14, 9, 12 Fq products): T ← T + Q and the
    chord line at P. Inputs T (6), Q (4), P (2); outputs T (6), then the
    line c0, c1, c4 (6)."""
    s = Schedule("B17 add_step", 12)
    x = s.inputs()
    X, Y, Z = (x[0], x[1]), (x[2], x[3]), (x[4], x[5])
    x2, y2 = (x[6], x[7]), (x[8], x[9])
    xp, yp = x[10], x[11]
    u, v, vv, uu, line = add_layers12(s, X, Y, Z, x2, y2, xp, yp)
    t = s.products(add_layer3_reqs(v, vv, uu, X, Z))
    m = s.linear(add_A(t))
    To = add_layer4(s, u, v, t[0], (m[0], m[1]), (m[2], m[3]), Y, Z)
    s.output(To + [c for v in line for c in v])
    return s


def b17_f_fold_schedule():
    """B17 `f_fold` (`pallas_tower._k_f_fold`): B5's line product, its 39
    Fq products and their fin: f ← f·line. Inputs f (12), the line c0, c1,
    c4 (6); output f (12)."""
    s = Schedule("B17 f_fold", 18)
    x = s.inputs()
    line = ((x[12], x[13]), (x[14], x[15]), (x[16], x[17]))
    fo = fold_014_fin(s.products(fold_014_reqs(fq12_from(x[:12]), *line)))
    s.output(s.linear(fq12_flat(fo)))
    return s


def b9_schedule():
    """`pallas_tower._k_fq12_sqr` (`pallas_tower.fq12_sqr`, the complex
    square; B4's first layer without the doubling): with a = (a0, a1),
    s = a0 + a1 and sv = a0 + v·a1, one product phase of 36 Fq products
    takes the Karatsuba sums of a0, a1, s and sv as operand forms
    (`_fq6_mul_parts(a0, a1) + _fq6_mul_parts(s, sv)`), one linear phase
    makes tt and ss (`_fq6_mul_fin`) into c0 = ss − tt − v·tt and
    c1 = 2·tt. Input a (12); output a² (12)."""
    s = Schedule("B9", 12)
    t = s.products(fq12_sqr_reqs(fq12_from(s.inputs())))
    tt, ss = fq6_mul_fin(t[0:6]), fq6_mul_fin(t[6:12])
    s.output(s.linear(fq12_flat((sub6(sub6(ss, tt), mul_by_v(tt)),
                                 add6(tt, tt)))))
    return s


# ---------------------------------------------------------------------------
# B18: the final exponentiation's Frobenius products and easy part
# ---------------------------------------------------------------------------

def frob_consts(k):
    """The Fq2 constants of σ_k on Fq12 (`tower.fq12_frob`), in the order
    of the components they multiply: c0's v and v² parts, then c1's 1, v
    and v² parts."""
    c12 = htw.FROB12_C1[k]
    return [htw.FROB6_C1[k], htw.FROB6_C2[k], c12,
            htw.fq2_mul(htw.FROB6_C1[k], c12), htw.fq2_mul(htw.FROB6_C2[k], c12)]


# Every constant a product of B18 takes, in a fixed order: the Fq operand
# of each Frobenius constant at p and p² (`mul2_const`).
CONSTS = list(dict.fromkeys(c[0] or c[1] for k in (1, 2)
                            for c in frob_consts(k)))


def frob(s, b, k):
    """σ_k(b) (`tower.fq12_frob`): the components conjugated for odd k, five
    of them multiplied by constants in one product phase of 10 Fq products
    (`mul2_const`), each fin one product's node, so the next phase's
    operand forms are as short as B8's."""
    flat = [x for fq6 in b for x in fq6]
    if k % 2:
        flat = [(x[0], -x[1]) for x in flat]
    t = s.products([mul2_const(x, c)
                    for x, c in zip(flat[1:], frob_consts(k))])
    return fq12_from([c for x in [flat[0]] + t for c in x])


def frob_mul_schedule(k):
    """B18 ``frob_mul`` at p^k: a·σ_k(b), one phase of constant products,
    then B8's 54 with σ_k(b) as the second operand. Inputs a (12), b (12);
    output a·σ_k(b) (12)."""
    s = Schedule(f"B18 frob_mul k = {k}", 24)
    x = s.inputs()
    t = s.products(fq12_mul_reqs(fq12_from(x[:12]),
                                 frob(s, fq12_from(x[12:]), k)))
    s.output(s.linear(fq12_flat(fq12_mul_fin(t))))
    return s


def easy_down_schedule():
    """B18 ``easy_down``: f = (a0, a1) down the tower to the norm n of
    `tower.fq12_inv`'s Fq2 inverse. Phase 1: a0², a1², (a0 + a1)² (36 Fq
    products); t = a0² − v·a1² (the norm to Fq6), s = a0² + v·a1² and
    m = a0² + a1² − (a0 + a1)² = −2·a0·a1 (conj(f)² = s + m·w). Phase 2:
    `fq6_inv`'s six Fq2 products of t (15); c0 = t0² − ξ·t1t2,
    c1 = ξ·t2² − t0t1, c2 = t1² − t0t2. Phase 3: t2·c1, t1·c2, t0·c0 (9);
    tt = ξ(t2c1 + t1c2) + t0c0. Phase 4: tt0², tt1² (2); n = tt0² + tt1².
    Input f (12); outputs n, then s (6), m (6), c0-c2 (6), tt (2)."""
    s = Schedule("B18 easy_down", 12)
    a0, a1 = fq12_from(s.inputs())
    sq = s.products(fq6_sqr_reqs(a0) + fq6_sqr_reqs(a1)
                    + fq6_sqr_reqs(add6(a0, a1)))
    A, B, C = (fq6_mul_fin(sq[6 * i:6 * i + 6]) for i in range(3))
    vB = mul_by_v(B)
    m = s.linear2(list(sub6(A, vB)) + list(add6(A, vB))
                  + list(sub6(add6(A, B), C)))
    t, sv, mv = m[:3], m[3:6], m[6:]
    sq0, sq2, sq1, m12, m01, m02 = s.products(
        [sqr2(t[0]), sqr2(t[2]), sqr2(t[1]), mul2(t[1], t[2]),
         mul2(t[0], t[1]), mul2(t[0], t[2])])
    c = s.linear2([sub2(sq0, xi(m12)), sub2(xi(sq2), m01), sub2(sq1, m02)])
    u = s.products([mul2(t[2], c[1]), mul2(t[1], c[2]), mul2(t[0], c[0])])
    (tt,) = s.linear2([add2(xi(add2(u[0], u[1])), u[2])])
    (norm,) = s.products([([(tt[0], tt[0]), (tt[1], tt[1])],
                           lambda t: t[0] + t[1])])
    n = s.linear([norm])
    s.output(n + [x for v in sv + mv + c + [tt] for x in v])
    return s


def easy_up_schedule():
    """B18 ``easy_up``: the easy part's ascent from ``easy_down``'s values
    and n⁻¹. Phase 1: tt⁻¹ = (tt0·n⁻¹, −tt1·n⁻¹) (2 Fq products). Phase 2:
    the Fq6 inverse tmp = (c0, c1, c2)·tt⁻¹ (9). Phase 3:
    x = conj(f)·f⁻¹ = conj(f)²·tmp = s·tmp + (m·tmp)·w (36), as
    `tower.fq12_inv` gives f⁻¹ = conj(f)·tmp. Phase 4: σ_2(x)'s constant
    products (10). Phase 5: x·σ_2(x) (54). Inputs s (6), m (6), c0-c2 (6),
    tt (2), n⁻¹ (1); output the easy part (12)."""
    s = Schedule("B18 easy_up", 21)
    x = s.inputs()
    fq2s = [(x[2 * i], x[2 * i + 1]) for i in range(10)]
    sv, mv, c, tt, ninv = fq2s[:3], fq2s[3:6], fq2s[6:9], fq2s[9], x[20]
    (tinv,) = s.products([([(tt[0], ninv), (tt[1], ninv)],
                           lambda t: (t[0], -t[1]))])
    tmp = s.linear2(s.products([mul2(ci, tinv) for ci in c]))
    r = s.products(fq6_mul_reqs(sv, tmp) + fq6_mul_reqs(mv, tmp))
    e = fq12_from(s.linear(fq12_flat((fq6_mul_fin(r[:6]),
                                      fq6_mul_fin(r[6:])))))
    t = s.products(fq12_mul_reqs(e, frob(s, e, 2)))
    s.output(s.linear(fq12_flat(fq12_mul_fin(t))))
    return s


SCHEDULES = {"kB4": b4_schedule, "kB6": b6_schedule, "kB7": b7_schedule,
             "kB8": b8_schedule, "kB5": b5_schedule, "kB9": b9_schedule,
             "kDblStep": b17_dbl_step_schedule,
             "kFSqrFold": b17_f_sqr_fold_schedule,
             "kAddStep": b17_add_step_schedule,
             "kFFold": b17_f_fold_schedule,
             "kFrobMul1": lambda: frob_mul_schedule(1),
             "kFrobMul2": lambda: frob_mul_schedule(2),
             "kEasyDown": easy_down_schedule, "kEasyUp": easy_up_schedule}


def _array(name, values, per_line):
    lines = []
    for i in range(0, len(values), per_line):
        lines.append("    " + ", ".join(str(v) for v in
                                         values[i:i + per_line]) + ",")
    return (f"__device__ const int32_t {name}[] = {{\n" + "\n".join(lines)
            + "\n};")


def block():
    """The C++ table block of the header."""
    out = [BEGIN]
    for prefix, make in SCHEDULES.items():
        s = make()
        terms, ops, phases, out_slots, n_slots = s.tables()
        counts = s.product_counts()
        out.append(
            f"// {s.name}: {len(phases)} phases, {sum(counts)} Fq products "
            f"in the product phases ({', '.join(map(str, counts))}), "
            f"{len(terms)} terms, {n_slots} slots.")
        out.append(f"constexpr int {prefix}Phases = {len(phases)};")
        out.append(f"constexpr int {prefix}Slots = {n_slots};")
        out.append(f"constexpr int {prefix}Inputs = {s.n_inputs};")
        out.append(f"constexpr int {prefix}Outputs = {len(out_slots)};")
        out.append(_array(f"{prefix}PhaseOps",
                          [v for p in phases for v in p], 8))
        out.append(_array(f"{prefix}Ops", [v for o in ops for v in o], 8))
        out.append(_array(f"{prefix}Terms", terms, 8))
        out.append(_array(f"{prefix}OutSlots", out_slots, 12))
    words = [f"0x{(v << 384) % P >> (32 * j) & 0xFFFFFFFF:08x}u"
             for v in CONSTS for j in range(12)]
    out.append(f"// B18's constant operands: {len(CONSTS)} Fq values, Montgomery "
               f"form, 12 words each.")
    out.append(f"constexpr int kTowerConstCount = {len(CONSTS)};")
    out.append("__device__ const uint32_t kTowerConsts[] = {\n"
               + "\n".join("    " + ", ".join(words[i:i + 4]) + ","
                           for i in range(0, len(words), 4)) + "\n};")
    out.append(END)
    return "\n".join(out) + "\n"


def header_with(text, tables):
    i, j = text.index(BEGIN), text.index(END)
    return text[:i] + tables + text[j + len(END) + 1:]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    tables = block()
    if not (args.write or args.check):
        sys.stdout.write(tables)
        return 0
    text = open(HEADER).read()
    new = header_with(text, tables)
    if args.check:
        if new != text:
            print(f"{HEADER}: the schedule tables differ from the generator's",
                  file=sys.stderr)
            return 1
        return 0
    with open(HEADER, "w") as f:
        f.write(new)
    return 0


if __name__ == "__main__":
    sys.exit(main())
