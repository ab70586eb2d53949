"""Work of one dealing, dealt and checked, as ``mixes/dkg.py`` runs it.

The ladders' adds follow their scalars' nonzero base-16 digits: counted
exactly for the public scalars (the row commitments' x^j, the value
commitments' x^i·y^j + x^j·y^i at y = 1), as expected for the random ones
(coefficients below 2^254, rows and values uniform mod r); lanes of the
zero coefficient's point (infinity) add nothing.
"""

import functools

from . import model
from ..mixes.dkg import coeff_pos
from ..reference.params import R

LADDER_CHUNK = 1 << 19


def _nonzero(v: int) -> int:
    return 64 - format(v, "064x").count("0")


@functools.lru_cache(maxsize=8)
def public_digits(n, t, zero_pos):
    """Nonzero digits of the row commitments' and the value commitments'
    scalars over all their lanes."""
    rowc = evalc = 0
    for x in range(1, n + 1):
        pw = [pow(x, j, R) for j in range(t + 1)]
        nz = [_nonzero(p) for p in pw]
        for i in range(t + 1):
            rowc += sum(nz[j] for j in range(t + 1)
                        if coeff_pos(i, j) != zero_pos)
        for j in range(t + 1):
            for i in range(j + 1):
                if coeff_pos(i, j) == zero_pos:
                    continue
                evalc += _nonzero(pw[i] if i == j else (pw[i] + pw[j]) % R)
    return rowc, evalc


def work(config, traffic):
    n, t = int(config["nodes"]), int(config["threshold"])
    d1 = t + 1
    npos = d1 * (t + 2) // 2
    zero = int(traffic["zero_pos"])
    rowc_nz, eval_nz = public_digits(n, t, zero)
    w = model.Work()
    # the dealer: commitment, rows (powers, the grid product, the
    # Montgomery form of the coefficients)
    w.to_affine(False, npos)
    w.ladder(False, npos, npos, (npos - 1) * model.NONZERO_254)
    w.b1(npos, 1, "Fr")
    w.b1(t * n, t, "Fr")
    w.b1(n * d1 * d1, 1, "Fr")
    # row commitments: powers, canonical form, the commitment lifted, the
    # gathered ladders, the fold over j
    w.b1(t * n, t, "Fr")
    w.b1(n * d1, 1, "Fr")
    w.to_affine(False, npos)
    w.ladder(False, npos, n * d1 * d1, rowc_nz, LADDER_CHUNK)
    w.fold(False, d1, n * d1)
    # value commitments of the pairs (m, 1)
    w.b1(2 * t * n, 2 * t, "Fr")
    w.b1(2 * n * npos, 1, "Fr")
    w.b1(n * npos, 1, "Fr")
    w.to_affine(False, npos)
    w.ladder(False, npos, n * npos, eval_nz, LADDER_CHUNK)
    w.fold(False, npos, n)
    # the nodes' row check: commitments of their rows, compared
    w.b1(n * d1, 1, "Fr")
    w.to_affine(False, n * d1)
    w.ladder(False, n * d1, n * d1, n * d1 * model.NONZERO_MOD_R)
    w.eq(False, n * d1)
    # node 1's value check: powers of y, row sums, canonical form,
    # commitments, compared
    w.b1(t * n, t, "Fr")
    w.b1(n * d1, 1, "Fr")
    w.b1(n, 1, "Fr")
    w.to_affine(False, n)
    w.ladder(False, n, n, n * model.NONZERO_MOD_R)
    w.eq(False, n)
    # bytes: the coefficients in, the commitment, rows, row and value
    # commitments (Jacobian G1, 3 x 96 bytes) and both checks out
    w.bytes = (npos * 64 + npos * 288 + n * d1 * 64 + n * d1 * 288
               + n * 288 + n * d1 + n)
    return w.summary()
