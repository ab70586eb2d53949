"""The frozen yardstick: the card's peaks, the work of one launch of each
kernel per lane, and the launch shapes of the program's building blocks
as the port runs them today.

Work is counted in 32-bit integer results, as the card issues them: an Fq
Montgomery product (12 words) is 588 (2·12² multiply-adds of two results
and 12 low products), an Fr one (8 words) 264, a square in a Fermat
chain 456 / 208, a Keccak-f round 179 (3-input xors, funnel shifts, chi,
iota on 32-bit halves); the peak issues 64 a clock on each of the 132
SMs at the 1980 MHz maximum clock (CUDA C++ Programming Guide, compute
capability 9.0). Bytes: each input byte read once and each output byte
written once, at 3.35 TB/s (H100 SXM data sheet).

Per lane, in Fq products (G1 / G2; an Fq2 product is 3, a square 2): the
mixed add (B10) 11 / 30, the complete add 16 / 44, the doubling 7 / 16;
the Miller loop's doubling step with its line folded into f (B4) 122 and
its add step (B5) 80; the cyclotomic square (B6) 18, with a product (B7)
72, the Fq12 product (B8) 54 and square (B9) 36. A Fermat inversion
(B2) is its sliding-window chain: 378 squares and 82 products for p - 2,
253 and 59 for r - 2.
"""

from __future__ import annotations

SMS = 132
CLOCK_HZ = 1.98e9
RESULTS_PER_CLOCK_SM = 64
PEAK_RESULTS_PER_S = RESULTS_PER_CLOCK_SM * SMS * CLOCK_HZ
PEAK_BYTES_PER_S = 3.35e12

FQ_PRODUCT, FR_PRODUCT = 588, 264
FQ_SQUARE, FR_SQUARE = 456, 208
KECCAK_CHUNK = 17 * 24 * 179           # 16 rate blocks + padding, 24 rounds
FQ_INV_CHAIN = (378, 82)               # (squares, products), p - 2
FR_INV_CHAIN = (253, 59)               # r - 2

MADD = (11, 30)
ADD = (16, 44)
DBL = (7, 16)
TOWER = {"dbl_fold": 122, "add_fold": 80, "cyclo_sqr": 18,
         "cyclo_sqr_mul": 72, "fq12_mul": 54, "fq12_sqr": 36}
# The Miller loop over |X|'s 63 bits after the first, five of them 1; the
# final exponentiation's hard part: five x-powers of 58 B6 and 5 B7, then
# 7 B8 and one B9 (a check of k pairs adds k - 1 B8 to fold them).
MILLER = {"dbl_fold": 63, "add_fold": 5}
FINAL_EXP = {"cyclo_sqr": 290, "cyclo_sqr_mul": 25, "fq12_mul": 7,
             "fq12_sqr": 1}

# Products a lane of B1 (one Montgomery product) takes in the program's
# torch-level blocks, and the B1 launches they stack them into, G1 / G2:
# the complete add computes its doubling branch on every lane too (16 + 7
# products in G1), the affine lift one inversion (B2) and 4 / 15
# products, the comparison of two points 8 / 24.
COMPLETE_ADD_B1 = {False: (23, 5), True: (69, 5)}    # (products, launches)
TO_AFFINE_B1 = {False: (4, 4), True: (15, 6)}
EQ_B1 = {False: (8, 3), True: (24, 3)}
# Base-16 digits of a 255-bit ladder scalar, and the nonzero ones expected
# of a uniform scalar below r (the top digit is at most 7) and of one below
# 2^254 (the benchmark's random scalars).
LADDER_DIGITS = 64
NONZERO_MOD_R = 63 * 15 / 16 + 7 / 8
NONZERO_254 = 63 * 15 / 16 + 3 / 4
# The pairing check's tower glue on the card (easy part, Frobenius), per
# lane of the check, with its one B2.
CHECK_B1 = (265, 12)


class Work:
    """Launches and lanes per kernel key, and the integer results."""

    def __init__(self):
        self.launches, self.lanes = {}, {}
        self.results = 0.0
        self.bytes = 0

    def add(self, key, launches, lanes, results):
        self.launches[key] = self.launches.get(key, 0) + launches
        self.lanes[key] = self.lanes.get(key, 0) + lanes
        self.results += results

    def b1(self, lanes, launches, field="Fq"):
        self.add(f"mont_mul.{field}", launches, lanes,
                 lanes * (FQ_PRODUCT if field == "Fq" else FR_PRODUCT))

    def b2(self, lanes, field="Fq"):
        sq, pr = FQ_INV_CHAIN if field == "Fq" else FR_INV_CHAIN
        per = (sq * FQ_SQUARE + pr * FQ_PRODUCT if field == "Fq"
               else sq * FR_SQUARE + pr * FR_PRODUCT)
        self.add(f"mont_pow.{field}", 1, lanes, lanes * per)

    def tower(self, name, launches, lanes):
        self.add(name, launches, lanes * launches,
                 lanes * launches * TOWER[name] * FQ_PRODUCT)

    def to_affine(self, g2, lanes):
        per, launches = TO_AFFINE_B1[g2]
        self.b1(per * lanes, launches)
        self.b2(lanes)

    def eq(self, g2, lanes):
        per, launches = EQ_B1[g2]
        self.b1(per * lanes, launches)

    def madd(self, g2, launches, lanes):
        """``launches`` B10 launches of ``lanes`` lanes each."""
        key = "g2_madd" if g2 else "g1_madd"
        self.add(key, launches, launches * lanes,
                 launches * lanes * MADD[g2] * FQ_PRODUCT)

    def step4(self, g2, lanes, nonzero, chunk=None):
        """B13 over ``lanes`` lanes of 64 digits, ``nonzero`` of them
        nonzero in all (adds), one launch per ``chunk`` lanes."""
        launches = 1 if chunk is None else -(-lanes // chunk)
        key = "g2_step4" if g2 else "g1_step4"
        self.add(key, launches, lanes,
                 (lanes * LADDER_DIGITS * 4 * DBL[g2] + nonzero * ADD[g2])
                 * FQ_PRODUCT)

    def ladder(self, g2, points, lanes, nonzero, chunk=None):
        """The window-4 ladder over ``points`` affine points: their table
        (14 B10), then B13 over ``lanes`` lanes."""
        self.madd(g2, 14, points)
        self.step4(g2, lanes, nonzero, chunk)

    def fold(self, g2, n, extra_dims=1):
        """The pairwise tree of complete adds over n entries (odd levels
        padded), ``extra_dims`` lanes an entry."""
        per, launches = COMPLETE_ADD_B1[g2]
        while n > 1:
            n += n % 2
            n //= 2
            self.b1(per * n * extra_dims, launches)

    def pairing_check(self, lanes, pairs=2):
        for name, k in MILLER.items():
            self.tower(name, k, pairs * lanes)
        if pairs > 1:
            self.tower("fq12_mul", pairs - 1, lanes)
        for name, k in FINAL_EXP.items():
            self.tower(name, k, lanes)
        per, launches = CHECK_B1
        self.b1(per * lanes, launches)
        self.b2(lanes)

    def summary(self):
        t_ops = self.results / PEAK_RESULTS_PER_S
        t_bytes = self.bytes / PEAK_BYTES_PER_S
        return {"launches": dict(self.launches), "lanes": dict(self.lanes),
                "results": self.results, "bytes": self.bytes,
                "least_s": max(t_ops, t_bytes),
                "bound": "operations" if t_ops >= t_bytes else "bytes"}
