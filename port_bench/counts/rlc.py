"""Work of one RLC call: the transcript (B12 over the inputs' whole
2176-byte chunks, then over their digests), the exponents, both
shared-window MSMs (the table, B11, the fold of the accumulators), the
affine lifts of both sums and H, and the aggregate check on
``check_batch`` replicated lanes. B11's adds follow the exponents' nonzero
base-8 digits: 21 digits of uniform bits and a top one of one bit."""

from . import model

ACCUMULATORS = 16384
CHUNK = 2176
# A lane's affine pk (two 24-limb int32 coordinates) and sig (four), and
# their bool flags.
LANE_BYTES = 2 * 96 + 1 + 4 * 96 + 1


def work(config, traffic):
    n = int(config["signers"])
    w_bits, nbits = int(config["msm_window"]), int(config["rlc_scalar_bits"])
    check = int(config["check_batch"])
    w = model.Work()
    # six 32-bit word leaves of n·96 bytes each; level 2 from 64 chunks
    k = 6 * (n * 96 // CHUNK)
    if k:
        w.add("sha3_chunks", 1, k, k * model.KECCAK_CHUNK)
    if k >= 64:
        k2 = -(-k // (CHUNK // 32))
        w.add("sha3_chunks", 1, k2, k2 * model.KECCAK_CHUNK)
    digits = -(-nbits // w_bits)
    top_bits = nbits - (digits - 1) * w_bits
    nonzero = ((digits - 1) * (1 - 2.0 ** -w_bits)
               + (1 - 2.0 ** -top_bits))
    accs = min(ACCUMULATORS, n)
    for g2 in (False, True):
        w.madd(g2, (1 << w_bits) - 2, n)
        key = "g2_winacc" if g2 else "g1_winacc"
        w.add(key, 1, n, (n * nonzero * model.ADD[g2]
                          + accs * digits * w_bits * model.DBL[g2])
              * model.FQ_PRODUCT)
        w.fold(g2, accs)
    w.to_affine(False, 1)
    w.to_affine(True, 1)
    w.to_affine(True, 1)
    w.pairing_check(check)
    w.bytes = n * LANE_BYTES + 1
    return w.summary()
