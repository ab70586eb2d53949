"""Work of one strict call: the 2-pair check of every lane."""

from . import model

# Bytes of a lane's inputs (affine pk, H and sig: 24-limb int32
# coordinates and a bool each) and of its mask entry.
LANE_BYTES = 2 * 96 + 1 + 2 * (4 * 96 + 1) + 1


def work(config, traffic):
    n = int(traffic["batch"])
    w = model.Work()
    w.pairing_check(n)
    w.bytes = n * LANE_BYTES
    return w.summary()
