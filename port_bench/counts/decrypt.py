"""Work of one decryption epoch: the ciphertext check over the N
ciphertexts, the node's decryption shares (the affine lift of u, the
ladder of its key share, the shares' affine lift), and the check of all
N × N decryption shares."""

from . import model

# Affine G1 (u, a share, pk) and G2 (H, w) lanes with their flags; a
# Jacobian G1 u; a Fr key share; a mask entry.
G1_AFF, G2_AFF, G1_JAC, FR = 2 * 96 + 1, 4 * 96 + 1, 3 * 96, 32


def work(config, traffic):
    n = int(config["nodes"])
    c = n
    w = model.Work()
    w.pairing_check(c)
    w.to_affine(False, c)
    w.ladder(False, c, c, c * model.NONZERO_MOD_R)
    w.to_affine(False, c)
    w.pairing_check(n * c)
    w.bytes = (c * (G1_AFF + 2 * G2_AFF + G1_JAC + FR)
               + n * G1_AFF + n * c * G1_AFF + c + n * c)
    return w.summary()
