"""Milliseconds an operation spends in the torch fold of partial sums
(``DeviceCurve.fold_axis``, which ``fold_sum`` runs), from CUDA-event
spans."""

SPANS = [("threshold_crypto_tpu_torch.device.curve:G1.fold_axis", "fold"),
         ("threshold_crypto_tpu_torch.device.curve:G2.fold_axis", "fold")]


def read(data):
    ms = data.spans.get("fold")
    return sum(ms) / data.ops if ms else None
