"""Milliseconds an operation spends in the per-lane ladders
(``scalar_mul_gathered``, ``scalar_mul_pallas`` and ``commit_batch``,
nested calls counted once), from CUDA-event spans."""

SPANS = [
    ("threshold_crypto_tpu_torch.device.cuda_curve:scalar_mul_gathered",
     "ladders"),
    ("threshold_crypto_tpu_torch.device.cuda_curve:scalar_mul_pallas",
     "ladders"),
    ("threshold_crypto_tpu_torch.ops.threshold:commit_batch", "ladders"),
]


def read(data):
    ms = data.spans.get("ladders")
    return sum(ms) / data.ops if ms else None
