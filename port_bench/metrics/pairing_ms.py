"""Milliseconds an operation spends in the megakernel pairing checks
(``pairing_check_pallas``), from CUDA-event spans."""

SPANS = [("threshold_crypto_tpu_torch.device.pairing:pairing_check_pallas",
          "pairing")]


def read(data):
    ms = data.spans.get("pairing")
    return sum(ms) / data.ops if ms else None
