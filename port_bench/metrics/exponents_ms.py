"""Milliseconds an operation spends drawing the RLC exponents
(``ops.rlc_exponents``: the transcript's SHA3 and ChaCha20), from
CUDA-event spans."""

SPANS = [("threshold_crypto_tpu_torch.ops.threshold:rlc_exponents",
          "exponents")]


def read(data):
    ms = data.spans.get("exponents")
    return sum(ms) / data.ops if ms else None
