"""The benchmark's plain reference: BLS12-381 in Python ints, SHA3 from
``hashlib`` and ChaCha20 in NumPy.

Nothing here imports the program (``threshold_crypto_tpu_torch``) or the
JAX package. It reads the program's outputs only to judge them, and the
inputs the benchmark made as raw arrays.
"""
