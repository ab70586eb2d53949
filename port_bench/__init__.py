"""The benchmark of the PyTorch/CUDA port (``threshold_crypto_tpu_torch``).

``run.py`` runs one cell of the repository's ``BENCHMARK.json``. Each
configuration is a file of ``configs/``, each traffic mix a file of
``traffic/`` naming the operation kind of ``mixes/`` that runs it, each
per-layer metric a reader in ``metrics/`` and each operation kind's work a
module of ``counts/``; ``reference/`` is the plain reference that decides
``correct``.
"""
