"""Python-int BLS12-381 arithmetic (copies of the JAX package's host modules)."""
