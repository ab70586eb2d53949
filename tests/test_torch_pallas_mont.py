"""The port's Montgomery product and power against the TPU kernels they
replace, ``pallas_mont._mul_kernel`` and ``pallas_mont._pow_kernel``, run in
Pallas interpret mode on the CPU.

Same inputs, made from numpy seeds, go through ``pallas_mont.mul`` and
``pallas_mont.pow_fixed`` and through ``threshold_crypto_tpu_torch``'s
``device.mont`` on the CPU, where the CUDA kernels' plain PyTorch versions
run. Every comparison is exact: canonical limbs are unique.
"""

import functools
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import threshold_crypto_tpu.device.mont as jmont
from threshold_crypto_tpu_torch.device import mont

SPECS = [(mont.FQ, jmont.FQ), (mont.FR, jmont.FR)]
IDS = ["Fq", "Fr"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _elems(spec, n, seed):
    """0, 1, p − 1, p − 2, 2, (p − 1)/2, then n random field elements, as
    uint32 Montgomery limbs."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, spec.p - 1, spec.p - 2, 2, (spec.p - 1) // 2] + [
        int.from_bytes(rng.bytes(64), "little") % spec.p for _ in range(n)
    ]
    return np.stack([jmont.to_mont(spec, v) for v in vals])


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _np(t):
    return t.numpy().astype(np.uint32)


# The Pallas kernels in interpret mode, in a child process: XLA:CPU's fusion
# pass merges the kernels' unrolled limb arithmetic (inside the power's bit
# loop too) into fusions that take from many minutes to hours to compile.
# The child disables that pass, an optimisation that changes no integer
# result, and the kernels compile and run in seconds.
_PALLAS_CHILD = """
import io, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import threshold_crypto_tpu.device.mont as jmont
import threshold_crypto_tpu.device.pallas_mont as pallas_mont
pallas_mont.INTERPRET = True
inp = np.load(io.BytesIO(sys.stdin.buffer.read()))
spec = getattr(jmont, str(inp["spec"]))
out = {"mul": pallas_mont.mul(spec, inp["a"], inp["b"]),
       "inv": pallas_mont.pow_fixed(spec, inp["a"], spec.p - 2)}
buf = io.BytesIO()
np.savez(buf, **{k: np.asarray(v) for k, v in out.items()})
sys.stdout.buffer.write(buf.getvalue())
"""


@functools.lru_cache(maxsize=None)
def _pallas_interpret(jspec):
    """Inputs a, b (edge lanes first, lane 0 is zero) and what
    ``pallas_mont.mul(a, b)`` and ``pallas_mont.pow_fixed(a, p − 2)`` give
    in interpret mode."""
    a = _elems(jspec, 10, 10)
    b = _elems(jspec, 10, 11)
    b = b[::-1].copy()
    buf = io.BytesIO()
    np.savez(buf, spec=jspec.name.upper(), a=a, b=b)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=fusion")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PALLAS_CHILD],
                          input=buf.getvalue(), capture_output=True, env=env,
                          cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    out = np.load(io.BytesIO(proc.stdout))
    return a, b, out["mul"], out["inv"]


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_mul_matches_pallas_kernel_interpret(spec, jspec):
    a, b, want, _ = _pallas_interpret(jspec)
    got = _np(mont.mul(spec, _t(a), _t(b)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_pow_matches_pallas_kernel_interpret(spec, jspec):
    """The path's exponent, p − 2 (``mont.inv``); lane 0 is zero and stays
    zero."""
    a, _, _, want = _pallas_interpret(jspec)
    got = _np(mont.pow_fixed(spec, _t(a), spec.p - 2))
    assert np.array_equal(got, want)
    assert np.array_equal(_np(mont.inv(spec, _t(a))), want)
    assert not got[0].any()
