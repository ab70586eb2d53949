"""The port's megakernel path, ``ops.verify_batch_pallas`` →
``device.pairing.pairing_check_pallas``, against the JAX package.

On the CPU the tower kernels' plain versions run. Every lane kind of
``tests/test_torch_verify.py`` (valid, corrupted signature, wrong message,
infinite pk, infinite sig) and both infinite: the host oracle
(``threshold_crypto_tpu.host.pairing``) decides each lane, and the port's
``verify_batch`` must agree lane for lane. The slow test runs the JAX
package's own ``ops.verify_batch_pallas`` in its DIRECT mode.
"""

import io
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from threshold_crypto_tpu.device import pairing as jpr
from threshold_crypto_tpu.device import pallas_tower as ptw
from threshold_crypto_tpu.host import curve as hcv
from threshold_crypto_tpu.host import pairing as hpr
from threshold_crypto_tpu.host.params import R, X_BITS
from threshold_crypto_tpu_torch import convert, ops
from threshold_crypto_tpu_torch.device import cuda_mont
from threshold_crypto_tpu_torch.device import cuda_tower as ctw
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.device import packed as pk
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.device import tower as tw
from threshold_crypto_tpu_torch.device.mont import FQ


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lanes():
    """(pk, H, sig, kind) host points per lane."""
    rnd = random.Random(0xFA58)
    sks = [rnd.randrange(1, R) for _ in range(3)]
    hs = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R)) for _ in range(2)]
    pk = [hcv.G1.mul(hcv.G1.generator, s) for s in sks]
    sig = [hcv.G2.mul(hs[0], s) for s in sks]
    return [
        (pk[0], hs[0], sig[0], "valid"),
        (pk[1], hs[0], sig[1], "valid"),
        (pk[2], hs[0], hcv.G2.mul(hs[0], 999), "corrupted sig"),
        (pk[2], hs[1], sig[2], "wrong message"),
        (None, hs[0], sig[0], "inf pk"),
        (pk[1], hs[0], None, "inf sig"),
        (None, hs[1], None, "both inf"),
    ]


def _args(lanes):
    pk, h, sig, _ = zip(*lanes)
    return (dpr.g1_affine_from_host(pk, device="cpu"),
            dpr.g2_affine_from_host(h, device="cpu"),
            dpr.g2_affine_from_host(sig, device="cpu"))


@pytest.fixture(scope="module")
def pallas_run(lanes):
    """One verify_batch_pallas call, with the calls of each kernel's plain
    version counted (on the card each is one launch)."""
    calls = {k.name: 0 for mod in (cuda_mont, ctw) for k in mod.KERNELS}
    saved = []

    def counted(mod, k):
        def run(*args):
            calls[k.name] += 1
            return k.plain(*args)
        return run

    for mod in (cuda_mont, ctw):
        for k in mod.KERNELS:
            saved.append((mod, k.plain.__name__, k.plain))
            setattr(mod, k.plain.__name__, counted(mod, k))
    try:
        got = ops.verify_batch_pallas(*_args(lanes))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return got, calls


def test_verify_batch_pallas_matches_host_oracle(lanes, pallas_run):
    got, _ = pallas_run
    neg_g1 = hcv.G1.neg(hcv.G1.generator)
    want = [hpr.pairing_check([(pk, h), (neg_g1, sig)])
            for pk, h, sig, _ in lanes]
    assert got.dtype == torch.bool and got.shape == (len(lanes),)
    assert got.tolist() == want
    assert want == [k in ("valid", "both inf") for *_, k in lanes]


def test_verify_batch_pallas_equals_verify_batch(lanes, pallas_run):
    got, _ = pallas_run
    assert torch.equal(got, ops.verify_batch(*_args(lanes)))


def test_launches_per_call(pallas_run):
    """The driver's launches: B4 on each bit of |X| after the first, B5 on
    its 1-bits, B6/B7 on the zero/one bits of five exp-by-x, B8 once for
    the pair fold and 5 times in the final exponentiation, B18's
    ``frob_mul`` for its two Frobenius products, B9 once, and one B2 (the
    easy part's inversion; on the CPU the easy part runs through the tower,
    so ``easy_down`` and ``easy_up``, one launch each on the card, have no
    call here)."""
    _, calls = pallas_run
    bits = X_BITS[1:]
    ones = sum(bits)
    assert (len(bits), ones) == (63, 5)
    assert calls["dbl_fold"] == len(bits)
    assert calls["add_fold"] == ones
    assert calls["cyclo_sqr"] == 5 * (len(bits) - ones) == 290
    assert calls["cyclo_sqr_mul"] == 5 * ones == 25
    assert calls["fq12_mul"] == 6
    assert calls["frob_mul"] == 2
    assert calls["fq12_sqr"] == 1
    assert calls["mont_pow"] == 1
    assert calls["easy_down"] == calls["easy_up"] == 0
    assert calls["fq_engine"] == 0


def test_pairing_pallas_equals_host_pairing():
    rnd = random.Random(8)
    p = [hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R)), None]
    q = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R))] * 2
    got = dpr.pairing_pallas(dpr.g1_affine_from_host(p, device="cpu"),
                             dpr.g2_affine_from_host(q, device="cpu"))
    assert got[0][0][0].shape == (2, 24)
    assert tw.fq12_to_host(got) == [hpr.pairing(p[0], q[0]),
                                    hpr.pairing(None, q[1])]


@pytest.mark.parametrize("easy", ["tower", "kernel pieces"])
def test_packed_final_exponentiation_equals_tower(monkeypatch, easy):
    """``pairing_pallas`` (the packed Miller loop and
    ``final_exponentiation_packed``) equals ``pairing`` limb for limb, and
    ``final_exponentiation_packed`` equals ``final_exponentiation`` on the
    same Miller values, on lanes with P at infinity, Q at infinity, both
    (their Miller value is exactly one) and random pairs. "kernel pieces"
    runs the easy part as the card does, B18's plain pieces
    ``easy_down_ref``, the inversion and ``easy_up_ref``."""
    if easy == "kernel pieces":
        def pieces(f):
            norm, inter = ctw.easy_down_ref(f)
            return ctw.easy_up_ref(inter, mont.inv(FQ, norm))
        monkeypatch.setattr(ctw, "easy_part_ref", pieces)
    rnd = random.Random(0xF1)
    gp = [hcv.G1.mul(hcv.G1.generator, rnd.randrange(1, R)) for _ in range(2)]
    gq = [hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, R)) for _ in range(2)]
    p = [None, gp[0], None, gp[1]]
    q = [gq[0], None, None, gq[1]]
    p_aff = dpr.g1_affine_from_host(p, device="cpu")
    q_aff = dpr.g2_affine_from_host(q, device="cpu")
    got = dpr.pairing_pallas(p_aff, q_aff)
    want = dpr.pairing(p_aff, q_aff)
    assert all(torch.equal(g, w)
               for g, w in zip(tw.fq12_flat(got), tw.fq12_flat(want)))
    f = dpr.miller_loop(p_aff, q_aff)
    assert tw.fq12_to_host(f)[:3] == [hpr.miller_loop(None, None)] * 3
    packed = dpr.final_exponentiation_packed(pk.pack12(f))
    assert torch.equal(packed, pk.pack12(dpr.final_exponentiation(f)))
    assert tw.fq12_to_host(got) == [hpr.pairing(a, b) for a, b in zip(p, q)]


def test_fq12_convert_round_trip():
    """JAX Fq12 pytrees (nested, or the 12 arrays flat in flat12 order) ->
    the port's tuple -> numpy, bit-exact."""
    rng = np.random.default_rng(12)
    comps = [rng.integers(0, 1 << 16, size=(3, 24), dtype=np.uint32)
             for _ in range(12)]
    it = iter(comps)
    nested = tuple(tuple((next(it), next(it)) for _ in range(3))
                   for _ in range(2))
    for tree in (nested, comps):
        f = convert.fq12_from_jax(tree, device="cpu")
        assert [c.dtype for c in tw.fq12_flat(f)] == [torch.int32] * 12
        back = convert.fq12_to_jax(f)
        flat = [back[i][j][k] for i in range(2) for j in range(3)
                for k in range(2)]
        assert all(g.dtype == np.uint32 and np.array_equal(g, w)
                   for g, w in zip(flat, comps))
    assert all(x is y for x, y in zip(ptw.flat12(nested), comps))
    with pytest.raises(ValueError, match="12 components"):
        convert.fq12_from_jax(comps[:11], device="cpu")


# The JAX package's megakernel pipeline in DIRECT mode, in a child process:
# it jits each megakernel body on XLA:CPU, and with XLA's fusion pass on
# that compile took over 40 GiB of host memory here. The child disables
# that pass, an optimisation that changes no integer result.
_JAX_CHILD = """
import io, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from threshold_crypto_tpu import ops
from threshold_crypto_tpu.device import pallas_tower as ptw
inp = np.load(io.BytesIO(sys.stdin.buffer.read()))
g1 = (jnp.asarray(inp["px"]), jnp.asarray(inp["py"]), jnp.asarray(inp["pinf"]))
def g2(k):
    return ((jnp.asarray(inp[k + "x0"]), jnp.asarray(inp[k + "x1"])),
            (jnp.asarray(inp[k + "y0"]), jnp.asarray(inp[k + "y1"])),
            jnp.asarray(inp[k + "inf"]))
ptw.DIRECT = True
ok = ops.verify_batch_pallas(g1, g2("h"), g2("s"))
sys.stdout.write(" ".join(str(int(b)) for b in np.asarray(ok)))
"""


@pytest.mark.slow
def test_verify_batch_pallas_matches_jax_ops(lanes):
    pk, h, sig, _ = zip(*lanes)
    x, y, inf = map(np.asarray, jpr.g1_affine_from_host(pk))
    arrays = {"px": x, "py": y, "pinf": inf}
    for key, pts in (("h", h), ("s", sig)):
        (x0, x1), (y0, y1), inf = jpr.g2_affine_from_host(pts)
        arrays.update({key + "x0": x0, key + "x1": x1, key + "y0": y0,
                       key + "y1": y1, key + "inf": inf})
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=fusion")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _JAX_CHILD],
                          input=buf.getvalue(), capture_output=True, env=env,
                          cwd=root, timeout=3600)
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    want = [bool(int(b)) for b in proc.stdout.decode().split()]

    def g2(key):
        return convert.g2_from_jax(
            (arrays[key + "x0"], arrays[key + "x1"]),
            (arrays[key + "y0"], arrays[key + "y1"]), arrays[key + "inf"],
            device="cpu")

    got = ops.verify_batch_pallas(
        convert.g1_from_jax(arrays["px"], arrays["py"], arrays["pinf"],
                            device="cpu"), g2("h"), g2("s"))
    assert want == [k in ("valid", "both inf") for *_, k in lanes]
    assert got.tolist() == want
