"""The port's tower kernels B3-B9 (plain versions) against the JAX package's
in-kernel tower, and the port's packed layout against ``pallas_tower``'s.

The same seeded values, 128 lanes of random Fq12, T, Q and P with four zero
lanes (an affine (0, 0) P is an infinity lane), go through the in-kernel
functions of ``threshold_crypto_tpu/device/pallas_tower.py`` (plain jnp code
on its packed values, as ``tests/test_pallas_tower.py`` runs them) and
through ``threshold_crypto_tpu_torch.device.cuda_tower``'s dispatch on the
CPU, where each kernel's plain PyTorch version runs. The JAX side unpacks
through ``ptw.unpack`` to public 16-bit R = 2^384 limbs; every comparison is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threshold_crypto_tpu.device.mont as jmont
from threshold_crypto_tpu.device import pallas_tower as ptw
from threshold_crypto_tpu_torch import convert
from threshold_crypto_tpu_torch.device import cuda_mont
from threshold_crypto_tpu_torch.device import cuda_tower as ctw
from threshold_crypto_tpu_torch.device import mont
from threshold_crypto_tpu_torch.device import packed as pk
from threshold_crypto_tpu_torch.device import pairing as dpr

N = 128
ZERO_LANES = (0, 1, 2, 3)
P = jmont.FQ.p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _comps(rng, k):
    """k random Fq components, uint32[N, 24] Montgomery limbs, with the
    zero lanes zero and lane 4 = p − 1 (raw)."""
    out = []
    for _ in range(k):
        vals = [int.from_bytes(rng.bytes(64), "little") % P for _ in range(N)]
        for z in ZERO_LANES:
            vals[z] = 0
        vals[4] = (P - 1) * pow(jmont.FQ.r_mont, -1, P) % P
        out.append(mont.stack_mont(mont.FQ, vals).astype(np.uint32))
    return out


@pytest.fixture(scope="module")
def vals():
    rng = np.random.default_rng(0x70E3)
    return {name: _comps(rng, k)
            for name, k in (("f", 12), ("g", 12), ("T", 6), ("Q", 4),
                            ("P", 2))}


def _port(comps):
    return pk.pack([torch.from_numpy(c.astype(np.int32)) for c in comps])


def _port_out(packed, k):
    return [c.numpy().astype(np.uint32) for c in pk.unpack(packed, k)]


def _jax(comps):
    """Components -> the in-kernel values of ``pallas_tower`` (one
    [L, 8, 128] value per component)."""
    packed = ptw.pack([jnp.asarray(c) for c in comps], N)
    return [packed[i * ptw.L:(i + 1) * ptw.L] for i in range(len(comps))]


def _jax_out(values):
    return [np.asarray(c) for c in
            ptw.unpack(jnp.concatenate(values, axis=0), len(values), N)]


def _fq12(v):
    it = iter(v)
    return tuple(tuple((next(it), next(it)) for _ in range(3))
                 for _ in range(2))


def _fq2s(v):
    return tuple((v[2 * i], v[2 * i + 1]) for i in range(len(v) // 2))


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and np.array_equal(g, w), f"component {i}"


@pytest.fixture(scope="module")
def cyclotomic(vals):
    """Easy-part outputs f^((p⁶−1)(p²+1)) of the random f and g: elements
    of the cyclotomic subgroup (the zero lanes stay zero)."""
    def easy(comps):
        f = convert.fq12_from_jax(comps, device="cpu")
        return ptw.flat12(convert.fq12_to_jax(dpr._easy_part(f)))

    return {"f": easy(vals["f"]), "g": easy(vals["g"])}


# ---------------------------------------------------------------------------
# B3: the engine
# ---------------------------------------------------------------------------

ENGINE_OPS = ["mul", "add", "sub", "neg", "small3", "small8"]


@pytest.fixture(scope="module")
def engine(vals):
    a, b = vals["f"][:6], vals["g"][:6]
    port = {}
    for k in (3, 8):
        out = ctw.fq_engine_ref(_port(a), _port(b), k)
        port.update(mul=out[0], add=out[1], sub=out[2], neg=out[3])
        port[f"small{k}"] = out[4]
    return a, b, {op: _port_out(x, 6) for op, x in port.items()}


@pytest.mark.parametrize("op", ENGINE_OPS)
def test_engine_matches_pallas_engine(engine, op):
    """B3's plain version (the test entry's mul, add, sub, neg, small(k))
    against ``k_mul``, ``k_add``, ``k_sub``, ``k_neg``, ``k_small`` on six
    stacked Fq values."""
    a, b, port = engine
    A, B = ptw.cat(_jax(a)), ptw.cat(_jax(b))
    want = {
        "mul": lambda: ptw.k_mul(A, B), "add": lambda: ptw.k_add(A, B),
        "sub": lambda: ptw.k_sub(A, B), "neg": lambda: ptw.k_neg(A),
        "small3": lambda: ptw.k_small(A, 3),
        "small8": lambda: ptw.k_small(A, 8),
    }[op]()
    _assert_equal(port[op], _jax_out(ptw.split(want, 6)))


# ---------------------------------------------------------------------------
# B4-B9
# ---------------------------------------------------------------------------

def test_dbl_fold_matches_pallas(vals):
    fo, To = ctw.p_dbl_fold(_port(vals["f"]), _port(vals["T"]),
                            _port(vals["P"]))
    xp, yp = _jax(vals["P"])
    jf, jT = ptw.dbl_fold(_fq12(_jax(vals["f"])), _fq2s(_jax(vals["T"])),
                          xp, yp)
    _assert_equal(_port_out(fo, 12), _jax_out(_flat(jf)))
    _assert_equal(_port_out(To, 6), _jax_out(_flat(jT)))


def test_add_fold_matches_pallas(vals):
    fo, To = ctw.p_add_fold(_port(vals["f"]), _port(vals["T"]),
                            _port(vals["Q"]), _port(vals["P"]))
    xp, yp = _jax(vals["P"])
    jf, jT = ptw.add_fold(_fq12(_jax(vals["f"])), _fq2s(_jax(vals["T"])),
                          _fq2s(_jax(vals["Q"])), xp, yp)
    _assert_equal(_port_out(fo, 12), _jax_out(_flat(jf)))
    _assert_equal(_port_out(To, 6), _jax_out(_flat(jT)))


@pytest.mark.parametrize("kind", ["random", "cyclotomic"])
def test_cyclo_sqr_matches_pallas(vals, cyclotomic, kind):
    f = (vals if kind == "random" else cyclotomic)["f"]
    got = ctw.p_cyclo_sqr(_port(f))
    want = ptw.fq12_cyclo_sqr(_fq12(_jax(f)))
    _assert_equal(_port_out(got, 12), _jax_out(_flat(want)))


@pytest.mark.parametrize("kind", ["random", "cyclotomic"])
def test_cyclo_sqr_mul_matches_pallas(vals, cyclotomic, kind):
    src = vals if kind == "random" else cyclotomic
    got = ctw.p_cyclo_sqr_mul(_port(src["f"]), _port(src["g"]))
    want = ptw.fq12_mul(ptw.fq12_cyclo_sqr(_fq12(_jax(src["f"]))),
                        _fq12(_jax(src["g"])))
    _assert_equal(_port_out(got, 12), _jax_out(_flat(want)))


def test_fq12_mul_matches_pallas(vals):
    got = ctw.p_fq12_mul(_port(vals["f"]), _port(vals["g"]))
    want = ptw.fq12_mul(_fq12(_jax(vals["f"])), _fq12(_jax(vals["g"])))
    _assert_equal(_port_out(got, 12), _jax_out(_flat(want)))


def test_fq12_sqr_matches_pallas(vals):
    got = ctw.p_fq12_sqr(_port(vals["f"]))
    want = ptw.fq12_sqr(_fq12(_jax(vals["f"])))
    _assert_equal(_port_out(got, 12), _jax_out(_flat(want)))


def test_cyclo_sqr_is_the_square_on_the_cyclotomic_subgroup(vals,
                                                            cyclotomic):
    """On easy-part outputs Granger–Scott gives the true square; off the
    subgroup (the random values) it does not."""
    f = _port(cyclotomic["f"])
    assert torch.equal(ctw.p_cyclo_sqr(f), ctw.p_fq12_sqr(f))
    f = _port(vals["f"])
    same = (ctw.p_cyclo_sqr(f) == ctw.p_fq12_sqr(f)).all(0)
    assert same.tolist() == [lane in ZERO_LANES for lane in range(N)]


# ---------------------------------------------------------------------------
# The packed layout
# ---------------------------------------------------------------------------

def test_pack_has_the_plane_order_of_pallas_pack(vals):
    """Row c·24 + l of the port's pack holds limb l of component c, the
    plane order of ``ptw.pack`` with R·128 flattened (and without the
    engine form)."""
    comps = vals["Q"]
    port = _port(comps).numpy().astype(np.uint32)
    planes = ptw.pack([jnp.asarray(c) for c in comps], N)
    for i in range(len(comps)):
        lanes_last = planes[i * ptw.L:(i + 1) * ptw.L].reshape(ptw.L, -1).T
        public = np.asarray(ptw.from_engine(lanes_last[:N]))
        assert np.array_equal(port[i * 24:(i + 1) * 24].T, public)
        assert np.array_equal(port[i * 24:(i + 1) * 24].T, comps[i])


def test_unpack_inverts_pack(vals):
    x = _port(vals["f"])
    assert x.shape == (288, N) and x.is_contiguous()
    _assert_equal(_port_out(x, 12), vals["f"])
    assert torch.equal(pk.pack12(pk.unpack12(x)), x)
    assert torch.equal(pk.pack_fq2s(pk.unpack_fq2s(_port(vals["T"]), 3)),
                       _port(vals["T"]))


def test_packed_conj12_matches_pallas(vals):
    got = pk.packed_conj12(_port(vals["f"]))
    want = ptw.packed_conj12(ptw.pack([jnp.asarray(c) for c in vals["f"]],
                                      N))
    _assert_equal(_port_out(got, 12), [np.asarray(c) for c in
                                       ptw.unpack(want, 12, N)])


def test_packed_one_and_is_one_match_pallas(vals):
    R = ptw.pack_rows(N)
    _assert_equal(_port_out(pk.packed_one12(N, "cpu"), 12),
                  [np.asarray(c)[:N] for c in
                   ptw.unpack(ptw.packed_one12(R), 12, N)])
    _assert_equal(_port_out(pk.packed_one2(N, "cpu"), 2),
                  [np.asarray(c)[:N] for c in
                   ptw.unpack(ptw.packed_one2(R), 2, N)])
    # one on even lanes, the random f elsewhere, and a lane that differs
    # from one in its last limb only
    f = _port(vals["f"])
    one = pk.packed_one12(N, "cpu")
    mixed = torch.where(torch.arange(N) % 2 == 0, one, f)
    mixed[287, 2] = 1
    want = ptw.packed_is_one12(ptw.pack(
        [jnp.asarray(c.numpy().astype(np.uint32))
         for c in pk.unpack(mixed, 12)], N))
    got = pk.packed_is_one12(mixed)
    assert got.tolist() == np.asarray(want)[:N].tolist()
    assert got.sum() == N // 2 - 1


# ---------------------------------------------------------------------------
# Dispatch and the kernel registry
# ---------------------------------------------------------------------------

def test_registry_lists_every_kernel_with_its_plain_version():
    names = [k.name for mod in (cuda_mont, ctw) for k in mod.KERNELS]
    assert names == ["mont_mul", "mont_pow", "fq_engine", "dbl_fold",
                     "add_fold", "cyclo_sqr", "cyclo_sqr_mul", "fq12_mul",
                     "fq12_sqr", "dbl_step", "add_step", "f_sqr_fold",
                     "f_fold"]
    for mod in (cuda_mont, ctw):
        for k in mod.KERNELS:
            assert getattr(mod, k.launch.__name__) is k.launch
            assert getattr(mod, k.plain.__name__) is k.plain
            assert k.source.startswith("threshold_crypto_tpu_torch/csrc/")
            assert k.replaces.startswith("threshold_crypto_tpu/device/pallas_")


def test_cpu_tensors_never_reach_the_kernels(vals):
    """The wrappers take CUDA tensors only (no fallback), and the dispatch
    sends CPU tensors to the plain versions: no launch is counted."""
    f, T, P_ = _port(vals["f"]), _port(vals["T"]), _port(vals["P"])
    for k in ctw.KERNELS:
        k.count.reset()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctw.dbl_fold(f, T, P_)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctw.fq12_sqr(f)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctw.fq_engine(f, f, 3)
    ctw.p_fq12_sqr(f)
    assert all(k.count.launches == 0 for k in ctw.KERNELS)
    with pytest.raises(RuntimeError, match="no Montgomery kernel for device"):
        ctw.p_fq12_sqr(f.to("meta"))
