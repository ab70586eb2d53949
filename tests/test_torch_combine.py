"""The threshold combine (``ops.combine_batch``) and the unfused
shared-window MSM (kernel B16) on the CPU, against the host oracle.

``combine_batch`` takes t + 1 = 12 shares of a secret f(0) in G1 (decryption
shares u·f(xᵢ)) and G2 (signature shares H·f(xᵢ)), with xᵢ = i + 1, on each of
its three paths ("pallas": B10 and B11; "scalarwise": B15; "bitscan": B16),
through the kernels' plain versions. Every path must give the host
oracle's point P·f(0) (Python-int λ and ``host/curve.py``'s mul and add, as
affine points), so they also equal each other; with the matrix bound of
``ops.fr`` lowered to 4, λ comes through B14's route and the points are the
same. ``ok`` is False on a duplicate x and on a zero x. The unfused
``msm_pallas_shared(fused=False)`` (B16 dblw and selmadd, the JAX
package's DIRECT branch) gives the fused form's sum at window 1 and 3 over
N = 11 lanes with 4 accumulators (a ragged last block) and an infinity
lane with a nonzero scalar.
"""

import random

import numpy as np
import pytest
import torch

from threshold_crypto_tpu_torch import ops
from threshold_crypto_tpu_torch.device import cuda_curve as ccv
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.host.params import R
from threshold_crypto_tpu_torch.ops import fr as frops

T1 = 12
A, N_MSM = 4, 11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups(name):
    return (dcv.G2, hcv.G2) if name == "G2" else (dcv.G1, hcv.G1)


@pytest.fixture(scope="module")
def shares():
    """Per group: the shares' Jacobian tuple [T1] (random Z ≠ 1 on some
    lanes, as a ladder leaves them), the x as Montgomery limbs, and the
    host's P·f(0)."""
    rnd = random.Random(0xC0B1)
    coeffs = [rnd.randrange(R) for _ in range(T1)]

    def f(x):
        return sum(c * pow(x, k, R) for k, c in enumerate(coeffs)) % R

    out = {}
    for name in ("G1", "G2"):
        curve, host = _groups(name)
        base = host.mul(host.generator, rnd.randrange(1, R))
        pts = [host.mul(base, f(i + 1)) for i in range(T1)]
        jac = curve.from_host_affine(pts, device="cpu")
        jac = curve.double(curve.double(jac))        # Z ≠ 1: 4·share
        out[name] = (jac, host.mul(base, 4 * coeffs[0] % R))
    xs = frops.fr_to_device(range(1, T1 + 1), "cpu")
    return out, xs


def _affine(curve, pt):
    return curve.to_host_affine(dcv.tree_map(lambda a: a[None], pt))[0]


@pytest.mark.parametrize("path", ["pallas", "scalarwise", "bitscan"])
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_combine_paths_match_host_oracle(shares, group, path):
    by_group, xs = shares
    jac, want = by_group[group]
    curve, _ = _groups(group)
    before = [k.count.launches for k in ccv.KERNELS]
    pt, ok = ops.combine_batch(curve, jac, xs, path=path)
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    assert _affine(curve, pt) == want
    assert [k.count.launches for k in ccv.KERNELS] == before   # CPU: plain


@pytest.mark.parametrize("path,group", [("pallas", "G1"),
                                        ("scalarwise", "G1"),
                                        ("bitscan", "G1"),
                                        ("pallas", "G2")])
def test_combine_through_the_kernel_route_of_lambda(monkeypatch, shares,
                                                    path, group):
    """With ``_LAGRANGE_MATRIX_MAX`` at 4, λ of the 12 shares comes from
    B14's route (the plain version of ``cuda_fr.lagrange_rowprod``) and is
    the matrix form's bit for bit; each path still gives the host's point."""
    by_group, xs = shares
    jac, want = by_group[group]
    curve, _ = _groups(group)
    lam_matrix, _ = frops.lagrange_coeffs_at_zero(xs)
    monkeypatch.setattr(frops, "_LAGRANGE_MATRIX_MAX", 4)
    calls = []
    real = frops.cuda_fr.lagrange_rowprod
    monkeypatch.setattr(frops.cuda_fr, "lagrange_rowprod",
                        lambda x: calls.append(1) or real(x))
    lam, ok = frops.lagrange_coeffs_at_zero(xs)
    assert bool(ok) and torch.equal(lam, lam_matrix) and calls == [1]
    pt, ok = ops.combine_batch(curve, jac, xs, path=path)
    assert bool(ok) and calls == [1, 1]
    assert _affine(curve, pt) == want


@pytest.mark.parametrize("case", ["duplicate", "zero"])
def test_combine_not_ok_on_duplicate_or_zero_x(shares, case):
    by_group, xs = shares
    jac, _ = by_group["G1"]
    bad = xs.clone()
    bad[7] = bad[2] if case == "duplicate" else 0
    _, ok = ops.combine_batch(dcv.G1, jac, bad, path="pallas")
    assert not bool(ok)


def test_unknown_combine_path_raises(shares):
    by_group, xs = shares
    with pytest.raises(ValueError, match="unknown combine path"):
        ops.combine_batch(dcv.G1, by_group["G1"][0], xs, path="scan")


def _msm_case(g2, seed):
    """N_MSM points and 64-bit scalars: lane 1 at infinity with another
    lane's coordinates and a nonzero scalar, lanes 2 and 3 the same point,
    lane 0 a zero scalar."""
    host = hcv.G2 if g2 else hcv.G1
    rnd = random.Random(seed)
    pts = [host.mul(host.generator, rnd.randrange(1, R))
           for _ in range(N_MSM)]
    ks = [rnd.randrange(1 << 64) for _ in range(N_MSM)]
    pts[3] = pts[2]
    ks[0] = 0
    dead = pts[1]
    pts[1] = None
    want = None
    for p, k in zip(pts, ks):
        if p is not None:
            want = host.add(want, host.mul(p, k))
    aff = (dpr.g2_affine_from_host if g2 else dpr.g1_affine_from_host)(
        pts, device="cpu")
    live = (dpr.g2_affine_from_host if g2 else dpr.g1_affine_from_host)(
        [dead], device="cpu")
    aff = dcv.tree_map(lambda a, b: torch.cat([a[:1], b, a[2:]]), aff[:2],
                       live[:2]) + (aff[2],)
    raw = b"".join(k.to_bytes(32, "little") for k in ks)
    scalars = torch.from_numpy(np.frombuffer(raw, "<u2").astype(
        np.int32).reshape(N_MSM, 16))
    return aff, scalars, want


@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_unfused_msm_matches_fused_and_host(monkeypatch, g2, window):
    """``msm_pallas_shared(fused=False)``: per window one dblw and one
    selmadd per block of 4 lanes (blocks 0-3, 4-7 and 8-10 with one padding
    lane) over 4 accumulators; the same sum as the fused B11 form and the
    host oracle."""
    curve = dcv.G2 if g2 else dcv.G1
    aff, scalars, want = _msm_case(g2, 0x16 + window)
    calls = {"dblw": 0, "selmadd": 0}

    def spy(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run

    with monkeypatch.context() as mp:
        mp.setattr(ccv, "p_dblw", spy("dblw", ccv.p_dblw))
        mp.setattr(ccv, "p_selmadd", spy("selmadd", ccv.p_selmadd))
        unfused = ccv.msm_pallas_shared(curve, aff, scalars, nbits=64,
                                        window=window, accumulators=A,
                                        fused=False)
    windows = -(-64 // window)
    assert calls == {"dblw": windows, "selmadd": 3 * windows}
    fused = ccv.msm_pallas_shared(curve, aff, scalars, nbits=64,
                                  window=window, accumulators=A)
    assert _affine(curve, unfused) == _affine(curve, fused) == want


def test_b16_wrappers_are_reached_through_the_module():
    """Every caller reaches B16 through the module attributes (which
    chip_smoke.py replaces to count and time them), and a CPU tensor never
    reaches a kernel."""
    b16 = [k for k in ccv.KERNELS if k.source.endswith("shared.cu")]
    assert [k.name for k in b16] == ["g1_selmadd", "g2_selmadd", "g1_dblw",
                                     "g2_dblw"]
    for k in b16:
        assert getattr(ccv, k.launch.__name__) is k.launch
        assert getattr(ccv, k.plain.__name__) is k.plain
        rows = 144 if k.name.startswith("g2") else 72
        acc = torch.zeros(rows, 4, dtype=torch.int32)
        with pytest.raises(ValueError):
            if "selmadd" in k.name:
                k.launch(acc, torch.zeros(rows, 8, dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32), 0)
            else:
                k.launch(acc, 1)
