"""The PyTorch port as a package: what it imports, where it runs, how its
kernels are built."""

import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from threshold_crypto_tpu_torch import _build, convert
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.host.curve import G1, G2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "threshold_crypto_tpu_torch",
    "threshold_crypto_tpu_torch._build",
    "threshold_crypto_tpu_torch.convert",
    "threshold_crypto_tpu_torch.host.params",
    "threshold_crypto_tpu_torch.host.tower",
    "threshold_crypto_tpu_torch.host.curve",
    "threshold_crypto_tpu_torch.host.chacha",
    "threshold_crypto_tpu_torch.host.sampling",
    "threshold_crypto_tpu_torch.hashing",
    "threshold_crypto_tpu_torch.poly",
    "threshold_crypto_tpu_torch.device.mont",
    "threshold_crypto_tpu_torch.device.cuda_mont",
    "threshold_crypto_tpu_torch.device.tower",
    "threshold_crypto_tpu_torch.device.packed",
    "threshold_crypto_tpu_torch.device.cuda_tower",
    "threshold_crypto_tpu_torch.device.pairing",
    "threshold_crypto_tpu_torch.device.curve",
    "threshold_crypto_tpu_torch.device.cuda_curve",
    "threshold_crypto_tpu_torch.device.keccak",
    "threshold_crypto_tpu_torch.device.chacha",
    "threshold_crypto_tpu_torch.device.hash2g2",
    "threshold_crypto_tpu_torch.device.cuda_fr",
    "threshold_crypto_tpu_torch.ops",
    "threshold_crypto_tpu_torch.ops.threshold",
    "threshold_crypto_tpu_torch.ops.fr",
    "threshold_crypto_tpu_torch.utils.rng",
    "threshold_crypto_tpu_torch.native",
    "threshold_crypto_tpu_torch.host.pairing",
    "threshold_crypto_tpu_torch.error",
    "threshold_crypto_tpu_torch.into_fr",
    "threshold_crypto_tpu_torch.mock.engine",
    "threshold_crypto_tpu_torch.backend",
    "threshold_crypto_tpu_torch.lib",
    "threshold_crypto_tpu_torch.serde_impl",
    "threshold_crypto_tpu_torch.codec_impl",
    "threshold_crypto_tpu_torch.parallel",
    "threshold_crypto_tpu_torch.parallel.mesh",
    "threshold_crypto_tpu_torch.parallel.multihost",
    "threshold_crypto_tpu_torch.parallel.sharded",
    "threshold_crypto_tpu_torch.parallel.dryrun",
]


def test_import_pulls_in_no_jax_and_builds_nothing():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "threshold_crypto_tpu"))
        assert not bad, bad
        from threshold_crypto_tpu_torch import _build
        assert _build._libs == {{}}, _build._libs
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dpr.g1_affine_from_host([G1.generator])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dpr.g2_affine_from_host([G2.generator])
    x = convert.to_jax(dpr.g1_affine_from_host([G1.generator], device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.g1_from_jax(*x)


# Entry points whose ``device`` default is None and means the card: the
# mesh takes ``default_device`` (cuda:{local rank}), ``global_mesh`` the
# device ``initialize`` chose, ``rlc_exponents`` the first absorbed
# tensor's device, else the card.
NONE_MEANS_CARD = {"threshold_crypto_tpu_torch.parallel.mesh.make_mesh",
                   "threshold_crypto_tpu_torch.parallel.multihost.global_mesh",
                   "threshold_crypto_tpu_torch.ops.threshold.rlc_exponents"}


def _device_defaults():
    """{module.function: default} of every public function (and public
    method of a public class) of the port with a ``device`` parameter
    that has a default."""
    import importlib
    import inspect
    import pkgutil

    import threshold_crypto_tpu_torch as pkg

    out = {}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns += [(f"{name}.{k}", getattr(v, "__func__", v))
                        for k, v in vars(obj).items()
                        if not k.startswith("_")]
            for qual, fn in fns:
                if not inspect.isfunction(fn):
                    continue
                par = inspect.signature(fn).parameters.get("device")
                if par is not None and par.default is not par.empty:
                    out[f"{mod.__name__}.{qual}"] = par.default
    return out


def test_every_entry_point_defaults_to_the_card():
    """Read from the signatures: every entry point of the port that takes
    a ``device`` runs on the card unless the caller asks for the CPU; its
    default is "cuda", or None where the function resolves None to the
    card (``NONE_MEANS_CARD``). ``run_world`` and ``dryrun_multichip``
    among them."""
    defaults = _device_defaults()
    assert defaults["threshold_crypto_tpu_torch.parallel.multihost."
                    "run_world"] == "cuda"
    assert defaults["threshold_crypto_tpu_torch.parallel.dryrun."
                    "dryrun_multichip"] == "cuda"
    assert defaults["threshold_crypto_tpu_torch.parallel.multihost."
                    "initialize"] == "cuda"
    assert defaults["threshold_crypto_tpu_torch.hashing.hash_g2_batch"] \
        == "cuda"
    assert len(defaults) >= 15
    off = {k: v for k, v in defaults.items()
           if not (v == "cuda" or (v is None and k in NONE_MEANS_CARD))}
    assert off == {}
    assert {k for k, v in defaults.items() if v is None} == NONE_MEANS_CARD


def test_none_device_defaults_resolve_to_the_card(monkeypatch):
    """The None defaults of ``NONE_MEANS_CARD`` reach for the card: without
    CUDA the mesh and ``rlc_exponents`` with nothing to absorb raise, and
    name device='cpu' as the way to the CPU."""
    from threshold_crypto_tpu_torch.ops import threshold as tops
    from threshold_crypto_tpu_torch.parallel import mesh, multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_mesh()
    monkeypatch.setattr(multihost, "_device", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.global_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.rlc_exponents(4, bytes(32))
    assert mesh.make_mesh(device="cpu").device == torch.device("cpu")


def test_build_command_targets_sm90a_from_package_sources():
    srcs = _build.sources()
    assert srcs and all(
        os.path.dirname(s) == os.path.join(_build.HERE, "csrc") for s in srcs)
    cmd = _build.command("mont", "/nonexistent/libmont.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    inputs = [a for a in cmd if a.endswith((".cu", ".cpp", ".c"))]
    assert inputs == [os.path.join(_build.CSRC, "mont.cu")]
    assert not any(a.startswith(("-I", "-l", "-L")) for a in cmd)  # no torch
    assert cmd[0].endswith("nvcc")
    assert os.path.dirname(_build.library_path("mont")) == _build.BUILD_DIR


@pytest.mark.parametrize("name", ["miller", "fq12"])
def test_tower_sources_build_alone_with_the_shared_headers(name):
    """Each tower source is one nvcc of its own .cu, finding the
    lane-group engine tower_group.cuh (and the register engine it
    includes) beside it, and its library name hashes every header too. No
    tower source includes tower.cuh, whose one-thread lane bodies no
    launcher runs."""
    srcs = [os.path.basename(s) for s in _build.sources()]
    assert srcs == ["fold.cu", "fq12.cu", "fr.cu", "keccak.cu", "ladder.cu",
                    "miller.cu", "mont.cu", "msm.cu", "shared.cu"]
    assert [os.path.basename(h) for h in _build.headers()] == [
        "curve.cuh", "fq.cuh", "fr.cuh", "keccak.cuh", "ladder_engine.cuh",
        "tower.cuh", "tower_group.cuh"]
    cmd = _build.command(name, "/nonexistent/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-Xptxas" in cmd
    inputs = [a for a in cmd if a.endswith((".cu", ".cuh", ".cpp", ".c"))]
    assert inputs == [os.path.join(_build.CSRC, name + ".cu")]
    assert not any(a.startswith(("-I", "-l", "-L")) for a in cmd)
    text = open(inputs[0]).read()
    assert '#include "tower_group.cuh"' in text
    assert '#include "tower.cuh"' not in text
    assert "#include <torch" not in text and "#include <ATen" not in text
    assert sorted(fn for fn, _ in _build.SIGNATURES[name]) == sorted(
        re.findall(r'extern "C" int (\w+)\(', text))


@pytest.mark.parametrize("name,header", [("msm", "curve.cuh"),
                                         ("msm", "ladder_engine.cuh"),
                                         ("keccak", "keccak.cuh"),
                                         ("mont", "ladder_engine.cuh"),
                                         ("ladder", "ladder_engine.cuh"),
                                         ("fr", "fr.cuh"),
                                         ("shared", "ladder_engine.cuh"),
                                         ("miller", "tower_group.cuh"),
                                         ("fq12", "tower_group.cuh")])
def test_msm_and_keccak_sources_build_alone(name, header):
    """The curve, transcript and Fr sources (the RLC slice's msm and
    keccak, the hash and encrypt slice's ladder, the combine slice's fr and
    shared), and the tower sources with the lane-group engine of B4 and
    B6: one nvcc each, their header beside them, no PyTorch headers, and a
    C launcher for every signature."""
    cmd = _build.command(name, "/nonexistent/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    inputs = [a for a in cmd if a.endswith((".cu", ".cuh", ".cpp", ".c"))]
    assert inputs == [os.path.join(_build.CSRC, name + ".cu")]
    text = open(inputs[0]).read()
    assert f'#include "{header}"' in text
    assert "#include <torch" not in text and "#include <ATen" not in text
    assert sorted(fn for fn, _ in _build.SIGNATURES[name]) == sorted(
        re.findall(r'extern "C" int (\w+)\(', text))


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A changed header gives every library a new name, so no stale build
    is loaded."""
    before = {n: _build.library_path(n) for n in ("mont", "miller", "fq12")}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert {n: _build.library_path(n) for n in before} == before
    with open(csrc / "fq.cuh", "a") as f:
        f.write("\n// changed\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    path.chmod(0o755)
    return str(path)


def test_build_renames_into_place_and_caches(tmp_path, monkeypatch):
    """A build lands under its content-hash name via a temporary file, keeps
    nvcc's log beside it, and is not run again once it is there."""
    calls = tmp_path / "calls"
    nvcc = _fake_nvcc(tmp_path, textwrap.dedent(f"""
        open({str(calls)!r}, "a").write("x")
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "wb").write(b"lib")
        print("ptxas info    : Used 40 registers")
    """))
    monkeypatch.setattr(_build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    logs = _build.build()
    names = sorted(logs)
    assert names == ["fold", "fq12", "fr", "keccak", "ladder", "miller",
                     "mont", "msm", "shared"]
    assert all("Used 40 registers" in logs[n] for n in names)
    assert all(re.search(rf"nvcc {n}\.cu: \d+\.\d s", logs[n])
               for n in names)
    paths = [_build.library_path(n) for n in names]
    assert all(open(p, "rb").read() == b"lib" for p in paths)
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(p) + ext for p in paths for ext in ("", ".log"))
    assert _build.build() == logs
    assert calls.read_text() == "x" * len(names)


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'print("error: no sm_90a here"); sys.exit(1)')
    monkeypatch.setattr(_build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert os.listdir(tmp_path / "build") == []


def test_kernels_list_the_ladder_kernels_in_both_groups():
    """B13 (step4) and B15 (step) in G1 and G2 forms, each with its source,
    the TPU kernel it replaces, a plain version and a count."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device.cuda_mont import KernelCount

    ladder = {k.name: k for k in ccv.KERNELS if k.source.endswith(
        "csrc/ladder.cu")}
    assert sorted(ladder) == ["g1_step", "g1_step4", "g2_step", "g2_step4"]
    tpu = "threshold_crypto_tpu/device/pallas_curve.py:"
    assert {k.replaces for k in ladder.values()} == {tpu + "385",
                                                     tpu + "373"}
    for k in ladder.values():
        assert k.plain.__name__ == k.name + "_ref"
        assert isinstance(k.count, KernelCount)
        assert ("tc_" + k.name) in [fn for fn, _ in _build.SIGNATURES["ladder"]]


def test_kernels_list_b14_and_b16():
    """B14 (lagrange_rowprod, ``csrc/fr.cu``) and B16 (selmadd and dblw in
    G1 and G2, ``csrc/shared.cu``), each with its source, the TPU kernel it
    replaces, a plain version, a count and a launcher."""
    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device import cuda_fr
    from threshold_crypto_tpu_torch.device.cuda_mont import KernelCount

    (b14,) = cuda_fr.KERNELS
    assert b14.name == "lagrange_rowprod"
    assert b14.source == "threshold_crypto_tpu_torch/csrc/fr.cu"
    assert b14.replaces == "threshold_crypto_tpu/device/pallas_fr.py:244"
    b16 = {k.name: k for k in ccv.KERNELS
           if k.source.endswith("csrc/shared.cu")}
    assert sorted(b16) == ["g1_dblw", "g1_selmadd", "g2_dblw", "g2_selmadd"]
    tpu = "threshold_crypto_tpu/device/pallas_curve.py:"
    assert {k.replaces for k in b16.values()} == {tpu + "410", tpu + "433"}
    for k, lib in [(b14, "fr")] + [(k, "shared") for k in b16.values()]:
        assert k.plain.__name__ == k.launch.__name__ + "_ref"
        assert isinstance(k.count, KernelCount)
        assert ("tc_" + k.name) in [fn for fn, _ in _build.SIGNATURES[lib]]


def test_kernels_list_b19():
    """B19, one fold level in G1 and G2 (``csrc/fold.cu``), citing the JAX
    ``_tree_sum`` (XLA adds, no Pallas kernel), with a plain version, a
    count and a C launcher; the wrapper takes CUDA tensors only, and the
    dispatch sends a CPU tensor to the plain version, which counts no
    launch."""
    import torch

    from threshold_crypto_tpu_torch.device import cuda_curve as ccv
    from threshold_crypto_tpu_torch.device.cuda_mont import KernelCount

    b19 = {k.name: k for k in ccv.KERNELS
           if k.source == "threshold_crypto_tpu_torch/csrc/fold.cu"}
    assert sorted(b19) == ["g1_fold_level", "g2_fold_level"]
    for g2, k in ((False, b19["g1_fold_level"]),
                  (True, b19["g2_fold_level"])):
        assert k.replaces == "threshold_crypto_tpu/device/curve.py:501"
        assert k.plain.__name__ == k.launch.__name__ + "_ref"
        assert getattr(ccv, k.launch.__name__) is k.launch
        assert isinstance(k.count, KernelCount)
        assert ("tc_" + k.name) in [fn for fn, _ in _build.SIGNATURES[
            "fold"]]
        pts = ccv.packed_infinity(g2, 6, "cpu")
        with pytest.raises(ValueError, match="CUDA tensor"):
            k.launch(pts, 2)
        k.count.reset()
        assert torch.equal(ccv.p_fold_level(g2, pts, 2),
                           ccv.packed_infinity(g2, 4, "cpu"))
        assert k.count.launches == 0
        with pytest.raises(ValueError, match="whole entries"):
            ccv.p_fold_level(g2, pts, 4)


def test_kernels_list_b17():
    """B17's four unfused Miller pieces in ``csrc/miller.cu``, each citing
    its TPU kernel, with a plain version, a count, a C launcher and a
    dispatcher under the JAX wrapper's name."""
    from threshold_crypto_tpu_torch.device import cuda_tower as ctw
    from threshold_crypto_tpu_torch.device.cuda_mont import KernelCount

    tpu = "threshold_crypto_tpu/device/pallas_tower.py:"
    b17 = {k.name: k for k in ctw.KERNELS if k.replaces in (
        tpu + "886", tpu + "895", tpu + "940", tpu + "948")}
    assert sorted(b17) == ["add_step", "dbl_step", "f_fold", "f_sqr_fold"]
    for k in b17.values():
        assert k.source == "threshold_crypto_tpu_torch/csrc/miller.cu"
        assert k.plain.__name__ == k.launch.__name__ + "_ref"
        assert isinstance(k.count, KernelCount)
        assert ("tc_" + k.name) in [fn for fn, _ in _build.SIGNATURES[
            "miller"]]
        assert callable(getattr(ctw, "p_" + k.name))


def test_ops_export_the_dkg_and_rlc_names():
    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import curve as dcv

    names = ["commit_batch", "powers_batch", "bivar_commit_batch",
             "bivar_row_batch", "bivar_commit_row_batch",
             "bivar_commit_eval_batch", "verify_sig_shares_rlc"]
    assert all(n in ops.__all__ and callable(getattr(ops, n)) for n in names)
    for curve in (dcv.G1, dcv.G2):
        for method in ("generator", "neg", "eq", "scalar_mul",
                       "msm_scalarwise", "fold_axis"):
            assert callable(getattr(curve, method))


# The JAX ``ops`` names with no counterpart in the port: its jit, AOT-cache
# and stepwise wrappers (``ops/threshold.py``'s module docstring).
NO_COUNTERPART = ("set_aot_cache", "verify_batch_pallas_jit",
                  "verify_batch_stepwise", "combine_batch_stepwise",
                  "verify_sig_shares_rlc_stepwise")


def test_ops_export_every_name_of_the_jax_ops():
    """Every name the JAX ``ops/__init__.py`` imports (read from its text,
    JAX not imported) is in the port's ``ops``, but the five wrappers the
    port documents as having no counterpart; ``ops.poly_eval`` evaluates
    as ``ops.fr.poly_eval`` and the host's Horner."""
    import ast

    from threshold_crypto_tpu_torch import ops
    from threshold_crypto_tpu_torch.device import mont
    from threshold_crypto_tpu_torch.device.mont import FR
    from threshold_crypto_tpu_torch.ops import threshold

    path = os.path.join(REPO, "threshold_crypto_tpu", "ops", "__init__.py")
    tree = ast.parse(open(path).read())
    names = [a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert "poly_eval" in names and set(NO_COUNTERPART) <= set(names)
    missing = [n for n in names
               if n not in NO_COUNTERPART and not hasattr(ops, n)]
    assert missing == []
    assert all(n in ops.__all__ for n in names
               if n not in NO_COUNTERPART and n not in ("fr", "threshold"))
    assert all(n in threshold.__doc__ for n in NO_COUNTERPART)
    coeffs, xs = [5, 7, FR.p - 1], [0, 1, 3, FR.p - 2]
    c = torch.from_numpy(mont.stack_mont(FR, coeffs))
    x = torch.from_numpy(mont.stack_mont(FR, xs))
    got = ops.poly_eval(c, x)
    assert torch.equal(got, ops.fr.poly_eval(c, x))
    assert mont.unstack_mont(FR, got) == [
        sum(k * pow(v, i, FR.p) for i, k in enumerate(coeffs)) % FR.p
        for v in xs]


def test_top_level_exports_every_name_of_the_jax_package():
    """Every name of the JAX package's ``__all__`` (read from its
    ``__init__.py`` with ``ast``, JAX not imported) is in the port's top
    level and its ``__all__``, and the size accessors follow the port's
    backend."""
    import ast

    import threshold_crypto_tpu_torch as tc

    path = os.path.join(REPO, "threshold_crypto_tpu", "__init__.py")
    tree = ast.parse(open(path).read())
    (names,) = [ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["__all__"]]
    assert len(names) == 32 and "SecretKeySet" in names
    assert [n for n in names if not hasattr(tc, n)] == []
    assert sorted(tc.__all__) == sorted(names)
    assert (tc.PK_SIZE, tc.SIG_SIZE) == (48, 96)
    assert (tc.pk_size(), tc.sig_size()) == (48, 96)
    with tc.using("mock"):
        assert (tc.pk_size(), tc.sig_size()) == (4, 4)
    assert tc.get_backend().name == "bls12_381"


# JAX device-layer names with no counterpart of the same name in the port:
# XLA's fused programs, stepwise forms and jit wrappers (PyTorch runs
# eagerly), the Pallas switches, ``MUL_IMPL`` (XLA's lowering of the product
# loop, scan or unrolled) and ``np_prod`` (the JAX pairing's numpy helper for
# its packed reshape).
XLA_ONLY = ("*_fused", "*_stepwise", "_jit*", "use_pallas", "_use_pallas_*",
            "MUL_IMPL", "np_prod")


def _public_names(path):
    """Top-level functions, classes and assigned names of a module, and
    the methods of its classes (as "Class.method"), all without a leading
    underscore; read with ``ast``, nothing imported."""
    import ast

    names = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names += [f"{node.name}.{m.name}" for m in node.body
                      if isinstance(m, ast.FunctionDef)
                      and not m.name.startswith("_")]
    return [n for n in names if not n.startswith("_")]


def test_device_and_parallel_modules_cover_the_jax_ones():
    """Every public name of the JAX ``device/*.py`` and ``parallel/*.py``
    is in the port's module of the same name, but the XLA-only names; the
    ``pallas_*.py`` kernel modules have no module of that name in the port:
    each is cited by the ``replaces`` of kernels in the port's registries.
    ``parallel`` exports every name of the JAX ``parallel/__init__.py``."""
    import ast
    import fnmatch
    import importlib

    from threshold_crypto_tpu_torch import parallel

    cited = {k.replaces.split(":")[0] for mod in (
        "cuda_mont", "cuda_tower", "cuda_curve", "keccak", "cuda_fr")
        for k in importlib.import_module(
            f"threshold_crypto_tpu_torch.device.{mod}").KERNELS}
    missing, checked = [], 0
    for sub in ("device", "parallel"):
        folder = os.path.join(REPO, "threshold_crypto_tpu", sub)
        for fname in sorted(os.listdir(folder)):
            if not fname.endswith(".py") or fname == "__init__.py":
                continue
            if fname.startswith("pallas_"):
                assert f"threshold_crypto_tpu/{sub}/{fname}" in cited, fname
                continue
            mod = importlib.import_module(
                f"threshold_crypto_tpu_torch.{sub}.{fname[:-3]}")
            for name in _public_names(os.path.join(folder, fname)):
                if any(fnmatch.fnmatch(name.split(".")[-1], pat)
                       for pat in XLA_ONLY):
                    continue
                obj = mod
                for part in name.split("."):
                    obj = getattr(obj, part, None)
                checked += 1
                if obj is None:
                    missing.append(f"{sub}/{fname}: {name}")
    assert missing == [] and checked > 150, (missing, checked)
    init = os.path.join(REPO, "threshold_crypto_tpu", "parallel",
                        "__init__.py")
    exported = [a.asname or a.name
                for node in ast.walk(ast.parse(open(init).read()))
                if isinstance(node, ast.ImportFrom) for a in node.names]
    assert "sharded_verify_rlc" in exported
    assert [n for n in exported if not hasattr(parallel, n)] == []
