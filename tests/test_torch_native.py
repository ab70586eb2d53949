"""The port's native host library (``threshold_crypto_tpu_torch/native``,
``csrc/tc_native.cpp`` built by g++ through ``_build``) against the JAX
package's native library and the pure-Python oracles: SHA3-256 against
``hashlib``, the ChaCha20 streams against ``utils.rng.ChaChaRng`` and the
numpy ``host.chacha.chacha20_words``, ``hash_g2`` and
``g2_random_from_seed`` against ``host.sampling.g2_random``, and
``xor_with_hash`` against its composition; then the build itself: into
``_build/`` under a content-hash name, never beside the source, a failed
build raising with g++'s output, concurrent builds each ending with a
loadable library."""

import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from threshold_crypto_tpu import native as jnative
from threshold_crypto_tpu_torch import _build, native
from threshold_crypto_tpu_torch.host import chacha as hchacha
from threshold_crypto_tpu_torch.host import sampling
from threshold_crypto_tpu_torch.utils.rng import ChaChaRng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# empty, one rate block of the Keccak sponge short and over, 64 / 65 (the
# pre-hash threshold of hash_g1_g2), and long inputs
LENGTHS = [0, 1, 64, 65, 135, 136, 137, 1000]


def _data(n, k=7):
    return bytes((k * i + 3) % 256 for i in range(n))


@pytest.mark.parametrize("n", LENGTHS)
def test_sha3_256_matches_hashlib_and_jax(n):
    data = _data(n)
    got = native.sha3_256(data)
    assert got == hashlib.sha3_256(data).digest() == jnative.sha3_256(data)


@pytest.mark.parametrize("off,count", [(0, 100), (37, 20), (15, 1), (0, 0),
                                       (1000, 33)])
def test_chacha20_words_match_the_rng_numpy_and_jax(off, count):
    seed = bytes(range(32))
    rng = ChaChaRng(seed)
    stream = [rng.next_u32() for _ in range(off + count)]
    got = native.chacha20_words(seed, off, count)
    assert got == stream[off:]
    assert got == hchacha.chacha20_words(seed, off + count)[off:].tolist()
    assert got == jnative.chacha20_words(seed, off, count)


@pytest.mark.parametrize("n", [0, 64, 65, 333])
def test_chacha20_low_bytes_match_the_keystream_and_jax(n):
    seed = hashlib.sha3_256(b"keystream").digest()
    got = native.chacha20_low_bytes(seed, 0, n)
    assert got == ChaChaRng(seed).keystream_bytes(n)
    assert got == jnative.chacha20_low_bytes(seed, 0, n)
    words = hchacha.chacha20_words(seed, n + 5)
    assert native.chacha20_low_bytes(seed, 5, n) == bytes(
        (words[5:] & 0xFF).astype(np.uint8).tolist())


@pytest.mark.parametrize("n", [0, 64, 65])
def test_hash_g2_matches_the_sampling_oracle_and_jax(n):
    msg = _data(n, 11)
    digest = hashlib.sha3_256(msg).digest()
    want = sampling.g2_random(ChaChaRng(digest))
    assert native.hash_g2(msg) == want == jnative.hash_g2(msg)
    assert native.g2_random_from_seed(digest) == want
    assert jnative.g2_random_from_seed(digest) == want


@pytest.mark.parametrize("n", [0, 64, 65, 517])
def test_xor_with_hash_matches_its_composition_and_jax(n):
    key_material = b"\x17" * 48  # stands in for a compressed G1 point
    data = _data(n, 13)
    ks = ChaChaRng(hashlib.sha3_256(key_material).digest()).keystream_bytes(n)
    want = bytes(a ^ b for a, b in zip(ks, data))
    assert native.xor_with_hash(key_material, data) == want
    assert jnative.xor_with_hash(key_material, data) == want


def test_seed_length_guard():
    for fn, args in ((native.chacha20_words, (0, 4)),
                     (native.chacha20_low_bytes, (0, 4)),
                     (native.g2_random_from_seed, ())):
        with pytest.raises(ValueError, match="32 bytes"):
            fn(b"short", *args)


def test_library_lives_in_the_build_cache_with_abi_2():
    """The library is built into ``_build/`` under a name hashing the flags
    and the source; nothing is written beside the source, and the JAX
    package's source is not its input."""
    lib = _build.native_library()
    assert lib.tc_native_abi_version() == _build.NATIVE_ABI == 2
    path = _build.native_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libtc_native_")
    assert os.path.exists(path) and os.path.exists(path + ".log")
    assert "g++ tc_native.cpp:" in open(path + ".log").read()
    assert not [f for f in os.listdir(_build.CSRC) if f.endswith(".so")]
    cmd = _build.native_command("/nonexistent/lib.so")
    assert cmd[-1] == _build.NATIVE_SOURCE == os.path.join(
        _build.CSRC, "tc_native.cpp")
    assert "threshold_crypto_tpu/" not in " ".join(cmd).replace(
        "threshold_crypto_tpu_torch/", "")
    assert _build.NATIVE_SOURCE not in _build.sources()


def _fake_gxx(tmp_path, body):
    path = tmp_path / "g++"
    path.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    path.chmod(0o755)
    return str(path)


def test_failed_native_build_raises_with_gxx_output(tmp_path, monkeypatch):
    gxx = _fake_gxx(tmp_path, 'print("error: no compiler here"); '
                              'sys.exit(1)')
    monkeypatch.setattr(_build, "gxx", lambda: gxx)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.sha3_256(b"abc")
    assert os.listdir(tmp_path / "build") == []
    assert _build._libs == {}


def test_native_build_renames_into_place_and_caches(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    gxx = _fake_gxx(tmp_path, textwrap.dedent(f"""
        open({str(calls)!r}, "a").write("x")
        out = sys.argv[sys.argv.index("-o") + 1]
        assert out.endswith(".tmp"), out
        open(out, "wb").write(b"lib")
    """))
    monkeypatch.setattr(_build, "gxx", lambda: gxx)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    log = _build.build_native()
    assert "g++ tc_native.cpp:" in log
    path = _build.native_path()
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".log"])
    assert open(path, "rb").read() == b"lib"
    assert _build.build_native() == log
    assert calls.read_text() == "x"


def test_concurrent_builds_each_load_the_library(tmp_path):
    """Three processes build into one empty cache at once, as test workers
    do: each ends with a loadable library of ABI version 2."""
    code = textwrap.dedent(f"""
        from threshold_crypto_tpu_torch import _build
        _build.BUILD_DIR = {str(tmp_path)!r}
        lib = _build.native_library()
        print(lib.tc_native_abi_version())
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert [o.strip() for o, _ in outs] == ["2", "2", "2"]
    names = os.listdir(tmp_path)
    assert not [n for n in names if n.endswith(".tmp")], names
    assert len([n for n in names if n.endswith(".so")]) == 1
