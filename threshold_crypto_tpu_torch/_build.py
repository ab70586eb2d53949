"""Build the port's native code and load it with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, built at its first use by ``nvcc`` alone (no ninja, no PyTorch
headers), into ``_build/`` beside this file; the sources share the headers
``csrc/*.cuh``. The host library ``csrc/tc_native.cpp`` (SHA3, ChaCha20,
one message's hash to G2) is built the same way by ``g++``. The file name
carries a hash of the source, the headers and the flags, so a changed
source builds anew and an unchanged one is loaded from the cache. A build
writes to a temporary name and is renamed into place, so concurrent
workers cannot race, and no lock file can outlive a killed build. A failed
build raises with the compiler's output. Importing the package builds
nothing.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 600
# The host library: its source, its g++ flags (the JAX package's) and the
# ABI version its ``tc_native_abi_version`` must return.
NATIVE = "tc_native"
NATIVE_SOURCE = os.path.join(CSRC, "tc_native.cpp")
GXX_FLAGS = ["-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17"]
NATIVE_ABI = 2

# C signatures of each library's launchers: (name, argtypes).
_VP, _INT = ctypes.c_void_p, ctypes.c_int
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U16P = ctypes.POINTER(ctypes.c_uint16)
SIGNATURES = {
    "mont": [
        ("tc_mont_mul", [_VP, _VP, _VP, _INT, _INT, _U32P, _VP]),
        ("tc_mont_pow", [_VP, _VP, _INT, _U16P, _INT, _INT, _INT, _INT,
                         _U32P, _VP]),
    ],
    "miller": [
        ("tc_dbl_fold", [_VP] * 5 + [_INT, _VP]),
        ("tc_add_fold", [_VP] * 6 + [_INT, _VP]),
        ("tc_dbl_step", [_VP] * 4 + [_INT, _VP]),
        ("tc_add_step", [_VP] * 5 + [_INT, _VP]),
        ("tc_f_sqr_fold", [_VP] * 3 + [_INT, _VP]),
        ("tc_f_fold", [_VP] * 3 + [_INT, _VP]),
    ],
    "fq12": [
        ("tc_cyclo_sqr", [_VP, _VP, _INT, _VP]),
        ("tc_cyclo_sqr_mul", [_VP, _VP, _VP, _INT, _VP]),
        ("tc_fq12_mul", [_VP, _VP, _VP, _INT, _VP]),
        ("tc_fq12_sqr", [_VP, _VP, _INT, _VP]),
        ("tc_fq_engine", [_VP, _VP, _VP, _INT, _INT, _INT, _VP]),
        ("tc_frob_mul", [_VP, _VP, _VP, _INT, _INT, _VP]),
        ("tc_easy_down", [_VP, _VP, _VP, _INT, _VP]),
        ("tc_easy_up", [_VP, _VP, _VP, _INT, _VP]),
    ],
    "msm": [
        ("tc_g1_madd", [_VP, _VP, _VP, _INT, _VP]),
        ("tc_g2_madd", [_VP, _VP, _VP, _INT, _VP]),
        ("tc_g1_winacc", [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP]),
        ("tc_g2_winacc", [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP]),
    ],
    "keccak": [
        ("tc_sha3_chunks", [_VP, _VP, _INT, _VP]),
    ],
    "ladder": [
        ("tc_g1_step", [_VP, _VP, _VP, _VP, _INT, _INT, _VP]),
        ("tc_g2_step", [_VP, _VP, _VP, _VP, _INT, _INT, _VP]),
        ("tc_g1_step4", [_VP, _VP, _VP, _VP, _INT, _INT, _VP]),
        ("tc_g2_step4", [_VP, _VP, _VP, _VP, _INT, _INT, _VP]),
    ],
    "fr": [
        ("tc_lagrange_rowprod", [_VP, _VP, _VP, _INT, _INT, _VP]),
    ],
    "fold": [
        ("tc_g1_fold_level", [_VP, _VP, _INT, _INT, _VP]),
        ("tc_g2_fold_level", [_VP, _VP, _INT, _INT, _VP]),
    ],
    "shared": [
        ("tc_g1_selmadd", [_VP] * 4 + [_INT] * 4 + [_VP]),
        ("tc_g2_selmadd", [_VP] * 4 + [_INT] * 4 + [_VP]),
        ("tc_g1_dblw", [_VP, _VP, _INT, _INT, _VP]),
        ("tc_g2_dblw", [_VP, _VP, _INT, _INT, _VP]),
    ],
}

_CP, _SZ, _U64 = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64
NATIVE_SIGNATURES = [
    ("tc_sha3_256", [_CP, _SZ, _CP]),
    ("tc_chacha20_words", [_CP, _U64, _U32P, _SZ]),
    ("tc_chacha20_low_bytes", [_CP, _U64, _CP, _SZ]),
    ("tc_xor_with_hash", [_CP, _SZ, _CP, _SZ, _CP]),
    ("tc_hash_g2", [_CP, _SZ, _CP]),
    ("tc_g2_random_from_seed", [_CP, _CP]),
]

_lock = threading.Lock()
_libs: dict = {}


def sources() -> list:
    """Every kernel source of the package, sorted."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list:
    """The headers the sources share (``#include "*.cuh"``), sorted."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or path)


def _source(name: str) -> str:
    path = os.path.join(CSRC, name + ".cu")
    if path not in sources():
        raise ValueError(f"no kernel source {name}.cu")
    return path


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives once built; the name
    hashes the flags, the source and every shared header."""
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    for path in (_source(name), *headers()):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def command(name: str, out_path: str) -> list:
    """The nvcc command that builds ``csrc/<name>.cu`` into ``out_path``."""
    return [nvcc(), *FLAGS, "-o", out_path, _source(name)]


def build(names=None) -> dict:
    """Build the named libraries (all by default), one nvcc per source,
    all started together. Returns {name: nvcc's log, ending in a line with
    the build's seconds}; raises with nvcc's output if one fails. A library
    already built is not built again (its saved log is returned)."""
    if names is None:
        names = [os.path.basename(s)[:-3] for s in sources()]
    return _run({name: ("nvcc", name + ".cu", library_path(name),
                        lambda out, name=name: command(name, out))
                 for name in names})


def gxx() -> str:
    return shutil.which("g++") or "g++"


def native_path() -> str:
    """Where the host library lives once built; the name hashes the g++
    flags and the source."""
    h = hashlib.sha256()
    h.update(" ".join(GXX_FLAGS).encode())
    with open(NATIVE_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{NATIVE}_{h.hexdigest()[:16]}.so")


def native_command(out_path: str) -> list:
    """The g++ command that builds ``csrc/tc_native.cpp`` into
    ``out_path``."""
    return [gxx(), *GXX_FLAGS, "-o", out_path, NATIVE_SOURCE]


def build_native() -> str:
    """Build the host library if it is not built: g++'s log, ending in a
    line with the build's seconds; raises with g++'s output on failure."""
    return _run({NATIVE: ("g++", os.path.basename(NATIVE_SOURCE),
                          native_path(), native_command)})[NATIVE]


def _run(jobs) -> dict:
    """Run {name: (tool, source file, library path, command for an output
    path)}, every compiler started together, each into a temporary name
    renamed into place with its log beside it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    logs, running = {}, {}
    for name, (tool, src, path, make_command) in jobs.items():
        if os.path.exists(path):
            with open(path + ".log") as f:
                logs[name] = f.read()
            continue
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen(make_command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tool, src, tmp, path, time.monotonic())
    failed = []
    for name, (proc, tool, src, tmp, path, start) in running.items():
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\n{tool} timed out after {BUILD_TIMEOUT_S} s"
        out += f"\n{tool} {src}: {time.monotonic() - start:.1f} s\n"
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{tool} failed for {src}:\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        with open(tmp + ".log", "w") as f:
            f.write(out)
        os.replace(tmp + ".log", path + ".log")
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str):
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn, argtypes in SIGNATURES[name]:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def native_library():
    """The loaded host library, built at first use; raises unless its ABI
    version is ``NATIVE_ABI``."""
    with _lock:
        lib = _libs.get(NATIVE)
        if lib is None:
            build_native()
            lib = ctypes.CDLL(native_path())
            for fn, argtypes in NATIVE_SIGNATURES:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = None
            lib.tc_native_abi_version.restype = ctypes.c_int
            if lib.tc_native_abi_version() != NATIVE_ABI:
                raise RuntimeError(
                    f"{native_path()}: ABI version "
                    f"{lib.tc_native_abi_version()}, expected {NATIVE_ABI}")
            _libs[NATIVE] = lib
        return lib
