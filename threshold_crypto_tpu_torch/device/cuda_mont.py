"""The Montgomery kernels of ``csrc/mont.cu``: wrappers and plain versions.

Two kernels, each the counterpart of one Pallas kernel of the JAX package,
both on B13's carry-save register product (``csrc/ladder_engine.cuh``,
instantiated for Fq and Fr):

* ``mont_mul`` replaces ``threshold_crypto_tpu/device/pallas_mont.py``
  ``_mul_kernel``: a·b·R⁻¹ mod p per lane, canonical output. A block's 128
  lanes of a and b come into shared memory by one bulk copy each and go
  out by 16-byte vector stores, so device memory is read and written
  whole; the bytes bound it. The tensors must be 16-byte aligned (it
  raises otherwise; :func:`.mont.mul` copies a view that is not).
* ``mont_pow`` replaces ``pallas_mont._pow_kernel``: aᵉ for a fixed public
  exponent, the whole chain in one launch (Fermat inversion with e = p − 2,
  so 0 ↦ 0). ``pow_chain`` cuts e into sliding windows of at most
  ``WINDOW`` bits; the kernel builds the odd powers a, a³, … it reads and
  runs the chain with a dedicated square. The chain travels by value in the
  kernel's parameters: no copy to the card, no synchronisation. An
  exponent e ≥ p is reduced mod p − 1 first (p − 1 where that is 0), the
  same aᵉ for every a, 0 included. The chain's length times one product's
  latency bounds it at the paths' widths up to 8192 lanes (the RLC path's
  inversions have 1 and 512): there one lane runs over ``GROUP`` = 4
  threads of a warp (``pow_group``, up to 8192 lanes in Fq and 4096 in
  Fr, the measured crossovers), which share each product; above, one
  thread a lane with a dedicated square (the hash path's 65,536 lanes,
  where the card is full: about 1.7× the bound of the chain's multiply
  count).

Both take ``int32[N, L]`` contiguous CUDA tensors of 16-bit limbs (the
public layout of :mod:`.mont`) and allocate their output with
``torch.empty``. They launch on the current stream and do not synchronise.
Each wrapper counts its launches in a plain integer, ``MUL.launches`` /
``POW.launches``; ``widest`` keeps the most lanes one launch was given.
``KERNELS`` lists both with their plain versions and counts.

``mul_ref`` / ``pow_fixed_ref`` are the same functions in plain PyTorch
(int64 outer products and column sums; the power bit by bit). :mod:`.mont`
sends CPU tensors there; the tests and ``chip_smoke.py`` hold the kernels
against them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from .. import _build

MASK16 = 0xFFFF


class KernelCount:
    """Launches of one kernel, and the most lanes one launch was given."""

    __slots__ = ("launches", "widest")

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = 0
        self.widest = 0

    def add(self, lanes):
        self.launches += 1
        self.widest = max(self.widest, lanes)


class Kernel(NamedTuple):
    """One kernel of the port, for ``chip_smoke.py`` and the op counter:
    the wrapper that launches it (an attribute of its module, under the
    wrapper's own name, through which every caller reaches it), its plain
    PyTorch version, its launch count, its source and the TPU kernel it
    replaces."""

    name: str
    launch: Callable
    plain: Callable
    count: KernelCount
    source: str
    replaces: str


MUL = KernelCount()
POW = KernelCount()


@functools.lru_cache(maxsize=None)
def _modulus_arg(spec):
    """p as the kernel's 32-bit words (the launcher checks it against the
    field it was built for), built once per field."""
    words = spec.L // 2
    return (ctypes.c_uint32 * words)(
        *[(spec.p >> (32 * k)) & 0xFFFFFFFF for k in range(words)])


# Sliding windows of at most WINDOW bits: 2^(WINDOW − 1) odd powers at most.
WINDOW = 5
ENTRY_BITS = 5                  # csrc/mont.cu kEntryBits
NO_ENTRY = (1 << ENTRY_BITS) - 1
MAX_STEPS = 384                 # csrc/mont.cu kMaxSteps
MAX_ENTRIES = 16                # csrc/mont.cu kMaxEntries


def pow_windows(e: int, window: int = WINDOW):
    """e > 0 as a sliding-window chain, MSB first: [(squarings, odd
    value)], odd value None for squarings alone. The first window's
    squarings are 0; a window starts and ends with a 1 and spans at most
    ``window`` bits, and e = fold(acc ↦ acc·2^squarings + value)."""
    if e <= 0:
        raise ValueError("a chain needs a positive exponent")
    bits = bin(e)[2:]
    steps, pending, i = [], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            pending, i = pending + 1, i + 1
            continue
        j = min(i + window, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        steps.append((pending + j - i if steps else 0, int(bits[i:j], 2)))
        pending, i = 0, j
    if pending:
        steps.append((pending, None))
    return steps


# Threads a lane of B2: GROUP up to the field's GROUP_MAX_LANES lanes (a
# launch that leaves the card idle: the product's latency sets its pace,
# and G threads share it), one above (the dedicated square, and no
# shuffles, where the card is full). The crossovers are measured
# (tools/mont_variants.py --group-sweep, NVIDIA H100 80GB HBM3, 700 W):
# G = 4 ahead up to 8192 lanes in Fq and 4096 in Fr, G = 1 from the next
# power of two.
GROUP = 4
GROUP_MAX_LANES = {"Fq": 8192, "Fr": 4096}


def pow_group(spec, n: int) -> int:
    """Threads a lane of a B2 launch over n lanes of ``spec``'s field."""
    return GROUP if n <= GROUP_MAX_LANES[spec.name] else 1


@functools.lru_cache(maxsize=64)
def pow_chain(spec, e: int, window: int = WINDOW):
    """The kernel's chain for a^e in ``spec``'s field: (uint16 steps as a
    ctypes array, their number, odd powers read). Each step is squarings
    << ENTRY_BITS | (value − 1)/2, or NO_ENTRY for squarings alone."""
    if e >= spec.p:
        e = e % (spec.p - 1) or spec.p - 1
    steps = pow_windows(e, window)
    entries = max((v - 1) // 2 for _, v in steps if v is not None) + 1
    if len(steps) > MAX_STEPS or entries > MAX_ENTRIES:
        raise ValueError(f"a chain of {len(steps)} steps and {entries} odd "
                         f"powers does not fit the kernel")
    words = [s << ENTRY_BITS | (NO_ENTRY if v is None else (v - 1) // 2)
             for s, v in steps]
    return (ctypes.c_uint16 * len(words))(*words), len(words), entries


def _check(spec, x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != spec.L:
        raise ValueError(f"{name} must be [N, {spec.L}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _launcher(lib, fn):
    return getattr(_build.library(lib), fn)


def launch(lib, fn, count, tensors, *ints, lanes):
    """Call the launcher ``fn`` of ``csrc/<lib>.cu`` with the tensors' data
    pointers, then the ints, then the current stream of the first tensor's
    device; raise if the launch was refused, else count it (``lanes`` wide).
    The device is made current only where it is not already.
    """
    dev = tensors[0].device
    call = _launcher(lib, fn)
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = call(*(t.data_ptr() for t in tensors), *ints,
                   torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = call(*(t.data_ptr() for t in tensors), *ints,
                       torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, fn)
    count.add(lanes)


def mont_mul(spec, a, b):
    """Kernel B1: int32[N, L] Montgomery product on the card. a and b must
    start on 16-byte boundaries (the kernel's bulk copies read whole tiles):
    a fresh tensor does; a view that does not raises."""
    _check(spec, a, "a")
    _check(spec, b, "b")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must have one shape and one device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mont_mul: a and b must be 16-byte aligned")
    out = torch.empty_like(a)
    n = a.shape[0]
    if n:
        launch("mont", "tc_mont_mul", MUL, (a, b, out), n, spec.L // 2,
               _modulus_arg(spec), lanes=n)
    return out


def mont_pow(spec, a, e: int):
    """Kernel B2: int32[N, L] base ↦ a^e (e > 0) on the card."""
    _check(spec, a, "a")
    if e <= 0:
        raise ValueError("mont_pow needs a positive exponent")
    out = torch.empty_like(a)
    n = a.shape[0]
    if n == 0:
        return out
    steps, nsteps, entries = pow_chain(spec, e)
    launch("mont", "tc_mont_pow", POW, (a, out), n, steps, nsteps, entries,
           pow_group(spec, n), spec.L // 2, _modulus_arg(spec), lanes=n)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _column_sums(x, y):
    """Σ_{i+j=k} x_i·y_j for int64 [N, L] operands -> int64 [N, 2L-1].

    The outer product's rows, padded to 2L and re-read with a row width of
    2L−1, land row i shifted right by i; summing the rows sums each column.
    """
    n, L = x.shape
    prod = x.unsqueeze(-1) * y.unsqueeze(-2)                      # [N, L, L]
    prod = torch.nn.functional.pad(prod, (0, L))                  # [N, L, 2L]
    skew = prod.reshape(n, 2 * L * L)[:, : L * (2 * L - 1)]
    return skew.reshape(n, L, 2 * L - 1).sum(1)


def _lookahead(gen, prop):
    """Carry-in bits of a ripple where each column generates (gen) or
    passes on (prop) a binary carry: the carries of (G|Pr) + G, with the
    flags packed as the bits of G and Pr. Returns (bits [N, K], carry out)."""
    K = gen.shape[1]
    shifts = torch.arange(K, dtype=torch.int64, device=gen.device)
    G = (gen.to(torch.int64) << shifts).sum(1)
    Pr = (prop.to(torch.int64) << shifts).sum(1)
    X = G | Pr
    c = (X + G) ^ X ^ G
    return (c.unsqueeze(1) >> shifts) & 1, c >> K


def _resolve(cols):
    """Column sums (int64 [N, K], 0 ≤ col < 2^40) -> canonical 16-bit limbs
    and what carries out of the top column."""
    top = torch.zeros_like(cols[:, 0])
    for _ in range(3):  # column bound 2^40 -> 2^24+2^16 -> 2^16+2^8 -> 2^16
        c = cols >> 16
        top = top + c[:, -1]
        cols = (cols & MASK16) + torch.nn.functional.pad(c[:, :-1], (1, 0))
    low = cols & MASK16
    cin, over = _lookahead(cols >> 16, low == MASK16)
    return (low + cin) & MASK16, top + over


def mul_ref(spec, a, b):
    """Plain PyTorch Montgomery product of int32[N, L] limbs (SOS form).

    T = a·b by column sums; m = (T mod R)·(−p⁻¹) mod R; (T + m·p)/R < 2p;
    then one conditional subtract of p. Same canonical result as the kernel.
    """
    L = spec.L
    n = a.shape[0]
    p = torch.tensor(spec.p_limbs, dtype=torch.int64, device=a.device)
    ninv = (-pow(spec.p, -1, 1 << (16 * L))) % (1 << (16 * L))
    n_limbs = torch.tensor([(ninv >> (16 * i)) & MASK16 for i in range(L)],
                           dtype=torch.int64, device=a.device)
    pad = torch.nn.functional.pad

    t, _ = _resolve(pad(_column_sums(a.to(torch.int64), b.to(torch.int64)),
                        (0, 1)))                                  # 2L limbs
    m, _ = _resolve(_column_sums(t[:, :L], n_limbs.expand(n, L)))
    mp = _column_sums(m[:, :L], p.expand(n, L))
    u, over = _resolve(t + pad(mp, (0, 1)))                       # low L ≡ 0
    u = u[:, L:]
    d = u - p
    bin_, borrow = _lookahead(d < 0, d == 0)
    diff = (d - bin_) & MASK16
    take = (over != 0) | (borrow == 0)
    return torch.where(take.unsqueeze(-1), diff, u).to(torch.int32)


def pow_fixed_ref(spec, a, e: int):
    """Plain PyTorch a^e (e > 0): the kernel's square-and-multiply chain."""
    one_limbs = [(spec.one_mont >> (16 * i)) & MASK16 for i in range(spec.L)]
    acc = torch.tensor(one_limbs, dtype=torch.int32, device=a.device)
    acc = acc.expand_as(a).contiguous()
    for c in bin(e)[2:]:
        acc = mul_ref(spec, acc, acc)
        if c == "1":
            acc = mul_ref(spec, acc, a)
    return acc


KERNELS = (
    Kernel("mont_mul", mont_mul, mul_ref, MUL,
           "threshold_crypto_tpu_torch/csrc/mont.cu",
           "threshold_crypto_tpu/device/pallas_mont.py:45"),
    Kernel("mont_pow", mont_pow, pow_fixed_ref, POW,
           "threshold_crypto_tpu_torch/csrc/mont.cu",
           "threshold_crypto_tpu/device/pallas_mont.py:267"),
)
