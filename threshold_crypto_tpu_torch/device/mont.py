"""Batched multi-limb Montgomery arithmetic on torch tensors.

The counterpart of ``threshold_crypto_tpu/device/mont.py``. Field elements
keep the JAX package's public layout: 16-bit limbs, least significant first,
``[..., L]`` with a free leading batch shape, L = 24 for Fq (R = 2^384) and
L = 16 for Fr (R = 2^256), always canonical (< p) and in Montgomery form.
The limbs live in ``int32`` tensors (torch's ``uint32`` has no add, shift or
compare on the CPU); values equal the JAX package's ``uint32`` arrays.

* ``mul`` and ``pow_fixed`` dispatch on the tensor's device: a CUDA tensor
  goes to the hand-written kernels of :mod:`.cuda_mont` (or the call
  raises), a CPU tensor to their plain PyTorch versions.
* ``add`` / ``sub`` / ``neg`` are plain tensor code on either device. Their
  carry chains run as one vectorised carry-lookahead pass instead of a
  Python loop over the limbs: each limb's carry (or borrow) is generated or
  passed on, and packing those flags as the bits of two small integers
  turns the whole ripple into one integer addition (see ``_carry_in``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..host.params import P as _P
from ..host.params import R as _R
from . import cuda_mont

MASK16 = 0xFFFF


class FpSpec:
    """Static description of one prime field's limb layout (hashable)."""

    __slots__ = ("p", "L", "n0inv", "r_mont", "r2", "p_limbs", "one_mont",
                 "name")

    def __init__(self, p: int, L: int, name: str):
        assert p.bit_length() <= 16 * L
        self.p = p
        self.L = L
        self.name = name
        self.r_mont = (1 << (16 * L)) % p
        self.r2 = (self.r_mont * self.r_mont) % p
        self.n0inv = (-pow(p, -1, 1 << 16)) % (1 << 16)
        self.p_limbs = tuple((p >> (16 * i)) & 0xFFFF for i in range(L))
        self.one_mont = self.r_mont

    def __repr__(self):
        return f"FpSpec({self.name}, L={self.L})"


FQ = FpSpec(_P, 24, "Fq")
FR = FpSpec(_R, 16, "Fr")


def device_of(device) -> torch.device:
    """The torch device an entry point runs on; CUDA must really be there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    return device


# ---------------------------------------------------------------------------
# Host-side conversions (numpy; API boundary and tests)
# ---------------------------------------------------------------------------

def limbs_from_int(spec: FpSpec, x: int) -> np.ndarray:
    x %= spec.p
    return np.array(
        [(x >> (16 * i)) & 0xFFFF for i in range(spec.L)], dtype=np.int32
    )


def int_from_limbs(arr) -> int:
    arr = np.asarray(arr, dtype=np.int64)
    return sum(int(v) << (16 * i) for i, v in enumerate(arr))


def to_mont(spec: FpSpec, x: int) -> np.ndarray:
    """Host int -> Montgomery-form limbs."""
    return limbs_from_int(spec, (x % spec.p) * spec.r_mont % spec.p)


def from_mont_int(spec: FpSpec, arr) -> int:
    """Montgomery-form limbs -> host int."""
    return int_from_limbs(arr) * pow(spec.r_mont, -1, spec.p) % spec.p


def stack_mont(spec: FpSpec, xs) -> np.ndarray:
    """[N] host ints -> int32[N, L] Montgomery limbs."""
    raw = b"".join(
        ((x % spec.p) * spec.r_mont % spec.p).to_bytes(2 * spec.L, "little")
        for x in xs
    )
    limbs = np.frombuffer(raw, dtype="<u2").astype(np.int32)
    return limbs.reshape(len(xs), spec.L)


def unstack_mont(spec: FpSpec, arr) -> list:
    """int32[..., L] Montgomery limbs (tensor or array) -> flat host ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    flat = np.asarray(arr, dtype=np.int64).reshape(-1, spec.L)
    rinv = pow(spec.r_mont, -1, spec.p)
    return [int_from_limbs(row) * rinv % spec.p for row in flat]


# ---------------------------------------------------------------------------
# Constants on a device (cached: every op would otherwise copy them anew)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def const_limbs(spec: FpSpec, x: int, device: torch.device) -> torch.Tensor:
    """Raw (unreduced) int32[L] limb constant on ``device``; must not reduce
    mod p, because the modulus itself is encoded through this path."""
    assert 0 <= x < 1 << (16 * spec.L)
    limbs = [(x >> (16 * i)) & 0xFFFF for i in range(spec.L)]
    return torch.tensor(limbs, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _lookahead_consts(L: int, device: torch.device):
    """(2^i, i) for i < L: pack flags into bits, and unpack them again."""
    shifts = torch.arange(L, dtype=torch.int32, device=device)
    return torch.ones_like(shifts) << shifts, shifts


# ---------------------------------------------------------------------------
# Carry chains
# ---------------------------------------------------------------------------

def _carry_in(gen, reach):
    """Carry-in bit of each limb of a ripple, and the carry out of the top.

    ``gen`` ([..., L], 0/1) says that a limb makes a carry itself, ``reach``
    that it makes one or passes on the one it receives (gen ⊆ reach). As
    bits of G and X, the ripple is the carry chain of the binary sum X + G,
    so the carries are (X + G) xor X xor G.
    """
    L = gen.shape[-1]
    weight, shifts = _lookahead_consts(L, gen.device)
    G = (gen * weight).sum(-1, dtype=torch.int32)
    X = (reach * weight).sum(-1, dtype=torch.int32)
    c = (X + G) ^ X ^ G
    return (c.unsqueeze(-1) >> shifts) & 1, c >> L


def _add_limbs(a, b):
    """a + b over 16-bit limbs -> (limbs[..., L], carry out[...] in {0,1}).

    A limb sum s < 2^17 makes a carry when s ≥ 2^16 and passes one on when
    s = 2^16 − 1, i.e. it reaches the next limb when s + 1 ≥ 2^16."""
    s = a + b
    cin, over = _carry_in(s >> 16, (s + 1) >> 16)
    return (s + cin) & MASK16, over


def _sub_limbs(a, b):
    """a - b over 16-bit limbs -> (diff[..., L], borrow[...] in {0,1}).

    A limb difference d borrows when d < 0 and passes a borrow on when
    d = 0."""
    d = a - b
    bin_, borrow = _carry_in(d < 0, d <= 0)
    return (d - bin_) & MASK16, borrow


def select(cond, a, b):
    """Elementwise limb select; cond[...] broadcast over the limb axis."""
    return torch.where(cond.unsqueeze(-1), a, b)


def add(spec: FpSpec, a, b):
    """(a + b) mod p, canonical-limb inputs/outputs."""
    s, over = _add_limbs(a, b)
    d, borrow = _sub_limbs(s, const_limbs(spec, spec.p, s.device))
    return select(over >= borrow, d, s)  # over, borrow ∈ {0, 1}


def sub(spec: FpSpec, a, b):
    """(a - b) mod p."""
    d, borrow = _sub_limbs(a, b)
    d2, _ = _add_limbs(d, const_limbs(spec, spec.p, d.device))
    return select(borrow != 0, d2, d)


def neg(spec: FpSpec, a):
    d, _ = _sub_limbs(const_limbs(spec, spec.p, a.device), a)
    return select(is_zero(spec, a), torch.zeros_like(a), d)  # -0 stays 0


def is_zero(spec: FpSpec, a):
    return (a == 0).all(-1)


def eq(spec: FpSpec, a, b):
    return (a == b).all(-1)


def one(spec: FpSpec, shape, device):
    """Montgomery-form 1 broadcast to the given batch shape."""
    base = const_limbs(spec, spec.one_mont, torch.device(device))
    return base.expand(tuple(shape) + (spec.L,))


def zero(spec: FpSpec, shape, device):
    return torch.zeros(tuple(shape) + (spec.L,), dtype=torch.int32,
                       device=device)


# ---------------------------------------------------------------------------
# Products and powers: kernel on CUDA, plain version on the CPU
# ---------------------------------------------------------------------------

def on_card(a) -> bool:
    """True for a CUDA tensor (its kernel runs), False for a CPU tensor (its
    plain version runs); any other device raises."""
    if a.device.type == "cuda":
        return True
    if a.device.type == "cpu":
        return False
    raise RuntimeError(f"no Montgomery kernel for device {a.device}")


def mul(spec: FpSpec, a, b):
    """Montgomery product a·b·R⁻¹ mod p over broadcast batch dims."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a = a.reshape(-1, spec.L).contiguous()
    b = b.reshape(-1, spec.L).contiguous()
    if on_card(a):
        # the kernel copies whole tiles from 16-byte boundaries: a view
        # off one (a flat view at an odd offset) goes to it as a copy
        a = a if a.data_ptr() % 16 == 0 else a.clone()
        b = b if b.data_ptr() % 16 == 0 else b.clone()
        out = cuda_mont.mont_mul(spec, a, b)
    else:
        out = cuda_mont.mul_ref(spec, a, b)
    return out.reshape(shape)


def sqr(spec: FpSpec, a):
    return mul(spec, a, a)


def mul_small(spec: FpSpec, a, k: int):
    """a * k for tiny static k (via repeated addition tree)."""
    assert 0 <= k
    if k == 0:
        return torch.zeros_like(a)
    result = None
    acc = a
    while k:
        if k & 1:
            result = acc if result is None else add(spec, result, acc)
        k >>= 1
        if k:
            acc = add(spec, acc, acc)
    return result


def pow_fixed(spec: FpSpec, a, e: int):
    """a^e for a fixed public exponent (MSB-first square-and-multiply)."""
    if e == 0:
        return one(spec, a.shape[:-1], a.device).clone()
    shape = a.shape
    a = a.reshape(-1, spec.L).contiguous()
    if on_card(a):
        out = cuda_mont.mont_pow(spec, a, e)
    else:
        out = cuda_mont.pow_fixed_ref(spec, a, e)
    return out.reshape(shape)


def inv(spec: FpSpec, a):
    """a^(p-2): Fermat inverse, mapping 0 -> 0."""
    return pow_fixed(spec, a, spec.p - 2)
