"""B1 and B2's lane bodies (``csrc/mont.cu`` over ``csrc/ladder_engine.cuh``'s
carry-save product and square), compiled for the host, against the plain
versions and Python ints.

g++ compiles ``mont.cu`` with CUDA's qualifiers defined away; its kernels and
launchers (inside ``#if defined(__CUDACC__)``) drop out, and the lane bodies
run as plain C++ (the carry flag a variable of ``tc::reg::Chain``). A serial
loop over a block's threads stands in for the block:

* B1: the block's rows of a and b come into its tiles (on the card one
  bulk copy a tile), each live thread runs ``mul_row`` on its row, then
  each thread stores its 16-byte chunks; lanes past n are neither loaded,
  computed nor stored. Bit-exact against ``mul_ref``
  and a·b·R⁻¹ mod m, Fq and Fr, at 1 lane, a block plus a ragged tail and
  two blocks, on the edge values 0, 1, m − 1 and R mod m.
* B2: ``pow_lane`` per thread, the odd powers in a block-wide table laid
  out as shared memory holds it (word-major, the thread fastest), on the
  chain ``cuda_mont.pow_chain`` builds for the wrapper; and
  ``pow_group_thread``, one lane over G = 2 or 4 threads, G host threads
  standing in for the group's lanes of a warp (each shuffle a barrier, a
  slot per thread, a barrier). Bit-exact against
  ``pow_fixed_ref`` and Python's ``pow`` for p − 2, (p − 1)/2, (p − 3)/4,
  r − 2, 1, 2, 3, 2^k, 2^k − 1 and a random 64-bit e; inv(0) = 0.
* The dedicated square against the product a·a and Python ints.
* The chain: its windows recompose e; a chain with one digit swapped or
  one odd power dropped gives another result (a mutation check of the
  comparison above).

Every comparison is exact. The PTX form runs only on the card:
``chip_smoke.py`` phase 3 holds the kernels bit-exact against their plain
versions at the paths' widths.
"""

import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from threshold_crypto_tpu_torch import _build
from threshold_crypto_tpu_torch.device import cuda_mont, mont

HARNESS = r"""
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

// A warp's shuffles for G host threads that run one lane group: each puts
// its value in its slot, all wait, each reads the source's slot, all wait.
static std::barrier<>* g_bar = nullptr;
static uint32_t g_slot[32];
static thread_local int tl_lane = 0;
static uint32_t exch(uint32_t v, int src) {
  g_slot[tl_lane] = v;
  g_bar->arrive_and_wait();
  const uint32_t r = g_slot[src];
  g_bar->arrive_and_wait();
  return r;
}
uint32_t __shfl_sync(unsigned, uint32_t v, int src) { return exch(v, src); }
uint32_t __shfl_up_sync(unsigned, uint32_t v, unsigned d, int w) {
  const int l = tl_lane;
  return exch(v, l % w >= int(d) ? l - int(d) : l);
}
uint32_t __shfl_down_sync(unsigned, uint32_t v, unsigned d, int w) {
  const int l = tl_lane;
  return exch(v, l % w + int(d) < w ? l + int(d) : l);
}

#include "mont.cu"

// Runs body(g) on G host threads, thread g as lane g of a warp.
template <class F>
void on_group(int G, F body) {
  std::barrier<> bar(G);
  g_bar = &bar;
  std::vector<std::thread> ts;
  for (int g = 0; g < G; ++g)
    ts.emplace_back([g, &body] {
      tl_lane = g;
      body(g);
    });
  for (auto& t : ts) t.join();
}

// stdin: int32 op, words, n, then the op's header and inputs; stdout: the
// output, int32.
static std::vector<int32_t> rd(size_t count) {
  std::vector<int32_t> v(count);
  if (fread(v.data(), 4, count, stdin) != count) exit(3);
  return v;
}

static void put(const std::vector<int32_t>& v) {
  fwrite(v.data(), 4, v.size(), stdout);
}

// B1 over n lanes: blocks of kTile threads; the block's rows of a and b
// come into its tiles (one bulk copy each on the card), each live thread
// runs its lane, and every thread stores its 16-byte chunks.
template <class Fd>
void mul(int n) {
  using tc::mnt::Tile;
  constexpr int L = Tile<Fd>::kLimbs;
  auto a = rd(size_t(L) * n), b = rd(size_t(L) * n);
  std::vector<int32_t> out(size_t(L) * n, -1);
  const int T = tc::mnt::kTile;
  for (int base = 0; base < n; base += T) {
    const int lanes = n - base < T ? n - base : T;
    const size_t off = size_t(base) * L;
    std::vector<int32_t> ta(Tile<Fd>::kSize, -7), tb(Tile<Fd>::kSize, -7);
    tc::mnt::copy_tile_in<Fd>(ta.data(), a.data() + off, lanes, nullptr);
    tc::mnt::copy_tile_in<Fd>(tb.data(), b.data() + off, lanes, nullptr);
    for (int t = 0; t < T; ++t)
      if (t < lanes) tc::mnt::mul_row<Fd>(ta.data(), tb.data(), t);
    for (int t = 0; t < T; ++t)
      tc::mnt::stage_out<Fd>(out.data() + off, ta.data(), lanes, t, T);
  }
  put(out);
}

// B2 over n lanes: blocks of `threads`, one table a block.
template <class Fd>
void pow_lanes(int n) {
  constexpr int S = Fd::kWords;
  auto head = rd(3);
  const int threads = head[0], nsteps = head[1], entries = head[2];
  auto steps = rd(nsteps);
  auto a = rd(size_t(2 * S) * n);
  tc::mnt::PowChain ch;
  ch.steps = nsteps;
  ch.entries = entries;
  for (int k = 0; k < nsteps; ++k) ch.step[k] = uint16_t(steps[k]);
  std::vector<int32_t> out(size_t(2 * S) * n);
  std::vector<uint32_t> tab(size_t(entries) * S * threads);
  for (int lane = 0; lane < n; ++lane) {
    uint32_t base[S], acc[S];
    const int t = lane % threads;
    tc::load_row<S>(a.data() + size_t(2 * S) * lane, base);
    tc::mnt::pow_lane<Fd>(acc, base, ch, tab.data() + t, threads);
    tc::store_row<S>(out.data() + size_t(2 * S) * lane, acc);
  }
  put(out);
}

// The square and the product a·a of n values of S words.
template <class Fd>
void sqr(int n) {
  constexpr int S = Fd::kWords;
  auto a = rd(size_t(S) * n);
  std::vector<int32_t> out;
  for (int l = 0; l < n; ++l) {
    uint32_t x[S], s[S], m[S];
    for (int j = 0; j < S; ++j) x[j] = uint32_t(a[size_t(S) * l + j]);
    tc::reg::mont_sqr_words<Fd>(s, x);
    tc::reg::mont_mul_words<Fd>(m, x, x);
    for (int j = 0; j < S; ++j) out.push_back(int32_t(s[j]));
    for (int j = 0; j < S; ++j) out.push_back(int32_t(m[j]));
  }
  put(out);
}

template <class Fd>
void constants() {
  std::vector<int32_t> out;
  for (int j = 0; j < Fd::kWords; ++j) out.push_back(int32_t(Fd::p(j)));
  for (int j = 0; j < Fd::kWords; ++j) out.push_back(int32_t(Fd::one(j)));
  out.push_back(int32_t(Fd::kN0));
  out.push_back(tc::mnt::is_modulus<Fd>(
      reinterpret_cast<const uint32_t*>(out.data())));
  out.push_back(tc::mnt::kGroup);
  out.push_back(tc::mnt::kMaxSteps);
  out.push_back(tc::mnt::kEntryBits);
  out.push_back(tc::mnt::kNoEntry);
  out.push_back(tc::mnt::kMaxEntries);
  put(out);
}

// B2 over n lanes, one lane over G threads: the G threads of a group run
// every lane in turn, each lane's table its own.
template <class Fd, int G>
void pow_group_lanes(int n) {
  constexpr int S = Fd::kWords;
  auto head = rd(3);
  const int nsteps = head[1], entries = head[2];
  auto steps = rd(nsteps);
  auto a = rd(size_t(2 * S) * n);
  tc::mnt::PowChain ch;
  ch.steps = nsteps;
  ch.entries = entries;
  for (int k = 0; k < nsteps; ++k) ch.step[k] = uint16_t(steps[k]);
  std::vector<int32_t> out(size_t(2 * S) * n, -1);
  std::vector<uint32_t> tab(size_t(entries) * S * n);
  on_group(G, [&](int g) {
    for (int lane = 0; lane < n; ++lane)
      tc::mnt::pow_group_thread<Fd, G>(
          a.data() + size_t(2 * S) * lane, out.data() + size_t(2 * S) * lane,
          ch, tab.data() + size_t(entries) * S * lane, 1, g, 0);
  });
  put(out);
}

// The group product of n pairs of S-word values.
template <class Fd, int G>
void group_mul_pairs(int n) {
  constexpr int S = Fd::kWords, K = S / G;
  auto a = rd(size_t(S) * n), b = rd(size_t(S) * n);
  std::vector<int32_t> out(size_t(S) * n);
  on_group(G, [&](int g) {
    uint32_t pw[K];
    for (int j = 0; j < K; ++j) pw[j] = Fd::p(g * K + j);
    for (int l = 0; l < n; ++l) {
      uint32_t x[K], y[K], r[K];
      for (int j = 0; j < K; ++j) {
        x[j] = uint32_t(a[size_t(S) * l + g * K + j]);
        y[j] = uint32_t(b[size_t(S) * l + g * K + j]);
      }
      tc::mnt::group_mul<Fd, G>(r, x, y, pw, g, 0);
      for (int j = 0; j < K; ++j)
        out[size_t(S) * l + g * K + j] = int32_t(r[j]);
    }
  });
  put(out);
}

template <class Fd>
void run(int op, int n) {
  if (op == 0) mul<Fd>(n);
  else if (op == 2) pow_lanes<Fd>(n);
  else if (op == 3) sqr<Fd>(n);
  else if (op == 5) pow_group_lanes<Fd, 2>(n);
  else if (op == 6) pow_group_lanes<Fd, 4>(n);
  else if (op == 7) group_mul_pairs<Fd, 2>(n);
  else if (op == 8) group_mul_pairs<Fd, 4>(n);
  else constants<Fd>();
}

int main() {
  int32_t h[3];
  if (fread(h, 4, 3, stdin) != 3) return 2;
  if (h[1] == 12) run<tc::mnt::FqField>(h[0], h[2]);
  else run<tc::mnt::FrField>(h[0], h[2]);
  return 0;
}
"""

OPS = {"mul": 0, "pow": 2, "sqr": 3, "constants": 4,
       "pow_g2": 5, "pow_g4": 6, "mul_g2": 7, "mul_g4": 8}
FIELDS = {"Fq": mont.FQ, "Fr": mont.FR}
P, R = mont.FQ.p, mont.FR.p
TILE = 128        # csrc/mont.cu kTile
POW_THREADS = 32  # the block the B2 lanes are laid out in here


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel sources for the host")
    d = tmp_path_factory.mktemp("csrc_mont")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = str(d / "harness")
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-I",
                    _build.CSRC, str(src), "-o", exe], check=True,
                   capture_output=True, timeout=300)
    return exe


def _run(exe, op, spec, n, blobs):
    head = np.array([OPS[op], spec.L // 2, n], np.int32).tobytes()
    proc = subprocess.run([exe], input=head + b"".join(blobs),
                          capture_output=True, timeout=120, check=True)
    return np.frombuffer(proc.stdout, np.int32).copy()


def _limbs(spec, xs):
    """Field values (taken as they are: Montgomery forms) as int32[n, L]."""
    return torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(spec.L)]
                         for x in xs], dtype=torch.int32)


def _ints(spec, t):
    return [sum(int(v) << (16 * i) for i, v in enumerate(row))
            for row in t.reshape(-1, spec.L).tolist()]


def _values(spec, n, rnd):
    """n values < m: the edge values 0, 1, m − 1, R mod m first, then
    seeded ones (one lane: a seeded one)."""
    edge = [0, 1, spec.p - 1, spec.r_mont] if n > 1 else []
    return (edge + [rnd.randrange(spec.p) for _ in range(n)])[:n]


@pytest.mark.parametrize("field", FIELDS)
def test_engine_constants_are_the_field_constants(harness, field):
    spec = FIELDS[field]
    S = spec.L // 2
    got = _run(harness, "constants", spec, 0, []).view(np.uint32).tolist()
    words = [(spec.p >> (32 * j)) & 0xFFFFFFFF for j in range(S)]
    assert got[:S] == words
    assert got[S:2 * S] == [(spec.r_mont >> (32 * j)) & 0xFFFFFFFF
                            for j in range(S)]
    assert got[2 * S] == (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    assert got[2 * S + 1] == 1
    assert list(cuda_mont._modulus_arg(spec)) == words
    # the wrapper's constants are the kernel's
    assert got[2 * S + 2:] == [cuda_mont.GROUP, cuda_mont.MAX_STEPS,
                               cuda_mont.ENTRY_BITS, cuda_mont.NO_ENTRY,
                               cuda_mont.MAX_ENTRIES]
    assert 1 << (cuda_mont.WINDOW - 1) <= cuda_mont.MAX_ENTRIES


@pytest.mark.parametrize("n", [1, 5, TILE, TILE + 37, 2 * TILE])
@pytest.mark.parametrize("field", FIELDS)
def test_mul_body_matches_plain_version(harness, field, n):
    """B1 at 1 lane, a ragged block, a block, a block and a ragged tail,
    and two blocks: equal to mul_ref and a·b·R⁻¹ mod m, every lane
    written, nothing past n."""
    spec = FIELDS[field]
    rnd = random.Random(0xB1 + n + spec.L)
    xs = _values(spec, n, rnd)
    ys = _values(spec, n, rnd)[::-1]
    a, b = _limbs(spec, xs), _limbs(spec, ys)
    got = _run(harness, "mul", spec, n, [a.numpy().tobytes(),
                                         b.numpy().tobytes()])
    assert got.size == n * spec.L
    want = cuda_mont.mul_ref(spec, a, b)
    assert np.array_equal(got, want.numpy().reshape(-1))
    rinv = pow(1 << (16 * spec.L), -1, spec.p)
    assert _ints(spec, torch.from_numpy(got)) == [
        x * y * rinv % spec.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("field", FIELDS)
def test_square_equals_product(harness, field):
    """mont_sqr_words(a) == mont_mul_words(a, a) == a²·R⁻¹ mod m, bit for
    bit, on the edge values and seeded ones (the top words set too)."""
    spec = FIELDS[field]
    S = spec.L // 2
    rnd = random.Random(0x5A + S)
    xs = _values(spec, 64, rnd) + [spec.p - 1 - rnd.randrange(1 << 40)
                                   for _ in range(16)]
    words = np.array([[(x >> (32 * j)) & 0xFFFFFFFF for j in range(S)]
                      for x in xs], np.uint32)
    got = _run(harness, "sqr", spec, len(xs), [words.tobytes()])
    got = got.view(np.uint32).reshape(len(xs), 2, S)
    assert np.array_equal(got[:, 0], got[:, 1])
    rinv = pow(1 << (32 * S), -1, spec.p)
    assert [sum(int(w) << (32 * j) for j, w in enumerate(row))
            for row in got[:, 0]] == [x * x * rinv % spec.p for x in xs]


def _pow(harness, spec, e, xs, chain=None, group=1):
    """B2's lanes: one thread a lane (group 1, blocks of POW_THREADS) or a
    lane over `group` threads."""
    steps, nsteps, entries = chain or cuda_mont.pow_chain(spec, e)
    head = np.array([POW_THREADS, nsteps, entries], np.int32)
    op = "pow" if group == 1 else f"pow_g{group}"
    return torch.from_numpy(_run(harness, op, spec, len(xs), [
        head.tobytes(), np.array(list(steps)[:nsteps], np.int32).tobytes(),
        _limbs(spec, xs).numpy().tobytes()]).reshape(len(xs), spec.L))


def _pow_host(spec, xs, e):
    """Montgomery forms xs -> (x·R⁻¹)^e·R mod m."""
    r, rinv = spec.r_mont, pow(spec.r_mont, -1, spec.p)
    return [pow(x * rinv % spec.p, e, spec.p) * r % spec.p for x in xs]


EXPONENTS = {
    "Fq": {"p-2": P - 2, "(p-1)/2": (P - 1) // 2, "(p-3)/4": (P - 3) // 4,
           "r-2": R - 2},
    "Fr": {"r-2": R - 2, "(r-1)/2": (R - 1) // 2},
}
SMALL = {"1": 1, "2": 2, "3": 3, "2^64": 1 << 64, "2^64-1": (1 << 64) - 1,
         "2^200": 1 << 200, "2^255-1": (1 << 255) - 1,
         "e64": random.Random(0xE64).getrandbits(64) | 1 << 63}


@pytest.mark.parametrize("e", sorted(SMALL))
@pytest.mark.parametrize("field", FIELDS)
def test_pow_body_small_and_structured_exponents(harness, field, e):
    """1, 2, 3, 2^k, 2^k − 1 and a random 64-bit e, at a block and a ragged
    tail: equal to Python's pow on every lane, pow_fixed_ref on 8."""
    spec, e = FIELDS[field], SMALL[e]
    n = POW_THREADS + 5
    xs = _values(spec, n, random.Random(e % 1000 + spec.L))
    got = _pow(harness, spec, e, xs)
    assert _ints(spec, got) == _pow_host(spec, xs, e)
    a = _limbs(spec, xs[:8])
    assert torch.equal(got[:8], cuda_mont.pow_fixed_ref(spec, a, e))


@pytest.mark.parametrize("n", [1, POW_THREADS + 5, 2 * POW_THREADS])
@pytest.mark.parametrize("fe", [(f, k) for f in EXPONENTS
                                for k in EXPONENTS[f]],
                         ids=lambda fe: f"{fe[0]}-{fe[1]}")
def test_pow_body_path_exponents(harness, fe, n):
    """The paths' exponents at 1 lane, a block and a ragged tail, and two
    blocks: Python's pow on every lane, pow_fixed_ref on 4, inv(0) = 0."""
    field, name = fe
    spec, e = FIELDS[field], EXPONENTS[field][name]
    xs = _values(spec, n, random.Random(n + spec.L + len(name)))
    got = _pow(harness, spec, e, xs)
    assert _ints(spec, got) == _pow_host(spec, xs, e)
    k = min(n, 4)
    assert torch.equal(got[:k], cuda_mont.pow_fixed_ref(
        spec, _limbs(spec, xs[:k]), e))
    if e == spec.p - 2 and n > 1:
        assert xs[0] == 0 and _ints(spec, got)[0] == 0


@pytest.mark.parametrize("field", FIELDS)
def test_pow_body_reduces_long_exponents(harness, field):
    """e ≥ m goes through e mod (m − 1), m − 1 where that is 0: the same
    a^e for every a, 0 included."""
    spec = FIELDS[field]
    xs = _values(spec, 12, random.Random(0x1E))
    for e in (spec.p + 5, 3 * (spec.p - 1), (1 << 400) + 12345):
        assert _ints(spec, _pow(harness, spec, e, xs)) == \
            _pow_host(spec, xs, e)


@pytest.mark.parametrize("window", [1, 4, 5])
def test_windows_recompose_the_exponent(window):
    """Each window starts and ends with a 1 and spans at most `window`
    bits; folding the chain gives e back."""
    exps = [*EXPONENTS["Fq"].values(), *EXPONENTS["Fr"].values(),
            *SMALL.values()]
    for e in exps:
        steps = cuda_mont.pow_windows(e, window)
        acc = 0
        for i, (sq, v) in enumerate(steps):
            assert (sq == 0) == (i == 0)
            if v is not None:
                assert v % 2 == 1 and v.bit_length() <= window
            acc = (acc << sq) + (v or 0)
        assert acc == e
        assert steps[-1][1] is not None or e % 2 == 0


def test_chain_encoding_and_limits():
    """pow_chain's words are squarings << 5 | (v − 1)/2 (31: none); p − 2
    takes 68 steps and 16 odd powers at w = 5."""
    steps, n, entries = cuda_mont.pow_chain(mont.FQ, P - 2)
    windows = cuda_mont.pow_windows(P - 2)
    assert (n, entries) == (len(windows), 16) == (68, 16)
    assert list(steps) == [s << 5 | (31 if v is None else (v - 1) // 2)
                           for s, v in windows]
    steps, n, entries = cuda_mont.pow_chain(mont.FQ, 2)
    assert list(steps) == [0, 1 << 5 | 31] and entries == 1
    with pytest.raises(ValueError):
        cuda_mont.pow_windows(0)


def test_mutated_chain_is_caught(harness):
    """The comparison above fails for a chain with two digits swapped or
    with its last odd power dropped (its digits then read a slot no one
    wrote, or the wrong one)."""
    spec, e = mont.FQ, P - 2
    xs = _values(spec, 8, random.Random(0x3D))[1:]         # no zero lane
    want = _pow_host(spec, xs, e)
    steps, n, entries = cuda_mont.pow_chain(spec, e)
    words = list(steps)
    i = next(k for k in range(1, n - 1)
             if words[k] & 31 != words[k + 1] & 31)
    swapped = list(words)
    swapped[i] = (words[i] & ~31) | (words[i + 1] & 31)
    swapped[i + 1] = (words[i + 1] & ~31) | (words[i] & 31)
    assert _ints(spec, _pow(harness, spec, e, xs,
                            (swapped, n, entries))) != want
    top = max(w & 31 for w in words if w & 31 != 31)
    dropped = [(w & ~31) | (top - 1) if w & 31 == top else w for w in words]
    assert _ints(spec, _pow(harness, spec, e, xs,
                            (dropped, n, entries - 1))) != want
    assert _ints(spec, _pow(harness, spec, e, xs)) == want


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("field", FIELDS)
def test_group_product_matches_python_ints(harness, field, group):
    """The lane-group product (words dealt over G threads, shuffles
    emulated by host threads) = a·b·R⁻¹ mod m, canonical, on the edge
    values and seeded pairs."""
    spec = FIELDS[field]
    S = spec.L // 2
    rnd = random.Random(0x6A + S + group)
    xs = _values(spec, 40, rnd) + [spec.p - 1 - rnd.randrange(1 << 40)
                                   for _ in range(8)]
    ys = xs[::-1]
    words = [np.array([[(x >> (32 * j)) & 0xFFFFFFFF for j in range(S)]
                       for x in v], np.uint32).tobytes() for v in (xs, ys)]
    got = _run(harness, f"mul_g{group}", spec, len(xs), words)
    got = got.view(np.uint32).reshape(len(xs), S)
    rinv = pow(1 << (32 * S), -1, spec.p)
    assert [sum(int(w) << (32 * j) for j, w in enumerate(row))
            for row in got] == [x * y * rinv % spec.p for x, y in zip(xs, ys)]


GROUP_EXPONENTS = {"p-2": (mont.FQ, P - 2), "(p-1)/2": (mont.FQ, (P - 1) // 2),
                   "r-2": (mont.FR, R - 2), "3": (mont.FQ, 3),
                   "2^64-1": (mont.FR, (1 << 64) - 1)}


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("name", sorted(GROUP_EXPONENTS))
def test_pow_group_body(harness, name, group):
    """B2 over a lane group (the package's G = 4, up to 8192 lanes; G = 2
    in tools/mont_variants.py): Python's pow on every lane, pow_fixed_ref
    on 2, inv(0) = 0; at 1 lane too."""
    spec, e = GROUP_EXPONENTS[name]
    xs = _values(spec, 5, random.Random(0x6B + group + len(name)))
    got = _pow(harness, spec, e, xs, group=group)
    assert _ints(spec, got) == _pow_host(spec, xs, e)
    assert torch.equal(got[:2], cuda_mont.pow_fixed_ref(
        spec, _limbs(spec, xs[:2]), e))
    if e == spec.p - 2:
        assert _ints(spec, got)[0] == 0
    one = _values(spec, 1, random.Random(0x6C + group))
    assert _ints(spec, _pow(harness, spec, e, one, group=group)) == \
        _pow_host(spec, one, e)


def test_pow_group_choice():
    """G = 4 threads a lane up to 8192 Fq lanes (the RLC path's 1 and 512,
    the per-pair paths' 8192) and 4096 Fr lanes (the combine's), one above
    (the hash path's 65,536)."""
    widths = (1, 512, 4096, 4097, 8192, 8193, 65536)
    assert [cuda_mont.pow_group(mont.FQ, n) for n in widths] \
        == [4, 4, 4, 4, 4, 1, 1]
    assert [cuda_mont.pow_group(mont.FR, n) for n in widths] \
        == [4, 4, 4, 1, 1, 1, 1]
