// Montgomery product (B1) and fixed-exponent power (B2) over BLS12-381 Fq
// and Fr, for sm_90a, on B13's carry-save register product
// (csrc/ladder_engine.cuh `mont_mul_words` / `mont_sqr_words`, a template
// over the field: FqField, S = 12 words; FrField, S = 8).
//
// B1 `mont_mul_kernel` replaces threshold_crypto_tpu/device/pallas_mont.py
// `_mul_kernel`; B2 `mont_pow_kernel` and `mont_pow_group_kernel` (one
// launcher, the wrapper's choice from n) replace `_pow_kernel` there.
//
// Layout. A lane is an element as the Python side holds it: int32[L] of
// 16-bit limbs, least significant first (L = 2S: 24 for Fq, 16 for Fr),
// lanes row-major [N, L]. R = 2^(16 L) = 2^(32 S) either way, so the
// Montgomery form and the canonical output are bit-identical with the TPU
// kernel's. The moduli are the descriptors' constants; the launchers refuse
// a modulus argument that is not one of them.
//
// B1: what bounds it, and the design. One product per lane, 588 (264)
// 32-bit IMAD results against 3·96 (3·64) bytes: on an H100 SXM (3.35 TB/s;
// 64 IMAD results per clock per SM, 132 SMs at 1.98 GHz) the bytes take
// about 2.4× as long as the multiplies, so memory traffic bounds it. With
// one thread reading its own 96-byte row (fq.cuh's load_row, the kernel
// before this one) a warp's load touches 32 rows 96 bytes apart: 23 % of
// the bytes bound at 638,976 lanes. Here a block's 128 lanes of a and of b
// are one contiguous tile (12 KB each for Fq): one thread asks for each
// tile with one 1-D bulk copy (cp.async.bulk, completed on the block's
// mbarrier), so the whole of both is in flight at once and no register
// stages it. Each thread packs its rows from shared memory into words with
// 16-byte reads (rows 96 bytes apart: a 2-way bank conflict in each quarter
// warp), runs the register product and writes its row back into a's tile;
// the block stores the tile with 16-byte vector stores, neighbouring
// threads on neighbouring chunks. The pointers must be 16-byte aligned (the
// launcher refuses others). Lanes past n take part in both barriers and
// skip only the product and the stores. tools/mont_variants.py times it
// against a bulk copy a row into rows padded to L + 4 limbs (no bank
// conflict) and against 16-byte vector loads, padded or not: the tile copy
// was the fastest in both fields at both of the paths' widths.
//
// B2: what bounds it, and the design. a^e for a public e shared by all
// lanes: one chain of dependent products per lane, and on the RLC path the
// launches have 1 lane (three Fermat inversions) or 512: latency, not
// throughput, bounds it, i.e. the chain's length times one product's
// latency. The kernel before this one ran fq.cuh's CIOS, whose 64-bit carry
// threads all S words of a half-round in series, bit by bit (610 products
// for p − 2), reading each bit from device memory that the wrapper copied
// from the host on every call (a stream synchronisation). Here:
// * the carry-save product, whose S words of a step do not depend on one
//   another, and a dedicated square (S(S + 1)/2 word products, the same
//   reduction; bit for bit the product's a·a);
// * a sliding-window chain: the host cuts e into windows of at most w bits
//   that start and end with a 1 (w = 5 for the wrapper's exponents: 16 odd
//   powers a, a³, …, a³¹ built with one square and 15 products), and sends
//   the chain by value in the kernel's parameters (`PowChain`, 776 bytes:
//   per step its squarings and the odd power it multiplies by). For p − 2
//   that is 378 squares and 82 products with the table, against 381 and
//   229; no device memory is read for the exponent, and nothing is copied;
// * the odd powers in shared memory, word-major with the thread fastest
//   (the entry is warp-uniform, so a warp's reads are conflict-free);
// * where the card is mostly idle (the wrapper: up to 8192 lanes in Fq,
//   4096 in Fr, the crossovers tools/mont_variants.py measures), one lane
//   over a group of G = 4 threads of a warp, each holding S / 4 words and
//   exchanging b_i, q and the carry-save words by shuffles: the threads
//   share each product's multiply-adds, so the chain's latency falls; where
//   it is full (the hash path's 65,536 lanes), one thread a lane with the
//   dedicated square, no shuffles: there the multiply count bounds it (a
//   square 3S² + 2S IMAD results, a product 4S² + S, over the chain), and
//   it runs at about 1.7× that bound;
// * blocks of the largest of 128, 64 and 32 threads whose grid still has a
//   block for every SM (32 below 132 · 64 threads).
//
// Every launcher returns cudaGetLastError() after its launch; the Python
// wrapper raises if that is not 0.
//
// Off the card (g++ behind stub qualifiers, for the tests) the lane bodies
// above the kernels compile as plain C++, and a loop over a block's threads
// stands in for the block.

#include <cstdint>

#include "fq.cuh"  // load_row / store_row: a row of 2S limbs <-> S words
#include "ladder_engine.cuh"

namespace tc {
namespace mnt {

using reg::FqField;
using reg::FrField;

// ---------------------------------------------------------------------------
// B1: the staged tile
// ---------------------------------------------------------------------------

constexpr int kTile = 128;  // lanes (and threads) of a B1 block

template <class Fd>
struct Tile {
  static constexpr int kLimbs = 2 * Fd::kWords;  // L
  static constexpr int kRow = kLimbs;             // a row in shared memory
  static constexpr int kSize = kTile * kRow;      // limbs of one tile
};

// Four limbs, one 16-byte access on the card (p 16-byte aligned).
struct Limb4 {
  int32_t x, y, z, w;
};

__device__ __forceinline__ Limb4 load4(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  const int4 v = *reinterpret_cast<const int4*>(p);
  return Limb4{v.x, v.y, v.z, v.w};
#else
  return Limb4{p[0], p[1], p[2], p[3]};
#endif
}

__device__ __forceinline__ void store4(int32_t* p, const Limb4& v) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<int4*>(p) = make_int4(v.x, v.y, v.z, v.w);
#else
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
#endif
}

// The first `lanes` rows of a block's tile, from device memory to shared
// memory: on the card one 1-D bulk copy (cp.async.bulk) of lanes·L limbs
// that completes on the block's mbarrier `bar`; both addresses and the
// size are multiples of 16 bytes (the launcher checks the pointers).
template <class Fd>
__device__ __forceinline__ void copy_tile_in(int32_t* tile,
                                             const int32_t* src, int lanes,
                                             uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(tile))),
         "l"(src), "r"(lanes * Tile<Fd>::kLimbs * 4),
         "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar)))
      : "memory");
#else
  (void)bar;
  for (int k = 0; k < lanes * Tile<Fd>::kLimbs; ++k) tile[k] = src[k];
#endif
}

// The block's mbarrier: armed by one thread for `bytes` of bulk copies,
// then waited on (phase 0) by every thread. No-ops off the card.
__device__ __forceinline__ void bar_arm(uint64_t* bar, int bytes) {
#if defined(__CUDA_ARCH__)
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
#else
  (void)bar;
  (void)bytes;
#endif
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done)
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(b) : "memory");
#else
  (void)bar;
#endif
}

// Thread `tid` of `threads` stores its share of the first `lanes` rows of
// the tile to dst (device memory): 16-byte chunks, neighbouring threads on
// neighbouring chunks.
template <class Fd>
__device__ __forceinline__ void stage_out(int32_t* dst, const int32_t* tile,
                                          int lanes, int tid, int threads) {
  const int chunks = lanes * (Tile<Fd>::kLimbs / 4);
#pragma unroll 1
  for (int c = tid; c < chunks; c += threads)
    store4(dst + 4 * c, load4(tile + 4 * c));
}

// A row of 2S limbs in shared memory <-> S words (only the low 16 bits of
// each limb are read), in 16-byte pieces.
template <int S>
__device__ __forceinline__ void read_row(uint32_t (&x)[S],
                                         const int32_t* row) {
#pragma unroll
  for (int k = 0; k < S / 2; ++k) {
    const Limb4 v = load4(row + 4 * k);
    x[2 * k] = (static_cast<uint32_t>(v.x) & 0xFFFFu) |
               (static_cast<uint32_t>(v.y) << 16);
    x[2 * k + 1] = (static_cast<uint32_t>(v.z) & 0xFFFFu) |
                   (static_cast<uint32_t>(v.w) << 16);
  }
}

template <int S>
__device__ __forceinline__ void write_row(int32_t* row,
                                          const uint32_t (&x)[S]) {
#pragma unroll
  for (int k = 0; k < S / 2; ++k)
    store4(row + 4 * k, Limb4{static_cast<int32_t>(x[2 * k] & 0xFFFFu),
                              static_cast<int32_t>(x[2 * k] >> 16),
                              static_cast<int32_t>(x[2 * k + 1] & 0xFFFFu),
                              static_cast<int32_t>(x[2 * k + 1] >> 16)});
}

// B1's lane: row tid of the a tile <- a·b·R^-1 (rows of the tiles).
template <class Fd>
__device__ __forceinline__ void mul_row(int32_t* ta, const int32_t* tb,
                                        int tid) {
  constexpr int S = Fd::kWords;
  uint32_t x[S], y[S];
  read_row<S>(x, ta + tid * Tile<Fd>::kRow);
  read_row<S>(y, tb + tid * Tile<Fd>::kRow);
  reg::mont_mul_words<Fd>(x, x, y);
  write_row<S>(ta + tid * Tile<Fd>::kRow, x);
}

// ---------------------------------------------------------------------------
// B2: the chain
// ---------------------------------------------------------------------------

constexpr int kMaxSteps = 384;      // a step per window; e < 2^381
constexpr int kMaxEntries = 16;     // odd powers a, a³, …, a³¹ (w = 5)
constexpr int kNoEntry = 31;        // a step of squarings only
constexpr int kEntryBits = 5;

// The exponent as the kernel takes it, by value: step 0 sets acc to the odd
// power a^(2·entry + 1) (its squarings are 0); each later step squares acc
// `step >> 5` times, then multiplies it by odd power `step & 31` unless that
// is kNoEntry.
struct PowChain {
  int steps;
  int entries;  // odd powers the chain reads: a^1 … a^(2·entries − 1)
  uint16_t step[kMaxSteps];
};

// Odd power e of the lane's table, word j: tab[(e·S + j)·stride].
template <int S>
__device__ __forceinline__ void entry_load(uint32_t (&x)[S],
                                           const uint32_t* tab, int stride,
                                           int e) {
#pragma unroll
  for (int j = 0; j < S; ++j) x[j] = tab[(e * S + j) * stride];
}

template <int S>
__device__ __forceinline__ void entry_store(uint32_t* tab, int stride, int e,
                                            const uint32_t (&x)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) tab[(e * S + j) * stride] = x[j];
}

// acc = base^e for the chain of e; tab: this lane's table slots.
template <class Fd>
__device__ __forceinline__ void pow_lane(uint32_t (&acc)[Fd::kWords],
                                         const uint32_t (&base)[Fd::kWords],
                                         const PowChain& ch, uint32_t* tab,
                                         int stride) {
  constexpr int S = Fd::kWords;
  uint32_t sq[S], x[S];
  entry_store<S>(tab, stride, 0, base);
  reg::mont_sqr_words<Fd>(sq, base);
#pragma unroll
  for (int j = 0; j < S; ++j) x[j] = base[j];
#pragma unroll 1
  for (int e = 1; e < ch.entries; ++e) {
    reg::mont_mul_words<Fd>(x, x, sq);
    entry_store<S>(tab, stride, e, x);
  }
  entry_load<S>(acc, tab, stride, ch.step[0] & kNoEntry);
#pragma unroll 1
  for (int k = 1; k < ch.steps; ++k) {
    const int step = ch.step[k];
    const int e = step & kNoEntry;
#pragma unroll 1
    for (int i = step >> kEntryBits; i > 0; --i)
      reg::mont_sqr_words<Fd>(acc, acc);
    if (e != kNoEntry) {
      entry_load<S>(x, tab, stride, e);
      reg::mont_mul_words<Fd>(acc, acc, x);
    }
  }
}

// ---------------------------------------------------------------------------
// B2 over a lane group: one lane over G threads of a warp
// ---------------------------------------------------------------------------
//
// Thread g of a group holds words g·K … g·K + K − 1 (K = S / G) of every
// value, and the last thread the top word S of the running sum. A round of
// the product: b_i from the thread that holds it; the step t += a·b_i; the
// high word of each thread's last word to the next thread; q = t_0·n0 from
// thread 0; the step t += q·m; the shift, t from the next thread (the high
// words stay where they are). At the end every thread gathers t and h and
// runs the carry chain and the subtract, keeping its own words: a product
// makes 4 shuffles a round and 2S at the end. Squares go through the
// product. Every thread of the warp takes part in every shuffle (lanes past
// n run on lane 0's value and store nothing).

constexpr int kGroup = 4;  // threads a lane of the group kernel

template <class Fd, int G>
struct Group {
  static constexpr int S = Fd::kWords;
  static constexpr int K = S / G;
  static_assert(S % G == 0, "the group must divide the words");
};

template <class Fd, int G>
__device__ __forceinline__ void group_mul(
    uint32_t (&r)[Group<Fd, G>::K], const uint32_t (&a)[Group<Fd, G>::K],
    const uint32_t (&b)[Group<Fd, G>::K],
    const uint32_t (&pw)[Group<Fd, G>::K], int g, int lead) {
  constexpr int S = Fd::kWords, K = Group<Fd, G>::K;
  constexpr unsigned kAll = 0xffffffffu;
  const bool last = g == G - 1;
  uint32_t t[K + 1], h[K + 1], hn[K + 1];
#pragma unroll
  for (int j = 0; j <= K; ++j) t[j] = h[j] = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const uint32_t bi = __shfl_sync(kAll, b[i % K], lead + i / K);
    hn[0] = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      reg::mad_wide(t[j], hn[j + 1], a[j], bi, t[j], h[j]);
    if (last) t[K] += h[K];
    const uint32_t up = __shfl_up_sync(kAll, hn[K], 1, G);
    h[0] = g == 0 ? 0u : up;
#pragma unroll
    for (int j = 1; j < K; ++j) h[j] = hn[j];
    h[K] = last ? hn[K] : 0u;
    const uint32_t q = __shfl_sync(kAll, t[0], lead) * Fd::kN0;
    hn[0] = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      reg::mad_wide(t[j], hn[j + 1], pw[j], q, t[j], h[j]);
    if (last) t[K] += h[K];
    const uint32_t tn = __shfl_down_sync(kAll, t[0], 1, G);
#pragma unroll
    for (int j = 0; j < K - 1; ++j) t[j] = t[j + 1];
    t[K - 1] = last ? t[K] : tn;
    t[K] = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) h[j] = hn[j + 1];
    h[K] = 0;
  }
  uint32_t ft[S + 1], fh[S + 1], fr[S];
#pragma unroll
  for (int w = 0; w < S; ++w) {
    ft[w] = __shfl_sync(kAll, t[w % K], lead + w / K);
    fh[w] = __shfl_sync(kAll, h[w % K], lead + w / K);
  }
  ft[S] = fh[S] = 0;
  reg::cs_finish<Fd>(fr, ft, fh);
#pragma unroll
  for (int gg = 0; gg < G; ++gg)
    if (g == gg) {
#pragma unroll
      for (int j = 0; j < K; ++j) r[j] = fr[gg * K + j];
    }
}

// Thread g's part of one lane's a^e: row is the lane's 2S limbs, out its
// output row (nullptr: store nothing), tab the lane's table slots
// (tab[(e·S + w)·stride] word w of odd power e).
template <class Fd, int G>
__device__ __forceinline__ void pow_group_thread(const int32_t* row,
                                                 int32_t* out,
                                                 const PowChain& ch,
                                                 uint32_t* tab, int stride,
                                                 int g, int lead) {
  constexpr int S = Fd::kWords, K = Group<Fd, G>::K;
  uint32_t base[K], acc[K], x[K], sq[K], pw[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int w = g * K + j;
    base[j] = (static_cast<uint32_t>(row[2 * w]) & 0xFFFFu) |
              (static_cast<uint32_t>(row[2 * w + 1]) << 16);
    pw[j] = 0;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (g == gg) pw[j] = Fd::p(gg * K + j);
    tab[(g * K + j) * stride] = base[j];
    x[j] = base[j];
  }
  group_mul<Fd, G>(sq, base, base, pw, g, lead);
#pragma unroll 1
  for (int e = 1; e < ch.entries; ++e) {
    group_mul<Fd, G>(x, x, sq, pw, g, lead);
#pragma unroll
    for (int j = 0; j < K; ++j) tab[(e * S + g * K + j) * stride] = x[j];
  }
  const int e0 = ch.step[0] & kNoEntry;
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = tab[(e0 * S + g * K + j) * stride];
#pragma unroll 1
  for (int k = 1; k < ch.steps; ++k) {
    const int step = ch.step[k];
    const int e = step & kNoEntry;
#pragma unroll 1
    for (int i = step >> kEntryBits; i > 0; --i)
      group_mul<Fd, G>(acc, acc, acc, pw, g, lead);
    if (e != kNoEntry) {
#pragma unroll
      for (int j = 0; j < K; ++j) x[j] = tab[(e * S + g * K + j) * stride];
      group_mul<Fd, G>(acc, acc, x, pw, g, lead);
    }
  }
  if (out != nullptr) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int w = g * K + j;
      out[2 * w] = static_cast<int32_t>(acc[j] & 0xFFFFu);
      out[2 * w + 1] = static_cast<int32_t>(acc[j] >> 16);
    }
  }
}

// True if mod (S words) is the descriptor's modulus.
template <class Fd>
inline bool is_modulus(const uint32_t* mod) {
  for (int j = 0; j < Fd::kWords; ++j)
    if (mod[j] != Fd::p(j)) return false;
  return true;
}

}  // namespace mnt
}  // namespace tc

#if defined(__CUDACC__)
#include <cuda_runtime.h>

namespace {

using tc::mnt::kTile;
using tc::mnt::PowChain;
using tc::mnt::Tile;

template <class Fd>
__global__ void __launch_bounds__(kTile)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int n) {
  __shared__ __align__(16) int32_t ta[Tile<Fd>::kSize];
  __shared__ __align__(16) int32_t tb[Tile<Fd>::kSize];
  __shared__ __align__(8) uint64_t bar;
  constexpr int L = Tile<Fd>::kLimbs;
  const int base = blockIdx.x * kTile;
  const int lanes = min(kTile, n - base);
  const size_t off = static_cast<size_t>(base) * L;
  const int tid = threadIdx.x;
  if (tid == 0) {
    tc::mnt::bar_arm(&bar, 2 * lanes * L * 4);
    tc::mnt::copy_tile_in<Fd>(ta, a + off, lanes, &bar);
    tc::mnt::copy_tile_in<Fd>(tb, b + off, lanes, &bar);
  }
  __syncthreads();  // the mbarrier is armed before anyone waits on it
  tc::mnt::bar_wait(&bar);
  if (tid < lanes) tc::mnt::mul_row<Fd>(ta, tb, tid);
  __syncthreads();
  tc::mnt::stage_out<Fd>(out + off, ta, lanes, tid, kTile);
}

constexpr int kMaxPowThreads = 128;

template <class Fd>
__global__ void __launch_bounds__(kMaxPowThreads)
mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                int n, const PowChain ch) {
  extern __shared__ uint32_t tab[];  // [entries][S][blockDim.x]
  constexpr int S = Fd::kWords;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) {
    const size_t off = static_cast<size_t>(lane) * (2 * S);
    uint32_t base[S], acc[S];
    tc::load_row<S>(a + off, base);
    tc::mnt::pow_lane<Fd>(acc, base, ch, tab + threadIdx.x, blockDim.x);
    tc::store_row<S>(out + off, acc);
  }
}

// B2 with one lane over G threads: lanes blockDim.x / G a block; every
// thread of the block runs the body (shuffles take the warp).
template <class Fd, int G>
__global__ void __launch_bounds__(kMaxPowThreads)
mont_pow_group_kernel(const int32_t* __restrict__ a,
                      int32_t* __restrict__ out, int n, const PowChain ch) {
  extern __shared__ uint32_t tab[];  // [entries][S][lanes of the block]
  constexpr int S = Fd::kWords;
  const int g = threadIdx.x % G, lead = (threadIdx.x & 31) - g;
  const int stride = blockDim.x / G, slot = threadIdx.x / G;
  const int lane = blockIdx.x * stride + slot;
  const bool live = lane < n;
  tc::mnt::pow_group_thread<Fd, G>(
      a + static_cast<size_t>(live ? lane : 0) * (2 * S),
      live ? out + static_cast<size_t>(lane) * (2 * S) : nullptr, ch,
      tab + slot, stride, g, lead);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <class Fd>
int launch_mul(const int32_t* a, const int32_t* b, int32_t* out, int n,
               cudaStream_t s) {
  if (!aligned16(a) || !aligned16(b) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  mont_mul_kernel<Fd><<<(n + kTile - 1) / kTile, kTile, 0, s>>>(a, b, out,
                                                               n);
  return static_cast<int>(cudaGetLastError());
}

// Threads a block for n lanes: the largest of 128, 64 and 32 whose grid
// still has a block for every SM, else 32.
inline int pow_threads(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 1;
  }
  for (int t = kMaxPowThreads; t > 32; t /= 2)
    if ((n + t - 1) / t >= sms) return t;
  return 32;
}

// Lets `kernel` take the most dynamic shared memory a launch of it asks
// for (16 odd powers of 128 lanes); `allowed` records that it was done.
inline int allow_table(const void* kernel, int words, bool& allowed) {
  if (allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::mnt::kMaxEntries * words * 4 * kMaxPowThreads);
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed = true;
  return 0;
}

// B2 over n lanes, one lane over `group` threads (1, or kGroup).
template <class Fd>
int launch_pow(const int32_t* a, int32_t* out, int n, const PowChain& ch,
               int group, cudaStream_t s) {
  constexpr int G = tc::mnt::kGroup;
  static bool allowed[2] = {false, false};
  if (group != 1 && group != G)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = group == 1 ? 0 : 1;
  const int err = allow_table(
      k == 0 ? reinterpret_cast<const void*>(mont_pow_kernel<Fd>)
             : reinterpret_cast<const void*>(mont_pow_group_kernel<Fd, G>),
      Fd::kWords, allowed[k]);
  if (err != 0) return err;
  const int threads = pow_threads(static_cast<long long>(n) * group);
  const int lanes = threads / group;
  const dim3 grid((n + lanes - 1) / lanes);
  const int bytes = ch.entries * Fd::kWords * 4 * lanes;
  if (group == 1) {
    mont_pow_kernel<Fd><<<grid, threads, bytes, s>>>(a, out, n, ch);
  } else {
    mont_pow_group_kernel<Fd, G><<<grid, threads, bytes, s>>>(a, out, n, ch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mod: the field's modulus, `words` 32-bit words (the launcher checks it
// against the descriptor of that width).
extern "C" int tc_mont_mul(const void* a, const void* b, void* out, int n,
                           int words, const uint32_t* mod, void* stream) {
  if (n <= 0) return 0;
  const auto* ap = static_cast<const int32_t*>(a);
  const auto* bp = static_cast<const int32_t*>(b);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (words == 12 && tc::mnt::is_modulus<tc::mnt::FqField>(mod))
    return launch_mul<tc::mnt::FqField>(ap, bp, op, n, s);
  if (words == 8 && tc::mnt::is_modulus<tc::mnt::FrField>(mod))
    return launch_mul<tc::mnt::FrField>(ap, bp, op, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// steps[nsteps]: the chain (PowChain's step), `entries` odd powers; one
// lane over `group` threads (1, or tc::mnt::kGroup).
extern "C" int tc_mont_pow(const void* a, void* out, int n,
                           const uint16_t* steps, int nsteps, int entries,
                           int group, int words, const uint32_t* mod,
                           void* stream) {
  if (n <= 0) return 0;
  if (nsteps < 1 || nsteps > tc::mnt::kMaxSteps || entries < 1 ||
      entries > tc::mnt::kMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  PowChain ch;
  ch.steps = nsteps;
  ch.entries = entries;
  for (int k = 0; k < tc::mnt::kMaxSteps; ++k)
    ch.step[k] = k < nsteps ? steps[k] : 0;
  const auto* ap = static_cast<const int32_t*>(a);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (words == 12 && tc::mnt::is_modulus<tc::mnt::FqField>(mod))
    return launch_pow<tc::mnt::FqField>(ap, op, n, ch, group, s);
  if (words == 8 && tc::mnt::is_modulus<tc::mnt::FrField>(mod))
    return launch_pow<tc::mnt::FrField>(ap, op, n, ch, group, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // __CUDACC__
