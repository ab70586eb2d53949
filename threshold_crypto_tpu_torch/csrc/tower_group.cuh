// The lane-group tower engine: one pairing lane spread over a group of
// kGroup threads of one warp, on B13's register product; the bodies of B4
// `dbl_fold`, B6 `cyclo_sqr` and B7 `cyclo_sqr_mul`.
//
// Replaces, for B4 (csrc/miller.cu `dbl_fold_kernel`), B6 and B7
// (csrc/fq12.cu `cyclo_sqr_group_kernel`, `cyclo_sqr_mul_group_kernel`),
// one-thread-per-lane bodies on tower.cuh (`dbl_fold_lane`, and the
// `cyclo_sqr_lane` that B6 and B7 ran), which ran the formulas of
// threshold_crypto_tpu/device/pallas_tower.py `dbl_fold` (:619-668),
// `fq12_cyclo_sqr` (:540-582) and `fq12_mul` (:492-509) as `__noinline__`
// calls over structs in a local-memory frame (B4: 96 registers, 3,504
// bytes).
//
// What bounds it. B4 is 122 Fq products a lane in four dependent layers
// (48, 19, 16 and 39), B6 18 in one, B7 72 in two (18, 54), against 3,648,
// 2,304 and 3,456 bytes a lane: the 32-bit multiply issue rate, by far. At
// the RLC check's widths (1,024 B4 lanes, 512 B6 and B7 lanes) one thread
// per lane fills 8 and 4 of 132 SMs with 4 warps each, and a launch takes
// the latency of one thread's 122 (72) products in series.
//
// What this engine does about it.
// * A lane's group of kGroup threads (kGroup divides 32, so the group is
//   inside one warp and `__syncwarp` of its mask is its barrier) shares
//   the lane's scratch in shared memory: one 12-word slot per Fq value,
//   the inputs staged once as 32-bit words from the packed 16-bit limbs.
// * The formulas are a static schedule (tools/tower_group_schedule.py
//   writes its tables below): phases of Fq products, the JAX package's
//   product layers, and linear phases between them (the adds, subs,
//   doublings and ξ-multiples that finish a layer). Every value between
//   two products is linear over Fq, so an operand is a linear form over
//   slots, Σ c·slot with small integer c: the Karatsuba sums and
//   differences are formed as the operands are loaded. The ops of a phase
//   are dealt round-robin over the group (thread g runs ops g, g + kGroup,
//   …); no op reads a slot another op of its phase writes, and the group
//   syncs between phases. B4's products per thread fall from 122 to
//   Σ ceil(layer / kGroup) = 16 at kGroup = 8; B6's from 18 to 3, B7's
//   from 72 to 3 + 7 = 10.
// * The field is ladder_engine.cuh's: operands in registers and the one
//   out-of-line carry-save product `reg::fp_mul_call`. A linear form is
//   summed unreduced, one 64-bit column a word (one multiply-add a word
//   and term, no carries), and reduced once, only as far as its use needs:
//   the product is canonical for operands below 2^384 whose product is
//   below R·p, so most operands take no reduction at all; a stored value
//   is made canonical. Table-driven loops keep one copy of each piece of
//   code.
// * Slots are reused by liveness: B4 needs 68 (3,280 bytes a lane with the
//   bank padding), B6 42, B7 78 (3,760 bytes). The launcher picks blocks
//   of 128, 64 or 32 threads, the largest that still gives at least one
//   block per SM, and the block stages its lanes' inputs and outputs as
//   coalesced rows.
// * Every Fq value is canonical, so every output equals the plain
//   versions' limbs; the schedules compute the JAX package's T, line and
//   Granger-Scott elements. No branch depends on the data:
//   zero lanes and infinity points run like any other lane, and lanes past
//   n run on zeros and are not stored.
//
// Off the card (g++ behind stub qualifiers, for the tests) a serial loop
// over the threads stands in for the block: the stages and phases are
// functions of (thread, lane scratch), so the same code runs.

#pragma once

#include <cstdint>
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

#include "ladder_engine.cuh"

namespace tc {
namespace grp {

// Threads of a lane's group, fixed by tools/tower_variants.py's sweep
// (G = 1, 4, 8, 16, 32 at both widths of B4, B6 and B7): 8 gives the
// cheapest whole check (B4 + B6 + B7) at the per-pair paths' widths; 16
// and 32 are faster at the RLC check's, by less a check than 8 gains a
// per-pair or hash check (PERF.md §6).
constexpr int kGroup = 8;
static_assert(32 % kGroup == 0, "a group lies inside one warp");

constexpr int kWords = reg::kWords;

// Words between two lanes' scratch for a schedule of `slots` slots: an odd
// number of 16-byte quads, so neighbouring lanes start in other banks.
__host__ __device__ constexpr int lane_words(int slots) {
  return (3 * slots | 1) * 4;
}

// ---------------------------------------------------------------------------
// Slots and linear forms
// ---------------------------------------------------------------------------

__device__ __forceinline__ void slot_load(reg::Fp& x, const uint32_t* lane,
                                          int slot) {
  const uint32_t* p = lane + kWords * slot;
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 v = q[i];
    x.w[4 * i] = v.x;
    x.w[4 * i + 1] = v.y;
    x.w[4 * i + 2] = v.z;
    x.w[4 * i + 3] = v.w;
  }
#else
  for (int j = 0; j < kWords; ++j) x.w[j] = p[j];
#endif
}

__device__ __forceinline__ void slot_store(uint32_t* lane, int slot,
                                           const reg::Fp& x) {
  uint32_t* p = lane + kWords * slot;
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q[i] = make_uint4(x.w[4 * i], x.w[4 * i + 1], x.w[4 * i + 2],
                      x.w[4 * i + 3]);
#else
  for (int j = 0; j < kWords; ++j) p[j] = x.w[j];
#endif
}

// 1 / (floor(p / 2^352) + 1): q = floor(acc_top · kInvPTop) for the top
// 64 bits acc_top = floor(acc / 2^352) is at most floor(acc / p) and at
// least floor(acc / p) − 2 (the double is exact below 2^53 and rounds
// down at most across one integer).
constexpr double kInvPTop = 1.0 / 436277739.0;

// acc ← acc − q·p for that q: below 3p, and 12 words.
__device__ __forceinline__ void qstep(uint32_t (&acc)[kWords + 1]) {
  const uint64_t top =
      (static_cast<uint64_t>(acc[kWords]) << 32) | acc[kWords - 1];
  const uint32_t q =
      static_cast<uint32_t>(static_cast<double>(top) * kInvPTop);
  uint64_t m = 0;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    m = static_cast<uint64_t>(q) * reg::p_word(j) + (m >> 32);
    const uint64_t d = static_cast<uint64_t>(acc[j]) -
                       static_cast<uint32_t>(m) - borrow;
    acc[j] = static_cast<uint32_t>(d);
    borrow = static_cast<uint32_t>(d >> 63);
  }
  acc[kWords] = 0;
}

// r ← r − p unless that borrows.
__device__ __forceinline__ void cond_sub(reg::Fp& r) {
  uint32_t d[kWords];
  reg::Chain c;
  d[0] = c.sub_cc(r.w[0], reg::p_word(0));
#pragma unroll
  for (int j = 1; j < kWords; ++j) d[j] = c.subc_cc(r.w[j], reg::p_word(j));
  const uint32_t borrow = c.subc(0u, 0u);
#pragma unroll
  for (int j = 0; j < kWords; ++j) r.w[j] = borrow ? r.w[j] : d[j];
}

// A form's word: its term count, then its reduction steps
// (tools/tower_group_schedule.py `reduction`): q·p off, then 0-3
// conditional subtracts of p.
constexpr int kQStep = 1 << 8;
constexpr int kCSubShift = 9;

// r = Σ c_i·slot_i over the terms of a form (each slot << 8 | c as an
// int8; `word` holds their count and the form's reduction steps). The sum
// is unreduced, one 64-bit column a word (one 32×32 + 64-bit multiply-add
// a word and term, no carries): |c|·x for c > 0, |c|·(2^384 − 1 − x) for
// c < 0, then W·(p + 1) for W the sum of the negative |c|; one carry pass
// and − W·2^384 leave Σ c·x + W·p, at least 0 and at most Σ|c|·p. The
// steps then give, for an operand of the product, a value below 2^384
// that keeps the product canonical, and for a value to store, the
// canonical one.
__device__ __forceinline__ void form(reg::Fp& r, const int32_t* terms,
                                     int word, const uint32_t* lane) {
  uint64_t col[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) col[j] = 0;
  uint32_t wneg = 0;
  const int nt = word & 0xFF;
#pragma unroll 1
  for (int i = 0; i < nt; ++i) {
    const int32_t term = terms[i];
    const int c = static_cast<int8_t>(term & 0xFF);
    reg::Fp v;
    slot_load(v, lane, term >> 8);
    const uint32_t flip = c < 0 ? 0xFFFFFFFFu : 0u;
    const uint32_t k = static_cast<uint32_t>(c < 0 ? -c : c);
    wneg += k & flip;
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      col[j] += static_cast<uint64_t>(v.w[j] ^ flip) * k;
  }
  uint32_t t[kWords + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t pj = reg::p_word(j) + (j == 0);
    const uint64_t v = col[j] + pj * wneg + carry;
    t[j] = static_cast<uint32_t>(v);
    carry = v >> 32;
  }
  t[kWords] = static_cast<uint32_t>(carry) - wneg;
  if (word & kQStep) qstep(t);
#pragma unroll
  for (int j = 0; j < kWords; ++j) r.w[j] = t[j];
  const int csubs = (word >> kCSubShift) & 3;
#pragma unroll 1
  for (int i = 0; i < csubs; ++i) cond_sub(r);
}

// Thread g's share of phase `ph` of a schedule on one lane's scratch:
// ops g, g + G, … of the phase. An op is (dst slot, first term, form A,
// form B): dst = A·B, or dst = A where B has no terms; a form's word holds
// its term count and reduction steps, and B's terms follow A's.
__device__ __forceinline__ void run_phase(const int32_t* phase_ops,
                                          const int32_t* ops,
                                          const int32_t* terms, int ph,
                                          int g, int G, uint32_t* lane) {
  const int first = phase_ops[2 * ph];
  const int count = phase_ops[2 * ph + 1];
#pragma unroll 1
  for (int i = g; i < count; i += G) {
    const int32_t* op = ops + 4 * (first + i);
    const int dst = op[0], t0 = op[1], fa = op[2], fb = op[3];
    reg::Fp a;
    form(a, terms + t0, fa, lane);
    if (fb != 0) {
      reg::Fp b;
      form(b, terms + t0 + (fa & 0xFF), fb, lane);
      a = reg::fp_mul_call(a, b);
    }
    slot_store(lane, dst, a);
  }
}

// ---------------------------------------------------------------------------
// Staging: packed int32[k·24, n] rows <-> the lanes' scratch
// ---------------------------------------------------------------------------

// Loads (or stores) a thread has in flight while staging.
constexpr int kStageBatch = 16;

// Components 0..comps − 1 of src into slots slot0.. of the block's lanes
// lane0 .. lane0 + 2^lane_shift − 1 (scratch `stride` words apart). Thread
// tid of nthreads copies words tid, tid + nthreads, … with the lane
// fastest, so a warp reads neighbouring columns of a row, kStageBatch
// words' loads issued before the first is stored; word k of component c
// is limbs 2k, 2k + 1 (rows c·24 + 2k, + 1). A lane ≥ n reads zeros.
__device__ __forceinline__ void stage_in(const int32_t* __restrict__ src,
                                         int comps, int slot0, int n,
                                         int lane0, int lane_shift, int tid,
                                         int nthreads, uint32_t* smem,
                                         int stride) {
  const int mask = (1 << lane_shift) - 1;
  const int total = (comps * kWords) << lane_shift;
#pragma unroll 1
  for (int base = tid; base < total; base += kStageBatch * nthreads) {
    uint32_t lo[kStageBatch], hi[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = base + k * nthreads;
      const int lane = lane0 + (i & mask);
      lo[k] = hi[k] = 0;
      if (i < total && lane < n) {
        const int32_t* row =
            src + static_cast<size_t>(2 * (i >> lane_shift)) * n + lane;
        lo[k] = static_cast<uint32_t>(row[0]);
        hi[k] = static_cast<uint32_t>(row[n]);
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = base + k * nthreads;
      if (i < total)
        smem[(i & mask) * stride + slot0 * kWords + (i >> lane_shift)] =
            (lo[k] & 0xFFFFu) | (hi[k] << 16);
    }
  }
}

// The output components of slots out_slots[0..comps) into packed dst
// [comps·24, n], limb rows with the lane fastest, kStageBatch words read
// before the first is written; lanes ≥ n are not written.
__device__ __forceinline__ void stage_out(int32_t* __restrict__ dst,
                                          const int32_t* out_slots,
                                          int comps, int n, int lane0,
                                          int lane_shift, int tid,
                                          int nthreads, const uint32_t* smem,
                                          int stride) {
  const int mask = (1 << lane_shift) - 1;
  const int total = (comps * 2 * kWords) << lane_shift;
#pragma unroll 1
  for (int base = tid; base < total; base += kStageBatch * nthreads) {
    uint32_t v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = base + k * nthreads;
      v[k] = 0;
      if (i < total) {
        const int r = i >> lane_shift;
        const int c = r / (2 * kWords), limb = r % (2 * kWords);
        const uint32_t w =
            smem[(i & mask) * stride + out_slots[c] * kWords + (limb >> 1)];
        v[k] = (limb & 1) ? (w >> 16) : (w & 0xFFFFu);
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = base + k * nthreads;
      const int lane = lane0 + (i & mask);
      if (i < total && lane < n)
        dst[static_cast<size_t>(i >> lane_shift) * n + lane] =
            static_cast<int32_t>(v[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// The schedules (generated; do not edit by hand)
// ---------------------------------------------------------------------------

// BEGIN SCHEDULE TABLES (tools/tower_group_schedule.py --write)
// B4: 9 phases, 122 Fq products in the product phases (48, 19, 16, 39), 833 terms, 68 slots.
constexpr int kB4Phases = 9;
constexpr int kB4Slots = 68;
constexpr int kB4Inputs = 20;
constexpr int kB4Outputs = 18;
__device__ const int32_t kB4PhaseOps[] = {
    0, 48, 48, 12, 60, 12, 72, 19,
    91, 6, 97, 16, 113, 6, 119, 39,
    158, 12,
};
__device__ const int32_t kB4Ops[] = {
    20, 0, 2, 2, 21, 4, 1, 1,
    22, 6, 2, 2, 23, 10, 1, 1,
    24, 12, 1, 1, 25, 14, 1, 1,
    26, 16, 2, 2, 27, 20, 1, 1,
    28, 22, 1, 1, 29, 24, 2, 2,
    30, 28, 2, 2, 31, 32, 1, 1,
    32, 34, 1, 1, 33, 36, 1, 1,
    34, 38, 2, 2, 35, 42, 1, 1,
    36, 44, 1, 1, 37, 46, 2, 2,
    38, 50, 1, 1, 39, 52, 1, 1,
    40, 54, 2, 2, 41, 58, 2, 2,
    42, 62, 2, 2, 43, 66, 260, 260,
    44, 74, 2, 2, 45, 78, 2, 2,
    46, 82, 260, 260, 47, 90, 2, 2,
    48, 94, 2, 2, 49, 98, 260, 260,
    50, 106, 2, 3, 51, 111, 2, 3,
    52, 116, 260, 259, 53, 123, 2, 2,
    54, 127, 2, 2, 55, 131, 260, 260,
    56, 139, 2, 2, 57, 143, 2, 2,
    58, 147, 260, 260, 59, 155, 260, 260,
    60, 163, 260, 260, 61, 171, 264, 264,
    62, 187, 260, 261, 63, 196, 260, 261,
    64, 205, 264, 263, 65, 220, 260, 261,
    66, 229, 260, 261, 67, 238, 264, 263,
    5, 253, 1292, 0, 11, 265, 1292, 0,
    3, 277, 1291, 0, 9, 288, 1291, 0,
    1, 299, 1289, 0, 7, 308, 1289, 0,
    0, 317, 1288, 0, 2, 325, 1288, 0,
    4, 333, 1288, 0, 6, 341, 1288, 0,
    8, 349, 1288, 0, 10, 357, 1288, 0,
    32, 365, 1284, 0, 33, 369, 1284, 0,
    34, 373, 1539, 0, 35, 376, 1539, 0,
    36, 379, 1539, 0, 37, 382, 1539, 0,
    38, 385, 1025, 0, 39, 386, 1025, 0,
    40, 387, 1025, 0, 41, 388, 1025, 0,
    42, 389, 1025, 0, 43, 390, 1025, 0,
    0, 391, 2, 2, 1, 395, 3, 3,
    2, 401, 2, 2, 3, 405, 258, 258,
    4, 409, 1, 257, 5, 411, 2, 2,
    6, 415, 2, 3, 7, 420, 1, 1,
    8, 422, 1, 1, 9, 424, 2, 2,
    10, 428, 1, 1, 11, 430, 1, 1,
    44, 432, 2, 2, 45, 436, 1, 1,
    46, 438, 1, 1, 47, 440, 2, 2,
    48, 444, 1, 1, 49, 446, 1, 1,
    50, 448, 2, 2, 17, 452, 1286, 0,
    13, 458, 1284, 0, 15, 462, 1284, 0,
    16, 466, 1284, 0, 12, 470, 1283, 0,
    14, 473, 1283, 0, 0, 476, 1, 2,
    1, 479, 1, 3, 2, 483, 258, 2,
    3, 487, 1, 1, 4, 489, 1, 1,
    7, 491, 258, 2, 8, 495, 1, 1,
    9, 497, 1, 1, 10, 499, 2, 2,
    11, 503, 2, 1, 27, 506, 3, 1,
    28, 510, 2, 2, 29, 514, 2, 1,
    30, 517, 3, 1, 31, 521, 2, 1,
    44, 524, 3, 1, 13, 528, 1286, 0,
    12, 534, 1284, 0, 15, 538, 1283, 0,
    14, 541, 1282, 0, 6, 543, 1539, 0,
    5, 546, 1026, 0, 0, 548, 1, 1,
    1, 550, 1, 1, 2, 552, 2, 2,
    3, 556, 1, 1, 4, 558, 1, 1,
    7, 560, 2, 2, 8, 564, 1, 1,
    9, 566, 1, 1, 10, 568, 2, 2,
    11, 572, 2, 2, 18, 576, 2, 2,
    19, 580, 260, 260, 20, 588, 1, 1,
    21, 590, 1, 1, 22, 592, 2, 2,
    23, 596, 1, 1, 24, 598, 1, 1,
    25, 600, 2, 2, 26, 604, 1, 1,
    27, 606, 1, 1, 28, 608, 2, 2,
    45, 612, 1, 1, 46, 614, 1, 1,
    47, 616, 2, 2, 48, 620, 2, 1,
    49, 623, 2, 1, 50, 626, 4, 2,
    51, 632, 2, 2, 52, 636, 2, 2,
    53, 640, 260, 260, 54, 648, 2, 2,
    55, 652, 2, 2, 56, 656, 260, 260,
    57, 664, 260, 3, 58, 671, 260, 3,
    59, 678, 264, 262, 60, 692, 2, 1,
    61, 695, 2, 1, 62, 698, 4, 2,
    36, 704, 1301, 0, 38, 725, 1295, 0,
    35, 740, 1294, 0, 34, 754, 1292, 0,
    30, 766, 1291, 0, 33, 777, 1290, 0,
    37, 787, 1290, 0, 32, 797, 1289, 0,
    29, 806, 1288, 0, 17, 814, 1287, 0,
    16, 821, 1286, 0, 31, 827, 1286, 0,
};
__device__ const int32_t kB4Terms[] = {
    3073, 3329, 3073, 3583, 3073, 3329, 3585, 3841,
    3585, 4095, 3585, 3841, 3585, 4097, 3841, 4353,
    3585, 3841, 4097, 4353, 3073, 3585, 3329, 3841,
    3073, 3329, 3585, 3841, 4097, 4353, 4097, 4607,
    4097, 4353, 1, 1537, 257, 1793, 1, 257,
    1537, 1793, 513, 2049, 769, 2305, 513, 769,
    2049, 2305, 1025, 2561, 1281, 2817, 1025, 1281,
    2561, 2817, 513, 1025, 2049, 2561, 769, 1281,
    2305, 2817, 513, 769, 1025, 1281, 2049, 2305,
    2561, 2817, 1, 513, 1537, 2049, 257, 769,
    1793, 2305, 1, 257, 513, 769, 1537, 1793,
    2049, 2305, 1, 1025, 1537, 2561, 257, 1281,
    1793, 2817, 1, 257, 1025, 1281, 1537, 1793,
    2561, 2817, 1, 1537, 1, 2561, 3071, 257,
    1793, 257, 2561, 2817, 1, 257, 1537, 1793,
    1, 257, 2562, 513, 2049, 513, 1537, 769,
    2305, 769, 1793, 513, 769, 2049, 2305, 513,
    769, 1537, 1793, 1025, 2561, 1025, 2049, 1281,
    2817, 1281, 2305, 1025, 1281, 2561, 2817, 1025,
    1281, 2049, 2305, 513, 1025, 2049, 2561, 513,
    1025, 1537, 2049, 769, 1281, 2305, 2817, 769,
    1281, 1793, 2305, 513, 769, 1025, 1281, 2049,
    2305, 2561, 2817, 513, 769, 1025, 1281, 1537,
    1793, 2049, 2305, 1, 513, 1537, 2049, 1,
    513, 1537, 2561, 3071, 257, 769, 1793, 2305,
    257, 769, 1793, 2561, 2817, 1, 257, 513,
    769, 1537, 1793, 2049, 2305, 1, 257, 513,
    769, 1537, 1793, 2562, 1, 1025, 1537, 2561,
    1, 1025, 2049, 2561, 3071, 257, 1281, 1793,
    2817, 257, 1281, 2305, 2561, 2817, 1, 257,
    1025, 1281, 1537, 1793, 2561, 2817, 1, 257,
    1025, 1281, 2049, 2305, 2562, 8193, 8449, 8959,
    9215, 9471, 9473, 9729, 9985, 10495, 12287, 12543,
    12545, 12801, 13057, 13567, 13823, 14079, 14081, 14337,
    14593, 15103, 16895, 17151, 17153, 8193, 8449, 8959,
    8961, 9217, 9727, 10238, 10241, 11519, 11775, 11777,
    12801, 13057, 13567, 13569, 13825, 14335, 14846, 14849,
    16127, 16383, 16385, 8447, 8703, 8705, 9218, 9727,
    9986, 10495, 11006, 11009, 13055, 13311, 13313, 13826,
    14335, 14594, 15103, 15614, 15617, 8193, 8703, 9214,
    9473, 9982, 10241, 10498, 11263, 8447, 8449, 9215,
    9217, 9730, 10495, 11265, 11775, 8447, 8449, 8961,
    9471, 9983, 9985, 12033, 12543, 12801, 13311, 13822,
    14081, 14590, 14849, 15106, 15871, 13055, 13057, 13823,
    13825, 14338, 15103, 15873, 16383, 13055, 13057, 13569,
    14079, 14591, 14593, 16641, 17151, 255, 1279, 1281,
    1537, 511, 1279, 1535, 1793, 255, 767, 2049,
    511, 1023, 2305, 767, 1279, 2561, 1023, 1535,
    2817, 2, 258, 514, 770, 1026, 1282, 6913,
    7423, 6145, 6655, 7167, 7423, 7425, 6399, 6655,
    6657, 7422, 7425, 6654, 6657, 5123, 5382, 5123,
    5626, 5123, 5382, 6654, 6657, 6146, 6911, 6145,
    6655, 6399, 6655, 6657, 5121, 3073, 5378, 3329,
    5121, 5378, 3073, 3329, 5633, 4097, 5890, 4353,
    5633, 5890, 4097, 4353, 5121, 4097, 5378, 4353,
    5121, 5378, 4097, 4353, 3585, 7681, 3841, 7938,
    3585, 3841, 7681, 7938, 2045, 2301, 2307, 2562,
    2818, 11518, 8, 264, 760, 1026, 244, 500,
    524, 1278, 1795, 2301, 2814, 2818, 248, 264,
    769, 12, 500, 1023, 3074, 6145, 6655, 3330,
    6399, 6655, 6657, 3074, 3330, 6654, 6657, 5123,
    3585, 5382, 3841, 5123, 5382, 3585, 3841, 5633,
    1281, 5890, 1538, 5633, 5890, 1281, 1538, 6145,
    6655, 1281, 6399, 6655, 6657, 1538, 6654, 6657,
    1281, 1538, 11773, 11779, 4609, 11523, 11779, 12285,
    4609, 12290, 12798, 4865, 12542, 12798, 12802, 4865,
    1023, 1279, 1793, 2056, 2312, 2808, 769, 1279,
    2296, 2312, 3064, 7160, 7176, 2824, 7160, 255,
    511, 513, 1, 511, 8193, 4097, 8449, 4353,
    8193, 8449, 4097, 4353, 8705, 7425, 8961, 7681,
    8705, 8961, 7425, 7681, 9217, 7425, 9473, 7681,
    9217, 9473, 7425, 7681, 8193, 8705, 4097, 7425,
    8449, 8961, 4353, 7681, 8193, 8449, 8705, 8961,
    4097, 4353, 7425, 7681, 9217, 4097, 9473, 4353,
    9217, 9473, 4097, 4353, 10753, 7937, 11009, 11265,
    10753, 11009, 7937, 11265, 9729, 7937, 9985, 11265,
    9729, 9985, 7937, 11265, 10241, 7937, 10497, 11265,
    10241, 10497, 7937, 11265, 8193, 9729, 4097, 8449,
    9985, 4353, 8193, 8449, 9729, 9985, 4097, 4353,
    8705, 10241, 7425, 7937, 8961, 10497, 7681, 11265,
    8705, 8961, 10241, 10497, 7425, 7681, 7937, 11265,
    9217, 10753, 7425, 7937, 9473, 11009, 7681, 11265,
    9217, 9473, 10753, 11009, 7425, 7681, 7937, 11265,
    8193, 8705, 9729, 10241, 4097, 7425, 7937, 8449,
    8961, 9985, 10497, 4353, 7681, 11265, 8193, 8449,
    8705, 8961, 9729, 9985, 10241, 10497, 4097, 4353,
    7425, 7681, 7937, 11265, 9217, 10753, 4097, 9473,
    11009, 4353, 9217, 9473, 10753, 11009, 4097, 4353,
    255, 511, 513, 1023, 1279, 1793, 2817, 4609,
    5119, 6657, 6913, 7423, 12289, 12545, 13055, 13057,
    13313, 13823, 14847, 15103, 15105, 769, 1025, 2047,
    5121, 5377, 5887, 11521, 11777, 12287, 13311, 13567,
    13569, 15615, 15871, 15873, 1, 511, 769, 1279,
    3071, 4609, 6911, 6913, 12543, 12545, 13311, 13313,
    14593, 15103, 1, 257, 767, 2306, 2815, 6146,
    6655, 12543, 12799, 12801, 14334, 14337, 1, 257,
    767, 769, 1025, 2047, 3071, 4863, 4865, 6398,
    6401, 255, 257, 2302, 2561, 6142, 6401, 12289,
    12799, 13826, 14591, 1023, 1025, 5375, 5377, 11775,
    11777, 13057, 13567, 15361, 15871, 1023, 1279, 1793,
    5375, 5631, 5633, 6911, 7167, 7169, 255, 257,
    1023, 1025, 2817, 4863, 5890, 6655, 255, 511,
    513, 2558, 2561, 12030, 12033, 1, 511, 2050,
    2815, 11522, 12287, 769, 1279, 5121, 5631, 6657,
    7167,
};
__device__ const int32_t kB4OutSlots[] = {
    16, 17, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    5, 6, 12, 13, 14, 15,
};
// B6: 2 phases, 18 Fq products in the product phases (18), 126 terms, 42 slots.
constexpr int kB6Phases = 2;
constexpr int kB6Slots = 42;
constexpr int kB6Inputs = 12;
constexpr int kB6Outputs = 12;
__device__ const int32_t kB6PhaseOps[] = {
    0, 18, 18, 12,
};
__device__ const int32_t kB6Ops[] = {
    12, 0, 2, 2, 13, 4, 1, 1,
    14, 6, 2, 2, 15, 10, 1, 1,
    16, 12, 260, 260, 17, 20, 2, 2,
    18, 24, 2, 2, 19, 28, 1, 1,
    20, 30, 2, 2, 21, 34, 1, 1,
    22, 36, 260, 260, 23, 44, 2, 2,
    24, 48, 2, 2, 25, 52, 1, 1,
    26, 54, 2, 2, 27, 58, 1, 1,
    28, 60, 260, 260, 29, 68, 2, 2,
    36, 72, 1287, 0, 37, 79, 1287, 0,
    30, 86, 1284, 0, 31, 90, 1284, 0,
    32, 94, 1284, 0, 33, 98, 1284, 0,
    34, 102, 1284, 0, 35, 106, 1284, 0,
    38, 110, 1284, 0, 39, 114, 1284, 0,
    40, 118, 1284, 0, 41, 122, 1284, 0,
};
__device__ const int32_t kB6Terms[] = {
    1, 257, 1, 511, 1, 257, 2049, 2305,
    2049, 2559, 2049, 2305, 1, 257, 2049, 2305,
    1, 511, 2049, 2559, 1, 2049, 257, 2305,
    1537, 1793, 1537, 2047, 1537, 1793, 1025, 1281,
    1025, 1535, 1025, 1281, 1025, 1281, 1537, 1793,
    1025, 1535, 1537, 2047, 1025, 1537, 1281, 1793,
    513, 769, 513, 1023, 513, 769, 2561, 2817,
    2561, 3071, 2561, 2817, 513, 769, 2561, 2817,
    513, 1023, 2561, 3071, 513, 2561, 769, 2817,
    1538, 6397, 6406, 6909, 6918, 7171, 7674, 1794,
    6397, 6650, 6909, 7162, 7171, 7430, 254, 3075,
    3587, 4090, 510, 3334, 3587, 3846, 766, 4611,
    5123, 5626, 1022, 4870, 5123, 5382, 1278, 6147,
    6659, 7162, 1534, 6406, 6659, 6918, 2050, 3325,
    3837, 4099, 2306, 3578, 4090, 4358, 2562, 4861,
    5373, 5635, 2818, 5114, 5626, 5894,
};
__device__ const int32_t kB6OutSlots[] = {
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
};
// B7: 4 phases, 72 Fq products in the product phases (18, 54), 690 terms, 78 slots.
constexpr int kB7Phases = 4;
constexpr int kB7Slots = 78;
constexpr int kB7Inputs = 24;
constexpr int kB7Outputs = 12;
__device__ const int32_t kB7PhaseOps[] = {
    0, 18, 18, 12, 30, 54, 84, 12,
};
__device__ const int32_t kB7Ops[] = {
    24, 0, 2, 2, 25, 4, 1, 1,
    26, 6, 2, 2, 27, 10, 1, 1,
    28, 12, 260, 260, 29, 20, 2, 2,
    30, 24, 2, 2, 31, 28, 1, 1,
    32, 30, 2, 2, 33, 34, 1, 1,
    34, 36, 260, 260, 35, 44, 2, 2,
    36, 48, 2, 2, 37, 52, 1, 1,
    38, 54, 2, 2, 39, 58, 1, 1,
    40, 60, 260, 260, 41, 68, 2, 2,
    48, 72, 1287, 0, 49, 79, 1287, 0,
    42, 86, 1284, 0, 43, 90, 1284, 0,
    44, 94, 1284, 0, 45, 98, 1284, 0,
    46, 102, 1284, 0, 47, 106, 1284, 0,
    50, 110, 1284, 0, 51, 114, 1284, 0,
    52, 118, 1284, 0, 53, 122, 1284, 0,
    0, 126, 1, 1, 1, 128, 1, 1,
    2, 130, 2, 2, 3, 134, 1, 1,
    4, 136, 1, 1, 5, 138, 2, 2,
    6, 142, 1, 1, 7, 144, 1, 1,
    8, 146, 2, 2, 9, 150, 2, 2,
    10, 154, 2, 2, 11, 158, 260, 260,
    24, 166, 2, 2, 25, 170, 2, 2,
    26, 174, 260, 260, 27, 182, 2, 2,
    28, 186, 2, 2, 29, 190, 260, 260,
    30, 198, 1, 1, 31, 200, 1, 1,
    32, 202, 2, 2, 33, 206, 1, 1,
    34, 208, 1, 1, 35, 210, 2, 2,
    36, 214, 1, 1, 37, 216, 1, 1,
    38, 218, 2, 2, 39, 222, 2, 2,
    40, 226, 2, 2, 41, 230, 260, 260,
    54, 238, 2, 2, 55, 242, 2, 2,
    56, 246, 260, 260, 57, 254, 2, 2,
    58, 258, 2, 2, 59, 262, 260, 260,
    60, 270, 2, 2, 61, 274, 2, 2,
    62, 278, 260, 260, 63, 286, 2, 2,
    64, 290, 2, 2, 65, 294, 260, 260,
    66, 302, 2, 2, 67, 306, 2, 2,
    68, 310, 260, 260, 69, 318, 260, 260,
    70, 326, 260, 260, 71, 334, 264, 264,
    72, 350, 260, 260, 73, 358, 260, 260,
    74, 366, 264, 264, 75, 382, 260, 260,
    76, 390, 260, 260, 77, 398, 264, 264,
    23, 414, 1316, 0, 21, 450, 1313, 0,
    19, 483, 1307, 0, 18, 510, 1304, 0,
    20, 534, 1304, 0, 22, 558, 1304, 0,
    17, 582, 1303, 0, 15, 605, 1300, 0,
    13, 625, 1297, 0, 12, 642, 1296, 0,
    14, 658, 1296, 0, 16, 674, 1296, 0,
};
__device__ const int32_t kB7Terms[] = {
    1, 257, 1, 511, 1, 257, 2049, 2305,
    2049, 2559, 2049, 2305, 1, 257, 2049, 2305,
    1, 511, 2049, 2559, 1, 2049, 257, 2305,
    1537, 1793, 1537, 2047, 1537, 1793, 1025, 1281,
    1025, 1535, 1025, 1281, 1025, 1281, 1537, 1793,
    1025, 1535, 1537, 2047, 1025, 1537, 1281, 1793,
    513, 769, 513, 1023, 513, 769, 2561, 2817,
    2561, 3071, 2561, 2817, 513, 769, 2561, 2817,
    513, 1023, 2561, 3071, 513, 2561, 769, 2817,
    1538, 9469, 9478, 9981, 9990, 10243, 10746, 1794,
    9469, 9722, 9981, 10234, 10243, 10502, 254, 6147,
    6659, 7162, 510, 6406, 6659, 6918, 766, 7683,
    8195, 8698, 1022, 7942, 8195, 8454, 1278, 9219,
    9731, 10234, 1534, 9478, 9731, 9990, 2050, 6397,
    6909, 7171, 2306, 6650, 7162, 7430, 2562, 7933,
    8445, 8707, 2818, 8186, 8698, 8966, 10753, 3073,
    11009, 3329, 10753, 11009, 3073, 3329, 11265, 3585,
    11521, 3841, 11265, 11521, 3585, 3841, 11777, 4097,
    12033, 4353, 11777, 12033, 4097, 4353, 11265, 11777,
    3585, 4097, 11521, 12033, 3841, 4353, 11265, 11521,
    11777, 12033, 3585, 3841, 4097, 4353, 10753, 11265,
    3073, 3585, 11009, 11521, 3329, 3841, 10753, 11009,
    11265, 11521, 3073, 3329, 3585, 3841, 10753, 11777,
    3073, 4097, 11009, 12033, 3329, 4353, 10753, 11009,
    11777, 12033, 3073, 3329, 4097, 4353, 12289, 4609,
    12545, 4865, 12289, 12545, 4609, 4865, 12801, 5121,
    13057, 5377, 12801, 13057, 5121, 5377, 13313, 5633,
    13569, 5889, 13313, 13569, 5633, 5889, 12801, 13313,
    5121, 5633, 13057, 13569, 5377, 5889, 12801, 13057,
    13313, 13569, 5121, 5377, 5633, 5889, 12289, 12801,
    4609, 5121, 12545, 13057, 4865, 5377, 12289, 12545,
    12801, 13057, 4609, 4865, 5121, 5377, 12289, 13313,
    4609, 5633, 12545, 13569, 4865, 5889, 12289, 12545,
    13313, 13569, 4609, 4865, 5633, 5889, 10753, 12289,
    3073, 4609, 11009, 12545, 3329, 4865, 10753, 11009,
    12289, 12545, 3073, 3329, 4609, 4865, 11265, 12801,
    3585, 5121, 11521, 13057, 3841, 5377, 11265, 11521,
    12801, 13057, 3585, 3841, 5121, 5377, 11777, 13313,
    4097, 5633, 12033, 13569, 4353, 5889, 11777, 12033,
    13313, 13569, 4097, 4353, 5633, 5889, 11265, 11777,
    12801, 13313, 3585, 4097, 5121, 5633, 11521, 12033,
    13057, 13569, 3841, 4353, 5377, 5889, 11265, 11521,
    11777, 12033, 12801, 13057, 13313, 13569, 3585, 3841,
    4097, 4353, 5121, 5377, 5633, 5889, 10753, 11265,
    12289, 12801, 3073, 3585, 4609, 5121, 11009, 11521,
    12545, 13057, 3329, 3841, 4865, 5377, 10753, 11009,
    11265, 11521, 12289, 12545, 12801, 13057, 3073, 3329,
    3585, 3841, 4609, 4865, 5121, 5377, 10753, 11777,
    12289, 13313, 3073, 4097, 4609, 5633, 11009, 12033,
    12545, 13569, 3329, 4353, 4865, 5889, 10753, 11009,
    11777, 12033, 12289, 12545, 13313, 13569, 3073, 3329,
    4097, 4353, 4609, 4865, 5633, 5889, 255, 511,
    513, 769, 1025, 1535, 1791, 2047, 2049, 6913,
    7169, 7679, 7935, 8191, 8193, 8449, 8705, 9215,
    9471, 9727, 9729, 14593, 14849, 15359, 15361, 15617,
    16127, 16383, 16639, 16641, 16897, 17153, 17663, 19455,
    19711, 19713, 255, 511, 513, 1023, 1279, 1281,
    1794, 2303, 6145, 6401, 6911, 7935, 8191, 8193,
    8703, 8959, 8961, 9474, 9983, 13825, 14081, 14591,
    15361, 15617, 16127, 16129, 16385, 16895, 17406, 17409,
    18687, 18943, 18945, 1, 257, 767, 1278, 1281,
    2046, 2049, 2562, 3071, 7681, 7937, 8447, 8958,
    8961, 9726, 9729, 10242, 10751, 15615, 15871, 15873,
    16386, 16895, 17154, 17663, 18174, 18177, 255, 257,
    770, 1535, 1538, 2303, 2558, 2817, 7935, 7937,
    8450, 9215, 9218, 9983, 10238, 10497, 15361, 15871,
    16382, 16641, 17150, 17409, 17666, 18431, 1, 511,
    769, 1279, 1790, 2049, 6399, 6401, 7681, 8191,
    8449, 8959, 9470, 9729, 14079, 14081, 15615, 15617,
    16383, 16385, 16898, 17663, 18433, 18943, 1, 511,
    1023, 1025, 1537, 2047, 7167, 7169, 7681, 8191,
    8703, 8705, 9217, 9727, 14847, 14849, 15615, 15617,
    16129, 16639, 17151, 17153, 19201, 19711, 1, 257,
    767, 1023, 1279, 1281, 1537, 1793, 2303, 7167,
    7423, 7425, 7681, 7937, 8447, 8449, 8705, 9215,
    9726, 9729, 14079, 14335, 14337, 1, 257, 767,
    769, 1025, 1535, 2046, 2049, 6399, 6655, 6657,
    7935, 8191, 8193, 8706, 9215, 9474, 9983, 10494,
    10497, 255, 511, 513, 1026, 1535, 1794, 2303,
    2814, 2817, 7938, 8447, 8958, 8961, 9474, 9983,
    15102, 15105, 1, 511, 1022, 1281, 1790, 2049,
    2306, 3071, 7934, 8193, 8450, 9215, 9470, 9729,
    14594, 15359, 255, 257, 1023, 1025, 1538, 2303,
    6145, 6655, 7681, 8191, 8702, 8961, 9470, 9729,
    9986, 10751, 255, 257, 769, 1279, 1791, 1793,
    6913, 7423, 7935, 7937, 8703, 8705, 9218, 9983,
    13825, 14335,
};
__device__ const int32_t kB7OutSlots[] = {
    12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
};
// END SCHEDULE TABLES

// Words of a lane's scratch in B4, B6 and B7.
constexpr int kB4LaneWords = lane_words(kB4Slots);
constexpr int kB6LaneWords = lane_words(kB6Slots);
constexpr int kB7LaneWords = lane_words(kB7Slots);

// ---------------------------------------------------------------------------
// Launch shape (nvcc only)
// ---------------------------------------------------------------------------

#if defined(__CUDACC__)
// The largest block, and the blocks a kernel asks to fit on an SM: at most
// 128 registers a thread.
constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 4;
// Shared memory one block may take (sm_90).
constexpr int kMaxBlockBytes = 232448;

// The group's barrier mask: the kGroup lanes of the warp holding this
// thread's group.
__device__ __forceinline__ unsigned group_mask() {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned ones = kGroup == 32 ? 0xFFFFFFFFu : (1u << kGroup) - 1u;
  return ones << (lane / kGroup * kGroup);
}

// The group's part of a schedule on its lane's scratch: every phase, each
// followed by the group's barrier.
__device__ __forceinline__ void run_schedule(const int32_t* phase_ops,
                                             const int32_t* ops,
                                             const int32_t* terms,
                                             int phases, uint32_t* lane) {
  const unsigned mask = group_mask();
  const int g = threadIdx.x % kGroup;
#pragma unroll 1
  for (int ph = 0; ph < phases; ++ph) {
    run_phase(phase_ops, ops, terms, ph, g, kGroup, lane);
    __syncwarp(mask);
  }
}

// A launch over n lanes of `lane_words` words of scratch each: blocks of
// the largest of 128, 64 and 32 threads whose grid still has a block for
// every SM and whose scratch fits a block (else 32), 2^shift lanes a block.
struct Shape {
  int blocks, threads, shift, bytes;
};

inline Shape group_shape(int n, int lane_words_) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 1;
  }
  const int lane_bytes = lane_words_ * 4;
  const long long work = static_cast<long long>(n) * kGroup;
  int threads = 32;
  for (int t = kMaxThreads; t > 32; t /= 2) {
    if ((t / kGroup) * lane_bytes <= kMaxBlockBytes &&
        (work + t - 1) / t >= sms) {
      threads = t;
      break;
    }
  }
  Shape s;
  s.threads = threads;
  s.shift = 0;
  while ((kGroup << (s.shift + 1)) <= threads) ++s.shift;
  s.blocks = (n + (1 << s.shift) - 1) >> s.shift;
  s.bytes = (1 << s.shift) * lane_bytes;
  return s;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// on request) and prefer the largest shared-memory carveout; `allowed`
// is the caller's record of what it already allowed.
inline int allow_scratch(const void* kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed = bytes;
  return 0;
}
#endif

}  // namespace grp
}  // namespace tc
