// The lane-group tower engine: one pairing lane spread over a group of
// kGroup threads of one warp, on B13's register product; the bodies of B4
// `dbl_fold`, B5 `add_fold`, B6 `cyclo_sqr`, B7 `cyclo_sqr_mul`, B8
// `fq12_mul`, B9 `fq12_sqr` and B17's four pieces `dbl_step`,
// `f_sqr_fold`, `add_step` and `f_fold`.
//
// Replaces, for B4, B5 and B17 (csrc/miller.cu `dbl_fold_kernel`,
// `add_fold_kernel`, `dbl_step_kernel`, `f_sqr_fold_kernel`,
// `add_step_kernel`, `f_fold_kernel`), B6-B9 (csrc/fq12.cu
// `cyclo_sqr_group_kernel`, `cyclo_sqr_mul_group_kernel`,
// `fq12_mul_group_kernel`, `fq12_sqr_group_kernel`), one-thread-per-lane
// bodies on tower.cuh (`dbl_fold_lane`, `add_fold_lane`, `fq12_mul_lane`,
// `dbl_step_lane`, `f_sqr_fold_lane`, `add_step_lane`, `f_fold_lane`, and
// the `cyclo_sqr_lane` that B6 and B7 ran), which ran the formulas of
// threshold_crypto_tpu/device/pallas_tower.py `dbl_fold` (:619-668),
// `add_fold` (:671-699), `fq12_cyclo_sqr` (:540-582), `fq12_mul`
// (:492-509) and `fq12_sqr` (:511-521), and the kernels `_k_dbl_step`
// (:886), `_k_add_step` (:895), `_k_f_sqr_fold` (:940) and `_k_f_fold`
// (:948), as `__noinline__` calls over structs in a local-memory frame
// (B4: 96 registers, 3,504 bytes; B9: 64, 3,696).
//
// What bounds it. B4 is 122 Fq products a lane in four dependent layers
// (48, 19, 16 and 39), B5 80 in four (6, 14, 48, 12: `add_step`'s layers,
// the line product's 39 in the third), B6 18 in one, B7 72 in two (18,
// 54), B8 54 in one, B9 36 in one, against 3,648, 4,032, 2,304, 3,456,
// 3,456 and 2,304 bytes a lane: the 32-bit multiply issue rate, by far.
// B17's pieces are B4 and B5 cut where the line is written: `dbl_step`
// 47 products in three layers (12, 19, 16) against 1,920 bytes a lane,
// `f_sqr_fold` 75 in two (36, 39) against 2,880, `add_step` 41 in four
// (6, 14, 9, 12) against 2,304 and `f_fold` 39 in one against 2,880.
// At the RLC check's widths (1,024 B4 and B5 lanes, 512 B6-B9 lanes) one
// thread per lane fills 8 and 4 of 132 SMs with 4 warps each, and a launch
// takes the latency of one thread's 122 (80, 72, 54, 36) products in
// series.
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
//   Σ ceil(layer / kGroup) = 16 at kGroup = 8; B5's from 80 to 11, B6's
//   from 18 to 3, B7's from 72 to 3 + 7 = 10, B8's from 54 to 7, B9's
//   from 36 to 5; B17's from 47, 75, 41 and 39 to 7, 10, 7 and 5.
// * The field is ladder_engine.cuh's: operands in registers and the one
//   out-of-line carry-save product `reg::fp_mul_call`. A linear form is
//   summed unreduced, one 64-bit column a word (one multiply-add a word
//   and term, no carries), and reduced once, only as far as its use needs:
//   the product is canonical for operands below 2^384 whose product is
//   below R·p, so most operands take no reduction at all; a stored value
//   is made canonical. Signed coefficients (B4's −3XX·Z, B5's −u·xp,
//   A = u²Z − v³ − 2Rr and Rr − A) are summed as |c|·(2^384 − 1 − x) plus
//   a multiple of p, so a form is never negative. Table-driven loops keep
//   one copy of each piece of code.
// * Slots are reused by liveness: B4 needs 68 (3,280 bytes a lane with the
//   bank padding), B5 80 (3,856 bytes), B6 42, B7 and B8 78 (3,760
//   bytes), B9 48 (2,320 bytes); B17's `dbl_step` 39, `f_sqr_fold` and
//   `f_fold` 57, `add_step` 33. The launcher picks blocks of 128, 64 or
//   32 threads, the largest that still gives at least one block per SM,
//   and the block stages its lanes' inputs and outputs as coalesced rows.
// * Every Fq value is canonical, so every output equals the plain
//   versions' limbs; the schedules compute the JAX package's T, line and
//   Granger-Scott elements (B4 and B5 its projective T and line scaling).
//   No branch depends on the data: zero lanes and infinity points run
//   like any other lane, and lanes past n run on zeros and are not stored.
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
// (G = 1, 4, 8, 16, 32 at both widths of B4-B9): 8 gives the cheapest
// whole check (B4-B9) at the per-pair paths' widths; 16 and 32 are faster
// at the RLC check's, whose stage the host's dispatch sets (PERF.md §5-6);
// a size chosen from n is not tried.
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
// conditional subtracts of p; or (a product's second operand in B18) one
// constant of the schedules' table, its index in its term's slot bits.
constexpr int kQStep = 1 << 8;
constexpr int kCSubShift = 9;
constexpr int kConstForm = 1 << 11;

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
// its term count and reduction steps, and B's terms follow A's. A B whose
// word has kConstForm is constant `consts` entry (its term >> 8), 12 words
// each, read from the read-only table every lane shares.
__device__ __forceinline__ void run_phase(const int32_t* phase_ops,
                                          const int32_t* ops,
                                          const int32_t* terms,
                                          const uint32_t* consts, int ph,
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
      const int32_t* tb = terms + t0 + (fa & 0xFF);
      if (fb & kConstForm) {
        const uint32_t* c = consts + kWords * (tb[0] >> 8);
#pragma unroll
        for (int j = 0; j < kWords; ++j) b.w[j] = c[j];
      } else {
        form(b, tb, fb, lane);
      }
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

// Fq values kept as int32[n, 24] limb rows (a lane's 24 limbs together, the
// layout of device/mont.py that B2 takes and gives) <-> slot `slot` of the
// block's lanes: thread tid of nthreads copies words (or limbs) tid,
// tid + nthreads, … of the block's rows, which lie one after another, so a
// warp reads (writes) neighbouring words. A lane ≥ n reads zeros and is
// not written.
__device__ __forceinline__ void stage_in_rows(const int32_t* __restrict__ src,
                                              int slot, int n, int lane0,
                                              int lane_shift, int tid,
                                              int nthreads, uint32_t* smem,
                                              int stride) {
  const int total = kWords << lane_shift;
#pragma unroll 1
  for (int i = tid; i < total; i += nthreads) {
    const int l = i / kWords, w = i % kWords;
    uint32_t v = 0;
    if (lane0 + l < n) {
      const int32_t* row = src + static_cast<size_t>(lane0) * 2 * kWords;
      v = (static_cast<uint32_t>(row[2 * i]) & 0xFFFFu) |
          (static_cast<uint32_t>(row[2 * i + 1]) << 16);
    }
    smem[l * stride + slot * kWords + w] = v;
  }
}

__device__ __forceinline__ void stage_out_rows(int32_t* __restrict__ dst,
                                               int slot, int n, int lane0,
                                               int lane_shift, int tid,
                                               int nthreads,
                                               const uint32_t* smem,
                                               int stride) {
  const int total = (2 * kWords) << lane_shift;
#pragma unroll 1
  for (int i = tid; i < total; i += nthreads) {
    const int l = i / (2 * kWords), limb = i % (2 * kWords);
    const uint32_t w = smem[l * stride + slot * kWords + (limb >> 1)];
    if (lane0 + l < n)
      dst[static_cast<size_t>(lane0) * 2 * kWords + i] =
          static_cast<int32_t>((limb & 1) ? (w >> 16) : (w & 0xFFFFu));
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
// B8: 2 phases, 54 Fq products in the product phases (54), 564 terms, 78 slots.
constexpr int kB8Phases = 2;
constexpr int kB8Slots = 78;
constexpr int kB8Inputs = 24;
constexpr int kB8Outputs = 12;
__device__ const int32_t kB8PhaseOps[] = {
    0, 54, 54, 12,
};
__device__ const int32_t kB8Ops[] = {
    24, 0, 1, 1, 25, 2, 1, 1,
    26, 4, 2, 2, 27, 8, 1, 1,
    28, 10, 1, 1, 29, 12, 2, 2,
    30, 16, 1, 1, 31, 18, 1, 1,
    32, 20, 2, 2, 33, 24, 2, 2,
    34, 28, 2, 2, 35, 32, 260, 260,
    36, 40, 2, 2, 37, 44, 2, 2,
    38, 48, 260, 260, 39, 56, 2, 2,
    40, 60, 2, 2, 41, 64, 260, 260,
    42, 72, 1, 1, 43, 74, 1, 1,
    44, 76, 2, 2, 45, 80, 1, 1,
    46, 82, 1, 1, 47, 84, 2, 2,
    48, 88, 1, 1, 49, 90, 1, 1,
    50, 92, 2, 2, 51, 96, 2, 2,
    52, 100, 2, 2, 53, 104, 260, 260,
    54, 112, 2, 2, 55, 116, 2, 2,
    56, 120, 260, 260, 57, 128, 2, 2,
    58, 132, 2, 2, 59, 136, 260, 260,
    60, 144, 2, 2, 61, 148, 2, 2,
    62, 152, 260, 260, 63, 160, 2, 2,
    64, 164, 2, 2, 65, 168, 260, 260,
    66, 176, 2, 2, 67, 180, 2, 2,
    68, 184, 260, 260, 69, 192, 260, 260,
    70, 200, 260, 260, 71, 208, 264, 264,
    72, 224, 260, 260, 73, 232, 260, 260,
    74, 240, 264, 264, 75, 256, 260, 260,
    76, 264, 260, 260, 77, 272, 264, 264,
    11, 288, 1316, 0, 9, 324, 1313, 0,
    7, 357, 1307, 0, 6, 384, 1304, 0,
    8, 408, 1304, 0, 10, 432, 1304, 0,
    5, 456, 1303, 0, 3, 479, 1300, 0,
    1, 499, 1297, 0, 0, 516, 1296, 0,
    2, 532, 1296, 0, 4, 548, 1296, 0,
};
__device__ const int32_t kB8Terms[] = {
    1, 3073, 257, 3329, 1, 257, 3073, 3329,
    513, 3585, 769, 3841, 513, 769, 3585, 3841,
    1025, 4097, 1281, 4353, 1025, 1281, 4097, 4353,
    513, 1025, 3585, 4097, 769, 1281, 3841, 4353,
    513, 769, 1025, 1281, 3585, 3841, 4097, 4353,
    1, 513, 3073, 3585, 257, 769, 3329, 3841,
    1, 257, 513, 769, 3073, 3329, 3585, 3841,
    1, 1025, 3073, 4097, 257, 1281, 3329, 4353,
    1, 257, 1025, 1281, 3073, 3329, 4097, 4353,
    1537, 4609, 1793, 4865, 1537, 1793, 4609, 4865,
    2049, 5121, 2305, 5377, 2049, 2305, 5121, 5377,
    2561, 5633, 2817, 5889, 2561, 2817, 5633, 5889,
    2049, 2561, 5121, 5633, 2305, 2817, 5377, 5889,
    2049, 2305, 2561, 2817, 5121, 5377, 5633, 5889,
    1537, 2049, 4609, 5121, 1793, 2305, 4865, 5377,
    1537, 1793, 2049, 2305, 4609, 4865, 5121, 5377,
    1537, 2561, 4609, 5633, 1793, 2817, 4865, 5889,
    1537, 1793, 2561, 2817, 4609, 4865, 5633, 5889,
    1, 1537, 3073, 4609, 257, 1793, 3329, 4865,
    1, 257, 1537, 1793, 3073, 3329, 4609, 4865,
    513, 2049, 3585, 5121, 769, 2305, 3841, 5377,
    513, 769, 2049, 2305, 3585, 3841, 5121, 5377,
    1025, 2561, 4097, 5633, 1281, 2817, 4353, 5889,
    1025, 1281, 2561, 2817, 4097, 4353, 5633, 5889,
    513, 1025, 2049, 2561, 3585, 4097, 5121, 5633,
    769, 1281, 2305, 2817, 3841, 4353, 5377, 5889,
    513, 769, 1025, 1281, 2049, 2305, 2561, 2817,
    3585, 3841, 4097, 4353, 5121, 5377, 5633, 5889,
    1, 513, 1537, 2049, 3073, 3585, 4609, 5121,
    257, 769, 1793, 2305, 3329, 3841, 4865, 5377,
    1, 257, 513, 769, 1537, 1793, 2049, 2305,
    3073, 3329, 3585, 3841, 4609, 4865, 5121, 5377,
    1, 1025, 1537, 2561, 3073, 4097, 4609, 5633,
    257, 1281, 1793, 2817, 3329, 4353, 4865, 5889,
    1, 257, 1025, 1281, 1537, 1793, 2561, 2817,
    3073, 3329, 4097, 4353, 4609, 4865, 5633, 5889,
    6399, 6655, 6657, 6913, 7169, 7679, 7935, 8191,
    8193, 9985, 10241, 10751, 11007, 11263, 11265, 11521,
    11777, 12287, 12543, 12799, 12801, 14593, 14849, 15359,
    15361, 15617, 16127, 16383, 16639, 16641, 16897, 17153,
    17663, 19455, 19711, 19713, 6399, 6655, 6657, 7167,
    7423, 7425, 7938, 8447, 9217, 9473, 9983, 11007,
    11263, 11265, 11775, 12031, 12033, 12546, 13055, 13825,
    14081, 14591, 15361, 15617, 16127, 16129, 16385, 16895,
    17406, 17409, 18687, 18943, 18945, 6145, 6401, 6911,
    7422, 7425, 8190, 8193, 8706, 9215, 10753, 11009,
    11519, 12030, 12033, 12798, 12801, 13314, 13823, 15615,
    15871, 15873, 16386, 16895, 17154, 17663, 18174, 18177,
    6399, 6401, 6914, 7679, 7682, 8447, 8702, 8961,
    11007, 11009, 11522, 12287, 12290, 13055, 13310, 13569,
    15361, 15871, 16382, 16641, 17150, 17409, 17666, 18431,
    6145, 6655, 6913, 7423, 7934, 8193, 9471, 9473,
    10753, 11263, 11521, 12031, 12542, 12801, 14079, 14081,
    15615, 15617, 16383, 16385, 16898, 17663, 18433, 18943,
    6145, 6655, 7167, 7169, 7681, 8191, 10239, 10241,
    10753, 11263, 11775, 11777, 12289, 12799, 14847, 14849,
    15615, 15617, 16129, 16639, 17151, 17153, 19201, 19711,
    6145, 6401, 6911, 7167, 7423, 7425, 7681, 7937,
    8447, 10239, 10495, 10497, 10753, 11009, 11519, 11521,
    11777, 12287, 12798, 12801, 14079, 14335, 14337, 6145,
    6401, 6911, 6913, 7169, 7679, 8190, 8193, 9471,
    9727, 9729, 11007, 11263, 11265, 11778, 12287, 12546,
    13055, 13566, 13569, 6399, 6655, 6657, 7170, 7679,
    7938, 8447, 8958, 8961, 11010, 11519, 12030, 12033,
    12546, 13055, 15102, 15105, 6145, 6655, 7166, 7425,
    7934, 8193, 8450, 9215, 11006, 11265, 11522, 12287,
    12542, 12801, 14594, 15359, 6399, 6401, 7167, 7169,
    7682, 8447, 9217, 9727, 10753, 11263, 11774, 12033,
    12542, 12801, 13058, 13823, 6399, 6401, 6913, 7423,
    7935, 7937, 9985, 10495, 11007, 11009, 11775, 11777,
    12290, 13055, 13825, 14335,
};
__device__ const int32_t kB8OutSlots[] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
};
// B5: 8 phases, 80 Fq products in the product phases (6, 14, 48, 12), 473 terms, 80 slots.
constexpr int kB5Phases = 8;
constexpr int kB5Slots = 80;
constexpr int kB5Inputs = 24;
constexpr int kB5Outputs = 18;
__device__ const int32_t kB5PhaseOps[] = {
    0, 6, 6, 4, 10, 14, 24, 2,
    26, 48, 74, 16, 90, 12, 102, 6,
};
__device__ const int32_t kB5Ops[] = {
    24, 0, 1, 1, 25, 2, 1, 1,
    26, 4, 2, 2, 27, 8, 1, 1,
    28, 10, 1, 1, 29, 12, 2, 2,
    31, 16, 1284, 0, 33, 20, 1284, 0,
    30, 24, 1539, 0, 32, 27, 1539, 0,
    24, 30, 2, 2, 25, 34, 1, 1,
    26, 36, 2, 2, 27, 40, 1, 1,
    28, 42, 1, 1, 29, 44, 1, 1,
    34, 46, 2, 2, 35, 50, 1, 1,
    36, 52, 1, 1, 37, 54, 2, 2,
    38, 58, 1, 1, 39, 60, 1, 1,
    40, 62, 1, 1, 41, 64, 1, 1,
    19, 66, 1286, 0, 18, 72, 1284, 0,
    20, 76, 1, 1, 21, 78, 1, 1,
    22, 80, 2, 2, 23, 84, 1, 1,
    28, 86, 1, 1, 29, 88, 2, 2,
    34, 92, 1, 1, 35, 94, 1, 1,
    36, 96, 2, 2, 37, 100, 1, 1,
    42, 102, 1, 1, 43, 104, 2, 2,
    44, 108, 1, 1, 45, 110, 1, 1,
    46, 112, 2, 2, 47, 116, 1, 1,
    48, 118, 1, 1, 49, 120, 2, 2,
    50, 124, 2, 2, 51, 128, 2, 2,
    52, 132, 260, 260, 53, 140, 1, 1,
    54, 142, 1, 1, 55, 144, 2, 2,
    56, 148, 1, 1, 57, 150, 1, 1,
    58, 152, 2, 2, 59, 156, 1, 1,
    60, 158, 1, 1, 61, 160, 2, 2,
    62, 164, 1, 1, 63, 166, 1, 1,
    64, 168, 2, 2, 65, 172, 2, 1,
    66, 175, 2, 1, 67, 178, 4, 2,
    68, 184, 2, 2, 69, 188, 2, 2,
    70, 192, 260, 260, 71, 200, 2, 2,
    72, 204, 2, 2, 73, 208, 260, 260,
    74, 216, 260, 3, 75, 223, 260, 3,
    76, 230, 264, 262, 77, 244, 2, 1,
    78, 247, 2, 1, 79, 250, 4, 2,
    9, 256, 1301, 0, 11, 277, 1295, 0,
    8, 292, 1294, 0, 7, 306, 1292, 0,
    3, 318, 1291, 0, 6, 329, 1290, 0,
    10, 339, 1290, 0, 5, 349, 1289, 0,
    13, 358, 1289, 0, 19, 367, 1289, 0,
    2, 376, 1288, 0, 1, 384, 1287, 0,
    0, 391, 1286, 0, 4, 397, 1286, 0,
    12, 403, 1286, 0, 18, 409, 1286, 0,
    23, 415, 1, 1, 24, 417, 1, 1,
    25, 419, 2, 2, 26, 423, 1, 1,
    27, 425, 1, 1, 28, 427, 2, 2,
    29, 431, 2, 1, 34, 434, 3, 1,
    35, 438, 2, 2, 36, 442, 2, 1,
    37, 445, 3, 1, 38, 449, 2, 2,
    15, 453, 1286, 0, 14, 459, 1284, 0,
    13, 463, 1539, 0, 17, 466, 1539, 0,
    12, 469, 1026, 0, 16, 471, 1026, 0,
};
__device__ const int32_t kB5Terms[] = {
    5121, 4097, 5377, 4353, 5121, 5377, 4097, 4353,
    4609, 4097, 4865, 4353, 4609, 4865, 4097, 4353,
    4095, 6399, 6655, 6657, 3583, 7167, 7423, 7425,
    3839, 6145, 6655, 3327, 6913, 7423, 8193, 8449,
    8193, 8703, 8193, 8449, 7681, 7937, 7681, 8191,
    7681, 7937, 7681, 4609, 7937, 4865, 7681, 7937,
    4609, 4865, 8193, 5121, 8449, 5377, 8193, 8449,
    5121, 5377, 7935, 5633, 8191, 5633, 8193, 5889,
    8449, 5889, 7423, 7679, 8705, 8961, 9217, 9727,
    7169, 7679, 9215, 9217, 8193, 6145, 8449, 6402,
    8193, 8449, 6145, 6402, 6145, 3073, 6402, 3329,
    6145, 6402, 3073, 3329, 6657, 4097, 6914, 4353,
    6657, 6914, 4097, 4353, 1, 4609, 257, 4865,
    1, 257, 4609, 4865, 513, 9729, 769, 9985,
    513, 769, 9729, 9985, 1025, 9729, 1281, 9985,
    1025, 1281, 9729, 9985, 1, 513, 4609, 9729,
    257, 769, 4865, 9985, 1, 257, 513, 769,
    4609, 4865, 9729, 9985, 1025, 4609, 1281, 4865,
    1025, 1281, 4609, 4865, 2561, 10241, 2817, 10497,
    2561, 2817, 10241, 10497, 1537, 10241, 1793, 10497,
    1537, 1793, 10241, 10497, 2049, 10241, 2305, 10497,
    2049, 2305, 10241, 10497, 1, 1537, 4609, 257,
    1793, 4865, 1, 257, 1537, 1793, 4609, 4865,
    513, 2049, 9729, 10241, 769, 2305, 9985, 10497,
    513, 769, 2049, 2305, 9729, 9985, 10241, 10497,
    1025, 2561, 9729, 10241, 1281, 2817, 9985, 10497,
    1025, 1281, 2561, 2817, 9729, 9985, 10241, 10497,
    1, 513, 1537, 2049, 4609, 9729, 10241, 257,
    769, 1793, 2305, 4865, 9985, 10497, 1, 257,
    513, 769, 1537, 1793, 2049, 2305, 4609, 4865,
    9729, 9985, 10241, 10497, 1025, 2561, 4609, 1281,
    2817, 4865, 1025, 1281, 2561, 2817, 4609, 4865,
    9727, 11007, 11009, 11519, 11775, 11777, 12801, 13057,
    13567, 15105, 15361, 15871, 16641, 16897, 17407, 17409,
    17665, 18175, 19199, 19455, 19457, 11265, 11521, 12031,
    13569, 13825, 14335, 15873, 16129, 16639, 17663, 17919,
    17921, 19967, 20223, 20225, 9473, 11007, 11265, 11775,
    13055, 13057, 15359, 15361, 16895, 16897, 17663, 17665,
    18945, 19455, 9473, 10753, 11263, 12290, 12799, 14594,
    15103, 16895, 17151, 17153, 18686, 18689, 9473, 10753,
    11263, 11265, 11521, 12031, 13055, 13311, 13313, 14846,
    14849, 9727, 10753, 12286, 12545, 14590, 14849, 16641,
    17151, 18178, 18943, 11519, 11521, 13823, 13825, 16127,
    16129, 17409, 17919, 19713, 20223, 11519, 11775, 11777,
    13823, 14079, 14081, 15359, 15615, 15617, 5121, 5377,
    5887, 5890, 7170, 7678, 8959, 9215, 9217, 5375,
    5631, 5633, 6141, 7421, 7427, 8705, 8961, 9471,
    9727, 10753, 11519, 11521, 12801, 13311, 14338, 15103,
    9727, 11007, 11009, 12542, 12545, 16382, 16385, 9473,
    11007, 12034, 12799, 15874, 16639, 11265, 11775, 13569,
    14079, 15105, 15615, 5375, 5377, 6142, 7170, 8705,
    9215, 5121, 5631, 5891, 7421, 8959, 8961, 8193,
    3073, 8449, 3329, 8193, 8449, 3073, 3329, 7681,
    4609, 7937, 4865, 7681, 7937, 4609, 4865, 5121,
    5631, 3585, 5375, 5631, 5633, 3841, 5630, 5633,
    3585, 3841, 5121, 5631, 4097, 5375, 5631, 5633,
    4353, 5630, 5633, 4097, 4353, 6911, 7167, 7169,
    7425, 8705, 9215, 6657, 7167, 7679, 8705, 6143,
    6399, 6401, 9471, 9727, 9729, 5889, 6399, 9217,
    9727,
};
__device__ const int32_t kB5OutSlots[] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17,
};
// B9: 2 phases, 36 Fq products in the product phases (36), 383 terms, 48 slots.
constexpr int kB9Phases = 2;
constexpr int kB9Slots = 48;
constexpr int kB9Inputs = 12;
constexpr int kB9Outputs = 12;
__device__ const int32_t kB9PhaseOps[] = {
    0, 36, 36, 12,
};
__device__ const int32_t kB9Ops[] = {
    12, 0, 1, 1, 13, 2, 1, 1,
    14, 4, 2, 2, 15, 8, 1, 1,
    16, 10, 1, 1, 17, 12, 2, 2,
    18, 16, 1, 1, 19, 18, 1, 1,
    20, 20, 2, 2, 21, 24, 2, 2,
    22, 28, 2, 2, 23, 32, 260, 260,
    24, 40, 2, 2, 25, 44, 2, 2,
    26, 48, 260, 260, 27, 56, 2, 2,
    28, 60, 2, 2, 29, 64, 260, 260,
    30, 72, 2, 3, 31, 77, 2, 3,
    32, 82, 260, 259, 33, 89, 2, 2,
    34, 93, 2, 2, 35, 97, 260, 260,
    36, 105, 2, 2, 37, 109, 2, 2,
    38, 113, 260, 260, 39, 121, 260, 260,
    40, 129, 260, 260, 41, 137, 264, 264,
    42, 153, 260, 261, 43, 162, 260, 261,
    44, 171, 264, 263, 45, 186, 260, 261,
    46, 195, 260, 261, 47, 204, 264, 263,
    5, 219, 1303, 0, 3, 242, 1299, 0,
    0, 261, 1297, 0, 1, 278, 1297, 0,
    4, 295, 1297, 0, 2, 312, 1295, 0,
    11, 327, 1292, 0, 9, 339, 1291, 0,
    7, 350, 1289, 0, 6, 359, 1288, 0,
    8, 367, 1288, 0, 10, 375, 1288, 0,
};
__device__ const int32_t kB9Terms[] = {
    1, 1537, 257, 1793, 1, 257, 1537, 1793,
    513, 2049, 769, 2305, 513, 769, 2049, 2305,
    1025, 2561, 1281, 2817, 1025, 1281, 2561, 2817,
    513, 1025, 2049, 2561, 769, 1281, 2305, 2817,
    513, 769, 1025, 1281, 2049, 2305, 2561, 2817,
    1, 513, 1537, 2049, 257, 769, 1793, 2305,
    1, 257, 513, 769, 1537, 1793, 2049, 2305,
    1, 1025, 1537, 2561, 257, 1281, 1793, 2817,
    1, 257, 1025, 1281, 1537, 1793, 2561, 2817,
    1, 1537, 1, 2561, 3071, 257, 1793, 257,
    2561, 2817, 1, 257, 1537, 1793, 1, 257,
    2562, 513, 2049, 513, 1537, 769, 2305, 769,
    1793, 513, 769, 2049, 2305, 513, 769, 1537,
    1793, 1025, 2561, 1025, 2049, 1281, 2817, 1281,
    2305, 1025, 1281, 2561, 2817, 1025, 1281, 2049,
    2305, 513, 1025, 2049, 2561, 513, 1025, 1537,
    2049, 769, 1281, 2305, 2817, 769, 1281, 1793,
    2305, 513, 769, 1025, 1281, 2049, 2305, 2561,
    2817, 513, 769, 1025, 1281, 1537, 1793, 2049,
    2305, 1, 513, 1537, 2049, 1, 513, 1537,
    2561, 3071, 257, 769, 1793, 2305, 257, 769,
    1793, 2561, 2817, 1, 257, 513, 769, 1537,
    1793, 2049, 2305, 1, 257, 513, 769, 1537,
    1793, 2562, 1, 1025, 1537, 2561, 1, 1025,
    2049, 2561, 3071, 257, 1281, 1793, 2817, 257,
    1281, 2305, 2561, 2817, 1, 257, 1025, 1281,
    1537, 1793, 2561, 2817, 1, 257, 1025, 1281,
    2049, 2305, 2562, 3326, 3582, 3586, 4863, 4865,
    6145, 6401, 6911, 6913, 7169, 7679, 7681, 7937,
    8447, 8703, 8959, 8961, 9217, 9473, 9983, 11775,
    12031, 12033, 4095, 4349, 4354, 5634, 6143, 6145,
    6401, 6911, 7681, 7937, 8447, 8449, 8705, 9215,
    9726, 9729, 11007, 11263, 11265, 3073, 3329, 3839,
    4612, 5374, 5630, 5889, 7166, 7425, 7681, 8191,
    8702, 8961, 9470, 9729, 9986, 10751, 3073, 3583,
    5116, 5122, 5634, 6143, 7170, 7679, 7935, 8191,
    8193, 8706, 9215, 9474, 9983, 10494, 10497, 3074,
    3582, 4863, 5119, 5121, 6399, 6401, 7167, 7169,
    7935, 7937, 8449, 8959, 9471, 9473, 11521, 12031,
    3843, 4351, 4607, 5630, 5889, 6399, 6401, 7935,
    7937, 8703, 8705, 9218, 9983, 10753, 11263, 3074,
    3330, 3838, 4094, 4350, 4354, 4610, 4866, 5374,
    7166, 7422, 7426, 3074, 3330, 3838, 3842, 4098,
    4606, 5116, 5122, 6398, 6654, 6658, 3326, 3582,
    3586, 4100, 4606, 4868, 5374, 5884, 5890, 3074,
    3582, 4092, 4354, 4860, 5122, 5380, 6142, 3326,
    3330, 4094, 4098, 4612, 5374, 6146, 6654, 3326,
    3330, 3842, 4350, 4862, 4866, 6914, 7422,
};
__device__ const int32_t kB9OutSlots[] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
};
// B17 dbl_step: 5 phases, 47 Fq products in the product phases (12, 19, 16), 191 terms, 39 slots.
constexpr int kDblStepPhases = 5;
constexpr int kDblStepSlots = 39;
constexpr int kDblStepInputs = 8;
constexpr int kDblStepOutputs = 12;
__device__ const int32_t kDblStepPhaseOps[] = {
    0, 12, 12, 19, 31, 6, 37, 16,
    53, 6,
};
__device__ const int32_t kDblStepOps[] = {
    8, 0, 2, 2, 9, 4, 1, 1,
    10, 6, 2, 2, 11, 10, 1, 1,
    12, 12, 1, 1, 13, 14, 1, 1,
    14, 16, 2, 2, 15, 20, 1, 1,
    16, 22, 1, 1, 17, 24, 2, 2,
    18, 28, 2, 2, 19, 32, 1, 1,
    20, 34, 2, 2, 21, 38, 3, 3,
    22, 44, 2, 2, 23, 48, 258, 258,
    24, 52, 1, 257, 25, 54, 2, 2,
    26, 58, 2, 3, 27, 63, 1, 1,
    28, 65, 1, 1, 29, 67, 2, 2,
    30, 71, 1, 1, 31, 73, 1, 1,
    32, 75, 2, 2, 33, 79, 1, 1,
    34, 81, 1, 1, 35, 83, 2, 2,
    36, 87, 1, 1, 37, 89, 1, 1,
    38, 91, 2, 2, 5, 95, 1286, 0,
    1, 101, 1284, 0, 3, 105, 1284, 0,
    4, 109, 1284, 0, 0, 113, 1283, 0,
    2, 116, 1283, 0, 15, 119, 1, 2,
    16, 122, 1, 3, 17, 126, 258, 2,
    18, 130, 1, 1, 19, 132, 1, 1,
    20, 134, 258, 2, 21, 138, 1, 1,
    22, 140, 1, 1, 23, 142, 2, 2,
    24, 146, 2, 1, 27, 149, 3, 1,
    28, 153, 2, 2, 29, 157, 2, 1,
    30, 160, 3, 1, 31, 164, 2, 1,
    32, 167, 3, 1, 3, 171, 1286, 0,
    2, 177, 1284, 0, 7, 181, 1283, 0,
    6, 184, 1282, 0, 1, 186, 1539, 0,
    0, 189, 1026, 0,
};
__device__ const int32_t kDblStepTerms[] = {
    1, 257, 1, 511, 1, 257, 513, 769,
    513, 1023, 513, 769, 513, 1025, 769, 1281,
    513, 769, 1025, 1281, 1, 513, 257, 769,
    1, 257, 513, 769, 1025, 1281, 1025, 1535,
    1025, 1281, 3841, 4351, 3073, 3583, 4095, 4351,
    4353, 3327, 3583, 3585, 4350, 4353, 3582, 3585,
    2051, 2310, 2051, 2554, 2051, 2310, 3582, 3585,
    3074, 3839, 3073, 3583, 3327, 3583, 3585, 2049,
    1, 2306, 257, 2049, 2306, 1, 257, 2561,
    1025, 2818, 1281, 2561, 2818, 1025, 1281, 2049,
    1025, 2306, 1281, 2049, 2306, 1025, 1281, 513,
    4609, 769, 4866, 513, 769, 4609, 4866, 7165,
    7421, 7427, 7682, 7938, 8446, 5128, 5384, 5880,
    6146, 5364, 5620, 5644, 6398, 6915, 7421, 7934,
    7938, 5368, 5384, 5889, 5132, 5620, 6143, 2,
    3073, 3583, 258, 3327, 3583, 3585, 2, 258,
    3582, 3585, 2051, 513, 2310, 769, 2051, 2310,
    513, 769, 2561, 6401, 2818, 6658, 2561, 2818,
    6401, 6658, 3073, 3583, 6401, 3327, 3583, 3585,
    6658, 3582, 3585, 6401, 6658, 8701, 8707, 1537,
    8451, 8707, 9213, 1537, 9218, 9726, 1793, 9470,
    9726, 9730, 1793, 4863, 5119, 5121, 5384, 5640,
    6136, 4609, 5119, 5624, 5640, 6392, 7160, 7176,
    6152, 7160, 4095, 4351, 4353, 3841, 4351,
};
__device__ const int32_t kDblStepOutSlots[] = {
    0, 1, 2, 3, 6, 7, 4, 5, 29, 30, 31, 32,
};
// B17 f_sqr_fold: 5 phases, 75 Fq products in the product phases (36, 39), 642 terms, 57 slots.
constexpr int kFSqrFoldPhases = 5;
constexpr int kFSqrFoldSlots = 57;
constexpr int kFSqrFoldInputs = 18;
constexpr int kFSqrFoldOutputs = 12;
__device__ const int32_t kFSqrFoldPhaseOps[] = {
    0, 36, 36, 12, 48, 12, 60, 39,
    99, 12,
};
__device__ const int32_t kFSqrFoldOps[] = {
    18, 0, 1, 1, 19, 2, 1, 1,
    20, 4, 2, 2, 21, 8, 1, 1,
    22, 10, 1, 1, 23, 12, 2, 2,
    24, 16, 1, 1, 25, 18, 1, 1,
    26, 20, 2, 2, 27, 24, 2, 2,
    28, 28, 2, 2, 29, 32, 260, 260,
    30, 40, 2, 2, 31, 44, 2, 2,
    32, 48, 260, 260, 33, 56, 2, 2,
    34, 60, 2, 2, 35, 64, 260, 260,
    36, 72, 2, 3, 37, 77, 2, 3,
    38, 82, 260, 259, 39, 89, 2, 2,
    40, 93, 2, 2, 41, 97, 260, 260,
    42, 105, 2, 2, 43, 109, 2, 2,
    44, 113, 260, 260, 45, 121, 260, 260,
    46, 129, 260, 260, 47, 137, 264, 264,
    48, 153, 260, 261, 49, 162, 260, 261,
    50, 171, 264, 263, 51, 186, 260, 261,
    52, 195, 260, 261, 53, 204, 264, 263,
    5, 219, 1292, 0, 11, 231, 1292, 0,
    3, 243, 1291, 0, 9, 254, 1291, 0,
    1, 265, 1289, 0, 7, 274, 1289, 0,
    0, 283, 1288, 0, 2, 291, 1288, 0,
    4, 299, 1288, 0, 6, 307, 1288, 0,
    8, 315, 1288, 0, 10, 323, 1288, 0,
    18, 331, 1284, 0, 19, 335, 1284, 0,
    20, 339, 1539, 0, 21, 342, 1539, 0,
    22, 345, 1539, 0, 23, 348, 1539, 0,
    24, 351, 1025, 0, 25, 352, 1025, 0,
    26, 353, 1025, 0, 27, 354, 1025, 0,
    28, 355, 1025, 0, 29, 356, 1025, 0,
    0, 357, 1, 1, 1, 359, 1, 1,
    2, 361, 2, 2, 3, 365, 1, 1,
    4, 367, 1, 1, 5, 369, 2, 2,
    6, 373, 1, 1, 7, 375, 1, 1,
    8, 377, 2, 2, 9, 381, 2, 2,
    10, 385, 2, 2, 11, 389, 260, 260,
    30, 397, 1, 1, 31, 399, 1, 1,
    32, 401, 2, 2, 33, 405, 1, 1,
    34, 407, 1, 1, 35, 409, 2, 2,
    36, 413, 1, 1, 37, 415, 1, 1,
    38, 417, 2, 2, 39, 421, 1, 1,
    40, 423, 1, 1, 41, 425, 2, 2,
    42, 429, 2, 1, 43, 432, 2, 1,
    44, 435, 4, 2, 45, 441, 2, 2,
    46, 445, 2, 2, 47, 449, 260, 260,
    48, 457, 2, 2, 49, 461, 2, 2,
    50, 465, 260, 260, 51, 473, 260, 3,
    52, 480, 260, 3, 53, 487, 264, 262,
    54, 501, 2, 1, 55, 504, 2, 1,
    56, 507, 4, 2, 21, 513, 1301, 0,
    23, 534, 1295, 0, 20, 549, 1294, 0,
    19, 563, 1292, 0, 15, 575, 1291, 0,
    18, 586, 1290, 0, 22, 596, 1290, 0,
    17, 606, 1289, 0, 14, 615, 1288, 0,
    13, 623, 1287, 0, 12, 630, 1286, 0,
    16, 636, 1286, 0,
};
__device__ const int32_t kFSqrFoldTerms[] = {
    1, 1537, 257, 1793, 1, 257, 1537, 1793,
    513, 2049, 769, 2305, 513, 769, 2049, 2305,
    1025, 2561, 1281, 2817, 1025, 1281, 2561, 2817,
    513, 1025, 2049, 2561, 769, 1281, 2305, 2817,
    513, 769, 1025, 1281, 2049, 2305, 2561, 2817,
    1, 513, 1537, 2049, 257, 769, 1793, 2305,
    1, 257, 513, 769, 1537, 1793, 2049, 2305,
    1, 1025, 1537, 2561, 257, 1281, 1793, 2817,
    1, 257, 1025, 1281, 1537, 1793, 2561, 2817,
    1, 1537, 1, 2561, 3071, 257, 1793, 257,
    2561, 2817, 1, 257, 1537, 1793, 1, 257,
    2562, 513, 2049, 513, 1537, 769, 2305, 769,
    1793, 513, 769, 2049, 2305, 513, 769, 1537,
    1793, 1025, 2561, 1025, 2049, 1281, 2817, 1281,
    2305, 1025, 1281, 2561, 2817, 1025, 1281, 2049,
    2305, 513, 1025, 2049, 2561, 513, 1025, 1537,
    2049, 769, 1281, 2305, 2817, 769, 1281, 1793,
    2305, 513, 769, 1025, 1281, 2049, 2305, 2561,
    2817, 513, 769, 1025, 1281, 1537, 1793, 2049,
    2305, 1, 513, 1537, 2049, 1, 513, 1537,
    2561, 3071, 257, 769, 1793, 2305, 257, 769,
    1793, 2561, 2817, 1, 257, 513, 769, 1537,
    1793, 2049, 2305, 1, 257, 513, 769, 1537,
    1793, 2562, 1, 1025, 1537, 2561, 1, 1025,
    2049, 2561, 3071, 257, 1281, 1793, 2817, 257,
    1281, 2305, 2561, 2817, 1, 257, 1025, 1281,
    1537, 1793, 2561, 2817, 1, 257, 1025, 1281,
    2049, 2305, 2562, 4609, 4865, 5375, 5631, 5887,
    5889, 6145, 6401, 6911, 8703, 8959, 8961, 9217,
    9473, 9983, 10239, 10495, 10497, 10753, 11009, 11519,
    13311, 13567, 13569, 4609, 4865, 5375, 5377, 5633,
    6143, 6654, 6657, 7935, 8191, 8193, 9217, 9473,
    9983, 9985, 10241, 10751, 11262, 11265, 12543, 12799,
    12801, 4863, 5119, 5121, 5634, 6143, 6402, 6911,
    7422, 7425, 9471, 9727, 9729, 10242, 10751, 11010,
    11519, 12030, 12033, 4609, 5119, 5630, 5889, 6398,
    6657, 6914, 7679, 4863, 4865, 5631, 5633, 6146,
    6911, 7681, 8191, 4863, 4865, 5377, 5887, 6399,
    6401, 8449, 8959, 9217, 9727, 10238, 10497, 11006,
    11265, 11522, 12287, 9471, 9473, 10239, 10241, 10754,
    11519, 12289, 12799, 9471, 9473, 9985, 10495, 11007,
    11009, 13057, 13567, 255, 1279, 1281, 1537, 511,
    1279, 1535, 1793, 255, 767, 2049, 511, 1023,
    2305, 767, 1279, 2561, 1023, 1535, 2817, 2,
    258, 514, 770, 1026, 1282, 4609, 3073, 4865,
    3329, 4609, 4865, 3073, 3329, 5121, 3585, 5377,
    3841, 5121, 5377, 3585, 3841, 5633, 3585, 5889,
    3841, 5633, 5889, 3585, 3841, 4609, 5121, 3073,
    3585, 4865, 5377, 3329, 3841, 4609, 4865, 5121,
    5377, 3073, 3329, 3585, 3841, 5633, 3073, 5889,
    3329, 5633, 5889, 3073, 3329, 7169, 4097, 7425,
    4353, 7169, 7425, 4097, 4353, 6145, 4097, 6401,
    4353, 6145, 6401, 4097, 4353, 6657, 4097, 6913,
    4353, 6657, 6913, 4097, 4353, 4609, 6145, 3073,
    4865, 6401, 3329, 4609, 4865, 6145, 6401, 3073,
    3329, 5121, 6657, 3585, 4097, 5377, 6913, 3841,
    4353, 5121, 5377, 6657, 6913, 3585, 3841, 4097,
    4353, 5633, 7169, 3585, 4097, 5889, 7425, 3841,
    4353, 5633, 5889, 7169, 7425, 3585, 3841, 4097,
    4353, 4609, 5121, 6145, 6657, 3073, 3585, 4097,
    4865, 5377, 6401, 6913, 3329, 3841, 4353, 4609,
    4865, 5121, 5377, 6145, 6401, 6657, 6913, 3073,
    3329, 3585, 3841, 4097, 4353, 5633, 7169, 3073,
    5889, 7425, 3329, 5633, 5889, 7169, 7425, 3073,
    3329, 255, 511, 513, 1023, 1279, 1281, 2305,
    2561, 3071, 9217, 9473, 9983, 10753, 11009, 11519,
    11521, 11777, 12287, 13311, 13567, 13569, 769, 1025,
    1535, 7681, 7937, 8447, 9985, 10241, 10751, 11775,
    12031, 12033, 14079, 14335, 14337, 1, 511, 769,
    1279, 2559, 2561, 9471, 9473, 11007, 11009, 11775,
    11777, 13057, 13567, 1, 257, 767, 1794, 2303,
    8706, 9215, 11007, 11263, 11265, 12798, 12801, 1,
    257, 767, 769, 1025, 1535, 2559, 2815, 2817,
    8958, 8961, 255, 257, 1790, 2049, 8702, 8961,
    10753, 11263, 12290, 13055, 1023, 1025, 7935, 7937,
    10239, 10241, 11521, 12031, 13825, 14335, 1023, 1279,
    1281, 7935, 8191, 8193, 9471, 9727, 9729, 255,
    257, 1023, 1025, 2305, 2815, 8450, 9215, 255,
    511, 513, 2046, 2049, 10494, 10497, 1, 511,
    1538, 2303, 9986, 10751, 769, 1279, 7681, 8191,
    9217, 9727,
};
__device__ const int32_t kFSqrFoldOutSlots[] = {
    12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
};
// B17 add_step: 8 phases, 41 Fq products in the product phases (6, 14, 9, 12), 188 terms, 33 slots.
constexpr int kAddStepPhases = 8;
constexpr int kAddStepSlots = 33;
constexpr int kAddStepInputs = 12;
constexpr int kAddStepOutputs = 12;
__device__ const int32_t kAddStepPhaseOps[] = {
    0, 6, 6, 4, 10, 14, 24, 2,
    26, 9, 35, 4, 39, 12, 51, 6,
};
__device__ const int32_t kAddStepOps[] = {
    12, 0, 1, 1, 13, 2, 1, 1,
    14, 4, 2, 2, 15, 8, 1, 1,
    16, 10, 1, 1, 17, 12, 2, 2,
    19, 16, 1284, 0, 21, 20, 1284, 0,
    18, 24, 1539, 0, 20, 27, 1539, 0,
    12, 30, 2, 2, 13, 34, 1, 1,
    14, 36, 2, 2, 15, 40, 1, 1,
    16, 42, 1, 1, 17, 44, 1, 1,
    22, 46, 2, 2, 23, 50, 1, 1,
    24, 52, 1, 1, 25, 54, 2, 2,
    26, 58, 1, 1, 27, 60, 1, 1,
    28, 62, 1, 1, 29, 64, 1, 1,
    7, 66, 1286, 0, 6, 72, 1284, 0,
    8, 76, 1, 1, 9, 78, 1, 1,
    10, 80, 2, 2, 11, 84, 1, 1,
    16, 86, 1, 1, 17, 88, 2, 2,
    22, 92, 1, 1, 23, 94, 1, 1,
    24, 96, 2, 2, 1, 100, 1289, 0,
    13, 109, 1289, 0, 0, 118, 1286, 0,
    12, 124, 1286, 0, 11, 130, 1, 1,
    14, 132, 1, 1, 15, 134, 2, 2,
    16, 138, 1, 1, 17, 140, 1, 1,
    22, 142, 2, 2, 23, 146, 2, 1,
    24, 149, 3, 1, 25, 153, 2, 2,
    30, 157, 2, 1, 31, 160, 3, 1,
    32, 164, 2, 2, 3, 168, 1286, 0,
    2, 174, 1284, 0, 1, 178, 1539, 0,
    5, 181, 1539, 0, 0, 184, 1026, 0,
    4, 186, 1026, 0,
};
__device__ const int32_t kAddStepTerms[] = {
    2049, 1025, 2305, 1281, 2049, 2305, 1025, 1281,
    1537, 1025, 1793, 1281, 1537, 1793, 1025, 1281,
    1023, 3327, 3583, 3585, 511, 4095, 4351, 4353,
    767, 3073, 3583, 255, 3841, 4351, 5121, 5377,
    5121, 5631, 5121, 5377, 4609, 4865, 4609, 5119,
    4609, 4865, 4609, 1537, 4865, 1793, 4609, 4865,
    1537, 1793, 5121, 2049, 5377, 2305, 5121, 5377,
    2049, 2305, 4863, 2561, 5119, 2561, 5121, 2817,
    5377, 2817, 4351, 4607, 5633, 5889, 6145, 6655,
    4097, 4607, 6143, 6145, 5121, 3073, 5377, 3330,
    5121, 5377, 3073, 3330, 3073, 1, 3330, 257,
    3073, 3330, 1, 257, 3585, 1025, 3842, 1281,
    3585, 3842, 1025, 1281, 2049, 2305, 2815, 2818,
    4098, 4606, 5887, 6143, 6145, 2303, 2559, 2561,
    3069, 4349, 4355, 5633, 5889, 6399, 2303, 2305,
    3070, 4098, 5633, 6143, 2049, 2559, 2819, 4349,
    5887, 5889, 5121, 1, 5377, 257, 5121, 5377,
    1, 257, 4609, 3073, 4865, 3329, 4609, 4865,
    3073, 3329, 2049, 2559, 513, 2303, 2559, 2561,
    769, 2558, 2561, 513, 769, 2049, 2559, 1025,
    2303, 2559, 2561, 1281, 2558, 2561, 1025, 1281,
    4351, 4607, 5633, 5889, 6145, 6655, 4097, 4607,
    6143, 6145, 3071, 3839, 3841, 7935, 8191, 8193,
    2817, 3839, 7681, 8191,
};
__device__ const int32_t kAddStepOutSlots[] = {
    0, 1, 2, 3, 4, 5, 6, 7, 26, 27, 28, 29,
};
// B17 f_fold: 2 phases, 39 Fq products in the product phases (39), 285 terms, 57 slots.
constexpr int kFFoldPhases = 2;
constexpr int kFFoldSlots = 57;
constexpr int kFFoldInputs = 18;
constexpr int kFFoldOutputs = 12;
__device__ const int32_t kFFoldPhaseOps[] = {
    0, 39, 39, 12,
};
__device__ const int32_t kFFoldOps[] = {
    18, 0, 1, 1, 19, 2, 1, 1,
    20, 4, 2, 2, 21, 8, 1, 1,
    22, 10, 1, 1, 23, 12, 2, 2,
    24, 16, 1, 1, 25, 18, 1, 1,
    26, 20, 2, 2, 27, 24, 2, 2,
    28, 28, 2, 2, 29, 32, 260, 260,
    30, 40, 1, 1, 31, 42, 1, 1,
    32, 44, 2, 2, 33, 48, 1, 1,
    34, 50, 1, 1, 35, 52, 2, 2,
    36, 56, 1, 1, 37, 58, 1, 1,
    38, 60, 2, 2, 39, 64, 1, 1,
    40, 66, 1, 1, 41, 68, 2, 2,
    42, 72, 2, 1, 43, 75, 2, 1,
    44, 78, 4, 2, 45, 84, 2, 2,
    46, 88, 2, 2, 47, 92, 260, 260,
    48, 100, 2, 2, 49, 104, 2, 2,
    50, 108, 260, 260, 51, 116, 260, 3,
    52, 123, 260, 3, 53, 130, 264, 262,
    54, 144, 2, 1, 55, 147, 2, 1,
    56, 150, 4, 2, 9, 156, 1301, 0,
    11, 177, 1295, 0, 8, 192, 1294, 0,
    7, 206, 1292, 0, 3, 218, 1291, 0,
    6, 229, 1290, 0, 10, 239, 1290, 0,
    5, 249, 1289, 0, 2, 258, 1288, 0,
    1, 266, 1287, 0, 0, 273, 1286, 0,
    4, 279, 1286, 0,
};
__device__ const int32_t kFFoldTerms[] = {
    1, 3073, 257, 3329, 1, 257, 3073, 3329,
    513, 3585, 769, 3841, 513, 769, 3585, 3841,
    1025, 3585, 1281, 3841, 1025, 1281, 3585, 3841,
    1, 513, 3073, 3585, 257, 769, 3329, 3841,
    1, 257, 513, 769, 3073, 3329, 3585, 3841,
    1025, 3073, 1281, 3329, 1025, 1281, 3073, 3329,
    2561, 4097, 2817, 4353, 2561, 2817, 4097, 4353,
    1537, 4097, 1793, 4353, 1537, 1793, 4097, 4353,
    2049, 4097, 2305, 4353, 2049, 2305, 4097, 4353,
    1, 1537, 3073, 257, 1793, 3329, 1, 257,
    1537, 1793, 3073, 3329, 513, 2049, 3585, 4097,
    769, 2305, 3841, 4353, 513, 769, 2049, 2305,
    3585, 3841, 4097, 4353, 1025, 2561, 3585, 4097,
    1281, 2817, 3841, 4353, 1025, 1281, 2561, 2817,
    3585, 3841, 4097, 4353, 1, 513, 1537, 2049,
    3073, 3585, 4097, 257, 769, 1793, 2305, 3329,
    3841, 4353, 1, 257, 513, 769, 1537, 1793,
    2049, 2305, 3073, 3329, 3585, 3841, 4097, 4353,
    1025, 2561, 3073, 1281, 2817, 3329, 1025, 1281,
    2561, 2817, 3073, 3329, 4863, 5119, 5121, 5631,
    5887, 5889, 6913, 7169, 7679, 9217, 9473, 9983,
    10753, 11009, 11519, 11521, 11777, 12287, 13311, 13567,
    13569, 5377, 5633, 6143, 7681, 7937, 8447, 9985,
    10241, 10751, 11775, 12031, 12033, 14079, 14335, 14337,
    4609, 5119, 5377, 5887, 7167, 7169, 9471, 9473,
    11007, 11009, 11775, 11777, 13057, 13567, 4609, 4865,
    5375, 6402, 6911, 8706, 9215, 11007, 11263, 11265,
    12798, 12801, 4609, 4865, 5375, 5377, 5633, 6143,
    7167, 7423, 7425, 8958, 8961, 4863, 4865, 6398,
    6657, 8702, 8961, 10753, 11263, 12290, 13055, 5631,
    5633, 7935, 7937, 10239, 10241, 11521, 12031, 13825,
    14335, 5631, 5887, 5889, 7935, 8191, 8193, 9471,
    9727, 9729, 4863, 4865, 5631, 5633, 6913, 7423,
    8450, 9215, 4863, 5119, 5121, 6654, 6657, 10494,
    10497, 4609, 5119, 6146, 6911, 9986, 10751, 5377,
    5887, 7681, 8191, 9217, 9727,
};
__device__ const int32_t kFFoldOutSlots[] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
};
// B18 frob_mul k = 1: 3 phases, 64 Fq products in the product phases (10, 54), 590 terms, 78 slots.
constexpr int kFrobMul1Phases = 3;
constexpr int kFrobMul1Slots = 78;
constexpr int kFrobMul1Inputs = 24;
constexpr int kFrobMul1Outputs = 12;
__device__ const int32_t kFrobMul1PhaseOps[] = {
    0, 10, 10, 54, 64, 12,
};
__device__ const int32_t kFrobMul1Ops[] = {
    24, 0, 1, 2049, 25, 2, 1, 2049,
    26, 4, 1, 2049, 27, 6, 1, 2049,
    28, 8, 2, 2049, 29, 11, 2, 2049,
    30, 14, 2, 2049, 31, 17, 2, 2049,
    32, 20, 2, 2049, 33, 23, 2, 2049,
    14, 26, 1, 1, 15, 28, 1, 1,
    16, 30, 2, 2, 17, 34, 1, 1,
    18, 36, 1, 1, 19, 38, 2, 2,
    20, 42, 1, 1, 21, 44, 1, 1,
    22, 46, 2, 2, 23, 50, 2, 2,
    34, 54, 2, 2, 35, 58, 260, 260,
    36, 66, 2, 2, 37, 70, 2, 2,
    38, 74, 260, 260, 39, 82, 2, 2,
    40, 86, 2, 2, 41, 90, 260, 260,
    42, 98, 1, 1, 43, 100, 1, 1,
    44, 102, 2, 2, 45, 106, 1, 1,
    46, 108, 1, 1, 47, 110, 2, 2,
    48, 114, 1, 1, 49, 116, 1, 1,
    50, 118, 2, 2, 51, 122, 2, 2,
    52, 126, 2, 2, 53, 130, 260, 260,
    54, 138, 2, 2, 55, 142, 2, 2,
    56, 146, 260, 260, 57, 154, 2, 2,
    58, 158, 2, 2, 59, 162, 260, 260,
    60, 170, 2, 2, 61, 174, 2, 2,
    62, 178, 260, 260, 63, 186, 2, 2,
    64, 190, 2, 2, 65, 194, 260, 260,
    66, 202, 2, 2, 67, 206, 2, 2,
    68, 210, 260, 260, 69, 218, 260, 260,
    70, 226, 260, 260, 71, 234, 264, 264,
    72, 250, 260, 260, 73, 258, 260, 260,
    74, 266, 264, 264, 75, 282, 260, 260,
    76, 290, 260, 260, 77, 298, 264, 264,
    11, 314, 1316, 0, 9, 350, 1313, 0,
    7, 383, 1307, 0, 6, 410, 1304, 0,
    8, 434, 1304, 0, 10, 458, 1304, 0,
    5, 482, 1303, 0, 3, 505, 1300, 0,
    1, 525, 1297, 0, 0, 542, 1296, 0,
    2, 558, 1296, 0, 4, 574, 1296, 0,
};
__device__ const int32_t kFrobMul1Terms[] = {
    4095, 1, 3585, 1, 4097, 257, 4607, 257,
    4609, 5119, 513, 4609, 4865, 513, 5121, 5377,
    769, 5121, 5631, 769, 5633, 6143, 1025, 5633,
    5889, 1025, 1, 3073, 257, 3583, 1, 257,
    3073, 3583, 513, 6399, 769, 6401, 513, 769,
    6399, 6401, 1025, 6657, 1281, 6913, 1025, 1281,
    6657, 6913, 513, 1025, 6399, 6657, 769, 1281,
    6401, 6913, 513, 769, 1025, 1281, 6399, 6401,
    6657, 6913, 1, 513, 3073, 6399, 257, 769,
    3583, 6401, 1, 257, 513, 769, 3073, 3583,
    6399, 6401, 1, 1025, 3073, 6657, 257, 1281,
    3583, 6913, 1, 257, 1025, 1281, 3073, 3583,
    6657, 6913, 1537, 7169, 1793, 7679, 1537, 1793,
    7169, 7679, 2049, 7681, 2305, 7937, 2049, 2305,
    7681, 7937, 2561, 8193, 2817, 8703, 2561, 2817,
    8193, 8703, 2049, 2561, 7681, 8193, 2305, 2817,
    7937, 8703, 2049, 2305, 2561, 2817, 7681, 7937,
    8193, 8703, 1537, 2049, 7169, 7681, 1793, 2305,
    7679, 7937, 1537, 1793, 2049, 2305, 7169, 7679,
    7681, 7937, 1537, 2561, 7169, 8193, 1793, 2817,
    7679, 8703, 1537, 1793, 2561, 2817, 7169, 7679,
    8193, 8703, 1, 1537, 3073, 7169, 257, 1793,
    3583, 7679, 1, 257, 1537, 1793, 3073, 3583,
    7169, 7679, 513, 2049, 6399, 7681, 769, 2305,
    6401, 7937, 513, 769, 2049, 2305, 6399, 6401,
    7681, 7937, 1025, 2561, 6657, 8193, 1281, 2817,
    6913, 8703, 1025, 1281, 2561, 2817, 6657, 6913,
    8193, 8703, 513, 1025, 2049, 2561, 6399, 6657,
    7681, 8193, 769, 1281, 2305, 2817, 6401, 6913,
    7937, 8703, 513, 769, 1025, 1281, 2049, 2305,
    2561, 2817, 6399, 6401, 6657, 6913, 7681, 7937,
    8193, 8703, 1, 513, 1537, 2049, 3073, 6399,
    7169, 7681, 257, 769, 1793, 2305, 3583, 6401,
    7679, 7937, 1, 257, 513, 769, 1537, 1793,
    2049, 2305, 3073, 3583, 6399, 6401, 7169, 7679,
    7681, 7937, 1, 1025, 1537, 2561, 3073, 6657,
    7169, 8193, 257, 1281, 1793, 2817, 3583, 6913,
    7679, 8703, 1, 257, 1025, 1281, 1537, 1793,
    2561, 2817, 3073, 3583, 6657, 6913, 7169, 7679,
    8193, 8703, 3839, 4095, 4097, 4353, 4609, 5119,
    5375, 5631, 5633, 9985, 10241, 10751, 11007, 11263,
    11265, 11521, 11777, 12287, 12543, 12799, 12801, 14593,
    14849, 15359, 15361, 15617, 16127, 16383, 16639, 16641,
    16897, 17153, 17663, 19455, 19711, 19713, 3839, 4095,
    4097, 4607, 4863, 4865, 5378, 5887, 9217, 9473,
    9983, 11007, 11263, 11265, 11775, 12031, 12033, 12546,
    13055, 13825, 14081, 14591, 15361, 15617, 16127, 16129,
    16385, 16895, 17406, 17409, 18687, 18943, 18945, 3585,
    3841, 4351, 4862, 4865, 5630, 5633, 8706, 9215,
    10753, 11009, 11519, 12030, 12033, 12798, 12801, 13314,
    13823, 15615, 15871, 15873, 16386, 16895, 17154, 17663,
    18174, 18177, 3839, 3841, 4354, 5119, 5122, 5887,
    6142, 8961, 11007, 11009, 11522, 12287, 12290, 13055,
    13310, 13569, 15361, 15871, 16382, 16641, 17150, 17409,
    17666, 18431, 3585, 4095, 4353, 4863, 5374, 5633,
    9471, 9473, 10753, 11263, 11521, 12031, 12542, 12801,
    14079, 14081, 15615, 15617, 16383, 16385, 16898, 17663,
    18433, 18943, 3585, 4095, 4607, 4609, 5121, 5631,
    10239, 10241, 10753, 11263, 11775, 11777, 12289, 12799,
    14847, 14849, 15615, 15617, 16129, 16639, 17151, 17153,
    19201, 19711, 3585, 3841, 4351, 4607, 4863, 4865,
    5121, 5377, 5887, 10239, 10495, 10497, 10753, 11009,
    11519, 11521, 11777, 12287, 12798, 12801, 14079, 14335,
    14337, 3585, 3841, 4351, 4353, 4609, 5119, 5630,
    5633, 9471, 9727, 9729, 11007, 11263, 11265, 11778,
    12287, 12546, 13055, 13566, 13569, 3839, 4095, 4097,
    4610, 5119, 5378, 5887, 8958, 8961, 11010, 11519,
    12030, 12033, 12546, 13055, 15102, 15105, 3585, 4095,
    4606, 4865, 5374, 5633, 5890, 9215, 11006, 11265,
    11522, 12287, 12542, 12801, 14594, 15359, 3839, 3841,
    4607, 4609, 5122, 5887, 9217, 9727, 10753, 11263,
    11774, 12033, 12542, 12801, 13058, 13823, 3839, 3841,
    4353, 4863, 5375, 5377, 9985, 10495, 11007, 11009,
    11775, 11777, 12290, 13055, 13825, 14335,
};
__device__ const int32_t kFrobMul1OutSlots[] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
};
// B18 frob_mul k = 2: 3 phases, 64 Fq products in the product phases (10, 54), 584 terms, 78 slots.
constexpr int kFrobMul2Phases = 3;
constexpr int kFrobMul2Slots = 78;
constexpr int kFrobMul2Inputs = 24;
constexpr int kFrobMul2Outputs = 12;
__device__ const int32_t kFrobMul2PhaseOps[] = {
    0, 10, 10, 54, 64, 12,
};
__device__ const int32_t kFrobMul2Ops[] = {
    24, 0, 1, 2049, 25, 2, 1, 2049,
    26, 4, 1, 2049, 27, 6, 1, 2049,
    28, 8, 1, 2049, 29, 10, 1, 2049,
    30, 12, 1, 2049, 31, 14, 1, 2049,
    32, 16, 1, 2049, 33, 18, 1, 2049,
    14, 20, 1, 1, 15, 22, 1, 1,
    16, 24, 2, 2, 17, 28, 1, 1,
    18, 30, 1, 1, 19, 32, 2, 2,
    20, 36, 1, 1, 21, 38, 1, 1,
    22, 40, 2, 2, 23, 44, 2, 2,
    34, 48, 2, 2, 35, 52, 260, 260,
    36, 60, 2, 2, 37, 64, 2, 2,
    38, 68, 260, 260, 39, 76, 2, 2,
    40, 80, 2, 2, 41, 84, 260, 260,
    42, 92, 1, 1, 43, 94, 1, 1,
    44, 96, 2, 2, 45, 100, 1, 1,
    46, 102, 1, 1, 47, 104, 2, 2,
    48, 108, 1, 1, 49, 110, 1, 1,
    50, 112, 2, 2, 51, 116, 2, 2,
    52, 120, 2, 2, 53, 124, 260, 260,
    54, 132, 2, 2, 55, 136, 2, 2,
    56, 140, 260, 260, 57, 148, 2, 2,
    58, 152, 2, 2, 59, 156, 260, 260,
    60, 164, 2, 2, 61, 168, 2, 2,
    62, 172, 260, 260, 63, 180, 2, 2,
    64, 184, 2, 2, 65, 188, 260, 260,
    66, 196, 2, 2, 67, 200, 2, 2,
    68, 204, 260, 260, 69, 212, 260, 260,
    70, 220, 260, 260, 71, 228, 264, 264,
    72, 244, 260, 260, 73, 252, 260, 260,
    74, 260, 264, 264, 75, 276, 260, 260,
    76, 284, 260, 260, 77, 292, 264, 264,
    11, 308, 1316, 0, 9, 344, 1313, 0,
    7, 377, 1307, 0, 6, 404, 1304, 0,
    8, 428, 1304, 0, 10, 452, 1304, 0,
    5, 476, 1303, 0, 3, 499, 1300, 0,
    1, 519, 1297, 0, 0, 536, 1296, 0,
    2, 552, 1296, 0, 4, 568, 1296, 0,
};
__device__ const int32_t kFrobMul2Terms[] = {
    3585, 1281, 3841, 1281, 4097, 1, 4353, 1,
    4609, 1537, 4865, 1537, 5121, 1793, 5377, 1793,
    5633, 257, 5889, 257, 1, 3073, 257, 3329,
    1, 257, 3073, 3329, 513, 6145, 769, 6401,
    513, 769, 6145, 6401, 1025, 6657, 1281, 6913,
    1025, 1281, 6657, 6913, 513, 1025, 6145, 6657,
    769, 1281, 6401, 6913, 513, 769, 1025, 1281,
    6145, 6401, 6657, 6913, 1, 513, 3073, 6145,
    257, 769, 3329, 6401, 1, 257, 513, 769,
    3073, 3329, 6145, 6401, 1, 1025, 3073, 6657,
    257, 1281, 3329, 6913, 1, 257, 1025, 1281,
    3073, 3329, 6657, 6913, 1537, 7169, 1793, 7425,
    1537, 1793, 7169, 7425, 2049, 7681, 2305, 7937,
    2049, 2305, 7681, 7937, 2561, 8193, 2817, 8449,
    2561, 2817, 8193, 8449, 2049, 2561, 7681, 8193,
    2305, 2817, 7937, 8449, 2049, 2305, 2561, 2817,
    7681, 7937, 8193, 8449, 1537, 2049, 7169, 7681,
    1793, 2305, 7425, 7937, 1537, 1793, 2049, 2305,
    7169, 7425, 7681, 7937, 1537, 2561, 7169, 8193,
    1793, 2817, 7425, 8449, 1537, 1793, 2561, 2817,
    7169, 7425, 8193, 8449, 1, 1537, 3073, 7169,
    257, 1793, 3329, 7425, 1, 257, 1537, 1793,
    3073, 3329, 7169, 7425, 513, 2049, 6145, 7681,
    769, 2305, 6401, 7937, 513, 769, 2049, 2305,
    6145, 6401, 7681, 7937, 1025, 2561, 6657, 8193,
    1281, 2817, 6913, 8449, 1025, 1281, 2561, 2817,
    6657, 6913, 8193, 8449, 513, 1025, 2049, 2561,
    6145, 6657, 7681, 8193, 769, 1281, 2305, 2817,
    6401, 6913, 7937, 8449, 513, 769, 1025, 1281,
    2049, 2305, 2561, 2817, 6145, 6401, 6657, 6913,
    7681, 7937, 8193, 8449, 1, 513, 1537, 2049,
    3073, 6145, 7169, 7681, 257, 769, 1793, 2305,
    3329, 6401, 7425, 7937, 1, 257, 513, 769,
    1537, 1793, 2049, 2305, 3073, 3329, 6145, 6401,
    7169, 7425, 7681, 7937, 1, 1025, 1537, 2561,
    3073, 6657, 7169, 8193, 257, 1281, 1793, 2817,
    3329, 6913, 7425, 8449, 1, 257, 1025, 1281,
    1537, 1793, 2561, 2817, 3073, 3329, 6657, 6913,
    7169, 7425, 8193, 8449, 3839, 4095, 4097, 4353,
    4609, 5119, 5375, 5631, 5633, 9985, 10241, 10751,
    11007, 11263, 11265, 11521, 11777, 12287, 12543, 12799,
    12801, 14593, 14849, 15359, 15361, 15617, 16127, 16383,
    16639, 16641, 16897, 17153, 17663, 19455, 19711, 19713,
    3839, 4095, 4097, 4607, 4863, 4865, 5378, 5887,
    9217, 9473, 9983, 11007, 11263, 11265, 11775, 12031,
    12033, 12546, 13055, 13825, 14081, 14591, 15361, 15617,
    16127, 16129, 16385, 16895, 17406, 17409, 18687, 18943,
    18945, 3585, 3841, 4351, 4862, 4865, 5630, 5633,
    8706, 9215, 10753, 11009, 11519, 12030, 12033, 12798,
    12801, 13314, 13823, 15615, 15871, 15873, 16386, 16895,
    17154, 17663, 18174, 18177, 3839, 3841, 4354, 5119,
    5122, 5887, 6142, 8961, 11007, 11009, 11522, 12287,
    12290, 13055, 13310, 13569, 15361, 15871, 16382, 16641,
    17150, 17409, 17666, 18431, 3585, 4095, 4353, 4863,
    5374, 5633, 9471, 9473, 10753, 11263, 11521, 12031,
    12542, 12801, 14079, 14081, 15615, 15617, 16383, 16385,
    16898, 17663, 18433, 18943, 3585, 4095, 4607, 4609,
    5121, 5631, 10239, 10241, 10753, 11263, 11775, 11777,
    12289, 12799, 14847, 14849, 15615, 15617, 16129, 16639,
    17151, 17153, 19201, 19711, 3585, 3841, 4351, 4607,
    4863, 4865, 5121, 5377, 5887, 10239, 10495, 10497,
    10753, 11009, 11519, 11521, 11777, 12287, 12798, 12801,
    14079, 14335, 14337, 3585, 3841, 4351, 4353, 4609,
    5119, 5630, 5633, 9471, 9727, 9729, 11007, 11263,
    11265, 11778, 12287, 12546, 13055, 13566, 13569, 3839,
    4095, 4097, 4610, 5119, 5378, 5887, 8958, 8961,
    11010, 11519, 12030, 12033, 12546, 13055, 15102, 15105,
    3585, 4095, 4606, 4865, 5374, 5633, 5890, 9215,
    11006, 11265, 11522, 12287, 12542, 12801, 14594, 15359,
    3839, 3841, 4607, 4609, 5122, 5887, 9217, 9727,
    10753, 11263, 11774, 12033, 12542, 12801, 13058, 13823,
    3839, 3841, 4353, 4863, 5375, 5377, 9985, 10495,
    11007, 11009, 11775, 11777, 12290, 13055, 13825, 14335,
};
__device__ const int32_t kFrobMul2OutSlots[] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
};
// B18 easy_down: 8 phases, 62 Fq products in the product phases (36, 15, 9, 2), 563 terms, 54 slots.
constexpr int kEasyDownPhases = 8;
constexpr int kEasyDownSlots = 54;
constexpr int kEasyDownInputs = 12;
constexpr int kEasyDownOutputs = 21;
__device__ const int32_t kEasyDownPhaseOps[] = {
    0, 36, 36, 18, 54, 15, 69, 6,
    75, 9, 84, 2, 86, 2, 88, 1,
};
__device__ const int32_t kEasyDownOps[] = {
    12, 0, 2, 2, 13, 4, 1, 1,
    14, 6, 2, 2, 15, 10, 1, 1,
    16, 12, 2, 2, 17, 16, 1, 1,
    18, 18, 260, 260, 19, 26, 2, 2,
    20, 30, 260, 260, 21, 38, 2, 2,
    22, 42, 260, 260, 23, 50, 2, 2,
    24, 54, 2, 2, 25, 58, 1, 1,
    26, 60, 2, 2, 27, 64, 1, 1,
    28, 66, 2, 2, 29, 70, 1, 1,
    30, 72, 260, 260, 31, 80, 2, 2,
    32, 84, 260, 260, 33, 92, 2, 2,
    34, 96, 260, 260, 35, 104, 2, 2,
    36, 108, 260, 260, 37, 116, 2, 2,
    38, 120, 260, 260, 39, 128, 2, 2,
    40, 132, 260, 260, 41, 140, 2, 2,
    42, 144, 264, 264, 43, 160, 260, 260,
    44, 168, 264, 264, 45, 184, 260, 260,
    46, 192, 264, 264, 47, 208, 260, 260,
    48, 216, 1301, 0, 49, 237, 1301, 0,
    0, 258, 1295, 0, 1, 273, 1295, 0,
    6, 288, 1295, 0, 7, 303, 1295, 0,
    50, 318, 1295, 0, 51, 333, 1295, 0,
    2, 348, 1292, 0, 3, 360, 1292, 0,
    8, 372, 1292, 0, 9, 384, 1292, 0,
    52, 396, 1292, 0, 53, 408, 1292, 0,
    4, 420, 1289, 0, 5, 429, 1289, 0,
    10, 438, 1289, 0, 11, 447, 1289, 0,
    12, 456, 2, 2, 13, 460, 1, 1,
    14, 462, 2, 2, 15, 466, 1, 1,
    16, 468, 2, 2, 17, 472, 1, 1,
    18, 474, 1, 1, 19, 476, 1, 1,
    20, 478, 2, 2, 21, 482, 1, 1,
    22, 484, 1, 1, 23, 486, 2, 2,
    24, 490, 1, 1, 25, 492, 1, 1,
    26, 494, 2, 2, 30, 498, 1285, 0,
    29, 503, 1284, 0, 32, 507, 1284, 0,
    27, 511, 1283, 0, 28, 514, 1283, 0,
    31, 517, 1539, 0, 12, 520, 1, 1,
    13, 522, 1, 1, 14, 524, 2, 2,
    15, 528, 1, 1, 16, 530, 1, 1,
    17, 532, 2, 2, 18, 536, 1, 1,
    19, 538, 1, 1, 20, 540, 2, 2,
    1, 544, 1287, 0, 0, 551, 1286, 0,
    2, 557, 1, 1, 3, 559, 1, 1,
    4, 561, 1026, 0,
};
__device__ const int32_t kEasyDownTerms[] = {
    1, 257, 1, 511, 1, 257, 513, 769,
    513, 1023, 513, 769, 1025, 1281, 1025, 1535,
    1025, 1281, 513, 769, 1025, 1281, 513, 1023,
    1025, 1535, 513, 1025, 769, 1281, 1, 257,
    513, 769, 1, 511, 513, 1023, 1, 513,
    257, 769, 1, 257, 1025, 1281, 1, 511,
    1025, 1535, 1, 1025, 257, 1281, 1537, 1793,
    1537, 2047, 1537, 1793, 2049, 2305, 2049, 2559,
    2049, 2305, 2561, 2817, 2561, 3071, 2561, 2817,
    2049, 2305, 2561, 2817, 2049, 2559, 2561, 3071,
    2049, 2561, 2305, 2817, 1537, 1793, 2049, 2305,
    1537, 2047, 2049, 2559, 1537, 2049, 1793, 2305,
    1537, 1793, 2561, 2817, 1537, 2047, 2561, 3071,
    1537, 2561, 1793, 2817, 1, 257, 1537, 1793,
    1, 511, 1537, 2047, 1, 1537, 257, 1793,
    513, 769, 2049, 2305, 513, 1023, 2049, 2559,
    513, 2049, 769, 2305, 1025, 1281, 2561, 2817,
    1025, 1535, 2561, 3071, 1025, 2561, 1281, 2817,
    513, 769, 1025, 1281, 2049, 2305, 2561, 2817,
    513, 1023, 1025, 1535, 2049, 2559, 2561, 3071,
    513, 1025, 2049, 2561, 769, 1281, 2305, 2817,
    1, 257, 513, 769, 1537, 1793, 2049, 2305,
    1, 511, 513, 1023, 1537, 2047, 2049, 2559,
    1, 513, 1537, 2049, 257, 769, 1793, 2305,
    1, 257, 1025, 1281, 1537, 1793, 2561, 2817,
    1, 511, 1025, 1535, 1537, 2047, 2561, 3071,
    1, 1025, 1537, 2561, 257, 1281, 1793, 2817,
    3073, 3839, 3842, 4351, 4354, 4609, 5118, 6145,
    6911, 6914, 7423, 7426, 7681, 8190, 9471, 9729,
    10238, 10241, 10750, 11007, 11010, 3330, 3839, 4094,
    4351, 4606, 4609, 4866, 6402, 6911, 7166, 7423,
    7678, 7681, 7938, 9726, 9729, 9986, 10241, 10498,
    11007, 11262, 3073, 3839, 3842, 4351, 4354, 4609,
    5118, 6145, 6654, 6911, 6914, 7169, 7678, 8959,
    8962, 3330, 3839, 4094, 4351, 4606, 4609, 4866,
    6145, 6402, 6911, 7166, 7169, 7426, 8959, 9214,
    3073, 3839, 3842, 4351, 4354, 4609, 5118, 6399,
    6402, 6657, 7166, 7423, 7426, 8705, 9214, 3330,
    3839, 4094, 4351, 4606, 4609, 4866, 6399, 6654,
    6657, 6914, 7423, 7678, 8705, 8962, 3327, 3839,
    4097, 4606, 5121, 6399, 6911, 7169, 7678, 8193,
    9217, 9729, 10495, 10498, 11519, 3582, 4094, 4097,
    4354, 5378, 6654, 7166, 7169, 7426, 8450, 9474,
    9986, 10495, 10750, 11774, 3327, 3839, 4097, 4606,
    5121, 6399, 6657, 7166, 7169, 7678, 7935, 7938,
    3582, 4094, 4097, 4354, 5378, 6654, 6657, 6914,
    7169, 7426, 7935, 8190, 3327, 3839, 4097, 4606,
    5121, 6145, 6911, 6914, 7423, 7426, 7681, 8190,
    3582, 4094, 4097, 4354, 5378, 6402, 6911, 7166,
    7423, 7678, 7681, 7938, 3327, 3585, 4351, 5633,
    6399, 6657, 7423, 8705, 9217, 9983, 10241, 12031,
    3582, 3842, 4606, 5890, 6654, 6914, 7678, 8962,
    9474, 10238, 10498, 12286, 3327, 3585, 4351, 5633,
    6145, 6657, 7423, 7426, 8447, 3582, 3842, 4606,
    5890, 6402, 6914, 7423, 7678, 8702, 3327, 3585,
    4351, 5633, 6399, 6911, 7169, 7678, 8193, 3582,
    3842, 4606, 5890, 6654, 7166, 7169, 7426, 8450,
    1, 257, 1, 511, 1, 257, 1025, 1281,
    1025, 1535, 1025, 1281, 513, 769, 513, 1023,
    513, 769, 513, 1025, 769, 1281, 513, 769,
    1025, 1281, 1, 513, 257, 769, 1, 257,
    513, 769, 1, 1025, 257, 1281, 1, 257,
    1025, 1281, 3585, 3842, 5377, 5633, 6143, 3585,
    4094, 5631, 5633, 4354, 6145, 6401, 6911, 3073,
    4862, 5121, 3330, 4866, 5375, 4097, 6399, 6401,
    1025, 7425, 1281, 7681, 1025, 1281, 7425, 7681,
    513, 7937, 769, 8193, 513, 769, 7937, 8193,
    1, 6913, 257, 7169, 1, 257, 6913, 7169,
    3582, 3585, 4350, 4353, 4863, 5119, 5121, 3074,
    3839, 3842, 4607, 4609, 5119, 1, 1, 257,
    257, 513, 769,
};
__device__ const int32_t kEasyDownOutSlots[] = {
    4, 6, 7, 8, 9, 10, 11, 48, 49, 50, 51, 52,
    53, 27, 28, 29, 30, 31, 32, 0, 1,
};
// B18 easy_up: 8 phases, 111 Fq products in the product phases (2, 9, 36, 10, 54), 883 terms, 76 slots.
constexpr int kEasyUpPhases = 8;
constexpr int kEasyUpSlots = 76;
constexpr int kEasyUpInputs = 21;
constexpr int kEasyUpOutputs = 12;
__device__ const int32_t kEasyUpPhaseOps[] = {
    0, 2, 2, 9, 11, 6, 17, 36,
    53, 12, 65, 10, 75, 54, 129, 12,
};
__device__ const int32_t kEasyUpOps[] = {
    21, 0, 1, 1, 22, 2, 1, 1,
    18, 4, 1, 1, 19, 6, 1, 1,
    20, 8, 2, 2, 23, 12, 1, 1,
    24, 14, 1, 1, 25, 16, 2, 2,
    26, 20, 1, 1, 27, 22, 1, 1,
    28, 24, 2, 2, 13, 28, 1539, 0,
    15, 31, 1539, 0, 17, 34, 1539, 0,
    12, 37, 1026, 0, 14, 39, 1026, 0,
    16, 41, 1026, 0, 18, 43, 1, 1,
    19, 45, 1, 1, 20, 47, 2, 2,
    21, 51, 1, 1, 22, 53, 1, 1,
    23, 55, 2, 2, 24, 59, 1, 1,
    25, 61, 1, 1, 26, 63, 2, 2,
    27, 67, 2, 2, 28, 71, 2, 2,
    29, 75, 260, 260, 30, 83, 2, 2,
    31, 87, 2, 2, 32, 91, 260, 260,
    33, 99, 2, 2, 34, 103, 2, 2,
    35, 107, 260, 260, 36, 115, 1, 1,
    37, 117, 1, 1, 38, 119, 2, 2,
    39, 123, 1, 1, 40, 125, 1, 1,
    41, 127, 2, 2, 42, 131, 1, 1,
    43, 133, 1, 1, 44, 135, 2, 2,
    45, 139, 2, 2, 46, 143, 2, 2,
    47, 147, 260, 260, 48, 155, 2, 2,
    49, 159, 2, 2, 50, 163, 260, 260,
    51, 171, 2, 2, 52, 175, 2, 2,
    53, 179, 260, 260, 5, 187, 1292, 0,
    11, 199, 1292, 0, 3, 211, 1291, 0,
    9, 222, 1291, 0, 1, 233, 1289, 0,
    7, 242, 1289, 0, 0, 251, 1288, 0,
    2, 259, 1288, 0, 4, 267, 1288, 0,
    6, 275, 1288, 0, 8, 283, 1288, 0,
    10, 291, 1288, 0, 12, 299, 1, 2049,
    13, 301, 1, 2049, 14, 303, 1, 2049,
    15, 305, 1, 2049, 16, 307, 1, 2049,
    17, 309, 1, 2049, 18, 311, 1, 2049,
    19, 313, 1, 2049, 20, 315, 1, 2049,
    21, 317, 1, 2049, 22, 319, 1, 1,
    23, 321, 1, 1, 24, 323, 2, 2,
    25, 327, 1, 1, 26, 329, 1, 1,
    27, 331, 2, 2, 28, 335, 1, 1,
    29, 337, 1, 1, 30, 339, 2, 2,
    31, 343, 2, 2, 32, 347, 2, 2,
    33, 351, 260, 260, 34, 359, 2, 2,
    35, 363, 2, 2, 36, 367, 260, 260,
    37, 375, 2, 2, 38, 379, 2, 2,
    39, 383, 260, 260, 40, 391, 1, 1,
    41, 393, 1, 1, 42, 395, 2, 2,
    43, 399, 1, 1, 44, 401, 1, 1,
    45, 403, 2, 2, 46, 407, 1, 1,
    47, 409, 1, 1, 48, 411, 2, 2,
    49, 415, 2, 2, 50, 419, 2, 2,
    51, 423, 260, 260, 52, 431, 2, 2,
    53, 435, 2, 2, 54, 439, 260, 260,
    55, 447, 2, 2, 56, 451, 2, 2,
    57, 455, 260, 260, 58, 463, 2, 2,
    59, 467, 2, 2, 60, 471, 260, 260,
    61, 479, 2, 2, 62, 483, 2, 2,
    63, 487, 260, 260, 64, 495, 2, 2,
    65, 499, 2, 2, 66, 503, 260, 260,
    67, 511, 260, 260, 68, 519, 260, 260,
    69, 527, 264, 264, 70, 543, 260, 260,
    71, 551, 260, 260, 72, 559, 264, 264,
    73, 575, 260, 260, 74, 583, 260, 260,
    75, 591, 264, 264, 11, 607, 1316, 0,
    9, 643, 1313, 0, 7, 676, 1307, 0,
    6, 703, 1304, 0, 8, 727, 1304, 0,
    10, 751, 1304, 0, 5, 775, 1303, 0,
    3, 798, 1300, 0, 1, 818, 1297, 0,
    0, 835, 1296, 0, 2, 851, 1296, 0,
    4, 867, 1296, 0,
};
__device__ const int32_t kEasyUpTerms[] = {
    4609, 5121, 4865, 5121, 3073, 5377, 3329, 5887,
    3073, 3329, 5377, 5887, 3585, 5377, 3841, 5887,
    3585, 3841, 5377, 5887, 4097, 5377, 4353, 5887,
    4097, 4353, 5377, 5887, 4863, 5119, 5121, 6143,
    6399, 6401, 6911, 7167, 7169, 4609, 5119, 5889,
    6399, 6657, 7167, 1, 3073, 257, 3329, 1,
    257, 3073, 3329, 513, 3585, 769, 3841, 513,
    769, 3585, 3841, 1025, 4097, 1281, 4353, 1025,
    1281, 4097, 4353, 513, 1025, 3585, 4097, 769,
    1281, 3841, 4353, 513, 769, 1025, 1281, 3585,
    3841, 4097, 4353, 1, 513, 3073, 3585, 257,
    769, 3329, 3841, 1, 257, 513, 769, 3073,
    3329, 3585, 3841, 1, 1025, 3073, 4097, 257,
    1281, 3329, 4353, 1, 257, 1025, 1281, 3073,
    3329, 4097, 4353, 1537, 3073, 1793, 3329, 1537,
    1793, 3073, 3329, 2049, 3585, 2305, 3841, 2049,
    2305, 3585, 3841, 2561, 4097, 2817, 4353, 2561,
    2817, 4097, 4353, 2049, 2561, 3585, 4097, 2305,
    2817, 3841, 4353, 2049, 2305, 2561, 2817, 3585,
    3841, 4097, 4353, 1537, 2049, 3073, 3585, 1793,
    2305, 3329, 3841, 1537, 1793, 2049, 2305, 3073,
    3329, 3585, 3841, 1537, 2561, 3073, 4097, 1793,
    2817, 3329, 4353, 1537, 1793, 2561, 2817, 3073,
    3329, 4097, 4353, 4609, 4865, 5375, 5631, 5887,
    5889, 6145, 6401, 6911, 8703, 8959, 8961, 9217,
    9473, 9983, 10239, 10495, 10497, 10753, 11009, 11519,
    13311, 13567, 13569, 4609, 4865, 5375, 5377, 5633,
    6143, 6654, 6657, 7935, 8191, 8193, 9217, 9473,
    9983, 9985, 10241, 10751, 11262, 11265, 12543, 12799,
    12801, 4863, 5119, 5121, 5634, 6143, 6402, 6911,
    7422, 7425, 9471, 9727, 9729, 10242, 10751, 11010,
    11519, 12030, 12033, 4609, 5119, 5630, 5889, 6398,
    6657, 6914, 7679, 4863, 4865, 5631, 5633, 6146,
    6911, 7681, 8191, 4863, 4865, 5377, 5887, 6399,
    6401, 8449, 8959, 9217, 9727, 10238, 10497, 11006,
    11265, 11522, 12287, 9471, 9473, 10239, 10241, 10754,
    11519, 12289, 12799, 9471, 9473, 9985, 10495, 11007,
    11009, 13057, 13567, 513, 1281, 769, 1281, 1025,
    1, 1281, 1, 1537, 1537, 1793, 1537, 2049,
    1793, 2305, 1793, 2561, 257, 2817, 257, 1,
    1, 257, 257, 1, 257, 1, 257, 513,
    3073, 769, 3329, 513, 769, 3073, 3329, 1025,
    3585, 1281, 3841, 1025, 1281, 3585, 3841, 513,
    1025, 3073, 3585, 769, 1281, 3329, 3841, 513,
    769, 1025, 1281, 3073, 3329, 3585, 3841, 1,
    513, 1, 3073, 257, 769, 257, 3329, 1,
    257, 513, 769, 1, 257, 3073, 3329, 1,
    1025, 1, 3585, 257, 1281, 257, 3841, 1,
    257, 1025, 1281, 1, 257, 3585, 3841, 1537,
    4097, 1793, 4353, 1537, 1793, 4097, 4353, 2049,
    4609, 2305, 4865, 2049, 2305, 4609, 4865, 2561,
    5121, 2817, 5377, 2561, 2817, 5121, 5377, 2049,
    2561, 4609, 5121, 2305, 2817, 4865, 5377, 2049,
    2305, 2561, 2817, 4609, 4865, 5121, 5377, 1537,
    2049, 4097, 4609, 1793, 2305, 4353, 4865, 1537,
    1793, 2049, 2305, 4097, 4353, 4609, 4865, 1537,
    2561, 4097, 5121, 1793, 2817, 4353, 5377, 1537,
    1793, 2561, 2817, 4097, 4353, 5121, 5377, 1,
    1537, 1, 4097, 257, 1793, 257, 4353, 1,
    257, 1537, 1793, 1, 257, 4097, 4353, 513,
    2049, 3073, 4609, 769, 2305, 3329, 4865, 513,
    769, 2049, 2305, 3073, 3329, 4609, 4865, 1025,
    2561, 3585, 5121, 1281, 2817, 3841, 5377, 1025,
    1281, 2561, 2817, 3585, 3841, 5121, 5377, 513,
    1025, 2049, 2561, 3073, 3585, 4609, 5121, 769,
    1281, 2305, 2817, 3329, 3841, 4865, 5377, 513,
    769, 1025, 1281, 2049, 2305, 2561, 2817, 3073,
    3329, 3585, 3841, 4609, 4865, 5121, 5377, 1,
    513, 1537, 2049, 1, 3073, 4097, 4609, 257,
    769, 1793, 2305, 257, 3329, 4353, 4865, 1,
    257, 513, 769, 1537, 1793, 2049, 2305, 1,
    257, 3073, 3329, 4097, 4353, 4609, 4865, 1,
    1025, 1537, 2561, 1, 3585, 4097, 5121, 257,
    1281, 1793, 2817, 257, 3841, 4353, 5377, 1,
    257, 1025, 1281, 1537, 1793, 2561, 2817, 1,
    257, 3585, 3841, 4097, 4353, 5121, 5377, 5887,
    6143, 6145, 6401, 6657, 7167, 7423, 7679, 7681,
    9473, 9729, 10239, 10495, 10751, 10753, 11009, 11265,
    11775, 12031, 12287, 12289, 14081, 14337, 14847, 14849,
    15105, 15615, 15871, 16127, 16129, 16385, 16641, 17151,
    18943, 19199, 19201, 5887, 6143, 6145, 6655, 6911,
    6913, 7426, 7935, 8705, 8961, 9471, 10495, 10751,
    10753, 11263, 11519, 11521, 12034, 12543, 13313, 13569,
    14079, 14849, 15105, 15615, 15617, 15873, 16383, 16894,
    16897, 18175, 18431, 18433, 5633, 5889, 6399, 6910,
    6913, 7678, 7681, 8194, 8703, 10241, 10497, 11007,
    11518, 11521, 12286, 12289, 12802, 13311, 15103, 15359,
    15361, 15874, 16383, 16642, 17151, 17662, 17665, 5887,
    5889, 6402, 7167, 7170, 7935, 8190, 8449, 10495,
    10497, 11010, 11775, 11778, 12543, 12798, 13057, 14849,
    15359, 15870, 16129, 16638, 16897, 17154, 17919, 5633,
    6143, 6401, 6911, 7422, 7681, 8959, 8961, 10241,
    10751, 11009, 11519, 12030, 12289, 13567, 13569, 15103,
    15105, 15871, 15873, 16386, 17151, 17921, 18431, 5633,
    6143, 6655, 6657, 7169, 7679, 9727, 9729, 10241,
    10751, 11263, 11265, 11777, 12287, 14335, 14337, 15103,
    15105, 15617, 16127, 16639, 16641, 18689, 19199, 5633,
    5889, 6399, 6655, 6911, 6913, 7169, 7425, 7935,
    9727, 9983, 9985, 10241, 10497, 11007, 11009, 11265,
    11775, 12286, 12289, 13567, 13823, 13825, 5633, 5889,
    6399, 6401, 6657, 7167, 7678, 7681, 8959, 9215,
    9217, 10495, 10751, 10753, 11266, 11775, 12034, 12543,
    13054, 13057, 5887, 6143, 6145, 6658, 7167, 7426,
    7935, 8446, 8449, 10498, 11007, 11518, 11521, 12034,
    12543, 14590, 14593, 5633, 6143, 6654, 6913, 7422,
    7681, 7938, 8703, 10494, 10753, 11010, 11775, 12030,
    12289, 14082, 14847, 5887, 5889, 6655, 6657, 7170,
    7935, 8705, 9215, 10241, 10751, 11262, 11521, 12030,
    12289, 12546, 13311, 5887, 5889, 6401, 6911, 7423,
    7425, 9473, 9983, 10495, 10497, 11263, 11265, 11778,
    12543, 13313, 13823,
};
__device__ const int32_t kEasyUpOutSlots[] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
};
// B18's constant operands: 8 Fq values, Montgomery form, 12 words each.
constexpr int kTowerConstCount = 8;
__device__ const uint32_t kTowerConsts[] = {
    0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u,
    0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu,
    0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u,
    0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u,
    0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu,
    0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu,
    0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u,
    0xd117228fu, 0x97e83cccu, 0xb2dc29eeu, 0xa35baecau,
    0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu,
    0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u,
    0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u,
    0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu,
    0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u,
    0x3c65e181u, 0xc6f0caa5u, 0x8d50fe95u, 0x7525cf52u,
    0xf4798a6bu, 0x4a85ed50u, 0x6cf8eebdu, 0x171da0fdu,
    0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu,
    0xc61577f7u, 0x16a8ca3au, 0x74fd029bu, 0xc26a2ff8u,
    0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu,
    0x798dba3au, 0xecfb361bu, 0x91865a2cu, 0xc100ddb8u,
    0x232bda8eu, 0x0ec08ff1u, 0xf1ca4721u, 0xd5c13cc6u,
    0xbf7b5c04u, 0x47222a47u, 0xe51c5f59u, 0x0110f184u,
    0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u,
    0xa2e99d69u, 0x07e83a49u, 0x8332bb7au, 0xeca8f331u,
    0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u,
};
// END SCHEDULE TABLES

// Words of a lane's scratch in B4-B9, B17 and B18.
constexpr int kB4LaneWords = lane_words(kB4Slots);
constexpr int kB5LaneWords = lane_words(kB5Slots);
constexpr int kB6LaneWords = lane_words(kB6Slots);
constexpr int kB7LaneWords = lane_words(kB7Slots);
constexpr int kB8LaneWords = lane_words(kB8Slots);
constexpr int kB9LaneWords = lane_words(kB9Slots);
constexpr int kDblStepLaneWords = lane_words(kDblStepSlots);
constexpr int kFSqrFoldLaneWords = lane_words(kFSqrFoldSlots);
constexpr int kAddStepLaneWords = lane_words(kAddStepSlots);
constexpr int kFFoldLaneWords = lane_words(kFFoldSlots);
constexpr int kFrobMulLaneWords =
    lane_words(kFrobMul1Slots > kFrobMul2Slots ? kFrobMul1Slots
                                               : kFrobMul2Slots);
constexpr int kEasyDownLaneWords = lane_words(kEasyDownSlots);
constexpr int kEasyUpLaneWords = lane_words(kEasyUpSlots);

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
    run_phase(phase_ops, ops, terms, kTowerConsts, ph, g, kGroup, lane);
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
