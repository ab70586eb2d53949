// Keccak-f[1600] and SHA3-256 of one 2176-byte chunk, per thread: the
// per-lane body of B12 (keccak.cu), as plain C++ behind CUDA's function
// qualifiers so that g++ compiles it too.
//
// Replaces the body of threshold_crypto_tpu/device/keccak.py `_k_sha3`
// (:197): a chunk is 16 SHA3-256 rate blocks of 136 bytes (17 lanes), then
// the padding block 0x06 … 0x80, 17 permutations in all. The TPU had no
// 64-bit integers and carried each lane as a (lo, hi) pair of u32 words
// (keccak.py:13-14); here a lane is one uint64_t, and the 25-lane state, the
// B array of rho/pi and the theta columns live in registers (every index is
// a constant once the round body is unrolled).
//
// Layout. A chunk is row `chunk` of int32[K, 544]: its bytes as
// little-endian 32-bit words, lane i = word 2i | word 2i+1 << 32. The digest
// is row `chunk` of int32[K, 8], the digest bytes as little-endian words.

#pragma once

#include <cstdint>

namespace tc {

constexpr int kChunkWords = 544;  // 2176 bytes
constexpr int kRateLanes = 17;    // 136-byte rate

__constant__ uint64_t kKeccakRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t v, int r) {
  return r == 0 ? v : (v << r) | (v >> (64 - r));
}

// The 24 rounds on the state s[x + 5y].
__device__ __forceinline__ void keccak_f1600(uint64_t (&s)[25]) {
  // rho offsets, indexed x + 5y
  const int rho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; ++y) s[x + 5 * y] ^= d;
    }
    // rho and pi: B[y, 2x + 3y] = rotl(A[x, y], rho[x, y])
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(s[x + 5 * y],
                                                  rho[x + 5 * y]);
    // chi
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        s[x + 5 * y] = b[x + 5 * y] ^
                       (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    s[0] ^= kKeccakRC[round];
  }
}

// B12 per lane: SHA3-256 of chunk `chunk` of words [K, 544] into out [K, 8].
__device__ __forceinline__ void sha3_chunk_lane(const int32_t* words,
                                                int32_t* out, int chunk) {
  const int32_t* src = words + static_cast<size_t>(chunk) * kChunkWords;
  uint64_t s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0;
  for (int blk = 0; blk < 16; ++blk) {
#pragma unroll
    for (int i = 0; i < kRateLanes; ++i) {
      const uint32_t lo = static_cast<uint32_t>(src[2 * i]);
      const uint32_t hi = static_cast<uint32_t>(src[2 * i + 1]);
      s[i] ^= static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
    }
    keccak_f1600(s);
    src += 2 * kRateLanes;
  }
  // the padding block: 0x06 at byte 0, 0x80 at byte 135 (lane 16, byte 7)
  s[0] ^= 0x06ull;
  s[16] ^= 0x8000000000000000ull;
  keccak_f1600(s);
  int32_t* dst = out + static_cast<size_t>(chunk) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = static_cast<int32_t>(static_cast<uint32_t>(s[i]));
    dst[2 * i + 1] = static_cast<int32_t>(static_cast<uint32_t>(s[i] >> 32));
  }
}

}  // namespace tc
