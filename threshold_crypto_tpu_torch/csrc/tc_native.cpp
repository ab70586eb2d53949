// tc_native — host-runtime primitives of threshold_crypto_tpu_torch.
//
// A copy of the JAX package's native/src/tc_native.cpp. The reference crate
// links native Rust crates for these capabilities: `tiny-keccak` for SHA3-256
// (src/util.rs:3-9) and `rand_chacha` 0.2 for the ChaCha20 word stream that
// drives hash-to-G2 sampling and the xor_with_hash KDF (src/lib.rs:691-715).
// This library is the port's host side of them: the card runs the batched
// field, curve and pairing math; this C++ runs the byte-oriented host work
// (hashing, keystreams, one message's hash to G2) where Python is 100-1000x
// off native speed. Built with g++ by the package's _build.py at first use
// and loaded through ctypes (native/__init__.py); the pure-Python chains
// (utils/rng.py, host/sampling.py) are the oracles the tests hold it to.
//
// All implementations are from the public specifications (FIPS-202 for
// Keccak, RFC 8439 for the ChaCha20 quarter-round; rand_chacha's word-stream
// framing: 64-bit block counter in state words 12-13, stream id 0 in 14-15).

#include <cstdint>
#include <cstring>
#include <cstddef>

// The Keccak state and ChaCha key/word buffers are aliased as byte arrays
// (little-endian lane order), and Fq limbs are memcpy'd between u64[] and
// u64[7] accumulators; all of it assumes a little-endian host.  Refuse to
// build elsewhere rather than silently produce wrong digests.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "tc_native requires a little-endian host");

namespace {

// ---------------------------------------------------------------------------
// Keccak-f[1600] and SHA3-256 (FIPS-202).
// ---------------------------------------------------------------------------

constexpr uint64_t kRoundConst[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rotation offsets r[x][y] laid out by lane index (x + 5y)
constexpr int kRho[25] = {
    0,  1,  62, 28, 27,
    36, 44, 6,  55, 20,
    3,  10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2,  61, 56, 14,
};

inline uint64_t rotl64(uint64_t v, int c) {
  return c == 0 ? v : (v << c) | (v >> (64 - c));
}

void keccak_f1600(uint64_t a[25]) {
  for (int round = 0; round < 24; ++round) {
    // theta
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    // rho + pi
    uint64_t b[25];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y) {
        int src = x + 5 * y;
        int dst = y + 5 * ((2 * x + 3 * y) % 5);
        b[dst] = rotl64(a[src], kRho[src]);
      }
    // chi
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    // iota
    a[0] ^= kRoundConst[round];
  }
}

}  // namespace

extern "C" {

// SHA3-256: rate 136 bytes, domain padding 0x06...0x80.
void tc_sha3_256(const uint8_t* data, size_t len, uint8_t out[32]) {
  constexpr size_t kRate = 136;
  uint64_t state[25];
  std::memset(state, 0, sizeof(state));
  uint8_t* bytes = reinterpret_cast<uint8_t*>(state);  // little-endian lanes

  while (len >= kRate) {
    for (size_t i = 0; i < kRate; ++i) bytes[i] ^= data[i];
    keccak_f1600(state);
    data += kRate;
    len -= kRate;
  }
  for (size_t i = 0; i < len; ++i) bytes[i] ^= data[i];
  bytes[len] ^= 0x06;
  bytes[kRate - 1] ^= 0x80;
  keccak_f1600(state);
  std::memcpy(out, bytes, 32);
}

namespace {

inline uint32_t rotl32(uint32_t v, int c) { return (v << c) | (v >> (32 - c)); }

// One ChaCha20 block (20 rounds) with rand_chacha 0.2 framing: 64-bit block
// counter in words 12-13, 64-bit stream id (always 0 here) in words 14-15.
void chacha20_block(const uint32_t key[8], uint64_t counter, uint32_t out[16]) {
  const uint32_t init[16] = {
      0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
      key[0], key[1], key[2], key[3], key[4], key[5], key[6], key[7],
      static_cast<uint32_t>(counter), static_cast<uint32_t>(counter >> 32),
      0u, 0u,
  };
  uint32_t x[16];
  std::memcpy(x, init, sizeof(x));

#define TC_QR(a, b, c, d)                        \
  x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 16);  \
  x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 12);  \
  x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 8);   \
  x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 7)

  for (int i = 0; i < 10; ++i) {
    TC_QR(0, 4, 8, 12);
    TC_QR(1, 5, 9, 13);
    TC_QR(2, 6, 10, 14);
    TC_QR(3, 7, 11, 15);
    TC_QR(0, 5, 10, 15);
    TC_QR(1, 6, 11, 12);
    TC_QR(2, 7, 8, 13);
    TC_QR(3, 4, 9, 14);
  }
#undef TC_QR
  for (int i = 0; i < 16; ++i) out[i] = x[i] + init[i];
}

}  // namespace

// Raw word stream: words `word_off .. word_off+n_words` of the ChaCha20Rng
// output sequence (u32 words, little-endian in memory).
void tc_chacha20_words(const uint8_t key_bytes[32], uint64_t word_off,
                       uint32_t* out, size_t n_words) {
  uint32_t key[8];
  std::memcpy(key, key_bytes, 32);
  uint64_t block = word_off / 16;
  size_t pos = static_cast<size_t>(word_off % 16);
  uint32_t buf[16];
  while (n_words > 0) {
    chacha20_block(key, block++, buf);
    size_t take = 16 - pos;
    if (take > n_words) take = n_words;
    std::memcpy(out, buf + pos, take * 4);
    out += take;
    n_words -= take;
    pos = 0;
  }
}

// rand 0.7 `Standard` u8 stream: byte i = low byte of output word i
// (one full u32 consumed per byte) — the xor_with_hash keystream
// (src/lib.rs:710-715).
void tc_chacha20_low_bytes(const uint8_t key_bytes[32], uint64_t word_off,
                           uint8_t* out, size_t n) {
  uint32_t key[8];
  std::memcpy(key, key_bytes, 32);
  uint64_t block = word_off / 16;
  size_t pos = static_cast<size_t>(word_off % 16);
  uint32_t buf[16];
  while (n > 0) {
    chacha20_block(key, block++, buf);
    while (pos < 16 && n > 0) {
      *out++ = static_cast<uint8_t>(buf[pos++]);
      --n;
    }
    pos = 0;
  }
}

// Fused KDF: data XOR low-byte keystream keyed by sha3_256(key_material) —
// the whole xor_with_hash hot path in one native call.
void tc_xor_with_hash(const uint8_t* key_material, size_t key_len,
                      const uint8_t* data, size_t n, uint8_t* out) {
  uint8_t digest[32];
  tc_sha3_256(key_material, key_len, digest);
  uint32_t key[8];
  std::memcpy(key, digest, 32);
  uint64_t block = 0;
  size_t pos = 0, i = 0;
  uint32_t buf[16];
  while (i < n) {
    chacha20_block(key, block++, buf);
    for (pos = 0; pos < 16 && i < n; ++pos, ++i)
      out[i] = data[i] ^ static_cast<uint8_t>(buf[pos]);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BLS12-381 host arithmetic for the hash-to-G2 sampling chain.
//
// The reference's `hash_g2` is G2::random(ChaChaRng(sha3_256(msg)))
// (src/lib.rs:691-694): rejection-sample an x over Fq2 from
// the ChaCha word stream, lift to a curve point, scale by the G2 cofactor.
// That whole chain is sequential, byte/bigint-oriented host work — exactly
// this library's domain; the Python oracle (host/sampling.py) is its
// cross-check (tests/test_torch_native.py).
//
// Fq is 6x64-limb Montgomery form (R = 2^384).  Note the sampled raw limbs
// from the RNG *are* the Montgomery representation (ff 0.6's Fq::random
// fills the repr directly), so acceptance is a plain limb compare against p.
// ---------------------------------------------------------------------------

namespace {

struct Fq {
  uint64_t l[6];
};

constexpr Fq kP = {{0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL,
                    0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                    0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL}};
constexpr uint64_t kInv64 = 0x89f3fffcfffcfffdULL;
constexpr Fq kR2 = {{0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL,
                     0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL,
                     0x9a793e85b519952dULL, 0x11988fe592cae3aaULL}};
constexpr Fq kOneM = {{0x760900000002fffdULL, 0xebf4000bc40c0002ULL,
                       0x5f48985753c758baULL, 0x77ce585370525745ULL,
                       0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL}};
// b = 4 (both Fq2 components of B_G2), Montgomery form
constexpr Fq kBMont = {{0xaa270000000cfff3ULL, 0x53cc0032fc34000aULL,
                        0x478fe97a6b0a807fULL, 0xb1d37ebee6ba24d7ULL,
                        0x8ec9733bbf78ab2fULL, 0x09d645513d83de7eULL}};
// G2 cofactor h2 (507 bits), plain integer, little-endian limbs
constexpr uint64_t kH2[8] = {0xcf1c38e31c7238e5ULL, 0x1616ec6e786f0c70ULL,
                             0x21537e293a6691aeULL, 0xa628f1cb4d9e82efULL,
                             0xa68a205b2e5a7ddfULL, 0xcd91de4547085abaULL,
                             0x091d50792876a202ULL, 0x05d543a95414e7f1ULL};
// exponents for Fq2 sqrt (Adj–Rodríguez-Henríquez, p ≡ 3 mod 4)
constexpr uint64_t kPm3d4[6] = {0xee7fbfffffffeaaaULL, 0x07aaffffac54ffffULL,
                                0xd9cc34a83dac3d89ULL, 0xd91dd2e13ce144afULL,
                                0x92c6e9ed90d2eb35ULL, 0x0680447a8e5ff9a6ULL};
constexpr uint64_t kPm1d2[6] = {0xdcff7fffffffd555ULL, 0x0f55ffff58a9ffffULL,
                                0xb39869507b587b12ULL, 0xb23ba5c279c2895fULL,
                                0x258dd3db21a5d66bULL, 0x0d0088f51cbff34dULL};
constexpr uint64_t kPm2[6] = {0xb9feffffffffaaa9ULL, 0x1eabfffeb153ffffULL,
                              0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                              0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};

inline int fq_cmp_raw(const Fq& a, const Fq& b) {
  for (int i = 5; i >= 0; --i) {
    if (a.l[i] < b.l[i]) return -1;
    if (a.l[i] > b.l[i]) return 1;
  }
  return 0;
}

inline bool fq_is_zero(const Fq& a) {
  uint64_t acc = 0;
  for (int i = 0; i < 6; ++i) acc |= a.l[i];
  return acc == 0;
}

inline Fq fq_add(const Fq& a, const Fq& b) {
  Fq r;
  unsigned __int128 c = 0;
  for (int i = 0; i < 6; ++i) {
    c += (unsigned __int128)a.l[i] + b.l[i];
    r.l[i] = (uint64_t)c;
    c >>= 64;
  }
  if (c || fq_cmp_raw(r, kP) >= 0) {
    unsigned __int128 br = 0;
    for (int i = 0; i < 6; ++i) {
      unsigned __int128 d =
          (unsigned __int128)r.l[i] - kP.l[i] - (uint64_t)br;
      r.l[i] = (uint64_t)d;
      br = (d >> 64) ? 1 : 0;
    }
  }
  return r;
}

inline Fq fq_sub(const Fq& a, const Fq& b) {
  Fq r;
  unsigned __int128 br = 0;
  for (int i = 0; i < 6; ++i) {
    unsigned __int128 d = (unsigned __int128)a.l[i] - b.l[i] - (uint64_t)br;
    r.l[i] = (uint64_t)d;
    br = (d >> 64) ? 1 : 0;
  }
  if (br) {
    unsigned __int128 c = 0;
    for (int i = 0; i < 6; ++i) {
      c += (unsigned __int128)r.l[i] + kP.l[i];
      r.l[i] = (uint64_t)c;
      c >>= 64;
    }
  }
  return r;
}

inline Fq fq_neg(const Fq& a) {
  if (fq_is_zero(a)) return a;
  Fq r;
  unsigned __int128 br = 0;
  for (int i = 0; i < 6; ++i) {
    unsigned __int128 d = (unsigned __int128)kP.l[i] - a.l[i] - (uint64_t)br;
    r.l[i] = (uint64_t)d;
    br = (d >> 64) ? 1 : 0;
  }
  return r;
}

// CIOS Montgomery multiplication: a·b·R⁻¹ mod p.
Fq fq_mul(const Fq& a, const Fq& b) {
  uint64_t t[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 6; ++i) {
    unsigned __int128 c = 0;
    for (int j = 0; j < 6; ++j) {
      c += (unsigned __int128)a.l[i] * b.l[j] + t[j];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    c += t[6];
    t[6] = (uint64_t)c;
    uint64_t t7 = (uint64_t)(c >> 64);

    uint64_t m = t[0] * kInv64;
    c = (unsigned __int128)m * kP.l[0] + t[0];
    c >>= 64;
    for (int j = 1; j < 6; ++j) {
      c += (unsigned __int128)m * kP.l[j] + t[j];
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    c += t[6];
    t[5] = (uint64_t)c;
    t[6] = t7 + (uint64_t)(c >> 64);
  }
  Fq r;
  std::memcpy(r.l, t, 48);
  if (t[6] || fq_cmp_raw(r, kP) >= 0) {
    unsigned __int128 br = 0;
    for (int i = 0; i < 6; ++i) {
      unsigned __int128 d = (unsigned __int128)r.l[i] - kP.l[i] - (uint64_t)br;
      r.l[i] = (uint64_t)d;
      br = (d >> 64) ? 1 : 0;
    }
  }
  return r;
}

inline Fq fq_sqr(const Fq& a) { return fq_mul(a, a); }

// a^e for a little-endian limb exponent (MSB-first double-and-multiply).
Fq fq_pow(const Fq& a, const uint64_t* e, int n_limbs) {
  int top = n_limbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) --top;
  Fq acc = kOneM;
  for (int k = top; k >= 0; --k) {
    acc = fq_sqr(acc);
    if ((e[k / 64] >> (k % 64)) & 1) acc = fq_mul(acc, a);
  }
  return acc;
}

inline Fq fq_inv(const Fq& a) { return fq_pow(a, kPm2, 6); }

// Montgomery -> plain integer limbs (for comparisons / serialization).
inline Fq fq_to_plain(const Fq& a) {
  Fq one_raw = {{1, 0, 0, 0, 0, 0}};
  return fq_mul(a, one_raw);
}

// ---- Fq2 = Fq[u]/(u²+1) ----------------------------------------------------

struct Fq2 {
  Fq c0, c1;
};

inline Fq2 fq2_add(const Fq2& a, const Fq2& b) {
  return {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)};
}
inline Fq2 fq2_sub(const Fq2& a, const Fq2& b) {
  return {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)};
}
inline Fq2 fq2_neg(const Fq2& a) { return {fq_neg(a.c0), fq_neg(a.c1)}; }
inline Fq2 fq2_conj(const Fq2& a) { return {a.c0, fq_neg(a.c1)}; }
inline bool fq2_is_zero(const Fq2& a) {
  return fq_is_zero(a.c0) && fq_is_zero(a.c1);
}

Fq2 fq2_mul(const Fq2& a, const Fq2& b) {
  Fq v0 = fq_mul(a.c0, b.c0);
  Fq v1 = fq_mul(a.c1, b.c1);
  Fq s = fq_mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
  return {fq_sub(v0, v1), fq_sub(fq_sub(s, v0), v1)};
}

Fq2 fq2_sqr(const Fq2& a) {
  Fq s = fq_add(a.c0, a.c1);
  Fq d = fq_sub(a.c0, a.c1);
  Fq m = fq_mul(a.c0, a.c1);
  return {fq_mul(s, d), fq_add(m, m)};
}

Fq2 fq2_inv(const Fq2& a) {
  Fq norm = fq_add(fq_sqr(a.c0), fq_sqr(a.c1));
  Fq ni = fq_inv(norm);
  return {fq_mul(a.c0, ni), fq_neg(fq_mul(a.c1, ni))};
}

Fq2 fq2_pow(const Fq2& a, const uint64_t* e, int n_limbs) {
  int top = n_limbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) --top;
  Fq2 acc = {kOneM, {{0, 0, 0, 0, 0, 0}}};
  for (int k = top; k >= 0; --k) {
    acc = fq2_sqr(acc);
    if ((e[k / 64] >> (k % 64)) & 1) acc = fq2_mul(acc, a);
  }
  return acc;
}

inline bool fq2_eq(const Fq2& a, const Fq2& b) {
  return fq_cmp_raw(a.c0, b.c0) == 0 && fq_cmp_raw(a.c1, b.c1) == 0;
}

// lexicographic compare on *plain* values: c1 first, then c0
// (pairing 0.16 Fq2 ordering; host/tower.py fq2_cmp)
int fq2_cmp_plain(const Fq2& a, const Fq2& b) {
  Fq a1 = fq_to_plain(a.c1), b1 = fq_to_plain(b.c1);
  int c = fq_cmp_raw(a1, b1);
  if (c) return c;
  Fq a0 = fq_to_plain(a.c0), b0 = fq_to_plain(b.c0);
  return fq_cmp_raw(a0, b0);
}

// sqrt in Fq2 for p ≡ 3 mod 4 (same algorithm as host/tower.py fq2_sqrt);
// returns false if a is a non-residue.
bool fq2_sqrt(const Fq2& a, Fq2* out) {
  Fq2 zero = {{{0, 0, 0, 0, 0, 0}}, {{0, 0, 0, 0, 0, 0}}};
  Fq2 one = {kOneM, {{0, 0, 0, 0, 0, 0}}};
  if (fq2_is_zero(a)) {
    *out = zero;
    return true;
  }
  Fq2 a1 = fq2_pow(a, kPm3d4, 6);
  Fq2 x0 = fq2_mul(a1, a);
  Fq2 alpha = fq2_mul(a1, x0);
  Fq2 norm = fq2_mul(fq2_conj(alpha), alpha);  // alpha^(p+1)
  Fq2 minus_one = {fq_neg(kOneM), {{0, 0, 0, 0, 0, 0}}};
  if (fq2_eq(norm, minus_one)) return false;
  Fq2 x;
  if (fq2_eq(alpha, minus_one)) {
    Fq2 u = {{{0, 0, 0, 0, 0, 0}}, kOneM};  // u = sqrt(-1)
    x = fq2_mul(u, x0);
  } else {
    Fq2 b = fq2_pow(fq2_add(one, alpha), kPm1d2, 6);
    x = fq2_mul(b, x0);
  }
  if (!fq2_eq(fq2_sqr(x), a)) return false;
  *out = x;
  return true;
}

// ---- G2 (E'(Fq2): y² = x³ + 4(1+u)... here b = (4, 4)) ---------------------

struct G2Jac {
  Fq2 x, y, z;  // z == 0 → infinity
};

G2Jac g2_dbl(const G2Jac& p) {
  if (fq2_is_zero(p.z) || fq2_is_zero(p.y)) {
    Fq2 one = {kOneM, {{0, 0, 0, 0, 0, 0}}};
    return {one, one, {{{0, 0, 0, 0, 0, 0}}, {{0, 0, 0, 0, 0, 0}}}};
  }
  Fq2 a = fq2_sqr(p.x);
  Fq2 b = fq2_sqr(p.y);
  Fq2 c = fq2_sqr(b);
  Fq2 d = fq2_sub(fq2_sqr(fq2_add(p.x, b)), fq2_add(a, c));
  d = fq2_add(d, d);
  Fq2 e = fq2_add(fq2_add(a, a), a);
  Fq2 x3 = fq2_sub(fq2_sqr(e), fq2_add(d, d));
  Fq2 c8 = fq2_add(c, c);
  c8 = fq2_add(c8, c8);
  c8 = fq2_add(c8, c8);
  Fq2 y3 = fq2_sub(fq2_mul(e, fq2_sub(d, x3)), c8);
  Fq2 yz = fq2_mul(p.y, p.z);
  Fq2 z3 = fq2_add(yz, yz);
  return {x3, y3, z3};
}

G2Jac g2_add_mixed(const G2Jac& p, const Fq2& qx, const Fq2& qy) {
  // p + (qx, qy) with q affine (z=1)
  if (fq2_is_zero(p.z)) {
    Fq2 one = {kOneM, {{0, 0, 0, 0, 0, 0}}};
    return {qx, qy, one};
  }
  Fq2 z1z1 = fq2_sqr(p.z);
  Fq2 u2 = fq2_mul(qx, z1z1);
  Fq2 s2 = fq2_mul(qy, fq2_mul(z1z1, p.z));
  if (fq2_eq(u2, p.x)) {
    if (fq2_eq(s2, p.y)) return g2_dbl(p);
    Fq2 one = {kOneM, {{0, 0, 0, 0, 0, 0}}};
    return {one, one, {{{0, 0, 0, 0, 0, 0}}, {{0, 0, 0, 0, 0, 0}}}};
  }
  Fq2 h = fq2_sub(u2, p.x);
  Fq2 hh = fq2_sqr(h);
  Fq2 i = fq2_add(hh, hh);
  i = fq2_add(i, i);
  Fq2 j = fq2_mul(h, i);
  Fq2 r = fq2_sub(s2, p.y);
  r = fq2_add(r, r);
  Fq2 v = fq2_mul(p.x, i);
  Fq2 x3 = fq2_sub(fq2_sub(fq2_sqr(r), j), fq2_add(v, v));
  Fq2 yj = fq2_mul(p.y, j);
  Fq2 y3 = fq2_sub(fq2_mul(r, fq2_sub(v, x3)), fq2_add(yj, yj));
  // (z+h)² − z² − h² = 2zh
  Fq2 z3 = fq2_sub(fq2_sqr(fq2_add(p.z, h)), fq2_add(z1z1, hh));
  return {x3, y3, z3};
}

// affine · h2 (507-bit fixed scalar): MSB-first double-and-add.
G2Jac g2_mul_h2(const Fq2& px, const Fq2& py) {
  Fq2 one = {kOneM, {{0, 0, 0, 0, 0, 0}}};
  G2Jac acc = {one, one, {{{0, 0, 0, 0, 0, 0}}, {{0, 0, 0, 0, 0, 0}}}};
  int top = 8 * 64 - 1;
  while (top >= 0 && !((kH2[top / 64] >> (top % 64)) & 1)) --top;
  for (int k = top; k >= 0; --k) {
    acc = g2_dbl(acc);
    if ((kH2[k / 64] >> (k % 64)) & 1) acc = g2_add_mixed(acc, px, py);
  }
  return acc;
}

// ---- ChaCha20Rng stream (rand_chacha 0.2 semantics) ------------------------

struct ChaChaStream {
  uint32_t key[8];
  uint64_t block;
  int pos;
  uint32_t buf[16];
};

inline void rng_init(ChaChaStream* s, const uint8_t seed[32]) {
  std::memcpy(s->key, seed, 32);
  s->block = 0;
  s->pos = 16;  // force refill
}

inline uint32_t rng_u32(ChaChaStream* s) {
  if (s->pos >= 16) {
    chacha20_block(s->key, s->block++, s->buf);
    s->pos = 0;
  }
  return s->buf[s->pos++];
}

inline uint64_t rng_u64(ChaChaStream* s) {
  uint64_t lo = rng_u32(s);
  uint64_t hi = rng_u32(s);
  return (hi << 32) | lo;
}

// ff 0.6 Fq::random: fill 6 repr limbs (little-endian), shave top 3 bits,
// accept if < p.  Accepted limbs ARE the Montgomery form.
Fq fq_random(ChaChaStream* s) {
  for (;;) {
    Fq r;
    for (int i = 0; i < 6; ++i) r.l[i] = rng_u64(s);
    r.l[5] &= (1ULL << 61) - 1;  // 381-bit shave mask
    if (fq_cmp_raw(r, kP) < 0) return r;
  }
}

// pairing 0.16 G2::random: x over Fq2, `greatest` coin, lift, cofactor-scale.
void g2_random_impl(ChaChaStream* s, Fq2* out_x, Fq2* out_y) {
  for (;;) {
    Fq2 x;
    x.c0 = fq_random(s);
    x.c1 = fq_random(s);
    bool greatest = (rng_u32(s) % 2) != 0;
    Fq2 rhs = fq2_add(fq2_mul(fq2_sqr(x), x), {kBMont, kBMont});
    Fq2 y;
    if (!fq2_sqrt(rhs, &y)) continue;
    Fq2 ny = fq2_neg(y);
    bool y_is_greatest = fq2_cmp_plain(y, ny) > 0;
    if (y_is_greatest != greatest) y = ny;
    G2Jac p = g2_mul_h2(x, y);
    if (fq2_is_zero(p.z)) continue;
    // Jacobian -> affine
    Fq2 zi = fq2_inv(p.z);
    Fq2 zi2 = fq2_sqr(zi);
    *out_x = fq2_mul(p.x, zi2);
    *out_y = fq2_mul(p.y, fq2_mul(zi2, zi));
    return;
  }
}

inline void fq_write_be(const Fq& a_mont, uint8_t out[48]) {
  Fq plain = fq_to_plain(a_mont);
  for (int i = 0; i < 6; ++i) {
    uint64_t v = plain.l[5 - i];
    for (int j = 0; j < 8; ++j) out[8 * i + j] = (uint8_t)(v >> (56 - 8 * j));
  }
}

}  // namespace

extern "C" {

// G2::random(ChaChaRng::from_seed(seed)) — the sampling half of hash_g2.
// Writes x.c0 || x.c1 || y.c0 || y.c1 as four 48-byte big-endian integers.
void tc_g2_random_from_seed(const uint8_t seed[32], uint8_t out[192]) {
  ChaChaStream s;
  rng_init(&s, seed);
  Fq2 x, y;
  g2_random_impl(&s, &x, &y);
  fq_write_be(x.c0, out);
  fq_write_be(x.c1, out + 48);
  fq_write_be(y.c0, out + 96);
  fq_write_be(y.c1, out + 144);
}

// Full hash_g2(msg) = G2::random(ChaChaRng(sha3_256(msg)))
// (src/lib.rs:691-694), one native call.
void tc_hash_g2(const uint8_t* msg, size_t len, uint8_t out[192]) {
  uint8_t digest[32];
  tc_sha3_256(msg, len, digest);
  tc_g2_random_from_seed(digest, out);
}

int tc_native_abi_version() { return 2; }

}  // extern "C"
