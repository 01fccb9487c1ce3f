// SHA-256 (FIPS 180-4) of one message, for one thread.
//
// The functions here are plain C++ as well: without __CUDACC__ they compile
// as host inline functions, so a host compiler can check them against
// hashlib before they reach the card.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TM_DEV __device__ __forceinline__
#define TM_CONST __constant__
#define TM_UNROLL _Pragma("unroll")
#define TM_LDG(p) __ldg(p)
TM_DEV uint32_t tm_rotr(uint32_t x, int k) { return __funnelshift_r(x, x, k); }
TM_DEV uint32_t tm_bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }
#else
#define TM_DEV static inline
#define TM_CONST static const
#define TM_UNROLL
#define TM_LDG(p) (*(p))
TM_DEV uint32_t tm_rotr(uint32_t x, int k) {
  return (x >> k) | (x << (32 - k));
}
TM_DEV uint32_t tm_bswap(uint32_t x) { return __builtin_bswap32(x); }
#endif

TM_CONST uint32_t TM_SHA256_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

// One compression of the 16 schedule words w (overwritten: the schedule
// is kept as a rolling window of 16 words) into the chaining value h.
TM_DEV void sha256_compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
  TM_UNROLL
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
      const uint32_t s0 = tm_rotr(x15, 7) ^ tm_rotr(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = tm_rotr(x2, 17) ^ tm_rotr(x2, 19) ^ (x2 >> 10);
      wt = w[t & 15] = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t S1 = tm_rotr(e, 6) ^ tm_rotr(e, 11) ^ tm_rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = hh + S1 + ch + TM_SHA256_K[t] + wt;
    const uint32_t S0 = tm_rotr(a, 2) ^ tm_rotr(a, 13) ^ tm_rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

// The big-endian schedule words of block `blk` (of `nblk`) of the padded
// message m of `len` bytes: the message, 0x80, zeros, and the 64-bit bit
// length in the last 8 bytes of the last block.
TM_DEV void sha256_load_block(const uint8_t *m, int len, int blk, int nblk,
                              uint32_t w[16]) {
  const int base = 64 * blk;
  TM_UNROLL
  for (int t = 0; t < 16; ++t) {
    uint32_t x = 0;
    TM_UNROLL
    for (int k = 0; k < 4; ++k) {
      const int pos = base + 4 * t + k;
      const uint32_t byte =
          pos < len ? (uint32_t)TM_LDG(m + pos) : (pos == len ? 0x80u : 0u);
      x = (x << 8) | byte;
    }
    w[t] = x;
  }
  if (blk == nblk - 1) {
    const uint64_t bits = (uint64_t)len * 8;
    w[14] = (uint32_t)(bits >> 32);
    w[15] = (uint32_t)bits;
  }
}

// SHA-256 of m (len bytes) into out (32 bytes, 4-byte aligned).
TM_DEV void sha256_one(const uint8_t *m, int len, uint8_t *out) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  const int nblk = (len + 8) / 64 + 1;
  for (int blk = 0; blk < nblk; ++blk) {
    uint32_t w[16];
    sha256_load_block(m, len, blk, nblk, w);
    sha256_compress(h, w);
  }
  uint32_t *o = (uint32_t *)out;
  TM_UNROLL
  for (int j = 0; j < 8; ++j) o[j] = tm_bswap(h[j]);
}
