// SHA-512 compression, one message per thread.
//
// Counterpart of K3 (tendermint_tpu/crypto/ed25519_jax/sha512.py: _compress,
// sha512_blocks, digest_le32). The TPU has no 64-bit integers, so the JAX
// version carried every word as a (hi, lo) pair of u32 lanes; here words
// are native uint64_t and the schedule is a 16-word ring. Each item hashes
// only its own 1..nblk blocks (the callers loop to the item's count).
#pragma once

#include "common.cuh"

TM_CONST uint64_t TM_SHA512_K[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};

TM_DEV uint64_t sha_rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

TM_DEV void sha512_init(uint64_t st[8]) {
  st[0] = 0x6a09e667f3bcc908ull;
  st[1] = 0xbb67ae8584caa73bull;
  st[2] = 0x3c6ef372fe94f82bull;
  st[3] = 0xa54ff53a5f1d36f1ull;
  st[4] = 0x510e527fade682d1ull;
  st[5] = 0x9b05688c2b3e6c1full;
  st[6] = 0x1f83d9abfb41bd6bull;
  st[7] = 0x5be0cd19137e2179ull;
}

// One 128-byte block given as 16 big-endian u64 message words.
TM_NOINLINE void sha512_compress(uint64_t st[8], const uint64_t blk[16]) {
  uint64_t w[16];
  TM_UNROLL
  for (int t = 0; t < 16; t++) w[t] = blk[t];
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
  TM_UNROLL
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {
      const uint64_t w2 = w[(t - 2) & 15], w15 = w[(t - 15) & 15];
      const uint64_t s1 = sha_rotr(w2, 19) ^ sha_rotr(w2, 61) ^ (w2 >> 6);
      const uint64_t s0 = sha_rotr(w15, 1) ^ sha_rotr(w15, 8) ^ (w15 >> 7);
      w[t & 15] += s1 + w[(t - 7) & 15] + s0;
    }
    const uint64_t S1 = sha_rotr(e, 14) ^ sha_rotr(e, 18) ^ sha_rotr(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = h + S1 + ch + TM_SHA512_K[t] + w[t & 15];
    const uint64_t S0 = sha_rotr(a, 28) ^ sha_rotr(a, 34) ^ sha_rotr(a, 39);
    const uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
    const uint64_t t2 = S0 + mj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

TM_DEV uint64_t sha_bswap64(uint64_t x) {
  x = ((x & 0x00ff00ff00ff00ffull) << 8) | ((x >> 8) & 0x00ff00ff00ff00ffull);
  x = ((x & 0x0000ffff0000ffffull) << 16) | ((x >> 16) & 0x0000ffff0000ffffull);
  return (x << 32) | (x >> 32);
}

// The Ed25519 challenge reads the 64 digest bytes as one little-endian
// integer: its u64 word k is the byte swap of state word k.
TM_DEV void sha512_digest_le64(uint64_t out[8], const uint64_t st[8]) {
  TM_UNROLL
  for (int k = 0; k < 8; k++) out[k] = sha_bswap64(st[k]);
}
