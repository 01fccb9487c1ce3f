// GF(2^255-19) arithmetic, one field element per thread.
//
// Counterpart of K1 (tendermint_tpu/crypto/ed25519_jax/field.py: carry,
// add/sub/neg, mul, sqr, freeze, is_zero/parity, inverse, pow_p58). The TPU
// version held 17 x 15-bit limbs so every product fit a 32-bit lane. Hopper
// has a 32x32->64 multiply-add (IMAD.WIDE), so this uses 10 limbs of
// alternately 26 and 25 bits (radix 2^25.5, the ref10 layout) with 64-bit
// column sums: 100 limb products per multiply instead of 289.
//
// Invariant ("carried"): limbs at rest are < 2^26 (even) and < 2^25 + 2^15
// (odd). fe_mul's column sums then stay below 2^60; add/sub/neg carry their
// result so every value handed to fe_mul is carried. All arithmetic is
// unsigned: subtraction adds 4p first.
#pragma once

#include "common.cuh"

struct fe {
  uint32_t v[10];
};

#define TM_M26 0x3ffffffu
#define TM_M25 0x1ffffffu

// limb widths and bit offsets: limb i holds bits [OFF[i], OFF[i] + W[i])
TM_DEV int fe_width(int i) { return (i & 1) ? 25 : 26; }
TM_DEV int fe_offset(int i) { return (i >> 1) * 51 + ((i & 1) ? 26 : 0); }

TM_DEV void fe_zero(fe &h) {
  TM_UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = 0;
}

TM_DEV void fe_one(fe &h) {
  fe_zero(h);
  h.v[0] = 1;
}

TM_DEV void fe_copy(fe &h, const fe &f) {
  TM_UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i];
}

// Carry a vector of column sums (each < 2^61) into a carried element. The
// interleaved order (two chains, 0->5 and 4->9) is ref10's: after it every
// limb is within its width except limbs 1 and 5, which exceed it by at most
// 2^15 and 2^11.
TM_DEV void fe_carry_wide(fe &out, uint64_t h[10]) {
  uint64_t c;
  c = h[0] >> 26; h[1] += c; h[0] &= TM_M26;
  c = h[4] >> 26; h[5] += c; h[4] &= TM_M26;
  c = h[1] >> 25; h[2] += c; h[1] &= TM_M25;
  c = h[5] >> 25; h[6] += c; h[5] &= TM_M25;
  c = h[2] >> 26; h[3] += c; h[2] &= TM_M26;
  c = h[6] >> 26; h[7] += c; h[6] &= TM_M26;
  c = h[3] >> 25; h[4] += c; h[3] &= TM_M25;
  c = h[7] >> 25; h[8] += c; h[7] &= TM_M25;
  c = h[4] >> 26; h[5] += c; h[4] &= TM_M26;
  c = h[8] >> 26; h[9] += c; h[8] &= TM_M26;
  c = h[9] >> 25; h[0] += c * 19; h[9] &= TM_M25;
  c = h[0] >> 26; h[1] += c; h[0] &= TM_M26;
  TM_UNROLL
  for (int i = 0; i < 10; i++) out.v[i] = (uint32_t)h[i];
}

// Same carry for 32-bit sums (add/sub/neg results, each < 2^30).
TM_DEV void fe_carry_narrow(fe &h) {
  uint32_t c;
  uint32_t *v = h.v;
  c = v[0] >> 26; v[1] += c; v[0] &= TM_M26;
  c = v[4] >> 26; v[5] += c; v[4] &= TM_M26;
  c = v[1] >> 25; v[2] += c; v[1] &= TM_M25;
  c = v[5] >> 25; v[6] += c; v[5] &= TM_M25;
  c = v[2] >> 26; v[3] += c; v[2] &= TM_M26;
  c = v[6] >> 26; v[7] += c; v[6] &= TM_M26;
  c = v[3] >> 25; v[4] += c; v[3] &= TM_M25;
  c = v[7] >> 25; v[8] += c; v[7] &= TM_M25;
  c = v[4] >> 26; v[5] += c; v[4] &= TM_M26;
  c = v[8] >> 26; v[9] += c; v[8] &= TM_M26;
  c = v[9] >> 25; v[0] += c * 19; v[9] &= TM_M25;
  c = v[0] >> 26; v[1] += c; v[0] &= TM_M26;
}

// 4p per limb: subtracting a carried value from it never goes negative.
#define TM_4P0 0xfffffb4u  /* 4 * (2^26 - 19) */
#define TM_4PE 0xffffffcu  /* 4 * (2^26 - 1)  */
#define TM_4PO 0x7fffffcu  /* 4 * (2^25 - 1)  */

TM_DEV uint32_t fe_4p(int i) {
  return i == 0 ? TM_4P0 : ((i & 1) ? TM_4PO : TM_4PE);
}

TM_DEV void fe_add(fe &h, const fe &f, const fe &g) {
  TM_UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + g.v[i];
  fe_carry_narrow(h);
}

TM_DEV void fe_sub(fe &h, const fe &f, const fe &g) {
  TM_UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + fe_4p(i) - g.v[i];
  fe_carry_narrow(h);
}

TM_DEV void fe_neg(fe &h, const fe &f) {
  TM_UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = fe_4p(i) - f.v[i];
  fe_carry_narrow(h);
}

// h = f * g. Limb weights are 2^ceil(25.5 i), so f_i g_j lands on column
// i + j with a factor 2 when i and j are both odd, and columns >= 10 fold
// back with 19 (2^255 = 19 mod p). Each product is one 32x32->64 multiply
// of a pre-doubled f limb and a pre-multiplied-by-19 g limb: < 2^57.
TM_DEV void fe_mul(fe &h, const fe &f, const fe &g) {
  uint32_t f2[10], g19[10];
  TM_UNROLL
  for (int i = 0; i < 10; i++) {
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    g19[i] = 19 * g.v[i];
  }
  uint64_t col[10];
  TM_UNROLL
  for (int k = 0; k < 10; k++) col[k] = 0;
  TM_UNROLL
  for (int i = 0; i < 10; i++) {
    TM_UNROLL
    for (int j = 0; j < 10; j++) {
      const uint32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const uint32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      col[(i + j) % 10] += (uint64_t)a * (uint64_t)b;
    }
  }
  fe_carry_wide(h, col);
}

// h = f^2 with 55 limb products instead of 100: f_i f_j and f_j f_i are one
// product doubled. The column sums are the same integers as fe_mul(f, f)'s,
// so the result is bit-identical to it. Each product is a (2 or 4) f_i
// (< 2^28) times a f_j or 19 f_j (< 2^31): < 2^59.
TM_DEV void fe_sq(fe &h, const fe &f) {
  uint32_t f19[10];
  TM_UNROLL
  for (int j = 0; j < 10; j++) f19[j] = 19 * f.v[j];
  uint64_t col[10];
  TM_UNROLL
  for (int k = 0; k < 10; k++) col[k] = 0;
  TM_UNROLL
  for (int i = 0; i < 10; i++) {
    TM_UNROLL
    for (int j = i; j < 10; j++) {
      const int sh = (i != j) + ((i & 1) && (j & 1));
      const uint32_t a = f.v[i] << sh;
      const uint32_t b = (i + j >= 10) ? f19[j] : f.v[j];
      col[(i + j) % 10] += (uint64_t)a * (uint64_t)b;
    }
  }
  fe_carry_wide(h, col);
}

TM_DEV void fe_sq_n(fe &h, const fe &f, int n) {
  fe_sq(h, f);
  for (int i = 1; i < n; i++) fe_sq(h, h);
}

// Canonical representative in [0, p) with every limb strictly within its
// width. Three exact sequential carry passes bring a carried value below
// 2^255; adding 19 then sets bit 255 exactly when the value is >= p, in
// which case the sum minus 2^255 is the reduced value.
TM_DEV void fe_freeze(fe &out, const fe &f) {
  uint32_t h[10];
  TM_UNROLL
  for (int i = 0; i < 10; i++) h[i] = f.v[i];
  for (int pass = 0; pass < 3; pass++) {
    TM_UNROLL
    for (int i = 0; i < 9; i++) {
      const int w = fe_width(i);
      h[i + 1] += h[i] >> w;
      h[i] &= (1u << w) - 1;
    }
    const uint32_t c = h[9] >> 25;
    h[9] &= TM_M25;
    h[0] += 19 * c;
  }
  uint32_t t[10];
  TM_UNROLL
  for (int i = 0; i < 10; i++) t[i] = h[i];
  t[0] += 19;
  TM_UNROLL
  for (int i = 0; i < 9; i++) {
    const int w = fe_width(i);
    t[i + 1] += t[i] >> w;
    t[i] &= (1u << w) - 1;
  }
  const uint32_t ge_p = t[9] >> 25;  // 1 iff value >= p
  t[9] &= TM_M25;
  TM_UNROLL
  for (int i = 0; i < 10; i++) out.v[i] = ge_p ? t[i] : h[i];
}

// 32 little-endian bytes of the canonical value (bit 255 clear).
TM_DEV void fe_tobytes(uint8_t s[32], const fe &f) {
  fe h;
  fe_freeze(h, f);
  uint64_t w[4] = {0, 0, 0, 0};
  TM_UNROLL
  for (int i = 0; i < 10; i++) {
    const int off = fe_offset(i);
    const int wi = off >> 6, sh = off & 63;
    w[wi] |= (uint64_t)h.v[i] << sh;
    if (sh + fe_width(i) > 64) w[wi + 1] |= (uint64_t)h.v[i] >> (64 - sh);
  }
  TM_UNROLL
  for (int i = 0; i < 32; i++) s[i] = (uint8_t)(w[i >> 3] >> (8 * (i & 7)));
}

// Low 255 bits of 32 little-endian bytes (bit 255 ignored) as strict limbs.
// The value may be >= p: callers that need y < p test it on the bytes.
TM_DEV void fe_frombytes(fe &h, const uint8_t s[32]) {
  uint64_t w[4];
  TM_UNROLL
  for (int k = 0; k < 4; k++) {
    uint64_t x = 0;
    TM_UNROLL
    for (int b = 7; b >= 0; b--) x = (x << 8) | s[8 * k + b];
    w[k] = x;
  }
  w[3] &= 0x7fffffffffffffffull;
  TM_UNROLL
  for (int i = 0; i < 10; i++) {
    const int off = fe_offset(i), wd = fe_width(i);
    const int wi = off >> 6, sh = off & 63;
    uint64_t x = w[wi] >> sh;
    if (sh + wd > 64) x |= w[wi + 1] << (64 - sh);
    h.v[i] = (uint32_t)(x & ((1ull << wd) - 1));
  }
}

TM_DEV bool fe_iszero(const fe &f) {
  fe h;
  fe_freeze(h, f);
  uint32_t acc = 0;
  TM_UNROLL
  for (int i = 0; i < 10; i++) acc |= h.v[i];
  return acc == 0;
}

TM_DEV uint32_t fe_parity(const fe &f) {
  fe h;
  fe_freeze(h, f);
  return h.v[0] & 1;
}

TM_DEV void fe_cmov(fe &h, const fe &f, bool take) {
  TM_UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = take ? f.v[i] : h.v[i];
}

// z^(2^250 - 1), and z^11 which both exponent chains reuse (the ref10
// addition chain, as in the JAX field.py).
TM_NOINLINE void fe_pow_2250m1(fe &z250, fe &z11, const fe &z) {
  fe z2, z9, t, z5, z10, z20, z40, z50, z100, z200;
  fe_sq(z2, z);
  fe_sq_n(t, z2, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sq(t, z11);
  fe_mul(z5, t, z9);             // 2^5 - 1
  fe_sq_n(t, z5, 5);
  fe_mul(z10, t, z5);            // 2^10 - 1
  fe_sq_n(t, z10, 10);
  fe_mul(z20, t, z10);           // 2^20 - 1
  fe_sq_n(t, z20, 20);
  fe_mul(z40, t, z20);           // 2^40 - 1
  fe_sq_n(t, z40, 10);
  fe_mul(z50, t, z10);           // 2^50 - 1
  fe_sq_n(t, z50, 50);
  fe_mul(z100, t, z50);          // 2^100 - 1
  fe_sq_n(t, z100, 100);
  fe_mul(z200, t, z100);         // 2^200 - 1
  fe_sq_n(t, z200, 50);
  fe_mul(z250, t, z50);          // 2^250 - 1
}

// z^(p-2) = z^(2^255 - 21); 0 for z = 0.
TM_NOINLINE void fe_invert(fe &out, const fe &z) {
  fe z250, z11, t;
  fe_pow_2250m1(z250, z11, z);
  fe_sq_n(t, z250, 5);
  fe_mul(out, t, z11);
}

// z^((p-5)/8) = z^(2^252 - 3).
TM_NOINLINE void fe_pow_p58(fe &out, const fe &z) {
  fe z250, z11, t;
  fe_pow_2250m1(z250, z11, z);
  fe_sq_n(t, z250, 2);
  fe_mul(out, t, z);
}
