// Montgomery arithmetic in Fq, the BLS12-381 base field, one element per
// thread.
//
// Counterpart of the limb engine under K10 (tendermint_tpu/crypto/
// bls12381/vec.py: mont_mul :141, vl_add / vl_sub, _cond_sub_p). The TPU
// version holds 30 x 13-bit limbs in int32 lanes (CFG_JAX, R = 2^390) so
// every column sum stays inside 32 bits. Hopper multiplies 32 x 32 -> 64
// in one instruction (IMAD.WIDE), so an element here is 12 x 32-bit limbs,
// little-endian, and the Montgomery radix is R = 2^384. A product is CIOS
// (coarsely integrated operand scanning) with 64-bit accumulators: 12
// rounds of 12 multiply-adds a[i] * b[j], one m = t[0] * n0 and 12
// multiply-adds m * p[j], 300 in all.
//
// Invariant: every element at rest is canonical (< p). CIOS with a, b < p
// and p < R / 4 leaves t < 2p, and one conditional subtraction of p makes
// it canonical; an add leaves a + b < 2p and takes the same subtraction; a
// subtraction that borrows adds p back. Zero tests are then plain limb
// compares, as vec.py's zero masks require.
//
// The functions are plain C++ as well: without __CUDACC__ they compile as
// host functions, so a host compiler can check them against Python
// integers before they ever reach the card.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TM_DEV __device__ __forceinline__
#define TM_NOINLINE __device__ __noinline__
#define TM_CONST __constant__
#define TM_UNROLL _Pragma("unroll")
#else
#define TM_DEV static inline
#define TM_NOINLINE static
#define TM_CONST static const
#define TM_UNROLL
#endif

#define FQ_LIMBS 12

struct fq {
  uint32_t v[FQ_LIMBS];
};

// p, little-endian 32-bit limbs
TM_CONST uint32_t FQ_P[FQ_LIMBS] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

// -p^-1 mod 2^32
#define FQ_N0 0xfffcfffdu

TM_DEV void fq_copy(fq &r, const fq &a) {
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) r.v[i] = a.v[i];
}

TM_DEV void fq_zero(fq &r) {
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) r.v[i] = 0;
}

TM_DEV bool fq_is_zero(const fq &a) {
  uint32_t acc = 0;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) acc |= a.v[i];
  return acc == 0;
}

// r = s - p if s >= p, else s; s < 2p
TM_DEV void fq_reduce_once(fq &r, const uint32_t s[FQ_LIMBS]) {
  uint32_t d[FQ_LIMBS];
  uint64_t borrow = 0;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) {
    const uint64_t x = (uint64_t)s[i] - FQ_P[i] - borrow;
    d[i] = (uint32_t)x;
    borrow = (x >> 32) & 1;
  }
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) r.v[i] = borrow ? s[i] : d[i];
}

// r = a + b mod p
TM_DEV void fq_add(fq &r, const fq &a, const fq &b) {
  uint32_t s[FQ_LIMBS];
  uint64_t carry = 0;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) {
    const uint64_t x = (uint64_t)a.v[i] + b.v[i] + carry;
    s[i] = (uint32_t)x;
    carry = x >> 32;
  }
  fq_reduce_once(r, s);  // a + b < 2p < 2^382: no carry out of limb 11
}

// r = a - b mod p
TM_DEV void fq_sub(fq &r, const fq &a, const fq &b) {
  uint32_t d[FQ_LIMBS];
  uint64_t borrow = 0;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) {
    const uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    d[i] = (uint32_t)x;
    borrow = (x >> 32) & 1;
  }
  const uint32_t mask = 0u - (uint32_t)borrow;  // add p back on a borrow
  uint64_t carry = 0;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) {
    const uint64_t x = (uint64_t)d[i] + (FQ_P[i] & mask) + carry;
    r.v[i] = (uint32_t)x;
    carry = x >> 32;
  }
}

// r = a * b * 2^-384 mod p (CIOS)
TM_NOINLINE void fq_mul(fq &r, const fq &a, const fq &b) {
  uint32_t t[FQ_LIMBS + 2];
  TM_UNROLL
  for (int j = 0; j < FQ_LIMBS + 2; j++) t[j] = 0;
  for (int i = 0; i < FQ_LIMBS; i++) {
    const uint64_t ai = a.v[i];
    uint64_t c = 0;
    TM_UNROLL
    for (int j = 0; j < FQ_LIMBS; j++) {
      const uint64_t x = t[j] + ai * b.v[j] + c;  // < 2^64
      t[j] = (uint32_t)x;
      c = x >> 32;
    }
    uint64_t x = (uint64_t)t[FQ_LIMBS] + c;
    t[FQ_LIMBS] = (uint32_t)x;
    t[FQ_LIMBS + 1] = (uint32_t)(x >> 32);

    const uint64_t m = (uint32_t)(t[0] * FQ_N0);
    c = ((uint64_t)t[0] + m * FQ_P[0]) >> 32;  // low word is 0 by m's choice
    TM_UNROLL
    for (int j = 1; j < FQ_LIMBS; j++) {
      x = t[j] + m * FQ_P[j] + c;
      t[j - 1] = (uint32_t)x;
      c = x >> 32;
    }
    x = (uint64_t)t[FQ_LIMBS] + c;
    t[FQ_LIMBS - 1] = (uint32_t)x;
    t[FQ_LIMBS] = t[FQ_LIMBS + 1] + (uint32_t)(x >> 32);
  }
  // t < 2p < 2^382: t[FQ_LIMBS] is 0
  fq_reduce_once(r, t);
}
