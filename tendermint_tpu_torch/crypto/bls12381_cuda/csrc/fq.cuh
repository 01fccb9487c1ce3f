// Montgomery arithmetic in Fq, the BLS12-381 base field.
//
// Counterpart of the limb engine under K10 (tendermint_tpu/crypto/
// bls12381/vec.py: mont_mul :141, vl_add / vl_sub, _cond_sub_p). The TPU
// version holds 30 x 13-bit limbs in int32 lanes (CFG_JAX, R = 2^390) so
// every column sum stays inside 32 bits. Hopper multiplies 32 x 32 bits in
// one instruction with the carry flag in and out, so an element here is 12
// x 32-bit limbs, little-endian, and the Montgomery radix is R = 2^384.
//
// The product is CIOS (coarsely integrated operand scanning), fully
// unrolled, with its operands and its 13-word accumulator in registers:
// each of 12 rounds adds a[i] * b (one carry chain of the 12 low halves,
// one of the 12 high halves), then m * p with m = t[0] * n0 (two chains
// more), then drops the zero word. On the card each step is one PTX
// instruction of a carry chain (mad.lo.cc, madc.hi.cc, addc.cc): no 64-bit
// accumulator and no 64-bit add. Off the card (a host compiler checking
// this file) the same steps run on a carry flag held in a variable, so the
// host runs the very sequence of steps the card runs.
//
// Bounds: a, b < p. Before round i's m * p the accumulator is below
// 2p + (2^32 - 1) p, after it below 2^33 p < 2^415, so 13 words hold it and
// no chain carries out of the top word; after the shift it is below 2p
// (p < R / 4), and one conditional subtraction makes it canonical.
//
// Invariant: every element at rest is canonical (< p). An add leaves
// a + b < 2p and takes the same conditional subtraction (g2.cuh subtracts
// by adding p - b). Zero tests are then plain limb compares, as vec.py's
// zero masks require.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TM_DEV __device__ __forceinline__
#define TM_CONST __constant__
#define TM_UNROLL _Pragma("unroll")
#else
#define TM_DEV static inline
#define TM_CONST static const
#define TM_UNROLL
#endif

#define FQ_LIMBS 12

struct fq {
  uint32_t v[FQ_LIMBS];
};

// p, little-endian 32-bit limbs (literals, so that they fold into the
// unrolled code as immediates)
#define FQ_P0 0xffffaaabu
#define FQ_P1 0xb9feffffu
#define FQ_P2 0xb153ffffu
#define FQ_P3 0x1eabfffeu
#define FQ_P4 0xf6b0f624u
#define FQ_P5 0x6730d2a0u
#define FQ_P6 0xf38512bfu
#define FQ_P7 0x64774b84u
#define FQ_P8 0x434bacd7u
#define FQ_P9 0x4b1ba7b6u
#define FQ_P10 0x397fe69au
#define FQ_P11 0x1a0111eau

TM_DEV uint32_t fq_p(int i) {
  switch (i) {
    case 0: return FQ_P0;
    case 1: return FQ_P1;
    case 2: return FQ_P2;
    case 3: return FQ_P3;
    case 4: return FQ_P4;
    case 5: return FQ_P5;
    case 6: return FQ_P6;
    case 7: return FQ_P7;
    case 8: return FQ_P8;
    case 9: return FQ_P9;
    case 10: return FQ_P10;
    default: return FQ_P11;
  }
}

// -p^-1 mod 2^32
#define FQ_N0 0xfffcfffdu

// --- carry-chain steps ------------------------------------------------------
//
// cc carries the flag between steps. On the card it is the hardware's
// carry flag and the variable is unused (each step is one volatile asm
// statement, kept in order); on the host it holds the flag.

struct fq_cc {
  uint32_t c;
};

#ifdef __CUDA_ARCH__
#define TM_CC1(op, r, x, y)                                        \
  asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y))
#define TM_CC2(op, r, x, y, z)                                     \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(z))

// r = x + y, flag out
TM_DEV uint32_t add_cc(fq_cc &, uint32_t x, uint32_t y) {
  uint32_t r; TM_CC1("add.cc.u32", r, x, y); return r;
}
// r = x + y + flag, flag out
TM_DEV uint32_t addc_cc(fq_cc &, uint32_t x, uint32_t y) {
  uint32_t r; TM_CC1("addc.cc.u32", r, x, y); return r;
}
// r = x + y + flag
TM_DEV uint32_t addc(fq_cc &, uint32_t x, uint32_t y) {
  uint32_t r; TM_CC1("addc.u32", r, x, y); return r;
}
// r = x - y, borrow out
TM_DEV uint32_t sub_cc(fq_cc &, uint32_t x, uint32_t y) {
  uint32_t r; TM_CC1("sub.cc.u32", r, x, y); return r;
}
// r = x - y - borrow, borrow out
TM_DEV uint32_t subc_cc(fq_cc &, uint32_t x, uint32_t y) {
  uint32_t r; TM_CC1("subc.cc.u32", r, x, y); return r;
}
// r = x - y - borrow
TM_DEV uint32_t subc(fq_cc &, uint32_t x, uint32_t y) {
  uint32_t r; TM_CC1("subc.u32", r, x, y); return r;
}
// r = lo(x y) + z, flag out
TM_DEV uint32_t mad_lo_cc(fq_cc &, uint32_t x, uint32_t y, uint32_t z) {
  uint32_t r; TM_CC2("mad.lo.cc.u32", r, x, y, z); return r;
}
// r = lo(x y) + z + flag, flag out
TM_DEV uint32_t madc_lo_cc(fq_cc &, uint32_t x, uint32_t y, uint32_t z) {
  uint32_t r; TM_CC2("madc.lo.cc.u32", r, x, y, z); return r;
}
// r = hi(x y) + z, flag out
TM_DEV uint32_t mad_hi_cc(fq_cc &, uint32_t x, uint32_t y, uint32_t z) {
  uint32_t r; TM_CC2("mad.hi.cc.u32", r, x, y, z); return r;
}
// r = hi(x y) + z + flag, flag out
TM_DEV uint32_t madc_hi_cc(fq_cc &, uint32_t x, uint32_t y, uint32_t z) {
  uint32_t r; TM_CC2("madc.hi.cc.u32", r, x, y, z); return r;
}
// r = hi(x y) + z + flag
TM_DEV uint32_t madc_hi(fq_cc &, uint32_t x, uint32_t y, uint32_t z) {
  uint32_t r; TM_CC2("madc.hi.u32", r, x, y, z); return r;
}
#undef TM_CC1
#undef TM_CC2
#else
// the same steps in plain C++: cc.c is the flag (0 or 1)
TM_DEV uint32_t add_cc(fq_cc &cc, uint32_t x, uint32_t y) {
  const uint64_t s = (uint64_t)x + y;
  cc.c = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
TM_DEV uint32_t addc_cc(fq_cc &cc, uint32_t x, uint32_t y) {
  const uint64_t s = (uint64_t)x + y + cc.c;
  cc.c = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
TM_DEV uint32_t addc(fq_cc &cc, uint32_t x, uint32_t y) {
  return x + y + cc.c;
}
TM_DEV uint32_t sub_cc(fq_cc &cc, uint32_t x, uint32_t y) {
  cc.c = x < y;
  return x - y;
}
TM_DEV uint32_t subc_cc(fq_cc &cc, uint32_t x, uint32_t y) {
  const uint64_t d = (uint64_t)x - y - cc.c;
  cc.c = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
TM_DEV uint32_t subc(fq_cc &cc, uint32_t x, uint32_t y) {
  return x - y - cc.c;
}
TM_DEV uint32_t mad_lo_cc(fq_cc &cc, uint32_t x, uint32_t y, uint32_t z) {
  return add_cc(cc, x * y, z);
}
TM_DEV uint32_t madc_lo_cc(fq_cc &cc, uint32_t x, uint32_t y, uint32_t z) {
  return addc_cc(cc, x * y, z);
}
TM_DEV uint32_t mad_hi_cc(fq_cc &cc, uint32_t x, uint32_t y, uint32_t z) {
  return add_cc(cc, (uint32_t)(((uint64_t)x * y) >> 32), z);
}
TM_DEV uint32_t madc_hi_cc(fq_cc &cc, uint32_t x, uint32_t y, uint32_t z) {
  return addc_cc(cc, (uint32_t)(((uint64_t)x * y) >> 32), z);
}
TM_DEV uint32_t madc_hi(fq_cc &cc, uint32_t x, uint32_t y, uint32_t z) {
  return addc(cc, (uint32_t)(((uint64_t)x * y) >> 32), z);
}
#endif

// --- elements --------------------------------------------------------------

TM_DEV void fq_zero(fq &r) {
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) r.v[i] = 0;
}

// r = s - p if s >= p, else s; s < 2p
TM_DEV void fq_reduce_once(fq &r, const uint32_t s[FQ_LIMBS]) {
  fq_cc cc;
  uint32_t d[FQ_LIMBS];
  d[0] = sub_cc(cc, s[0], FQ_P0);
  TM_UNROLL
  for (int i = 1; i < FQ_LIMBS; i++) d[i] = subc_cc(cc, s[i], fq_p(i));
  const uint32_t keep = subc(cc, 0, 0);  // all ones when s < p
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) r.v[i] = d[i] ^ ((d[i] ^ s[i]) & keep);
}

// r = a + b mod p
TM_DEV void fq_add(fq &r, const fq &a, const fq &b) {
  fq_cc cc;
  uint32_t s[FQ_LIMBS];
  s[0] = add_cc(cc, a.v[0], b.v[0]);
  TM_UNROLL
  for (int i = 1; i < FQ_LIMBS; i++) s[i] = addc_cc(cc, a.v[i], b.v[i]);
  fq_reduce_once(r, s);  // a + b < 2p < 2^382: no carry out of limb 11
}

// r = a * b * 2^-384 mod p (CIOS, see the top of this file)
TM_DEV void fq_mul(fq &r, const fq &a, const fq &b) {
  fq_cc cc;
  uint32_t t[FQ_LIMBS + 1];
  TM_UNROLL
  for (int j = 0; j <= FQ_LIMBS; j++) t[j] = 0;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++) {
    const uint32_t ai = a.v[i];
    // t += a[i] * b: the low halves into t[0..11], then the high halves
    // into t[1..12]
    t[0] = mad_lo_cc(cc, ai, b.v[0], t[0]);
    TM_UNROLL
    for (int j = 1; j < FQ_LIMBS; j++) t[j] = madc_lo_cc(cc, ai, b.v[j], t[j]);
    t[FQ_LIMBS] = addc(cc, t[FQ_LIMBS], 0);
    t[1] = mad_hi_cc(cc, ai, b.v[0], t[1]);
    TM_UNROLL
    for (int j = 1; j < FQ_LIMBS - 1; j++)
      t[j + 1] = madc_hi_cc(cc, ai, b.v[j], t[j + 1]);
    t[FQ_LIMBS] = madc_hi(cc, ai, b.v[FQ_LIMBS - 1], t[FQ_LIMBS]);
    // t += m * p makes t[0] zero
    const uint32_t m = t[0] * FQ_N0;
    t[0] = mad_lo_cc(cc, m, FQ_P0, t[0]);
    TM_UNROLL
    for (int j = 1; j < FQ_LIMBS; j++) t[j] = madc_lo_cc(cc, m, fq_p(j), t[j]);
    t[FQ_LIMBS] = addc(cc, t[FQ_LIMBS], 0);
    t[1] = mad_hi_cc(cc, m, FQ_P0, t[1]);
    TM_UNROLL
    for (int j = 1; j < FQ_LIMBS - 1; j++)
      t[j + 1] = madc_hi_cc(cc, m, fq_p(j), t[j + 1]);
    t[FQ_LIMBS] = madc_hi(cc, m, FQ_P11, t[FQ_LIMBS]);
    // drop the zero word
    TM_UNROLL
    for (int j = 0; j < FQ_LIMBS; j++) t[j] = t[j + 1];
    t[FQ_LIMBS] = 0;
  }
  fq_reduce_once(r, t);
}
