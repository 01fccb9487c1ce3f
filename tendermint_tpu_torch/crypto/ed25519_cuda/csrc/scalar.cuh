// Reduction of the 512-bit SHA-512 challenge mod L = 2^252 + delta, and its
// 4-bit window digits.
//
// Counterpart of K2 (tendermint_tpu/crypto/ed25519_jax/scalar.py:
// sc_reduce_digits). The algorithm is the same signed fold: radix-2^11
// limbs, split at bit 253 (limb 23) using 2^253 = -2 delta (mod L), three
// folds take 517 bits below 2^253 in magnitude, then +8L and conditional
// subtractions of 8L, 4L, 2L and L land in [0, L). Limbs are int64 here, so
// the fold products (< 2^22 each, at most 12 per column) have wide margin.
// The reduction is a few hundred integer operations per signature, well
// under 1% of the verify.
#pragma once

#include "common.cuh"

#define TM_SC_RADIX 11
#define TM_SC_MASK 2047
#define TM_SC_NL 23

// 2 delta = 2 (L - 2^252) in 12 radix-2^11 limbs
TM_CONST int32_t TM_SC_D2[12] = {2010, 1396, 743, 794, 588, 352,
                                 1643, 1913, 1349, 1655, 1783, 20};
// 8L, 4L, 2L, L in 24 radix-2^11 limbs
TM_CONST int32_t TM_SC_LMULT[4][24] = {
    {1896, 1491, 926, 1129, 305, 1409, 428, 1511, 1303, 478, 991, 83,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4},
    {1972, 745, 1487, 1588, 1176, 704, 1238, 1779, 651, 1263, 1519, 41,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2},
    {2010, 1396, 743, 794, 588, 352, 1643, 1913, 1349, 1655, 1783, 20,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1},
    {1005, 1722, 371, 397, 294, 1200, 1845, 1980, 1698, 1851, 891, 10,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1024, 0},
};

// Sequential signed carry: limbs 0..n-2 land in [0, 2^11); the top limb
// keeps the sign of the whole value.
TM_DEV void sc_signed_carry(int64_t *x, int n) {
  for (int i = 0; i < n - 1; i++) {
    const int64_t c = x[i] >> TM_SC_RADIX;  // arithmetic: floor division
    x[i] -= c << TM_SC_RADIX;
    x[i + 1] += c;
  }
}

// out[0..n_out) = in[0..23) - in[23..n_in) * 2 delta, carried;
// n_out = max(24, n_in - 23 + 11).
TM_DEV int sc_fold(int64_t *out, const int64_t *in, int n_in) {
  const int n_hi = n_in - TM_SC_NL;
  int n_out = n_hi + 11;
  if (n_out < TM_SC_NL + 1) n_out = TM_SC_NL + 1;
  for (int k = 0; k < n_out; k++) out[k] = k < TM_SC_NL ? in[k] : 0;
  for (int i = 0; i < n_hi; i++) {
    const int64_t h = in[TM_SC_NL + i];
    TM_UNROLL
    for (int j = 0; j < 12; j++) out[i + j] -= h * (int64_t)TM_SC_D2[j];
  }
  sc_signed_carry(out, n_out);
  return n_out;
}

// x (24 carried limbs, value >= 0) -= sub if x >= sub.
TM_DEV void sc_cond_sub(int64_t x[24], const int32_t *sub) {
  int64_t d[24];
  for (int i = 0; i < 24; i++) d[i] = x[i] - (int64_t)sub[i];
  for (int i = 0; i < 23; i++) {
    const int64_t borrow = d[i] < 0 ? 1 : 0;
    d[i] += borrow << TM_SC_RADIX;
    d[i + 1] -= borrow;
  }
  const bool take = d[23] >= 0;
  for (int i = 0; i < 24; i++) x[i] = take ? d[i] : x[i];
}

// words: the 512-bit integer as 8 little-endian u64 words. digits: 64
// 4-bit windows of (value mod L), least significant first.
TM_NOINLINE void sc_reduce_digits(uint8_t digits[64], const uint64_t words[8]) {
  int64_t a[47], b[47];
  for (int k = 0; k < 47; k++) {
    const int bit = TM_SC_RADIX * k;
    const int w = bit >> 6, off = bit & 63;
    uint64_t v = 0;
    if (w < 8) {
      v = words[w] >> off;
      if (off > 64 - TM_SC_RADIX && w + 1 < 8) v |= words[w + 1] << (64 - off);
    }
    a[k] = (int64_t)(v & TM_SC_MASK);
  }
  int n = sc_fold(b, a, 47);   // |x| < 2^386
  n = sc_fold(a, b, n);        // |x| < 2^259
  n = sc_fold(b, a, n);        // |x| < 2^253, 24 limbs
  for (int i = 0; i < 24; i++) b[i] += TM_SC_LMULT[0][i];
  sc_signed_carry(b, 24);
  for (int m = 0; m < 4; m++) sc_cond_sub(b, TM_SC_LMULT[m]);
  for (int nib = 0; nib < 64; nib++) {
    const int bit = 4 * nib;
    const int li = bit / TM_SC_RADIX, off = bit % TM_SC_RADIX;
    int64_t v = b[li] >> off;
    if (off > TM_SC_RADIX - 4 && li + 1 < 24) v |= b[li + 1] << (TM_SC_RADIX - off);
    digits[nib] = (uint8_t)(v & 15);
  }
}
