// edwards25519 points, one point per thread: the constants, decompression
// and the encoding, the serial parts of a verify. The additions, the
// doubling and the scalar multiplies run on four lanes a point (lanes.cuh,
// verify4.cuh).
//
// Counterpart of K4 (tendermint_tpu/crypto/ed25519_jax/curve.py: decompress,
// encode; its add/dbl/add_niels and scalar multiplies are lanes.cuh's and
// verify4.cuh's). Extended coordinates (X, Y, Z, T) with the complete
// a = -1 addition law, so no input pair needs a branch. Where the TPU
// selected table entries with a one-hot product over all 16 entries, a
// group here indexes its table directly: verification handles public data
// only.
#pragma once

#include "field.cuh"

struct ge {
  fe X, Y, Z, T;
};

TM_CONST uint32_t TM_FE_D[10] = {56195235, 13857412, 51736253, 6949390,
                                 114729, 24766616, 60832955, 30306712,
                                 48412415, 21499315};
TM_CONST uint32_t TM_FE_D2[10] = {45281625, 27714825, 36363642, 13898781,
                                  229458, 15978800, 54557047, 27058993,
                                  29715967, 9444199};
TM_CONST uint32_t TM_FE_SQRTM1[10] = {34513072, 25610706, 9377949, 3500415,
                                      12389472, 33281959, 41962654, 31548777,
                                      326685, 11406482};

TM_DEV void fe_load_const(fe &h, const uint32_t *c) {
  TM_UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = c[i];
}

TM_DEV void ge_identity(ge &p) {
  fe_zero(p.X);
  fe_one(p.Y);
  fe_one(p.Z);
  fe_zero(p.T);
}

// RFC 8032 5.1.3 decoding of a 32-byte point. Returns false for y >= p, a
// non-square x^2, and x = 0 with sign bit 1 — the rules of the host spec's
// _recover_x. The point is written either way; the caller masks it.
TM_NOINLINE bool ge_decompress(ge &p, const uint8_t s[32]) {
  // y >= p iff the low 255 bits are in [2^255 - 19, 2^255 - 1]
  bool y_big = (s[31] & 0x7f) == 0x7f && s[0] >= 0xed;
  TM_UNROLL
  for (int i = 1; i < 31; i++) y_big = y_big && s[i] == 0xff;
  const uint32_t sign = s[31] >> 7;
  fe y, one, d, yy, u, v, v3, v7, t, x, vxx, chk;
  fe_frombytes(y, s);
  fe_one(one);
  fe_load_const(d, TM_FE_D);
  fe_sq(yy, y);
  fe_sub(u, yy, one);
  fe_mul(t, yy, d);
  fe_add(v, t, one);
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(t, x);
  fe_mul(vxx, v, t);
  fe_sub(chk, vxx, u);
  const bool ok_direct = fe_iszero(chk);
  fe_add(chk, vxx, u);
  const bool ok_flip = fe_iszero(chk);
  fe sqrtm1, xs;
  fe_load_const(sqrtm1, TM_FE_SQRTM1);
  fe_mul(xs, x, sqrtm1);
  fe_cmov(x, xs, !ok_direct);
  fe fx;
  fe_freeze(fx, x);
  uint32_t xz = 0;
  TM_UNROLL
  for (int i = 0; i < 10; i++) xz |= fx.v[i];
  const bool x_is_zero = xz == 0;
  const bool ok = !y_big && (ok_direct || ok_flip) && !(x_is_zero && sign == 1);
  fe xn;
  fe_neg(xn, x);
  fe_cmov(x, xn, (fx.v[0] & 1) != sign);
  fe_copy(p.X, x);
  fe_copy(p.Y, y);
  fe_one(p.Z);
  fe_mul(p.T, x, y);
  return ok;
}

// 32-byte encoding: canonical y with the parity of x in bit 255.
TM_NOINLINE void ge_encode(uint8_t s[32], const ge &p) {
  fe zi, x, y;
  fe_invert(zi, p.Z);
  fe_mul(x, p.X, zi);
  fe_mul(y, p.Y, zi);
  fe_tobytes(s, y);
  s[31] |= (uint8_t)(fe_parity(x) << 7);
}
