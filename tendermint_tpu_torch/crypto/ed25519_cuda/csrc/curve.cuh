// edwards25519 group operations, one point per thread.
//
// The additions, the doubling and the two scalar multiplies serve the
// one-thread verify that K8 keeps (verify.cuh); K5-K7 run them on four
// lanes a point (lanes.cuh). Decompression and the encoding serve both.
//
// Counterpart of K4 (tendermint_tpu/crypto/ed25519_jax/curve.py: decompress,
// encode, add/dbl/add_niels, scalar_mul_windowed, scalar_mul_base). Same
// formulas: extended coordinates (X, Y, Z, T) with the complete a = -1
// addition law, so no input pair needs a branch. Where the TPU selected
// table entries with a one-hot product over all 16 entries, a thread here
// indexes its table directly: verification handles public data only.
#pragma once

#include "field.cuh"

struct ge {
  fe X, Y, Z, T;
};

// affine niels form of a base-table entry: (y + x, y - x, 2 d x y)
struct ge_niels {
  fe ypx, ymx, t2d;
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

// complete addition (the 2d variant), 9 multiplies
TM_NOINLINE void ge_add(ge &r, const ge &p, const ge &q) {
  fe a, b, c, d, e, f, g, h, t0, t1, d2;
  fe_sub(t0, p.Y, p.X);
  fe_sub(t1, q.Y, q.X);
  fe_mul(a, t0, t1);
  fe_add(t0, p.Y, p.X);
  fe_add(t1, q.Y, q.X);
  fe_mul(b, t0, t1);
  fe_load_const(d2, TM_FE_D2);
  fe_mul(t0, p.T, q.T);
  fe_mul(c, t0, d2);
  fe_mul(d, p.Z, q.Z);
  fe_add(d, d, d);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// doubling, 4 multiplies + 4 squarings (T is never read by a doubling)
TM_NOINLINE void ge_dbl(ge &r, const ge &p) {
  fe a, b, c, e, f, g, h, t0;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_add(c, c, c);
  fe_add(h, a, b);
  fe_add(t0, p.X, p.Y);
  fe_sq(t0, t0);
  fe_sub(e, h, t0);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// mixed addition with an affine niels point, 7 multiplies
TM_NOINLINE void ge_add_niels(ge &r, const ge &p, const ge_niels &n) {
  fe a, b, c, d, e, f, g, h, t0;
  fe_sub(t0, p.Y, p.X);
  fe_mul(a, t0, n.ymx);
  fe_add(t0, p.Y, p.X);
  fe_mul(b, t0, n.ypx);
  fe_mul(c, p.T, n.t2d);
  fe_add(d, p.Z, p.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

TM_DEV void ge_neg(ge &r, const ge &p) {
  fe_neg(r.X, p.X);
  fe_copy(r.Y, p.Y);
  fe_copy(r.Z, p.Z);
  fe_neg(r.T, p.T);
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

// [k]P with k = sum digits[i] 16^i: a table of [0..15]P (15 additions),
// then 64 windows of 4 doublings and one table addition, most significant
// window first. The table is 2.5 KB per thread and lives in local memory.
TM_NOINLINE void ge_scalar_mul_windowed(ge &r, const ge &p, const uint8_t digits[64]) {
  ge table[16];
  ge_identity(table[0]);
  table[1] = p;
  for (int k = 2; k < 16; k++) ge_add(table[k], table[k - 1], p);
  ge acc;
  ge_identity(acc);
  for (int i = 63; i >= 0; i--) {
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_add(acc, acc, table[digits[i]]);
  }
  r = acc;
}

// [s]B with s = sum digits[i] 16^i from the fixed-base table
// (64 windows x 16 entries x 3 coordinates x 10 limbs, u32) in global
// memory: 64 mixed additions, no doublings.
TM_NOINLINE void ge_scalar_mul_base(ge &r, const uint8_t digits[64],
                               const uint32_t *__restrict__ table) {
  ge acc;
  ge_identity(acc);
  for (int i = 0; i < 64; i++) {
    const uint32_t *e = table + ((i * 16 + digits[i]) * 3) * 10;
    ge_niels n;
    TM_UNROLL
    for (int l = 0; l < 10; l++) {
      n.ypx.v[l] = TM_LDG(e + l);
      n.ymx.v[l] = TM_LDG(e + 10 + l);
      n.t2d.v[l] = TM_LDG(e + 20 + l);
    }
    ge_add_niels(acc, acc, n);
  }
  r = acc;
}
