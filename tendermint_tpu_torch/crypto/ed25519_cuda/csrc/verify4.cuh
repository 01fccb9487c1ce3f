// One strict, cofactorless Ed25519 verification on a group of four lanes:
// the core of ed25519_verify_dense (K5/K6) and ed25519_verify_sparse (K7).
//
// Counterpart of tendermint_tpu/crypto/ed25519_jax/verify.py _verify_kernel
// (K5) and _verify_sparse_stream_kernel (K7). The host keeps the length and
// s < L checks and ANDs its mask with this verdict, exactly as the JAX
// package does. K8 (tally.cu) runs the same item.
//
// Work split:
// * Serial parts, the same on all four lanes of the group: the SHA-512 of
//   the preimage (preimage.cuh, before this core), the reduction mod L,
//   the decompression of A (pow_p58) and the final encoding (one
//   inversion). A warp runs its 32 lanes in step, so one lane doing them
//   while three wait would take as long; a multiply split over the lanes
//   would save its products but not its carry chain, which sets its
//   latency.
// * [h](-A) and [s]B on lanes.cuh's parallel formulas: a table of
//   [0..15](-A) in cached form (14 additions), 64 windows of 4 doublings
//   and one addition, 64 mixed additions with the fixed-base table, one
//   addition of the two: about 800 rounds of one multiply a lane where one
//   thread would run about 3,000 multiplies in series.
//
// Per-thread scratch lives in shared memory, in the thread's own column of
// a [TM_V4_ROWS][stride] array (stride = the block's threads): the window
// table (16 entries x 10 limbs of the lane's coordinate), the digits of h
// and s (8 words each, 8 digits a word) and R (8 words). A warp's 32 reads
// or writes of one row hit 32 distinct banks whatever the digits, and no
// thread reads another's column, so the core needs no barrier.
#pragma once

#include "lanes.cuh"
#include "preimage.cuh"
#include "scalar.cuh"

#define TM_V4_TABLE_ROW 0    // 160 rows: entry k, limb l at row 10 k + l
#define TM_V4_H_ROW 160      // 8 rows: digits 8w .. 8w + 7 of h mod L
#define TM_V4_S_ROW 168      // 8 rows: digits of s
#define TM_V4_R_ROW 176      // 8 rows: R as little-endian words
#define TM_V4_ROWS 184

TM_DEV void v4_store(uint32_t *col, int stride, int row, const fe &f) {
  TM_UNROLL
  for (int l = 0; l < 10; l++) col[(row + l) * stride] = f.v[l];
}

TM_DEV void v4_load(fe &f, const uint32_t *col, int stride, int row) {
  TM_UNROLL
  for (int l = 0; l < 10; l++) f.v[l] = col[(row + l) * stride];
}

// digit i (0..63, least significant first) of the scalar at row base
TM_DEV int v4_digit(const uint32_t *col, int stride, int base, int i) {
  return (col[(base + (i >> 3)) * stride] >> (4 * (i & 7))) & 15;
}

TM_DEV uint32_t v4_le_word(const uint8_t *b) {
  return (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
         ((uint32_t)b[3] << 24);
}

// [s]B + [h](-A), encoded, compared with R as bytes; the same verdict on
// the four lanes. col is the thread's column of the scratch array. A failed
// decompression is masked to the identity before the scalar multiply: its
// coordinates are off the curve, where the addition law's z != 0 guarantee
// (and so the inversion in the encoding) does not hold. Its verdict is
// false either way.
//
// Out of line: the kernels call one copy.
//
// The digest is reduced before A is decompressed, so the caller's digest
// is read before the core's own locals are written. With A decompressed
// first, nvcc (sm_90a, NVVM at -O1 and up) gave the caller's digest and A
// one local-memory slot in a build with this core inlined. The
// decompression then overwrote the digest, and every verdict with A not
// the identity came out false (PERF.md, Open questions).
TM_NOINLINE bool verify4_core(const uint8_t r[32], const uint8_t a[32],
                         const uint8_t s[32], const uint64_t digest_le[8],
                         const uint32_t *__restrict__ base_table,
                         uint32_t *col, int stride) {
  const int c = lane4();
  // the caller's inputs first: the digits of h and s, and R, into the
  // scratch column
  {
    uint8_t hd[64];
    sc_reduce_digits(hd, digest_le);
    TM_UNROLL
    for (int w = 0; w < 8; w++) {
      uint32_t x = 0;
      TM_UNROLL
      for (int k = 0; k < 8; k++) x |= (uint32_t)hd[8 * w + k] << (4 * k);
      col[(TM_V4_H_ROW + w) * stride] = x;
      col[(TM_V4_S_ROW + w) * stride] = v4_le_word(s + 4 * w);
      col[(TM_V4_R_ROW + w) * stride] = v4_le_word(r + 4 * w);
    }
  }
  fe p;
  bool ok_a;
  {
    ge A;
    ok_a = ge_decompress(A, a);
    if (!ok_a) ge_identity(A);
    ge4_neg_coord(p, c, A);
  }

  // the table [0..15](-A), cached
  fe q, acc;
  ge4_identity_cached(q, c);
  v4_store(col, stride, TM_V4_TABLE_ROW, q);
  ge4_to_cached(q, p);
  v4_store(col, stride, TM_V4_TABLE_ROW + 10, q);
  fe_copy(acc, p);
  for (int k = 2; k < 16; k++) {
    fe e;
    ge4_add(acc, q, false);
    ge4_to_cached(e, acc);
    v4_store(col, stride, TM_V4_TABLE_ROW + 10 * k, e);
  }

  // [h](-A), most significant window first
  ge4_identity(acc, c);
  for (int i = 63; i >= 0; i--) {
    ge4_dbl(acc);
    ge4_dbl(acc);
    ge4_dbl(acc);
    ge4_dbl(acc);
    v4_load(q, col, stride,
            TM_V4_TABLE_ROW + 10 * v4_digit(col, stride, TM_V4_H_ROW, i));
    ge4_add(acc, q, false);
  }

  // [s]B: lane c reads its part of entry (i, digit) of the fixed-base
  // table (64 x 16 x (y + x, y - x, 2d x y) x 10 limbs) through the
  // read-only path; lane 2's is 1
  fe sb;
  ge4_identity(sb, c);
  const int part = pick4(c, 1, 0, 0, 2);
  for (int i = 0; i < 64; i++) {
    const uint32_t *e =
        base_table +
        ((i * 16 + v4_digit(col, stride, TM_V4_S_ROW, i)) * 3 + part) * 10;
    fe n;
    TM_UNROLL
    for (int l = 0; l < 10; l++) n.v[l] = TM_LDG(e + l);
    if (c == 2) fe_one(n);
    ge4_add(sb, n, true);
  }

  ge4_to_cached(q, acc);
  ge4_add(sb, q, false);

  // the encoding, on every lane
  ge P;
  fe_xchg(P.X, sb, 0);
  fe_xchg(P.Y, sb, 1);
  fe_xchg(P.Z, sb, 2);
  fe_zero(P.T);
  uint8_t enc[32];
  ge_encode(enc, P);
  bool eq = true;
  TM_UNROLL
  for (int w = 0; w < 8; w++)
    eq = eq && v4_le_word(enc + 4 * w) == col[(TM_V4_R_ROW + w) * stride];
  return ok_a && eq;
}

// Dense wire format: see preimage.cuh. Every lane of the group hashes; the
// item's block count may differ from its warp neighbours', so the warp
// meets again before the core's first exchange.
TM_DEV bool verify4_dense_item(const uint32_t *__restrict__ words, int nblk,
                               const uint32_t *__restrict__ s_words,
                               const uint32_t *__restrict__ base_table,
                               uint32_t *col, int stride) {
  uint8_t r[32], a[32], s[32];
  uint64_t dig[8];
  dense_item_inputs(r, a, s, dig, words, nblk, s_words);
  lanes_sync();
  return verify4_core(r, a, s, dig, base_table, col, stride);
}

// Sparse wire format: see preimage.cuh. Every lane of the group assembles
// and hashes (mlen, and so the block count, varies as in the dense format).
TM_DEV bool verify4_sparse_item(const uint8_t *__restrict__ tpl, int mlen_max,
                                const int32_t *__restrict__ cols, int ncols,
                                const uint8_t *__restrict__ dvals, int mlen,
                                const uint8_t *__restrict__ r_g,
                                const uint8_t *__restrict__ a_g,
                                const uint8_t *__restrict__ s_g,
                                const uint32_t *__restrict__ base_table,
                                uint32_t *col, int stride) {
  uint8_t r[32], a[32], s[32];
  uint64_t dig[8];
  sparse_item_inputs(r, a, s, dig, tpl, mlen_max, cols, ncols, dvals, mlen,
                     r_g, a_g, s_g);
  lanes_sync();
  return verify4_core(r, a, s, dig, base_table, col, stride);
}
