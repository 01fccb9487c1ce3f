// The inputs of one verification from the two wire formats: R, A and s as
// bytes, and the SHA-512 digest of the preimage R || A || M as 8
// little-endian u64 words (the challenge before its reduction mod L).
//
// Counterpart of K5's block reads and of K7's preimage assembly
// (tendermint_tpu/crypto/ed25519_jax/verify.py _verify_kernel,
// _assemble_blocks). Used by the four-lane verify (verify4.cuh).
#pragma once

#include "sha512.cuh"

// Dense wire format (prepare_batch): an item's preimage R || A || M, padded,
// as nblk_max blocks of 32 big-endian u32 words; R and A are read back out
// of the first block. Only the item's own nblk blocks are hashed.
TM_DEV void dense_item_inputs(uint8_t r[32], uint8_t a[32], uint8_t s[32],
                              uint64_t dig[8],
                              const uint32_t *__restrict__ words, int nblk,
                              const uint32_t *__restrict__ s_words) {
  TM_UNROLL
  for (int t = 0; t < 8; t++) {
    const uint32_t wr = TM_LDG(words + t), wa = TM_LDG(words + 8 + t);
    const uint32_t ws = TM_LDG(s_words + t);
    TM_UNROLL
    for (int b = 0; b < 4; b++) {
      r[4 * t + b] = (uint8_t)(wr >> (24 - 8 * b));
      a[4 * t + b] = (uint8_t)(wa >> (24 - 8 * b));
      s[4 * t + b] = (uint8_t)(ws >> (8 * b));
    }
  }
  uint64_t st[8];
  sha512_init(st);
  for (int b = 0; b < nblk; b++) {
    uint64_t blk[16];
    TM_UNROLL
    for (int t = 0; t < 16; t++) {
      const uint32_t *w = words + 32 * b + 2 * t;
      blk[t] = ((uint64_t)TM_LDG(w) << 32) | TM_LDG(w + 1);
    }
    sha512_compress(st, blk);
  }
  sha512_digest_le64(dig, st);
}

// Sparse wire format (prepare_sparse_stream): block b of an item's
// preimage assembled from its chunk's template, the diff columns, mlen, R
// and A — byte-identical to prepare_batch. Same write order as the JAX
// _assemble_blocks: template, diff values, zero from mlen on, the 0x80
// marker, then the 128-bit big-endian bit length at the end of block
// nblk - 1. Duplicate pad columns rewrite the same value.
TM_DEV void sparse_block(uint64_t blk[16], int b,
                         const uint8_t *__restrict__ tpl, int mlen_max,
                         const int32_t *__restrict__ cols, int ncols,
                         const uint8_t *__restrict__ dvals, int mlen,
                         const uint8_t r[32], const uint8_t a[32], int nblk) {
  uint8_t buf[128];
  for (int j = 0; j < 128; j++) {
    const int pos = 128 * b + j, mp = pos - 64;
    uint8_t v;
    if (pos < 32) {
      v = r[pos];
    } else if (pos < 64) {
      v = a[pos - 32];
    } else {
      v = mp < mlen_max ? TM_LDG(tpl + mp) : 0;
    }
    buf[j] = v;
  }
  for (int c = 0; c < ncols; c++) {
    const int pos = 64 + TM_LDG(cols + c);
    if ((pos >> 7) == b) buf[pos & 127] = TM_LDG(dvals + c);
  }
  const uint32_t bitlen = (uint32_t)(mlen + 64) * 8u;
  const int last = nblk * 128;  // end of the item's last block
  for (int j = 0; j < 128; j++) {
    const int pos = 128 * b + j, mp = pos - 64;
    if (mp >= mlen) buf[j] = 0;
    if (mp == mlen) buf[j] = 0x80;
    const int k = last - 1 - pos;  // byte k of the big-endian length
    if (k >= 0 && k < 8) buf[j] = k < 4 ? (uint8_t)(bitlen >> (8 * k)) : 0;
  }
  TM_UNROLL
  for (int t = 0; t < 16; t++) {
    uint64_t x = 0;
    TM_UNROLL
    for (int i = 0; i < 8; i++) x = (x << 8) | buf[8 * t + i];
    blk[t] = x;
  }
}

TM_DEV void sparse_item_inputs(uint8_t r[32], uint8_t a[32], uint8_t s[32],
                               uint64_t dig[8],
                               const uint8_t *__restrict__ tpl, int mlen_max,
                               const int32_t *__restrict__ cols, int ncols,
                               const uint8_t *__restrict__ dvals, int mlen,
                               const uint8_t *__restrict__ r_g,
                               const uint8_t *__restrict__ a_g,
                               const uint8_t *__restrict__ s_g) {
  TM_UNROLL
  for (int i = 0; i < 32; i++) {
    r[i] = TM_LDG(r_g + i);
    a[i] = TM_LDG(a_g + i);
    s[i] = TM_LDG(s_g + i);
  }
  const int nblk = (64 + mlen + 17 + 127) / 128;
  uint64_t st[8];
  sha512_init(st);
  for (int b = 0; b < nblk; b++) {
    uint64_t blk[16];
    sparse_block(blk, b, tpl, mlen_max, cols, ncols, dvals, mlen, r, a, nblk);
    sha512_compress(st, blk);
  }
  sha512_digest_le64(dig, st);
}
