// One strict, cofactorless Ed25519 verification per thread: the core of
// ed25519_verify_tally (K8, tally.cu). K5-K7 run four lanes a signature
// instead (verify4.cuh); this core stays as long as K8 uses it.
//
// Counterpart of K5 (tendermint_tpu/crypto/ed25519_jax/verify.py
// _verify_kernel). The host keeps the length and s < L checks and ANDs its
// mask with this verdict, exactly as the JAX package does.
#pragma once

#include "curve.cuh"
#include "preimage.cuh"
#include "scalar.cuh"

// [s]B + [h](-A), encoded, compared with R as bytes. A failed decompression
// is masked to the identity before the scalar multiply: its coordinates are
// off the curve, where the addition law's z != 0 guarantee (and so the
// inversion in the encoding) does not hold. Its verdict is false either way.
TM_NOINLINE bool verify_core(const uint8_t r[32], const uint8_t a[32],
                        const uint8_t s[32], const uint64_t digest_le[8],
                        const uint32_t *__restrict__ base_table) {
  ge A;
  const bool ok_a = ge_decompress(A, a);
  if (!ok_a) ge_identity(A);
  ge negA;
  ge_neg(negA, A);
  uint8_t h_digits[64], s_digits[64];
  sc_reduce_digits(h_digits, digest_le);
  TM_UNROLL
  for (int i = 0; i < 32; i++) {
    s_digits[2 * i] = s[i] & 15;
    s_digits[2 * i + 1] = s[i] >> 4;
  }
  ge hA, sB, rp;
  ge_scalar_mul_windowed(hA, negA, h_digits);
  ge_scalar_mul_base(sB, s_digits, base_table);
  ge_add(rp, sB, hA);
  uint8_t enc[32];
  ge_encode(enc, rp);
  bool eq = true;
  TM_UNROLL
  for (int i = 0; i < 32; i++) eq = eq && enc[i] == r[i];
  return ok_a && eq;
}

// K8's item: the dense wire format's inputs (preimage.cuh), verified by
// this one thread.
TM_DEV bool verify_dense_item(const uint32_t *__restrict__ words, int nblk,
                              const uint32_t *__restrict__ s_words,
                              const uint32_t *__restrict__ base_table) {
  uint8_t r[32], a[32], s[32];
  uint64_t dig[8];
  dense_item_inputs(r, a, s, dig, words, nblk, s_words);
  return verify_core(r, a, s, dig, base_table);
}
