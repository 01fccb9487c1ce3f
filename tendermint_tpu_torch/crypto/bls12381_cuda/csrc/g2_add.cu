// bls_g2_add_round — K10 of tendermint_tpu/crypto/bls12381/vec.py
// (_g2_add_round :285, which jits g2_add_vec :227 over mont_mul :141 under
// CFG_JAX :79): one pairwise round of the G2 tree sum that builds an
// aggregate pubkey, out[i] = P[i] + Q[i] for i < n.
//
// Layout: P, Q and out are item-major (n, 3, 2, 12) uint32 — per lane the
// Jacobian X, Y, Z, each an Fq2 (c0, c1), each 12 little-endian 32-bit
// limbs of a canonical Montgomery residue (R = 2^384): 72 words, 288 bytes
// a lane. The tree sum (vec.py's counterpart in the port) passes the
// two halves of one (2n, 3, 2, 12) tensor as P and Q.
//
// Bound: operations. A lane with both points finite does 6 Fq2 products
// and 2 squares before the branch, then 6 and 2 more (the addition) or 3
// and 4 (the doubling). An Fq2 product is 3 Fq products, a square 2: 44 or
// 39 Fq products of 300 32x32->64 multiply-adds each (a lane with a point
// at infinity does none), against 864 bytes of traffic, far above
// the card's ~5 integer operations per byte of memory traffic. At the
// tree's sizes (at most 512 lanes a round) the card is nearly empty and a
// launch lasts one thread's whole addition: latency, not throughput, sets
// its time. One thread per lane; each lane's 72 words in and out are read
// and written by that thread.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include "g2.cuh"

#define TM_G2_THREADS 128
#define TM_G2_WORDS (3 * 2 * FQ_LIMBS)

TM_DEV void load_point(g2j &pt, const uint32_t *__restrict__ src) {
  fq *dst[6] = {&pt.x.c0, &pt.x.c1, &pt.y.c0, &pt.y.c1, &pt.z.c0, &pt.z.c1};
  TM_UNROLL
  for (int c = 0; c < 6; c++) {
    TM_UNROLL
    for (int i = 0; i < FQ_LIMBS; i++) dst[c]->v[i] = src[c * FQ_LIMBS + i];
  }
}

TM_DEV void store_point(uint32_t *__restrict__ dst, const g2j &pt) {
  const fq *src[6] = {&pt.x.c0, &pt.x.c1, &pt.y.c0,
                      &pt.y.c1, &pt.z.c0, &pt.z.c1};
  TM_UNROLL
  for (int c = 0; c < 6; c++) {
    TM_UNROLL
    for (int i = 0; i < FQ_LIMBS; i++) dst[c * FQ_LIMBS + i] = src[c]->v[i];
  }
}

__global__ void __launch_bounds__(TM_G2_THREADS)
bls_g2_add_round_kernel(const uint32_t *__restrict__ p,
                        const uint32_t *__restrict__ q,
                        uint32_t *__restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * TM_G2_THREADS + threadIdx.x;
  if (i >= n) return;
  g2j a, b, r;
  load_point(a, p + i * TM_G2_WORDS);
  load_point(b, q + i * TM_G2_WORDS);
  g2_add_lane(r, a, b);
  store_point(out + i * TM_G2_WORDS, r);
}

extern "C" int tm_bls_g2_add_round(const void *p, const void *q, void *out,
                                   long long n, void *stream) {
  if (n > 0) {
    const long long grid = (n + TM_G2_THREADS - 1) / TM_G2_THREADS;
    bls_g2_add_round_kernel<<<(unsigned)grid, TM_G2_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t *)p, (const uint32_t *)q, (uint32_t *)out, n);
  }
  return (int)cudaGetLastError();
}
