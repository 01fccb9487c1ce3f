// sha256_many — K9 of tendermint_tpu/crypto/merkle_fast.py (_device_fn,
// the jitted _sha256_words behind sha256_many_device): SHA-256 of n
// messages of one length, one thread per message, 256 threads a block.
//
// Input: the n messages back to back, (n, len) bytes, as the host joins
// them (one copy up); each thread builds its own padded big-endian
// schedule in registers, so no packed word array crosses the bus and any
// length works (nblk = (len + 8) / 64 + 1 blocks). Output: (n, 32) bytes,
// the big-endian digests, in the order of the input.
//
// Bound: operations. One compression is at least 1,384 32-bit integer
// instructions (64 rounds of 14, 48 schedule words of 10, with three-input
// LOP3/IADD3 and funnel-shift rotates) against 64 bytes of input, far
// above the card's ~5 integer operations per byte of memory traffic
// (INT32 rate / HBM rate). The rounds keep the 8 working words and
// a rolling 16-word schedule in registers; the round constants sit in
// constant memory (every thread of a warp reads the same one); rotates are
// single funnel shifts.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include "sha256.cuh"

#define TM_SHA_THREADS 256

__global__ void __launch_bounds__(TM_SHA_THREADS)
sha256_many_kernel(const uint8_t *__restrict__ msgs, long long n, int len,
                   uint8_t *__restrict__ out) {
  const long long i = (long long)blockIdx.x * TM_SHA_THREADS + threadIdx.x;
  if (i >= n) return;
  sha256_one(msgs + (size_t)i * len, len, out + (size_t)i * 32);
}

extern "C" int tm_sha256_many(const void *msgs, long long n, int len,
                              void *out, void *stream) {
  if (n > 0) {
    const long long grid = (n + TM_SHA_THREADS - 1) / TM_SHA_THREADS;
    sha256_many_kernel<<<(unsigned)grid, TM_SHA_THREADS, 0,
                         (cudaStream_t)stream>>>((const uint8_t *)msgs, n,
                                                 len, (uint8_t *)out);
  }
  return (int)cudaGetLastError();
}
