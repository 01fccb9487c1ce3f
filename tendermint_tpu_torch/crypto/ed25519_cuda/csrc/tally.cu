// ed25519_verify_tally — K8 of tendermint_tpu/crypto/ed25519_jax/sharded.py
// (full_step :78, built by _sharded_step :66): the dense verify of K5 on one
// shard plus the exact voting-power tally over the signatures it accepts.
//
// Each item carries its power as eight 8-bit limbs (sharded._power_limbs:
// int64 -> uint64 -> limbs, host-invalid rows already zeroed). One thread
// verifies one signature, as ed25519_verify_dense does; the block then sums
// the limbs of its accepted items in shared memory, and one thread per limb
// adds the block's sum into the shard's (8,) int64 accumulator with one
// 64-bit atomicAdd. The wrapper zeroes the accumulator on the same stream
// before the launch. The host recombines sum_j limb_sum_j * 2^(8j) in
// Python ints, so the total is exact for any int64 powers; the JAX package
// psums int32 limb planes, which bounds a batch to 2^22 signatures
// (sharded.MAX_EXACT_SIGS), and the port keeps that bound.
//
// Bound: operations, as for the dense verify (about 3,750 field multiplies
// a signature against ~330 bytes of input); the tally adds 8 limbs a
// signature and 8 atomics a block. The verdict is 1 byte.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include "verify.cuh"

#define TM_THREADS 128
#define TM_LIMBS 8

__global__ void __launch_bounds__(TM_THREADS)
ed25519_verify_tally_kernel(const uint32_t *__restrict__ blocks,
                            const int32_t *__restrict__ nblk,
                            const uint32_t *__restrict__ s_words,
                            const int32_t *__restrict__ limbs,
                            const uint32_t *__restrict__ base_table,
                            uint8_t *__restrict__ out,
                            unsigned long long *__restrict__ sums, int n,
                            int nblk_max) {
  __shared__ unsigned long long part[TM_LIMBS];
  if (threadIdx.x < TM_LIMBS) part[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const uint32_t *words = blocks + (size_t)i * nblk_max * 32;
    const int nb = min(max(nblk[i], 0), nblk_max);
    const bool ok = verify_dense_item(words, nb, s_words + (size_t)i * 8,
                                      base_table);
    out[i] = ok ? 1 : 0;
    if (ok) {
      const int32_t *own = limbs + (size_t)i * TM_LIMBS;
      for (int j = 0; j < TM_LIMBS; j++) {
        const int32_t v = own[j];
        if (v) atomicAdd(&part[j], (unsigned long long)(uint32_t)v);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < TM_LIMBS && part[threadIdx.x])
    atomicAdd(&sums[threadIdx.x], part[threadIdx.x]);
}

extern "C" int tm_ed25519_verify_tally(const void *blocks, const void *nblk,
                                       const void *s_words,
                                       const void *limbs,
                                       const void *base_table, void *out,
                                       void *sums, int n, int nblk_max,
                                       void *stream) {
  if (n > 0) {
    ed25519_verify_tally_kernel<<<(n + TM_THREADS - 1) / TM_THREADS,
                                  TM_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)blocks, (const int32_t *)nblk,
        (const uint32_t *)s_words, (const int32_t *)limbs,
        (const uint32_t *)base_table, (uint8_t *)out,
        (unsigned long long *)sums, n, nblk_max);
  }
  return (int)cudaGetLastError();
}
