// ed25519_verify_tally — K8 of tendermint_tpu/crypto/ed25519_jax/sharded.py
// (full_step :78, built by _sharded_step :66): the dense verify of K5 on one
// shard plus the exact voting-power tally over the signatures it accepts.
//
// Bound: operations, as for the dense verify (about 3,750 field multiplies
// a signature against ~330 bytes of input); the tally adds 8 limbs a
// signature and 8 atomics a block. The verify is K5's core on the
// four-lane group operations (verify4_dense_item: a group of four lanes a
// signature, 16 signatures a block of 64 threads). A design that gave each
// lane of a group the serial parts of its own signature (four signatures a
// group) issued about a fifth fewer instructions a signature but read
// slower at K8's widths, and was dropped (PERF.md, Findings).
//
// The tally: each item carries its power as eight 8-bit limbs
// (sharded._power_limbs: int64 -> uint64 -> limbs, host-invalid rows already
// zeroed). Lane 0 of each group takes the limbs of its accepted item, a
// warp adds them with shuffles, the block its warps in shared memory, and
// one thread per limb adds the block's sum into the shard's (8,) int64
// accumulator with one 64-bit atomicAdd. The wrapper zeroes the
// accumulator on the same stream before the launch. The host recombines
// sum_j limb_sum_j * 2^(8j) in Python ints, so the total is exact for any
// int64 powers; the JAX package psums int32 limb planes, which bounds a
// batch to 2^22 signatures (sharded.MAX_EXACT_SIGS), and the port keeps
// that bound.
//
// An item past n verifies the last item again and stores nothing, so every
// lane of a warp reaches every exchange.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include "verify4.cuh"

#define TM_LIMBS 8
#define TM_THREADS 64  // 16 signatures a block

// the limbs of each thread's accepted item (take) into sums, once a block
__device__ __forceinline__ void tally_block(const int32_t *__restrict__ own,
                                            bool take,
                                            unsigned long long *sums) {
  __shared__ unsigned long long part[TM_LIMBS];
  if (threadIdx.x < TM_LIMBS) part[threadIdx.x] = 0;
  uint32_t v[TM_LIMBS];
#pragma unroll
  for (int j = 0; j < TM_LIMBS; j++) v[j] = take ? (uint32_t)own[j] : 0u;
#pragma unroll
  for (int j = 0; j < TM_LIMBS; j++)
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_down_sync(0xffffffffu, v[j], off);  // < 32 * 2^8
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < TM_LIMBS; j++)
      if (v[j]) atomicAdd(&part[j], (unsigned long long)v[j]);
  }
  __syncthreads();
  if (threadIdx.x < TM_LIMBS && part[threadIdx.x])
    atomicAdd(&sums[threadIdx.x], part[threadIdx.x]);
}

__global__ void __launch_bounds__(TM_THREADS)
ed25519_verify_tally_kernel(const uint32_t *__restrict__ blocks,
                            const int32_t *__restrict__ nblk,
                            const uint32_t *__restrict__ s_words,
                            const int32_t *__restrict__ limbs,
                            const uint32_t *__restrict__ base_table,
                            uint8_t *__restrict__ out,
                            unsigned long long *__restrict__ sums, int n,
                            int nblk_max) {
  __shared__ uint32_t scratch[TM_V4_ROWS * TM_THREADS];
  const int item = blockIdx.x * (TM_THREADS / 4) + (threadIdx.x >> 2);
  const int i = item < n ? item : n - 1;
  const int nb = min(max(nblk[i], 0), nblk_max);
  const bool ok = verify4_dense_item(
      blocks + (size_t)i * nblk_max * 32, nb, s_words + (size_t)i * 8,
      base_table, scratch + threadIdx.x, TM_THREADS);
  const bool first = (threadIdx.x & 3) == 0;
  if (item < n && first) out[item] = ok ? 1 : 0;
  tally_block(limbs + (size_t)i * TM_LIMBS, ok && item < n && first, sums);
}

extern "C" int tm_ed25519_verify_tally(const void *blocks, const void *nblk,
                                       const void *s_words,
                                       const void *limbs,
                                       const void *base_table, void *out,
                                       void *sums, int n, int nblk_max,
                                       void *stream) {
  if (n > 0) {
    const int per = TM_THREADS / 4;
    ed25519_verify_tally_kernel<<<(n + per - 1) / per, TM_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const uint32_t *)blocks, (const int32_t *)nblk,
        (const uint32_t *)s_words, (const int32_t *)limbs,
        (const uint32_t *)base_table, (uint8_t *)out,
        (unsigned long long *)sums, n, nblk_max);
  }
  return (int)cudaGetLastError();
}
