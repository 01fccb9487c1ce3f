// The device-profile tool's stub kernels: the verify kernels' wire formats
// in, a verdict per item out, and a chosen amount of device work between.
//
// stub_verify_dense  — P1 and P2 of tendermint_tpu/tools/device_profile.py
//   (install_stub_kernels: _kern / stub_kernel :291-297, stub_stream
//   :299-303; the stream stub is the same per-item function over K chunks,
//   one flat grid here, as K5 and K6 share ed25519_verify_dense). Per item:
//   the uint32 sum of every block word, the 8 s words and nblk. With limb
//   and sum pointers it also tallies, as ed25519_verify_tally does, for the
//   sharded path's stub (the JAX tool swaps sharded._verify_kernel).
// stub_verify_sparse — P3 (stub_sparse :305-317). Per item: the uint32 sum
//   of its diff-column bytes, its R, A and s bytes, and mlen.
//
// Then device_work rounds of the LCG x * 1664525 + 1013904223 (mod 2^32)
// (_burn :278-283) and the verdict parity == 0; the burned word is written
// out too. device_work comes in at run time and stands for a verify's
// cost: every round is one dependent multiply-add on the device.
//
// What bounds them on this card. With device_work at 0, bytes: each input
// read once. With rounds, not the INT32 peak (2 operations a round an
// item, 0.012-0.025 ms at 20,000 rounds) but the chain: each item's rounds
// depend one on the next, so no schedule beats rounds x the latency of one
// dependent IMAD, whatever the occupancy.
//
// The design (stub.cuh). A warp owns 32 consecutive items and reads their
// rows as one span, adjacent lanes on adjacent 16-byte words (4-byte
// words, or bytes, where a slice's base is not so aligned: the diff
// columns of a slice start at any byte), adds each word into its item's
// slot in shared memory, and hands each lane its item's sum. The lane then
// runs its rounds as an unrolled chain of one mad.lo.u32 (one IMAD) a
// round in blocks of STUB_BLOCK, each round an asm volatile statement the
// compiler can neither fold into one multiply-add by a^k nor drop, then the
// rest one by one. The tally adds accepted items' limbs per block in shared
// memory and then with one 64-bit atomicAdd per limb per block.
//
// stub_chain — on no path: one warp's chain of rounds between two clock64
// reads, to measure the cycles of one dependent round on this card. Its
// own chain, not stub_burn: unrolled blocks of STUB_CHAIN_BLOCK rounds, so
// that its loop's branch is under a percent of the time and the floor it
// measures (rounds x one round) does not grow with the stubs' overhead.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stub.cuh"

#define TM_THREADS 128

__global__ void __launch_bounds__(TM_THREADS)
stub_verify_dense_kernel(const uint32_t *__restrict__ blocks,
                         const int32_t *__restrict__ nblk,
                         const uint32_t *__restrict__ s_words,
                         const int32_t *__restrict__ limbs,
                         uint8_t *__restrict__ out,
                         uint32_t *__restrict__ burned,
                         unsigned long long *__restrict__ sums, int n,
                         int nblk_max, int device_work) {
  __shared__ uint32_t acc[TM_THREADS];
  __shared__ unsigned long long part[STUB_LIMBS];
  if (limbs != nullptr && threadIdx.x < STUB_LIMBS) part[threadIdx.x] = 0;
  __syncthreads();
  const int warp0 = threadIdx.x & ~31;
  const int i0 = blockIdx.x * TM_THREADS + warp0;
  const int rows = n - i0 < 32 ? n - i0 : 32;
  if (rows > 0)  // the same for the whole warp
    stub_dense_lane(blocks, nblk, s_words, limbs, out, burned, i0, rows,
                    nblk_max, device_work, acc + warp0, part);
  if (limbs == nullptr) return;
  __syncthreads();
  if (threadIdx.x < STUB_LIMBS && part[threadIdx.x])
    atomicAdd(&sums[threadIdx.x], part[threadIdx.x]);
}

__global__ void __launch_bounds__(TM_THREADS)
stub_verify_sparse_kernel(const uint8_t *__restrict__ dvals, int ncols,
                          const int32_t *__restrict__ mlen,
                          const uint8_t *__restrict__ r,
                          const uint8_t *__restrict__ a,
                          const uint8_t *__restrict__ s,
                          uint8_t *__restrict__ out,
                          uint32_t *__restrict__ burned, int n,
                          int device_work) {
  __shared__ uint32_t acc[TM_THREADS];
  const int warp0 = threadIdx.x & ~31;
  const int i0 = blockIdx.x * TM_THREADS + warp0;
  const int rows = n - i0 < 32 ? n - i0 : 32;
  if (rows > 0)  // the same for the whole warp
    stub_sparse_lane(dvals, ncols, mlen, r, a, s, out, burned, i0, rows,
                     device_work, acc + warp0);
}

#define STUB_CHAIN_BLOCK 256

__global__ void stub_chain_kernel(uint32_t *__restrict__ out,
                                  long long *__restrict__ cycles,
                                  int rounds) {
  uint32_t x = threadIdx.x;
  const long long t0 = clock64();
  int r = rounds;
#pragma unroll 1
  for (; r >= STUB_CHAIN_BLOCK; r -= STUB_CHAIN_BLOCK) {
#pragma unroll
    for (int k = 0; k < STUB_CHAIN_BLOCK; k++) stub_round(x);
  }
#pragma unroll 1
  for (; r > 0; r--) stub_round(x);
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  cycles[threadIdx.x] = t1 - t0;
}

static int tm_grid(int n) { return (n + TM_THREADS - 1) / TM_THREADS; }

extern "C" int tm_stub_verify_dense(const void *blocks, const void *nblk,
                                    const void *s_words, const void *limbs,
                                    void *out, void *burned, void *sums,
                                    int n, int nblk_max, int device_work,
                                    void *stream) {
  if (n > 0) {
    stub_verify_dense_kernel<<<tm_grid(n), TM_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t *)blocks, (const int32_t *)nblk,
        (const uint32_t *)s_words, (const int32_t *)limbs, (uint8_t *)out,
        (uint32_t *)burned, (unsigned long long *)sums, n, nblk_max,
        device_work);
  }
  return (int)cudaGetLastError();
}

extern "C" int tm_stub_verify_sparse(const void *dvals, int ncols,
                                     const void *mlen, const void *r,
                                     const void *a, const void *s, void *out,
                                     void *burned, int n, int device_work,
                                     void *stream) {
  if (n > 0) {
    stub_verify_sparse_kernel<<<tm_grid(n), TM_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const uint8_t *)dvals, ncols, (const int32_t *)mlen,
        (const uint8_t *)r, (const uint8_t *)a, (const uint8_t *)s,
        (uint8_t *)out, (uint32_t *)burned, n, device_work);
  }
  return (int)cudaGetLastError();
}

// out: 32 burned words (lane l starts from l); cycles: 32 int64
extern "C" int tm_stub_chain(void *out, void *cycles, int rounds,
                             void *stream) {
  stub_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (long long *)cycles, rounds);
  return (int)cudaGetLastError();
}
