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
// and the verdict parity == 0. Both constants are odd, so each round flips
// the parity and the verdict alone would let the compiler fold the loop to
// parity ^ (rounds & 1): the burned word is written out as well, and the
// loop is kept rolled, so every round is one dependent multiply-add on the
// device. device_work comes in at run time.
//
// Bound: bytes at device_work 0 (each input read once); operations (2 a
// round a thread) as device_work grows. Simple and right first: one thread
// per item, its row read word by word.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

#define TM_THREADS 128
#define TM_LIMBS 8

__device__ __forceinline__ uint32_t stub_burn(uint32_t x, int rounds) {
  // not unrolled: an unrolled body of k rounds folds into one
  // multiply-add with constants a^k and c(a^(k-1) + ... + 1), which would
  // cut the device work k-fold
#pragma unroll 1
  for (int r = 0; r < rounds; r++) x = x * 1664525u + 1013904223u;
  return x;
}

__global__ void __launch_bounds__(TM_THREADS)
stub_verify_dense_kernel(const uint32_t *__restrict__ blocks,
                         const int32_t *__restrict__ nblk,
                         const uint32_t *__restrict__ s_words,
                         const int32_t *__restrict__ limbs,
                         uint8_t *__restrict__ out,
                         uint32_t *__restrict__ burned,
                         unsigned long long *__restrict__ sums, int n,
                         int nblk_max, int device_work) {
  __shared__ unsigned long long part[TM_LIMBS];
  if (limbs != nullptr && threadIdx.x < TM_LIMBS) part[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const uint32_t *row = blocks + (size_t)i * nblk_max * 32;
    uint32_t x = 0;
    for (int w = 0; w < nblk_max * 32; w++) x += row[w];
    for (int t = 0; t < 8; t++) x += s_words[(size_t)i * 8 + t];
    x += (uint32_t)nblk[i];
    x = stub_burn(x, device_work);
    const bool ok = (x & 1u) == 0;
    out[i] = ok ? 1 : 0;
    burned[i] = x;
    if (limbs != nullptr && ok) {
      for (int j = 0; j < TM_LIMBS; j++) {
        const int32_t v = limbs[(size_t)i * TM_LIMBS + j];
        if (v) atomicAdd(&part[j], (unsigned long long)(uint32_t)v);
      }
    }
  }
  if (limbs == nullptr) return;
  __syncthreads();
  if (threadIdx.x < TM_LIMBS && part[threadIdx.x])
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x = 0;
  for (int c = 0; c < ncols; c++) x += dvals[(size_t)i * ncols + c];
  for (int b = 0; b < 32; b++)
    x += (uint32_t)r[(size_t)i * 32 + b] + a[(size_t)i * 32 + b]
         + s[(size_t)i * 32 + b];
  x += (uint32_t)mlen[i];
  x = stub_burn(x, device_work);
  out[i] = (x & 1u) == 0 ? 1 : 0;
  burned[i] = x;
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
