// Ed25519 batch-verify kernels for Hopper (sm_90a), four lanes per
// signature, with a plain C interface loaded through ctypes.
//
// ed25519_verify_dense  — K5/K6 of tendermint_tpu/crypto/ed25519_jax/
//   verify.py (_verify_kernel, _verify_stream_kernel). K6's lax.scan over
//   chunks becomes one flat grid over every item.
// ed25519_verify_sparse — K7 (_verify_sparse_stream_kernel with
//   _assemble_blocks): each group assembles its own preimage from its
//   chunk's template and the sparse diff columns, then verifies it.
//
// Bound: operations. A verify is about 3,750 field multiplies (most of
// 100 32x32->64 multiply-adds, squarings 55) against ~300 bytes of input,
// so the integer pipes, not memory, set the floor. At commit sizes (150 to
// 10,240 signatures) the card is far from that floor: a launch lasts about
// as long as one signature's chain of dependent multiplies, since there
// are too few warps to hide it. So the design shortens that chain: a group
// of four lanes verifies one signature (verify4.cuh, on the parallel
// formulas of lanes.cuh), 8 signatures a warp, and a block of 64 threads
// (16 signatures, two warps) spreads a 150-signature commit over 10 SMs
// with at most one warp on each scheduler. The window table lives in
// shared memory, 47,104 bytes a block. The verdict is 1 byte.
//
// A group past the last item verifies the last item again and stores
// nothing, so every lane of a warp reaches every exchange.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include "verify4.cuh"

#define TM_THREADS 64
#define TM_ITEMS (TM_THREADS / 4)

__global__ void __launch_bounds__(TM_THREADS)
ed25519_verify_dense_kernel(const uint32_t *__restrict__ blocks,
                            const int32_t *__restrict__ nblk,
                            const uint32_t *__restrict__ s_words,
                            const uint32_t *__restrict__ base_table,
                            uint8_t *__restrict__ out, int n, int nblk_max) {
  __shared__ uint32_t scratch[TM_V4_ROWS * TM_THREADS];
  const int item = blockIdx.x * TM_ITEMS + (threadIdx.x >> 2);
  const int i = item < n ? item : n - 1;
  // an item hashes at most the blocks its row holds (as the plain version)
  const int nb = min(max(nblk[i], 0), nblk_max);
  const bool ok = verify4_dense_item(
      blocks + (size_t)i * nblk_max * 32, nb, s_words + (size_t)i * 8,
      base_table, scratch + threadIdx.x, TM_THREADS);
  if (item < n && (threadIdx.x & 3) == 0) out[item] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(TM_THREADS)
ed25519_verify_sparse_kernel(const uint8_t *__restrict__ templates,
                             int mlen_max,
                             const int32_t *__restrict__ cols, int ncols,
                             const uint8_t *__restrict__ dvals,
                             const int32_t *__restrict__ mlen,
                             const uint8_t *__restrict__ r,
                             const uint8_t *__restrict__ a,
                             const uint8_t *__restrict__ s, int chunk,
                             const uint32_t *__restrict__ base_table,
                             uint8_t *__restrict__ out, int n) {
  __shared__ uint32_t scratch[TM_V4_ROWS * TM_THREADS];
  const int item = blockIdx.x * TM_ITEMS + (threadIdx.x >> 2);
  const int i = item < n ? item : n - 1;
  const bool ok = verify4_sparse_item(
      templates + (size_t)(i / chunk) * mlen_max, mlen_max, cols, ncols,
      dvals + (size_t)i * ncols, mlen[i], r + (size_t)i * 32,
      a + (size_t)i * 32, s + (size_t)i * 32, base_table,
      scratch + threadIdx.x, TM_THREADS);
  if (item < n && (threadIdx.x & 3) == 0) out[item] = ok ? 1 : 0;
}

static int tm_grid(int n) { return (n + TM_ITEMS - 1) / TM_ITEMS; }

extern "C" int tm_ed25519_verify_dense(const void *blocks, const void *nblk,
                                       const void *s_words,
                                       const void *base_table, void *out,
                                       int n, int nblk_max, void *stream) {
  if (n > 0) {
    ed25519_verify_dense_kernel<<<tm_grid(n), TM_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const uint32_t *)blocks, (const int32_t *)nblk,
        (const uint32_t *)s_words, (const uint32_t *)base_table,
        (uint8_t *)out, n, nblk_max);
  }
  return (int)cudaGetLastError();
}

extern "C" int tm_ed25519_verify_sparse(
    const void *templates, int mlen_max, const void *cols, int ncols,
    const void *dvals, const void *mlen, const void *r, const void *a,
    const void *s, int chunk, const void *base_table, void *out, int n,
    void *stream) {
  if (n > 0) {
    ed25519_verify_sparse_kernel<<<tm_grid(n), TM_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const uint8_t *)templates, mlen_max, (const int32_t *)cols, ncols,
        (const uint8_t *)dvals, (const int32_t *)mlen, (const uint8_t *)r,
        (const uint8_t *)a, (const uint8_t *)s, chunk,
        (const uint32_t *)base_table, (uint8_t *)out, n);
  }
  return (int)cudaGetLastError();
}
