// Ed25519 batch-verify kernels for Hopper (sm_90a), one thread per
// signature, with a plain C interface loaded through ctypes.
//
// ed25519_verify_dense  — K5/K6 of tendermint_tpu/crypto/ed25519_jax/
//   verify.py (_verify_kernel, _verify_stream_kernel). K6's lax.scan over
//   chunks becomes one flat grid over every item.
// ed25519_verify_sparse — K7 (_verify_sparse_stream_kernel with
//   _assemble_blocks): each thread assembles its own preimage from its
//   chunk's template and the sparse diff columns, then verifies it.
//
// Bound: operations. A verify is about 3,750 field multiplies (each 100
// 32x32->64 multiply-adds plus carries) against ~300 bytes of input, so
// the integer pipes, not memory, set the floor. This first version spends
// nothing on that yet: one thread per item, the [0..15]P window table in
// local memory, squarings done as multiplies. With one thread per item a
// launch lasts as long as one thread's whole verify until the card is
// full, and a 10,240-signature commit is far from filling it: at commit
// sizes the kernel is bound by the latency of one verify, not by the
// card's operation rate. The verdict is 1 byte.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include "verify.cuh"

#define TM_THREADS 128

__global__ void __launch_bounds__(TM_THREADS)
ed25519_verify_dense_kernel(const uint32_t *__restrict__ blocks,
                            const int32_t *__restrict__ nblk,
                            const uint32_t *__restrict__ s_words,
                            const uint32_t *__restrict__ base_table,
                            uint8_t *__restrict__ out, int n, int nblk_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t *words = blocks + (size_t)i * nblk_max * 32;
  // an item hashes at most the blocks its row holds (as the plain version)
  const int nb = min(max(nblk[i], 0), nblk_max);
  out[i] = verify_dense_item(words, nb, s_words + (size_t)i * 8,
                             base_table) ? 1 : 0;
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t *tpl = templates + (size_t)(i / chunk) * mlen_max;
  out[i] = verify_sparse_item(tpl, mlen_max, cols, ncols,
                              dvals + (size_t)i * ncols, mlen[i],
                              r + (size_t)i * 32, a + (size_t)i * 32,
                              s + (size_t)i * 32, base_table) ? 1 : 0;
}

static int tm_grid(int n) { return (n + TM_THREADS - 1) / TM_THREADS; }

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
