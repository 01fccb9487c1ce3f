// probe_sum_u8 — K11 of tendermint_tpu/crypto/batch.py (device_threshold's
// jitted probe x.astype(int32).sum()): the int32 sum of a byte buffer.
// crypto/batch.py times one round trip through it (upload, launch, read
// back) to set the host/device break-even batch size.
//
// Bound: bytes (one read of the input); at the probe's 32 KB the launch
// itself dominates. One block of 256 threads, a strided per-thread sum and
// a shared-memory tree: no atomics, so the output needs no zeroing.

#include <cuda_runtime.h>
#include <stdint.h>

#define TM_PROBE_THREADS 256

__global__ void __launch_bounds__(TM_PROBE_THREADS)
probe_sum_u8_kernel(const uint8_t *__restrict__ x, long long n,
                    int32_t *__restrict__ out) {
  __shared__ int32_t part[TM_PROBE_THREADS];
  int32_t acc = 0;
  for (long long i = threadIdx.x; i < n; i += TM_PROBE_THREADS) acc += x[i];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = TM_PROBE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = part[0];
}

extern "C" int tm_probe_sum_u8(const void *x, long long n, void *out,
                               void *stream) {
  probe_sum_u8_kernel<<<1, TM_PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)x, n, (int32_t *)out);
  return (int)cudaGetLastError();
}
