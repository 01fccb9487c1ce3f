// probe_sum_u8 — K11 of tendermint_tpu/crypto/batch.py (device_threshold's
// jitted probe x.astype(int32).sum()) and P4 of tools/device_profile.py
// (touch): the int32 sum of a byte buffer, mod 2^32. crypto/batch.py times
// one round trip through it (upload, launch, read back) to set the
// host/device break-even batch size; the device profiler's cost model
// times it as the fixed cost of a dispatch.
//
// Bound: bytes (one read of the input). A reduction over a grid of blocks
// in one launch: each thread reads 16 bytes a load (uint4, four loads in
// flight) in a grid-stride loop and adds their bytes with __dp4a, a warp
// adds its lanes with shuffles, a block its warps in shared memory. A
// one-block grid writes its sum to the output. A larger grid writes each
// block's sum to a partial, and the block that finishes last (a counter
// of finished blocks) adds the partials, writes the output and sets the
// counter back to 0 for the next launch on the stream. Unsigned adds wrap
// mod 2^32 in any order, so the result is exact and the same every run.
// The grid is one block per 32 KB of input, at most the caller's cap: a
// 32 KB probe is one block, 64 KB and up two or more. The launch is the
// probe's only device work: a probe's time is a dispatch's.

#include <cuda_runtime.h>
#include <stdint.h>

#define TM_PROBE_THREADS 256
#define TM_PROBE_BYTES_PER_BLOCK 32768
#define TM_PROBE_UNROLL 4

__device__ __forceinline__ uint32_t byte_sum4(uint32_t w, uint32_t acc) {
  return __dp4a(w, 0x01010101u, acc);
}

// the sum of acc over the block, on thread 0
__device__ __forceinline__ uint32_t block_sum(uint32_t acc) {
  __shared__ uint32_t part[TM_PROBE_THREADS / 32];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  acc = 0;
  if (warp == 0) {
    acc = lane < TM_PROBE_THREADS / 32 ? part[lane] : 0;
    for (int off = 4; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// ws: the counter of finished blocks (0 between launches), then one
// partial a block. Unused by a one-block grid.
__global__ void __launch_bounds__(TM_PROBE_THREADS)
probe_sum_u8_kernel(const uint8_t *__restrict__ x, long long n,
                    uint32_t *__restrict__ out, uint32_t *ws) {
  __shared__ bool last;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  // bytes before the first 16-byte boundary, then whole uint4s, then the
  // tail
  long long head = (16 - ((uintptr_t)x & 15)) & 15;
  if (head > n) head = n;
  const long long nvec = (n - head) >> 4;
  const uint4 *v = (const uint4 *)(x + head);
  uint32_t acc = 0;
  for (long long k = tid; k < nvec; k += TM_PROBE_UNROLL * nthreads) {
    uint4 w[TM_PROBE_UNROLL];
#pragma unroll
    for (int u = 0; u < TM_PROBE_UNROLL; u++) {
      const long long j = k + u * nthreads;
      w[u] = j < nvec ? __ldg(v + j) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < TM_PROBE_UNROLL; u++) {
      acc = byte_sum4(w[u].x, acc);
      acc = byte_sum4(w[u].y, acc);
      acc = byte_sum4(w[u].z, acc);
      acc = byte_sum4(w[u].w, acc);
    }
  }
  const long long tail = head + (nvec << 4);
  if (tid < head) acc += x[tid];
  if (tid < n - tail) acc += x[tail + tid];
  acc = block_sum(acc);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) *out = acc;
    return;
  }
  uint32_t *counter = ws, *partials = ws + 1;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other block's partial is written and fenced
  acc = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += TM_PROBE_THREADS)
    acc += __ldcg(partials + b);
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    *out = acc;
    *counter = 0;
  }
}

// The number of blocks a launch over n bytes uses, at most cap.
extern "C" int tm_probe_blocks(long long n, int cap) {
  long long b = (n + TM_PROBE_BYTES_PER_BLOCK - 1) / TM_PROBE_BYTES_PER_BLOCK;
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

// out: one int32. ws: cap + 1 words, the first zero before the first
// launch; every launch leaves it zero. Launches on one stream may share
// ws, launches that can overlap may not.
extern "C" int tm_probe_sum_u8(const void *x, long long n, void *out,
                               void *ws, int cap, void *stream) {
  probe_sum_u8_kernel<<<tm_probe_blocks(n, cap), TM_PROBE_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t *)x, n, (uint32_t *)out, (uint32_t *)ws);
  return (int)cudaGetLastError();
}
