// K10 of tendermint_tpu/crypto/bls12381/vec.py on Hopper (sm_90a): the G2
// additions that build an aggregate pubkey.
//
// bls_g2_add_round — _g2_add_round :285 (which jits g2_add_vec :227 over
// mont_mul :141 under CFG_JAX :79): one pairwise round, out[i] = P[i] +
// Q[i] for i < n.
// bls_g2_tree_sum — the whole tree of vec.py's aggregate_pubkeys_vec (one
// _g2_add_round a level, from Python) in one launch: (n, 3, 2, 12) lanes,
// n a power of 2, -> their sum, with the JAX tree's order (at every level
// lane i adds lane i + half), so the root's Jacobian X, Y and Z equal the
// level-by-level tree's, not only its affine value.
// bls_fq_mul — Montgomery products of (n, 12) limb pairs, each repeated
// reps times on its own result: the card's check of fq_mul against the
// plain version, and its latency (one thread, many reps).
//
// Layout: item-major (n, 3, 2, 12) uint32 — per lane the Jacobian X, Y, Z,
// each an Fq2 (c0, c1), each 12 little-endian 32-bit limbs of a canonical
// Montgomery residue (R = 2^384): 72 words, 288 bytes a lane.
//
// Bound. An addition of two finite points is 44 Fq products of 300 32 x 32
// multiply-adds (a lane with a point at infinity does none): operations,
// at any size. But a tree of 2^k lanes is k levels of dependent additions,
// so its floor is the critical path, k additions of five product levels,
// not the card's rate. The design shortens that path: a group of 16
// threads runs one addition, one Fq product a thread at each of the five
// levels (g2.cuh), and the product is an unrolled carry-chain CIOS in
// registers (fq.cuh). The tree is one launch: block g of G blocks takes
// the leaves congruent to g mod G, a class that the pairing i + half keeps
// closed for the first log2(n / G) levels, and sums it in shared memory
// with the block's barrier between levels; the block that finishes last (a
// fence and a ticket, as probe.cu) sums the G partials in the same order.
// G and the lanes a block holds are both about sqrt(n), so no level takes
// more than one pass of the block's groups up to 1,024 lanes. The tree
// takes at most 2^14 lanes, the padded width of a commit's most signers
// (types/vote.py MAX_VOTES_COUNT, 10,000).
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include "g2.cuh"

#define TM_G2_ROUND_THREADS 128
#define TM_G2_TREE_MAX_THREADS 256
// at most this many lanes a tree
#define TM_G2_TREE_MAX_LANES (1 << 14)
// the workspace: the finished-block counter, then (16-byte aligned) one
// partial lane a block
#define TM_G2_WS_HEAD 4

__global__ void __launch_bounds__(TM_G2_ROUND_THREADS)
bls_g2_add_round_kernel(const uint32_t *__restrict__ p,
                        const uint32_t *__restrict__ q,
                        uint32_t *__restrict__ out, long long n) {
  constexpr int NG = TM_G2_ROUND_THREADS / G2_GROUP;
  __shared__ __align__(16) uint32_t scr[NG][G2_SCR_WORDS];
  const int grp = threadIdx.x / G2_GROUP, lane = threadIdx.x % G2_GROUP;
  const long long i = (long long)blockIdx.x * NG + grp;
  if (i >= n) return;  // the whole group
  g2_add_group(out + i * G2_WORDS, p + i * G2_WORDS, q + i * G2_WORDS,
               scr[grp], lane);
}

// copy a lane, 18 uint4 words, with the block's threads
__device__ __forceinline__ void copy_lanes(uint32_t *dst, const uint32_t *src,
                                           int lanes, bool from_l2) {
  const int words4 = lanes * (G2_WORDS / 4);
  uint4 *d = (uint4 *)dst;
  const uint4 *s = (const uint4 *)src;
  for (int w = threadIdx.x; w < words4; w += blockDim.x)
    d[w] = from_l2 ? __ldcg(s + w) : s[w];
}

__global__ void __launch_bounds__(TM_G2_TREE_MAX_THREADS)
bls_g2_tree_sum_kernel(const uint32_t *__restrict__ in,
                       uint32_t *__restrict__ out, uint32_t *ws, int n) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ bool last;
  const int G = gridDim.x, L = n / G, g = blockIdx.x;
  uint32_t *lanes = smem;
  const int grp = threadIdx.x / G2_GROUP, lane = threadIdx.x % G2_GROUP;
  const int ngroups = blockDim.x / G2_GROUP;
  uint32_t *scr = smem + (L > G ? L : G) * G2_WORDS + grp * G2_SCR_WORDS;
  g2_tree_gather(lanes, in, n, G, g, threadIdx.x, blockDim.x);
  __syncthreads();
  g2_tree_levels(lanes, L, scr, grp, ngroups, lane);
  if (G == 1) {
    copy_lanes(out, lanes, 1, false);
    return;
  }
  uint32_t *counter = ws, *partials = ws + TM_G2_WS_HEAD;
  copy_lanes(partials + g * G2_WORDS, lanes, 1, false);
  __threadfence();  // the partial is visible before the count says so
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)G - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written and fenced; lane g of width
  // G, summed in the same order
  copy_lanes(lanes, partials, G, true);
  __syncthreads();
  g2_tree_levels(lanes, G, scr, grp, ngroups, lane);
  copy_lanes(out, lanes, 1, false);
  if (threadIdx.x == 0) *counter = 0;
}

__global__ void bls_fq_mul_kernel(const uint32_t *__restrict__ a,
                                  const uint32_t *__restrict__ b,
                                  uint32_t *__restrict__ out, int n,
                                  int reps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fq x, y;
  TM_UNROLL
  for (int k = 0; k < FQ_LIMBS; k++) {
    x.v[k] = a[i * FQ_LIMBS + k];
    y.v[k] = b[i * FQ_LIMBS + k];
  }
#pragma unroll 1
  for (int r = 0; r < reps; r++) fq_mul(x, x, y);
  TM_UNROLL
  for (int k = 0; k < FQ_LIMBS; k++) out[i * FQ_LIMBS + k] = x.v[k];
}

// blocks of the tree over n lanes, G = 2^floor(k / 2) for n = 2^k; a block
// holds L = n / G lanes
static int tree_blocks(long long n) {
  int G = 1;
  while ((long long)G * G * 4 <= n) G *= 2;
  return G;
}

extern "C" int tm_bls_g2_add_round(const void *p, const void *q, void *out,
                                   long long n, void *stream) {
  if (n > 0) {
    const int ng = TM_G2_ROUND_THREADS / G2_GROUP;
    const long long grid = (n + ng - 1) / ng;
    bls_g2_add_round_kernel<<<(unsigned)grid, TM_G2_ROUND_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t *)p, (const uint32_t *)q, (uint32_t *)out, n);
  }
  return (int)cudaGetLastError();
}

// in: (n, 3, 2, 12), n a power of 2 up to TM_G2_TREE_MAX_LANES; out: one
// lane. ws: TM_G2_WS_HEAD + tree_blocks(n) * 72 words, the first zero
// before the first launch; every launch leaves it zero. Launches on one
// stream may share ws, launches that can overlap may not.
extern "C" int tm_bls_g2_tree_sum(const void *in, void *out, void *ws,
                                  long long n, void *stream) {
  if (n < 1 || (n & (n - 1)) || n > TM_G2_TREE_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  const int G = tree_blocks(n), L = (int)n / G;
  const int cap = L > G ? L : G;
  int threads = (cap / 2) * G2_GROUP;
  if (threads < G2_GROUP) threads = G2_GROUP;
  if (threads > TM_G2_TREE_MAX_THREADS) threads = TM_G2_TREE_MAX_THREADS;
  const int smem = (cap * G2_WORDS + (threads / G2_GROUP) * G2_SCR_WORDS) *
                   (int)sizeof(uint32_t);
  // from 2^13 lanes a block holds 128 lanes and 16 groups' scratch, 60,672
  // bytes, over the 48 KB a launch gets without asking: ask each time, on
  // the current device
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bls_g2_tree_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  bls_g2_tree_sum_kernel<<<G, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t *)in, (uint32_t *)out, (uint32_t *)ws, (int)n);
  return (int)cudaGetLastError();
}

extern "C" int tm_bls_fq_mul(const void *a, const void *b, void *out, int n,
                             int reps, void *stream) {
  if (n > 0)
    bls_fq_mul_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)a, (const uint32_t *)b, (uint32_t *)out, n, reps);
  return (int)cudaGetLastError();
}
