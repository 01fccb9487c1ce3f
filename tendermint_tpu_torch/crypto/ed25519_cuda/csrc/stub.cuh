// A warp's work in the device-profile stub kernels (stub.cu): the
// coalesced reads of its 32 items' rows and the chain of LCG rounds.
//
// A warp owns 32 consecutive items, lane l the item i0 + l. The warp reads
// the span of their rows in order, adjacent lanes on adjacent 16-byte (or
// 4-byte) words, and adds each word's sum into the owning item's slot of
// a 32-word accumulator in shared memory. An item's value is the uint32
// sum of its words (or bytes) mod 2^32, so the order of the adds does not
// matter. Then each lane runs its item's rounds.
//
// Plain C++ as well: without __CUDACC__ a lane's code compiles for the
// host, where a g++ harness runs a warp's 32 lanes as 32 threads and
// defines the tm_host_warp_* functions (tests/test_torch_stub_host.py).
#pragma once

#include <stddef.h>
#include <stdint.h>

// rounds unrolled into one block of a stub's chain: the loop's counter,
// compare and branch come once a block of 64 dependent IMADs
#define STUB_BLOCK 64
#define STUB_LIMBS 8

#ifdef __CUDACC__
#define STUB_DEV __device__ __forceinline__
#define STUB_UNROLL _Pragma("unroll")
#define STUB_ROLLED _Pragma("unroll 1")
#define STUB_LDG(p) __ldg(p)

STUB_DEV int stub_lane() { return threadIdx.x & 31; }
STUB_DEV void stub_warp_sync() { __syncwarp(); }
STUB_DEV uint32_t stub_xor(uint32_t v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
STUB_DEV unsigned long long stub_xor64(unsigned long long v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
STUB_DEV int stub_from(int v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
STUB_DEV void stub_add(uint32_t *p, uint32_t v) { atomicAdd(p, v); }
STUB_DEV void stub_add64(unsigned long long *p, unsigned long long v) {
  atomicAdd(p, v);
}
STUB_DEV uint32_t stub_bytes(uint32_t w, uint32_t acc) {
  return __dp4a(w, 0x01010101u, acc);
}
// One round, x = 1664525 x + 1013904223 mod 2^32: one mad.lo.u32, an IMAD
// on the card. A volatile asm statement is neither merged with its
// neighbours nor removed, so a block of k rounds stays k dependent
// multiply-adds and is not folded into one by a^k.
STUB_DEV void stub_round(uint32_t &x) {
  asm volatile("mad.lo.u32 %0, %0, 1664525, 1013904223;" : "+r"(x));
}
#else
#define STUB_DEV static inline
#define STUB_UNROLL
#define STUB_ROLLED
#define STUB_LDG(p) (*(p))

int tm_host_warp_lane();
void tm_host_warp_sync();
uint32_t tm_host_warp_from(uint32_t v, int src);
unsigned long long tm_host_warp_from64(unsigned long long v, int src);

STUB_DEV int stub_lane() { return tm_host_warp_lane(); }
STUB_DEV void stub_warp_sync() { tm_host_warp_sync(); }
STUB_DEV uint32_t stub_xor(uint32_t v, int m) {
  return tm_host_warp_from(v, stub_lane() ^ m);
}
STUB_DEV unsigned long long stub_xor64(unsigned long long v, int m) {
  return tm_host_warp_from64(v, stub_lane() ^ m);
}
STUB_DEV int stub_from(int v, int src) {
  return (int)tm_host_warp_from((uint32_t)v, src);
}
STUB_DEV void stub_add(uint32_t *p, uint32_t v) {
  __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
STUB_DEV void stub_add64(unsigned long long *p, unsigned long long v) {
  __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
STUB_DEV uint32_t stub_bytes(uint32_t w, uint32_t acc) {
  return acc + (w & 0xff) + (w >> 8 & 0xff) + (w >> 16 & 0xff) + (w >> 24);
}
STUB_DEV void stub_round(uint32_t &x) { x = x * 1664525u + 1013904223u; }
#endif

// rounds LCG rounds: whole blocks of STUB_BLOCK, then the rest one by one
STUB_DEV uint32_t stub_burn(uint32_t x, int rounds) {
  int r = rounds;
  STUB_ROLLED
  for (; r >= STUB_BLOCK; r -= STUB_BLOCK) {
    STUB_UNROLL
    for (int k = 0; k < STUB_BLOCK; k++) stub_round(x);
  }
  STUB_ROLLED
  for (; r > 0; r--) stub_round(x);
  return x;
}

// The four words at p; vec: p is 16-byte aligned.
#ifdef __CUDACC__
typedef uint4 stub_u4;
STUB_DEV stub_u4 stub_load4(const uint32_t *p, bool vec) {
  if (vec) return STUB_LDG((const uint4 *)p);
  return make_uint4(STUB_LDG(p), STUB_LDG(p + 1), STUB_LDG(p + 2),
                    STUB_LDG(p + 3));
}
#else
struct stub_u4 {
  uint32_t x, y, z, w;
};
STUB_DEV stub_u4 stub_load4(const uint32_t *p, bool) {
  return {p[0], p[1], p[2], p[3]};
}
#endif

STUB_DEV uint32_t stub_sum4(stub_u4 u) { return u.x + u.y + u.z + u.w; }

// 16 if p is 16-byte aligned, 4 if 4-byte aligned, else 1
STUB_DEV int stub_align(const void *p) {
  const uintptr_t a = (uintptr_t)p;
  return (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
}

// acc plus the sum of the 16 bytes at p, read as one 16-byte word, four
// 4-byte words or 16 bytes as p's alignment allows
STUB_DEV uint32_t stub_bytes16(const uint8_t *p, int align, uint32_t acc) {
#ifdef __CUDACC__
  if (align == 16) {
    const uint4 u = STUB_LDG((const uint4 *)p);
    return stub_bytes(u.w, stub_bytes(u.z, stub_bytes(u.y,
                                                      stub_bytes(u.x, acc))));
  }
#endif
  if (align >= 4) {
    const uint32_t *w = (const uint32_t *)p;
    STUB_UNROLL
    for (int k = 0; k < 4; k++) acc = stub_bytes(w[k], acc);
    return acc;
  }
  STUB_UNROLL
  for (int k = 0; k < 16; k++) acc += p[k];
  return acc;
}

// Dense rows (P1/P2): the block words and s words of the warp's items
// [i0, i0 + rows), rows >= 1, into acc (the warp's 32 shared words); the
// lane's own value, 0 for a lane past rows. A row is nblk_max blocks of
// 128 bytes, and 8 lanes read one block with 16-byte loads: an aligned
// group of 8 lanes always reads one item, adds its four words, and
// reduces over the group with shuffles before one lane adds the group's
// sum into acc. The s words (32 bytes a row: a pair of lanes an item) and
// up to STUB_BATCH block words a lane are loaded before the first is
// used, so rows of up to two blocks cost one trip to memory.
#define STUB_BATCH 16
STUB_DEV uint32_t stub_dense_sum(const uint32_t *blocks, const int32_t *nblk,
                                 const uint32_t *s_words, int i0, int rows,
                                 int nblk_max, uint32_t *acc) {
  const int lane = stub_lane();
  acc[lane] = 0;
  const uint32_t nb = lane < rows ? (uint32_t)nblk[i0 + lane] : 0;
  const bool vb = stub_align(blocks) == 16, vs = stub_align(s_words) == 16;
  const uint32_t *sw = s_words + (size_t)i0 * 8;
  stub_u4 sv[2];
  STUB_UNROLL
  for (int u = 0; u < 2; u++) {
    const int f = 32 * u + lane;
    sv[u] = f < 2 * rows ? stub_load4(sw + 4 * f, vs) : stub_u4{0, 0, 0, 0};
  }
  stub_warp_sync();
  const uint32_t *bw = blocks + (size_t)i0 * nblk_max * 32;
  const int total = rows * nblk_max * 8;  // 16-byte words of the rows
  for (int base = 0; base < total; base += STUB_BATCH * 32) {
    stub_u4 v[STUB_BATCH];
    STUB_UNROLL
    for (int u = 0; u < STUB_BATCH; u++) {
      const int f = base + 32 * u + lane;
      v[u] = f < total ? stub_load4(bw + 4 * f, vb) : stub_u4{0, 0, 0, 0};
    }
    STUB_UNROLL
    for (int u = 0; u < STUB_BATCH; u++) {
      const int f = base + 32 * u + lane;
      uint32_t g = stub_sum4(v[u]);
      g += stub_xor(g, 4);
      g += stub_xor(g, 2);
      g += stub_xor(g, 1);
      if ((lane & 7) == 0 && f < total) stub_add(acc + (f >> 3) / nblk_max, g);
    }
  }
  STUB_UNROLL
  for (int u = 0; u < 2; u++) {
    const int f = 32 * u + lane;
    uint32_t g = stub_sum4(sv[u]);
    g += stub_xor(g, 1);
    if ((lane & 1) == 0 && f < 2 * rows) stub_add(acc + (f >> 1), g);
  }
  stub_warp_sync();
  return lane < rows ? acc[lane] + nb : 0;
}

// P1's tally: the limbs (8 int32 a row, two 16-byte words) of the warp's
// accepted items, zero-extended, added into part (the block's 8 shared
// sums). A pair of lanes reads an item's row; the lane takes the verdict
// from the item's owner, the warp reduces each limb over the lanes of one
// parity, and lanes 0 and 1 add four limbs each.
STUB_DEV void stub_dense_tally(const int32_t *limbs, int i0, int rows,
                               bool ok, unsigned long long *part) {
  const int lane = stub_lane();
  const bool vec = stub_align(limbs) == 16;
  const uint32_t *lw = (const uint32_t *)limbs + (size_t)i0 * 8;
  unsigned long long t[4] = {0, 0, 0, 0};
  STUB_UNROLL
  for (int u = 0; u < 2; u++) {
    const int f = 32 * u + lane;
    const bool take = stub_from(ok ? 1 : 0, f >> 1) != 0 && f < 2 * rows;
    if (take) {
      const stub_u4 q = stub_load4(lw + 4 * f, vec);
      t[0] += q.x;
      t[1] += q.y;
      t[2] += q.z;
      t[3] += q.w;
    }
  }
  STUB_UNROLL
  for (int m = 2; m < 32; m <<= 1) {
    STUB_UNROLL
    for (int j = 0; j < 4; j++) t[j] += stub_xor64(t[j], m);
  }
  if (lane < 2) {
    STUB_UNROLL
    for (int j = 0; j < 4; j++)
      if (t[j]) stub_add64(part + 4 * lane + j, t[j]);
  }
}

// Sparse rows (P3): the R, A and s bytes and the ncols diff-column bytes
// of the warp's items [i0, i0 + rows), rows >= 1, into acc; the lane's
// own value, 0 for a lane past rows. R, A and s are 32 bytes a row: a
// pair of lanes reads an item's two 16-byte words of each and adds their
// bytes four at a time (dp4a). The diff columns are read as the 4-byte
// words of the warp's span (a scalar head up to the first 4-byte boundary
// and a scalar tail), so a slice that starts at any row reads as well; a
// word that straddles two items (ncols not a multiple of 4) adds each
// byte to its own item.
STUB_DEV uint32_t stub_sparse_sum(const uint8_t *dvals, int ncols,
                                  const int32_t *mlen, const uint8_t *r,
                                  const uint8_t *a, const uint8_t *s,
                                  int i0, int rows, uint32_t *acc) {
  const int lane = stub_lane();
  acc[lane] = 0;
  const uint32_t ml = lane < rows ? (uint32_t)mlen[i0 + lane] : 0;
  stub_warp_sync();
  const int ar = stub_align(r), aa = stub_align(a), as = stub_align(s);
  const size_t off = (size_t)i0 * 32;
  uint32_t v[2];
  STUB_UNROLL
  for (int u = 0; u < 2; u++) {
    const int f = 32 * u + lane;
    v[u] = 0;
    if (f < 2 * rows) {
      v[u] = stub_bytes16(r + off + 16 * f, ar, v[u]);
      v[u] = stub_bytes16(a + off + 16 * f, aa, v[u]);
      v[u] = stub_bytes16(s + off + 16 * f, as, v[u]);
    }
  }
  STUB_UNROLL
  for (int u = 0; u < 2; u++) {
    const int f = 32 * u + lane;
    const uint32_t g = v[u] + stub_xor(v[u], 1);
    if ((lane & 1) == 0 && f < 2 * rows) stub_add(acc + (f >> 1), g);
  }
  if (ncols > 0) {
    const uint8_t *d = dvals + (size_t)i0 * ncols;
    const int len = rows * ncols;
    int head = (int)((4 - ((uintptr_t)d & 3)) & 3);
    if (head > len) head = len;
    const int nw = (len - head) >> 2;
    const uint32_t *dw = (const uint32_t *)(d + head);
    for (int k = lane; k < nw; k += 32) {
      const uint32_t w = STUB_LDG(dw + k);
      const int p = head + 4 * k, it = p / ncols;
      if ((p + 3) / ncols == it) {
        stub_add(acc + it, stub_bytes(w, 0));
      } else {
        for (int j = 0; j < 4; j++)
          stub_add(acc + (p + j) / ncols, w >> (8 * j) & 0xff);
      }
    }
    const int tail = head + 4 * nw;
    if (lane < head) stub_add(acc + lane / ncols, d[lane]);
    if (lane < len - tail) stub_add(acc + (tail + lane) / ncols, d[tail + lane]);
  }
  stub_warp_sync();
  return lane < rows ? acc[lane] + ml : 0;
}

// One lane of the dense kernel in the warp whose items are [i0, i0 + rows),
// rows >= 1: the warp's sums, then the lane's item (if any) burned, its
// verdict and burned word stored, and with limbs the warp's tally into
// part.
STUB_DEV void stub_dense_lane(const uint32_t *blocks, const int32_t *nblk,
                              const uint32_t *s_words, const int32_t *limbs,
                              uint8_t *out, uint32_t *burned, int i0,
                              int rows, int nblk_max, int device_work,
                              uint32_t *acc, unsigned long long *part) {
  const int lane = stub_lane();
  const uint32_t x0 = stub_dense_sum(blocks, nblk, s_words, i0, rows,
                                     nblk_max, acc);
  bool ok = false;
  if (lane < rows) {
    const uint32_t x = stub_burn(x0, device_work);
    ok = (x & 1u) == 0;
    out[i0 + lane] = ok ? 1 : 0;
    burned[i0 + lane] = x;
  }
  if (limbs != nullptr) stub_dense_tally(limbs, i0, rows, ok, part);
}

// One lane of the sparse kernel, as stub_dense_lane.
STUB_DEV void stub_sparse_lane(const uint8_t *dvals, int ncols,
                               const int32_t *mlen, const uint8_t *r,
                               const uint8_t *a, const uint8_t *s,
                               uint8_t *out, uint32_t *burned, int i0,
                               int rows, int device_work, uint32_t *acc) {
  const int lane = stub_lane();
  const uint32_t x0 = stub_sparse_sum(dvals, ncols, mlen, r, a, s, i0, rows,
                                      acc);
  if (lane >= rows) return;
  const uint32_t x = stub_burn(x0, device_work);
  out[i0 + lane] = (x & 1u) == 0 ? 1 : 0;
  burned[i0 + lane] = x;
}
