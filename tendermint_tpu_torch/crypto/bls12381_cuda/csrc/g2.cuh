// Fq2 = Fq[u] / (u^2 + 1) and the complete Jacobian addition on the twist
// E'(Fq2): y^2 = x^3 + 4(u + 1), on a group of 16 threads a point pair.
//
// Counterpart of vec.py's _f2* helpers and g2_add_vec :227 (K10's round
// body). The lane semantics are vec.py's, coordinate for coordinate, so a
// round can be held against the JAX function lane by lane:
//   - P at infinity (Z1 == 0) gives Q, whatever Q is;
//   - else Q at infinity gives P;
//   - else H == 0 and R == 0 (P == Q) gives the doubling formula;
//   - else the addition formula. A cancel lane (P == -Q: H == 0, R != 0)
//     keeps the formula's X and Y, and its Z = Z1 Z2 H is 0.
// vec.py computes both formulas in every lane and selects; here a group
// computes only what it returns (a padding lane of the tree, a point at
// infinity, does no arithmetic). The values are the same: each coordinate
// is a fixed polynomial of the inputs, canonical mod p.
//
// The work split. An addition is 44 Fq products (an Fq2 product is three,
// Karatsuba; a square two) in five levels of dependency, and one thread
// runs them in series in the time of 44 products. Here the group runs each
// level's products at once, one a thread: Z1^2, Z2^2, Y1 Z2, Y2 Z1, Z1 Z2
// (13 products); U1, U2, S1, S2 (12); H^2, R^2, Z1 Z2 H (7); H HH, U1 HH
// (6); R (V - X3), S1 HHH (6). A group of 16 runs every level in one
// pass (a group of 8, in 2, 2, 1, 1, 1, read slower: PERF.md, Findings).
// The doubling is three levels after
// the first two: X1^2, Y1^2, Y1 Z1 (7); X1 B, M^2, B^2 (7); M (S - Xd) (3).
// Between the product levels the threads form the Fq2 results and the
// sums the next level reads (H = U2 - U1, X3 = R^2 - HHH - 2V, ...), one
// Fq element a thread (a LIN step: up to four canonical terms, each added
// or subtracted).
//
// The steps are data: each task names its output slot and up to four
// input slots of the group's scratch (31 Fq elements in shared memory,
// slot 0 holding zero, slots 1-12 the inputs X1 .. Z2), with a sign for
// each second operand. A MUL task computes (x0 +/- x1)(x2 +/- x3), a LIN
// task x0 +/- x1 +/- x2 +/- x3. Every thread of a group runs the same
// instructions whatever its task, and a step ends with the group's
// barrier (__syncwarp over its 16 lanes). A slot is reused once every
// reader of its earlier value has run: the enum below gives each value
// its slot, and names that share a number never live at once. Branches
// (infinity, doubling) read the scratch after a barrier, so they are the
// same on every thread of the group.
//
// Without __CUDACC__ (a host compiler checking this file) the harness runs
// a group's threads as host threads and defines tm_host_grp_sync and
// tm_host_blk_sync.
#pragma once

#include "fq.cuh"

#ifdef __CUDACC__
#define TM_TABLE __device__ const
#else
#define TM_TABLE static const
#endif

// threads of a group, words of one lane (X, Y, Z; each c0, c1; each 12
// limbs) and of the group's scratch
#define G2_GROUP 16
#define G2_WORDS (6 * FQ_LIMBS)
#define G2_SLOTS 31
#define G2_SCR_WORDS (G2_SLOTS * FQ_LIMBS)

#ifdef __CUDACC__
// the group's barrier; the group is one half of a warp
__device__ __forceinline__ void grp_sync() {
  __syncwarp(0xFFFFu << (threadIdx.x & G2_GROUP));
}
__device__ __forceinline__ void blk_sync() { __syncthreads(); }
#else
void tm_host_grp_sync();
void tm_host_blk_sync();
static inline void grp_sync() { tm_host_grp_sync(); }
static inline void blk_sync() { tm_host_blk_sync(); }
#endif

TM_DEV void fq_ld(fq &r, const uint32_t *s) {
#ifdef __CUDA_ARCH__
  const uint4 *v = (const uint4 *)s;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS / 4; i++) {
    const uint4 w = v[i];
    r.v[4 * i] = w.x;
    r.v[4 * i + 1] = w.y;
    r.v[4 * i + 2] = w.z;
    r.v[4 * i + 3] = w.w;
  }
#else
  for (int i = 0; i < FQ_LIMBS; i++) r.v[i] = s[i];
#endif
}

TM_DEV void fq_st(uint32_t *d, const fq &a) {
#ifdef __CUDA_ARCH__
  uint4 *v = (uint4 *)d;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS / 4; i++)
    v[i] = make_uint4(a.v[4 * i], a.v[4 * i + 1], a.v[4 * i + 2],
                      a.v[4 * i + 3]);
#else
  for (int i = 0; i < FQ_LIMBS; i++) d[i] = a.v[i];
#endif
}

// r = a + b, or a - b where neg is set (b canonical: p - b is in (0, p],
// so a + (p - b) < 2p and the add's one subtraction makes it canonical)
TM_DEV void fq_add_signed(fq &r, const fq &a, const fq &b, bool neg) {
  fq_cc cc;
  fq nb;
  nb.v[0] = sub_cc(cc, FQ_P0, b.v[0]);
  TM_UNROLL
  for (int i = 1; i < FQ_LIMBS; i++) nb.v[i] = subc_cc(cc, fq_p(i), b.v[i]);
  const uint32_t m = 0u - (uint32_t)neg;
  TM_UNROLL
  for (int i = 0; i < FQ_LIMBS; i++)
    nb.v[i] = b.v[i] ^ ((b.v[i] ^ nb.v[i]) & m);
  fq_add(r, a, nb);
}

struct g2_task {
  uint8_t out, x0, x1, x2, x3;
  uint8_t neg;  // MUL: bit 0 negates x1, bit 1 x3; LIN: bits 0-2 x1-x3
};

#define G2_MUL 0
#define G2_LIN 1

struct g2_step {
  uint8_t kind, n;  // n tasks, after the previous steps' in the table
};

// The programs' names live in their own namespace, apart from libm's
// (j0, y1, ...) and CUDA's.
namespace g2p {

// Each value's slot in the group's scratch (capitals: an Fq2 component,
// A = c0, B = c1; lower case: a raw product before it is combined).

enum g2_slot {
  ZERO = 0,
  X1A = 1, X1B = 2, Y1A = 3, Y1B = 4, Z1A = 5, Z1B = 6,
  X2A = 7, X2B = 8, Y2A = 9, Y2B = 10, Z2A = 11, Z2B = 12,
  Z1Z1A = 13, m1 = 14, Z2Z2A = 15, m2 = 16, k0 = 17, k1 = 18,
  k2 = 19, c0 = 20, c1 = 21, c2 = 22, i0 = 23, i1 = 24,
  i2 = 25, Z1Z1B = 9, Z2Z2B = 10, Y1Z2A = 11, Y1Z2B = 12, Y2Z1A = 26,
  Y2Z1B = 27, Z1Z2A = 28, Z1Z2B = 29, u0 = 14, u1 = 16, u2 = 17,
  v0 = 18, v1 = 19, v2 = 20, s0 = 21, s1 = 22, s2 = 23,
  t0 = 24, t1 = 25, t2 = 30, U1A = 7, U1B = 8, U2A = 9,
  U2B = 10, S1A = 11, S1B = 12, S2A = 13, S2B = 15, HA = 14,
  HB = 16, RA = 17, RB = 18, HHA = 1, mh = 2, RRA = 3,
  mr = 4, z0 = 5, z1 = 6, z2 = 9, HHB = 10, RRB = 13,
  Z3A = 15, Z3B = 19, g0 = 2, g1 = 4, g2 = 5, w0 = 6,
  w1 = 9, w2 = 20, HHHA = 1, HHHB = 7, VVA = 8, VVB = 10,
  X3A = 2, X3B = 4, DA = 3, DB = 5, q0 = 6, q1 = 8,
  q2 = 9, e0 = 10, e1 = 13, e2 = 14, YYA = 1, YYB = 3,
  EEA = 5, EEB = 7, Y3A = 6, Y3B = 8, AA = 7, ma = 8,
  BA = 9, mb = 10, yz0 = 11, yz1 = 12, yz2 = 13, AB = 3,
  BB = 4, M3A = 5, YZA = 6, YZB = 14, M3B = 7, ZdA = 8,
  ZdB = 10, p0 = 3, p1 = 6, p2 = 11, MMA = 12, mm = 13,
  BBA = 14, mbb = 15, XBA = 1, XBB = 2, MMB = 4, BBB = 9,
  E2A = 16, SA = 3, SB = 6, E2B = 11, E4A = 13, XdA = 1,
  XdB = 2, E4B = 9, E8A = 14, WdA = 4, WdB = 11, E8B = 12,
  n0 = 3, n1 = 6, n2 = 9, YdA = 4, YdB = 5,
};


// Both formulas' first two levels: Z1Z1, Z2Z2, U1, U2, S1, S2, then
// H = U2 - U1 and R = S2 - S1, which pick the formula.
TM_CONST g2_step G2_PRE_STEPS[] = {
    {G2_MUL, 13}, {G2_LIN, 8}, {G2_MUL, 12}, {G2_LIN, 8}, {G2_LIN, 4}};
TM_TABLE g2_task G2_PRE_TASKS[] = {
    // MUL
    {Z1Z1A, Z1A, Z1B, Z1A, Z1B, 2},         // Z1Z1A = (Z1A + Z1B) (Z1A - Z1B)
    {m1, Z1A, ZERO, Z1B, ZERO, 0},          // m1 = Z1A Z1B
    {Z2Z2A, Z2A, Z2B, Z2A, Z2B, 2},         // Z2Z2A = (Z2A + Z2B) (Z2A - Z2B)
    {m2, Z2A, ZERO, Z2B, ZERO, 0},          // m2 = Z2A Z2B
    {k0, Y1A, ZERO, Z2A, ZERO, 0},          // k0 = Y1A Z2A
    {k1, Y1B, ZERO, Z2B, ZERO, 0},          // k1 = Y1B Z2B
    {k2, Y1A, Y1B, Z2A, Z2B, 0},            // k2 = (Y1A + Y1B) (Z2A + Z2B)
    {c0, Y2A, ZERO, Z1A, ZERO, 0},          // c0 = Y2A Z1A
    {c1, Y2B, ZERO, Z1B, ZERO, 0},          // c1 = Y2B Z1B
    {c2, Y2A, Y2B, Z1A, Z1B, 0},            // c2 = (Y2A + Y2B) (Z1A + Z1B)
    {i0, Z1A, ZERO, Z2A, ZERO, 0},          // i0 = Z1A Z2A
    {i1, Z1B, ZERO, Z2B, ZERO, 0},          // i1 = Z1B Z2B
    {i2, Z1A, Z1B, Z2A, Z2B, 0},            // i2 = (Z1A + Z1B) (Z2A + Z2B)
    // LIN
    {Z1Z1B, m1, m1, ZERO, ZERO, 0},         // Z1Z1B = m1 + m1
    {Z2Z2B, m2, m2, ZERO, ZERO, 0},         // Z2Z2B = m2 + m2
    {Y1Z2A, k0, k1, ZERO, ZERO, 1},         // Y1Z2A = k0 - k1
    {Y1Z2B, k2, k0, k1, ZERO, 3},           // Y1Z2B = k2 - k0 - k1
    {Y2Z1A, c0, c1, ZERO, ZERO, 1},         // Y2Z1A = c0 - c1
    {Y2Z1B, c2, c0, c1, ZERO, 3},           // Y2Z1B = c2 - c0 - c1
    {Z1Z2A, i0, i1, ZERO, ZERO, 1},         // Z1Z2A = i0 - i1
    {Z1Z2B, i2, i0, i1, ZERO, 3},           // Z1Z2B = i2 - i0 - i1
    // MUL
    {u0, X1A, ZERO, Z2Z2A, ZERO, 0},        // u0 = X1A Z2Z2A
    {u1, X1B, ZERO, Z2Z2B, ZERO, 0},        // u1 = X1B Z2Z2B
    {u2, X1A, X1B, Z2Z2A, Z2Z2B, 0},        // u2 = (X1A + X1B) (Z2Z2A + Z2Z2B)
    {v0, X2A, ZERO, Z1Z1A, ZERO, 0},        // v0 = X2A Z1Z1A
    {v1, X2B, ZERO, Z1Z1B, ZERO, 0},        // v1 = X2B Z1Z1B
    {v2, X2A, X2B, Z1Z1A, Z1Z1B, 0},        // v2 = (X2A + X2B) (Z1Z1A + Z1Z1B)
    {s0, Y1Z2A, ZERO, Z2Z2A, ZERO, 0},      // s0 = Y1Z2A Z2Z2A
    {s1, Y1Z2B, ZERO, Z2Z2B, ZERO, 0},      // s1 = Y1Z2B Z2Z2B
    {s2, Y1Z2A, Y1Z2B, Z2Z2A, Z2Z2B, 0},    // s2 = (Y1Z2A + Y1Z2B)
                                            //      (Z2Z2A + Z2Z2B)
    {t0, Y2Z1A, ZERO, Z1Z1A, ZERO, 0},      // t0 = Y2Z1A Z1Z1A
    {t1, Y2Z1B, ZERO, Z1Z1B, ZERO, 0},      // t1 = Y2Z1B Z1Z1B
    {t2, Y2Z1A, Y2Z1B, Z1Z1A, Z1Z1B, 0},    // t2 = (Y2Z1A + Y2Z1B)
                                            //      (Z1Z1A + Z1Z1B)
    // LIN
    {U1A, u0, u1, ZERO, ZERO, 1},           // U1A = u0 - u1
    {U1B, u2, u0, u1, ZERO, 3},             // U1B = u2 - u0 - u1
    {U2A, v0, v1, ZERO, ZERO, 1},           // U2A = v0 - v1
    {U2B, v2, v0, v1, ZERO, 3},             // U2B = v2 - v0 - v1
    {S1A, s0, s1, ZERO, ZERO, 1},           // S1A = s0 - s1
    {S1B, s2, s0, s1, ZERO, 3},             // S1B = s2 - s0 - s1
    {S2A, t0, t1, ZERO, ZERO, 1},           // S2A = t0 - t1
    {S2B, t2, t0, t1, ZERO, 3},             // S2B = t2 - t0 - t1
    // LIN
    {HA, U2A, U1A, ZERO, ZERO, 1},          // HA = U2A - U1A
    {HB, U2B, U1B, ZERO, ZERO, 1},          // HB = U2B - U1B
    {RA, S2A, S1A, ZERO, ZERO, 1},          // RA = S2A - S1A
    {RB, S2B, S1B, ZERO, ZERO, 1},          // RB = S2B - S1B
};

// The addition after H and R (add-2007-bl, as vec.py): HH, R^2, Z3 =
// Z1Z2 H; HHH, V; X3 = R^2 - HHH - 2V; Y3 = R (V - X3) - S1 HHH.
TM_CONST g2_step G2_ADD_STEPS[] = {
    {G2_MUL, 7}, {G2_LIN, 4}, {G2_MUL, 6}, {G2_LIN, 4}, {G2_LIN, 2},
    {G2_LIN, 2}, {G2_MUL, 6}, {G2_LIN, 4}, {G2_LIN, 2}};
TM_TABLE g2_task G2_ADD_TASKS[] = {
    // MUL
    {HHA, HA, HB, HA, HB, 2},               // HHA = (HA + HB) (HA - HB)
    {mh, HA, ZERO, HB, ZERO, 0},            // mh = HA HB
    {RRA, RA, RB, RA, RB, 2},               // RRA = (RA + RB) (RA - RB)
    {mr, RA, ZERO, RB, ZERO, 0},            // mr = RA RB
    {z0, Z1Z2A, ZERO, HA, ZERO, 0},         // z0 = Z1Z2A HA
    {z1, Z1Z2B, ZERO, HB, ZERO, 0},         // z1 = Z1Z2B HB
    {z2, Z1Z2A, Z1Z2B, HA, HB, 0},          // z2 = (Z1Z2A + Z1Z2B) (HA + HB)
    // LIN
    {HHB, mh, mh, ZERO, ZERO, 0},           // HHB = mh + mh
    {RRB, mr, mr, ZERO, ZERO, 0},           // RRB = mr + mr
    {Z3A, z0, z1, ZERO, ZERO, 1},           // Z3A = z0 - z1
    {Z3B, z2, z0, z1, ZERO, 3},             // Z3B = z2 - z0 - z1
    // MUL
    {g0, HA, ZERO, HHA, ZERO, 0},           // g0 = HA HHA
    {g1, HB, ZERO, HHB, ZERO, 0},           // g1 = HB HHB
    {g2, HA, HB, HHA, HHB, 0},              // g2 = (HA + HB) (HHA + HHB)
    {w0, U1A, ZERO, HHA, ZERO, 0},          // w0 = U1A HHA
    {w1, U1B, ZERO, HHB, ZERO, 0},          // w1 = U1B HHB
    {w2, U1A, U1B, HHA, HHB, 0},            // w2 = (U1A + U1B) (HHA + HHB)
    // LIN
    {HHHA, g0, g1, ZERO, ZERO, 1},          // HHHA = g0 - g1
    {HHHB, g2, g0, g1, ZERO, 3},            // HHHB = g2 - g0 - g1
    {VVA, w0, w1, ZERO, ZERO, 1},           // VVA = w0 - w1
    {VVB, w2, w0, w1, ZERO, 3},             // VVB = w2 - w0 - w1
    // LIN
    {X3A, RRA, HHHA, VVA, VVA, 7},          // X3A = RRA - HHHA - VVA - VVA
    {X3B, RRB, HHHB, VVB, VVB, 7},          // X3B = RRB - HHHB - VVB - VVB
    // LIN
    {DA, VVA, X3A, ZERO, ZERO, 1},          // DA = VVA - X3A
    {DB, VVB, X3B, ZERO, ZERO, 1},          // DB = VVB - X3B
    // MUL
    {q0, RA, ZERO, DA, ZERO, 0},            // q0 = RA DA
    {q1, RB, ZERO, DB, ZERO, 0},            // q1 = RB DB
    {q2, RA, RB, DA, DB, 0},                // q2 = (RA + RB) (DA + DB)
    {e0, S1A, ZERO, HHHA, ZERO, 0},         // e0 = S1A HHHA
    {e1, S1B, ZERO, HHHB, ZERO, 0},         // e1 = S1B HHHB
    {e2, S1A, S1B, HHHA, HHHB, 0},          // e2 = (S1A + S1B) (HHHA + HHHB)
    // LIN
    {YYA, q0, q1, ZERO, ZERO, 1},           // YYA = q0 - q1
    {YYB, q2, q0, q1, ZERO, 3},             // YYB = q2 - q0 - q1
    {EEA, e0, e1, ZERO, ZERO, 1},           // EEA = e0 - e1
    {EEB, e2, e0, e1, ZERO, 3},             // EEB = e2 - e0 - e1
    // LIN
    {Y3A, YYA, EEA, ZERO, ZERO, 1},         // Y3A = YYA - EEA
    {Y3B, YYB, EEB, ZERO, ZERO, 1},         // Y3B = YYB - EEB
};

// The doubling (dbl-2009-l, as vec.py) from X1, Y1, Z1: A = X1^2,
// B = Y1^2, M = 3A, Zd = 2 Y1 Z1; S = 4 X1 B, Xd = M^2 - 2S; Yd = M (S - Xd)
// - 8 B^2.
TM_CONST g2_step G2_DBL_STEPS[] = {
    {G2_MUL, 7}, {G2_LIN, 5}, {G2_LIN, 3}, {G2_MUL, 7}, {G2_LIN, 5},
    {G2_LIN, 4}, {G2_LIN, 4}, {G2_LIN, 3}, {G2_MUL, 3}, {G2_LIN, 2}};
TM_TABLE g2_task G2_DBL_TASKS[] = {
    // MUL
    {AA, X1A, X1B, X1A, X1B, 2},            // AA = (X1A + X1B) (X1A - X1B)
    {ma, X1A, ZERO, X1B, ZERO, 0},          // ma = X1A X1B
    {BA, Y1A, Y1B, Y1A, Y1B, 2},            // BA = (Y1A + Y1B) (Y1A - Y1B)
    {mb, Y1A, ZERO, Y1B, ZERO, 0},          // mb = Y1A Y1B
    {yz0, Y1A, ZERO, Z1A, ZERO, 0},         // yz0 = Y1A Z1A
    {yz1, Y1B, ZERO, Z1B, ZERO, 0},         // yz1 = Y1B Z1B
    {yz2, Y1A, Y1B, Z1A, Z1B, 0},           // yz2 = (Y1A + Y1B) (Z1A + Z1B)
    // LIN
    {AB, ma, ma, ZERO, ZERO, 0},            // AB = ma + ma
    {BB, mb, mb, ZERO, ZERO, 0},            // BB = mb + mb
    {M3A, AA, AA, AA, ZERO, 0},             // M3A = AA + AA + AA
    {YZA, yz0, yz1, ZERO, ZERO, 1},         // YZA = yz0 - yz1
    {YZB, yz2, yz0, yz1, ZERO, 3},          // YZB = yz2 - yz0 - yz1
    // LIN
    {M3B, AB, AB, AB, ZERO, 0},             // M3B = AB + AB + AB
    {ZdA, YZA, YZA, ZERO, ZERO, 0},        // ZdA = YZA + YZA
    {ZdB, YZB, YZB, ZERO, ZERO, 0},        // ZdB = YZB + YZB
    // MUL
    {p0, X1A, ZERO, BA, ZERO, 0},           // p0 = X1A BA
    {p1, X1B, ZERO, BB, ZERO, 0},           // p1 = X1B BB
    {p2, X1A, X1B, BA, BB, 0},              // p2 = (X1A + X1B) (BA + BB)
    {MMA, M3A, M3B, M3A, M3B, 2},           // MMA = (M3A + M3B) (M3A - M3B)
    {mm, M3A, ZERO, M3B, ZERO, 0},          // mm = M3A M3B
    {BBA, BA, BB, BA, BB, 2},               // BBA = (BA + BB) (BA - BB)
    {mbb, BA, ZERO, BB, ZERO, 0},           // mbb = BA BB
    // LIN
    {XBA, p0, p1, ZERO, ZERO, 1},           // XBA = p0 - p1
    {XBB, p2, p0, p1, ZERO, 3},             // XBB = p2 - p0 - p1
    {MMB, mm, mm, ZERO, ZERO, 0},           // MMB = mm + mm
    {BBB, mbb, mbb, ZERO, ZERO, 0},         // BBB = mbb + mbb
    {E2A, BBA, BBA, ZERO, ZERO, 0},         // E2A = BBA + BBA
    // LIN
    {SA, XBA, XBA, XBA, XBA, 0},            // SA = XBA + XBA + XBA + XBA
    {SB, XBB, XBB, XBB, XBB, 0},            // SB = XBB + XBB + XBB + XBB
    {E2B, BBB, BBB, ZERO, ZERO, 0},         // E2B = BBB + BBB
    {E4A, E2A, E2A, ZERO, ZERO, 0},         // E4A = E2A + E2A
    // LIN
    {XdA, MMA, SA, SA, ZERO, 3},            // XdA = MMA - SA - SA
    {XdB, MMB, SB, SB, ZERO, 3},            // XdB = MMB - SB - SB
    {E4B, E2B, E2B, ZERO, ZERO, 0},         // E4B = E2B + E2B
    {E8A, E4A, E4A, ZERO, ZERO, 0},         // E8A = E4A + E4A
    // LIN
    {WdA, SA, XdA, ZERO, ZERO, 1},          // WdA = SA - XdA
    {WdB, SB, XdB, ZERO, ZERO, 1},          // WdB = SB - XdB
    {E8B, E4B, E4B, ZERO, ZERO, 0},         // E8B = E4B + E4B
    // MUL
    {n0, M3A, ZERO, WdA, ZERO, 0},          // n0 = M3A WdA
    {n1, M3B, ZERO, WdB, ZERO, 0},          // n1 = M3B WdB
    {n2, M3A, M3B, WdA, WdB, 0},            // n2 = (M3A + M3B) (WdA + WdB)
    // LIN
    {YdA, n0, n1, E8A, ZERO, 3},            // YdA = n0 - n1 - E8A
    {YdB, n2, n0, n1, E8B, 7},              // YdB = n2 - n0 - n1 - E8B
};

#define G2_NSTEPS(a) ((int)(sizeof(a) / sizeof((a)[0])))

// the output's six slots (X, Y, Z; c0, c1) by case: P at infinity gives Q,
// Q at infinity gives P, the addition, the doubling
#define G2_OUT_Q 0
#define G2_OUT_P 1
#define G2_OUT_ADD 2
#define G2_OUT_DBL 3
TM_TABLE uint8_t G2_OUT[4][6] = {{X2A, X2B, Y2A, Y2B, Z2A, Z2B},
                                 {X1A, X1B, Y1A, Y1B, Z1A, Z1B},
                                 {X3A, X3B, Y3A, Y3B, Z3A, Z3B},
                                 {XdA, XdB, YdA, YdB, ZdA, ZdB}};

}  // namespace g2p

// One program's steps on the group, lane = this thread's index in it.
TM_DEV void g2_run(const g2_step *steps, int nsteps, const g2_task *tasks,
                   uint32_t *scr, int lane) {
  int first = 0;
  for (int s = 0; s < nsteps; s++) {
    const int kind = steps[s].kind, n = steps[s].n;
    for (int t = lane; t < n; t += G2_GROUP) {
      const g2_task tk = tasks[first + t];
      fq x, y, r;
      fq_ld(x, scr + tk.x0 * FQ_LIMBS);
      fq_ld(y, scr + tk.x1 * FQ_LIMBS);
      fq_add_signed(x, x, y, tk.neg & 1);
      fq_ld(y, scr + tk.x2 * FQ_LIMBS);
      fq_ld(r, scr + tk.x3 * FQ_LIMBS);
      if (kind == G2_MUL) {
        fq_add_signed(y, y, r, tk.neg & 2);
        fq_mul(r, x, y);
      } else {
        fq_add_signed(x, x, y, tk.neg & 2);
        fq_add_signed(r, x, r, tk.neg & 4);
      }
      fq_st(scr + tk.out * FQ_LIMBS, r);
    }
    first += n;
    grp_sync();
  }
}

TM_DEV bool g2_slots_zero(const uint32_t *scr, int a, int b) {
  uint32_t acc = 0;
  for (int i = 0; i < FQ_LIMBS; i++)
    acc |= scr[a * FQ_LIMBS + i] | scr[b * FQ_LIMBS + i];
  return acc == 0;
}

// out = P + Q with vec.py's lane semantics, on the 16 threads of one group
// (lane 0 .. 15), each pointer a lane of G2_WORDS words. out may be p
// or q: the inputs are copied into the scratch first, and the output is
// written after the last step.
TM_DEV void g2_add_group(uint32_t *out, const uint32_t *p, const uint32_t *q,
                         uint32_t *scr, int lane) {
  for (int k = lane; k <= 12; k += G2_GROUP) {
    fq a;
    if (k == 0)
      fq_zero(a);
    else
      fq_ld(a, (k <= 6 ? p : q) + ((k - 1) % 6) * FQ_LIMBS);
    fq_st(scr + k * FQ_LIMBS, a);
  }
  grp_sync();
  int which;
  if (g2_slots_zero(scr, g2p::Z1A, g2p::Z1B)) {
    which = G2_OUT_Q;
  } else if (g2_slots_zero(scr, g2p::Z2A, g2p::Z2B)) {
    which = G2_OUT_P;
  } else {
    g2_run(g2p::G2_PRE_STEPS, G2_NSTEPS(g2p::G2_PRE_STEPS),
           g2p::G2_PRE_TASKS, scr, lane);
    if (g2_slots_zero(scr, g2p::HA, g2p::HB) &&
        g2_slots_zero(scr, g2p::RA, g2p::RB)) {
      g2_run(g2p::G2_DBL_STEPS, G2_NSTEPS(g2p::G2_DBL_STEPS),
             g2p::G2_DBL_TASKS, scr, lane);
      which = G2_OUT_DBL;
    } else {
      g2_run(g2p::G2_ADD_STEPS, G2_NSTEPS(g2p::G2_ADD_STEPS),
             g2p::G2_ADD_TASKS, scr, lane);
      which = G2_OUT_ADD;
    }
  }
  for (int k = lane; k < 6; k += G2_GROUP) {
    fq a;
    fq_ld(a, scr + g2p::G2_OUT[which][k] * FQ_LIMBS);
    fq_st(out + k * FQ_LIMBS, a);
  }
  grp_sync();  // every output read before the scratch is reused
}

// The tree of n lanes over G blocks: block g holds the leaves g + G k,
// k < n / G, as its local lanes k (copied by the threads tid of nthreads).
// Within that class the JAX tree's pairing i + half is the local pairing
// k + L / 2 for the first log2(n / G) levels, after which the block's lane
// 0 is lane g of the JAX tree at width G.
TM_DEV void g2_tree_gather(uint32_t *lanes, const uint32_t *in, int n, int G,
                           int g, int tid, int nthreads) {
  const int words = (n / G) * G2_WORDS;
  for (int w = tid; w < words; w += nthreads)
    lanes[w] = in[(size_t)(g + G * (w / G2_WORDS)) * G2_WORDS + w % G2_WORDS];
}

// The JAX tree's levels over width lanes held at lanes (G2_WORDS words
// each): at every level lane a becomes lane a + lane a + half, a < half.
// The block's groups take the additions of a level in turn and meet at the
// block's barrier after each level; lanes[0] ends as the sum.
TM_DEV void g2_tree_levels(uint32_t *lanes, int width, uint32_t *scr,
                           int grp, int ngroups, int lane) {
  for (int w = width; w > 1; w >>= 1) {
    const int half = w >> 1;
    for (int a = grp; a < half; a += ngroups)
      g2_add_group(lanes + a * G2_WORDS, lanes + a * G2_WORDS,
                   lanes + (a + half) * G2_WORDS, scr, lane);
    blk_sync();
  }
}
