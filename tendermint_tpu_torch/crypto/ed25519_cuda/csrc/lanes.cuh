// edwards25519 group operations on four lanes: a group of four threads
// holds one point, lane c (0-3) its coordinate c of (X, Y, Z, T).
//
// The parallel formulas of Hisil, Wong, Carter and Dawson ("Twisted
// Edwards Curves Revisited", ASIACRYPT 2008, section 4), as in the 4-lane
// vector backend of curve25519-dalek: the same extended coordinates, the
// same complete a = -1 law with the constant 2d, and the same products as
// the one-thread extended-coordinate addition, mixed addition and doubling
// (ref10's ge_add, ge_madd, ge_p2_dbl), so every result is the same
// projective point. Each operation is two rounds of one field multiply (or
// squaring) a lane, with field elements exchanged inside the group between
// them; one thread would run 7 to 9 multiplies in series.
//
// A table entry for an addition is in cached form, lane c holding
// (Y - X, Y + X, Z, 2d T)[c]; a fixed-base (niels) entry is (y - x, y + x,
// 1, 2d x y)[c]. Round 1 of an addition P1 + P2, lane by lane:
//   A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2), D = 2 Z1 Z2,
//   C = T1 2d T2 (a niels entry has Z2 = 1: lane 2 takes D = 2 Z1 and
//   skips its product);
// then E = B - A, F = D - C, G = D + C, H = B + A, and round 2:
//   X3 = E F, Y3 = G H, Z3 = F G, T3 = E H.
// A doubling squares X, Y, Z and X + Y in round 1 (Z^2 doubled), forms
// the doubling's e, f, g, h from them, and round 2 is the same four
// products.
//
// Every exchange is reached by all 32 lanes of the warp: the functions
// have no branch on data, and a group with no item runs a dummy one.
//
// On the card a lane is a thread and the exchange is __shfl_sync over the
// group's four lanes. Without __CUDACC__ (a g++ harness that checks this
// arithmetic on the host) the harness runs a group's four lanes as four
// threads and defines tm_host_lane and tm_host_xchg.
#pragma once

#include "curve.cuh"

#ifdef __CUDACC__
TM_DEV int lane4() { return threadIdx.x & 3; }

// the warp's lanes together again after code that diverged
TM_DEV void lanes_sync() { __syncwarp(); }

// h = f as lane src of this lane's group holds it
TM_DEV void fe_xchg(fe &h, const fe &f, int src) {
  TM_UNROLL
  for (int i = 0; i < 10; i++)
    h.v[i] = __shfl_sync(0xffffffffu, f.v[i], src, 4);
}
#else
int tm_host_lane();
void tm_host_xchg(uint32_t out[10], const uint32_t in[10], int src);

TM_DEV int lane4() { return tm_host_lane(); }

TM_DEV void lanes_sync() {}

TM_DEV void fe_xchg(fe &h, const fe &f, int src) {
  tm_host_xchg(h.v, f.v, src);
}
#endif

// v[c]: the value of a per-lane table for lane c
TM_DEV int pick4(int c, int v0, int v1, int v2, int v3) {
  return c == 0 ? v0 : (c == 1 ? v1 : (c == 2 ? v2 : v3));
}

// Per-lane choices are made with masks (all ones or zero), not branches:
// the lanes of a warp take different sides of every choice, and a branch
// a limb would cost more than the arithmetic it selects.
TM_DEV uint32_t lane_mask(bool b) { return 0u - (uint32_t)b; }

// m ? b : a, limb by limb
TM_DEV void fe_pick(fe &h, const fe &a, const fe &b, uint32_t m) {
  TM_UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = a.v[i] ^ ((a.v[i] ^ b.v[i]) & m);
}

// limb i of g, or of 4p - g where m is set
TM_DEV uint32_t limb_signed(uint32_t g, int i, uint32_t m) {
  return ((g ^ m) - m) + (fe_4p(i) & m);
}

// h = f + (g or -g) + (0, t or -t), carried; f, g, t carried. neg_g, use_t
// and neg_t are masks. The sum of a limb stays below 2^26 + 2 * 4p_i <
// 2^30, as fe_carry_narrow needs.
TM_DEV void fe_lin3(fe &h, const fe &f, const fe &g, uint32_t neg_g,
                    const fe &t, uint32_t use_t, uint32_t neg_t) {
  TM_UNROLL
  for (int i = 0; i < 10; i++)
    h.v[i] = f.v[i] + limb_signed(g.v[i], i, neg_g) +
             (limb_signed(t.v[i], i, neg_t) & use_t);
  fe_carry_narrow(h);
}

// this lane's coordinate of the identity (0, 1, 1, 0), and of its cached
// form (1, 1, 1, 0)
TM_DEV void ge4_identity(fe &p, int c) {
  fe_zero(p);
  p.v[0] = (c == 1 || c == 2) ? 1u : 0u;
}

TM_DEV void ge4_identity_cached(fe &q, int c) {
  fe_zero(q);
  q.v[0] = c == 3 ? 0u : 1u;
}

// --- stage functions: one lane's work between two exchanges ---------------

// Round 1 of an addition, the first factor: (Y1 - X1, Y1 + X1, 2 Z1, T1)[c]
// from the lane's own coordinate and o, its xor-1 partner's (Y1 on lane
// 0, X1 on lane 1).
TM_DEV void ge4_add_factor(fe &u, int c, const fe &own, const fe &o) {
  const uint32_t m0 = lane_mask(c == 0), m1 = lane_mask(c == 1),
                 m2 = lane_mask(c == 2);
  fe f, zero;
  fe_zero(zero);
  fe_pick(f, own, o, m0);
  // lane 0: o - own; 1: own + o; 2: own + own; 3: own + 0
  fe g;
  fe_pick(g, zero, o, m1);
  fe_pick(g, g, own, m0 | m2);
  fe_lin3(u, f, g, m0, zero, 0u, 0u);
}

// Round 2's sources: lane c reads P1, Q1, P2, Q2 from these lanes of the
// round-1 products (A, B, D, C) and forms P1 -/+ Q1 and P2 -/+ Q2:
//   lane 0: E = B - A, F = D - C      lane 1: G = D + C, H = B + A
//   lane 2: F = D - C, G = D + C      lane 3: E = B - A, H = B + A
TM_DEV int ge4_add_src(int c, int k) {
  switch (k) {
    case 0: return pick4(c, 1, 2, 2, 1);
    case 1: return pick4(c, 0, 3, 3, 0);
    case 2: return pick4(c, 2, 1, 2, 1);
    default: return pick4(c, 3, 0, 3, 0);
  }
}

TM_DEV void ge4_add_mix(fe &m1, fe &m2, int c, const fe &p1, const fe &q1,
                        const fe &p2, const fe &q2) {
  fe_lin3(m1, p1, q1, lane_mask(c != 1), q1, 0u, 0u);
  fe_lin3(m2, p2, q2, lane_mask(c == 0), q2, 0u, 0u);
}

// Round 1 of a doubling: the value lane c squares, (X, Y, Z, X + Y)[c];
// x and y are X and Y, read from lanes 0 and 1.
TM_DEV void ge4_dbl_base(fe &u, int c, const fe &own, const fe &x,
                         const fe &y) {
  fe xy;
  fe_add(xy, x, y);
  fe_pick(u, own, xy, lane_mask(c == 3));
}

// Round 2's sources for a doubling of the squares (a, b, c2, S) = (X^2,
// Y^2, 2 Z^2, (X + Y)^2) on lanes 0-3: every lane reads a and b, and
// t1, t2 from these lanes; then
//   lane 0: e = a + b - S, f = a - b + c2    lane 1: g = a - b, h = a + b
//   lane 2: f = a - b + c2, g = a - b        lane 3: e = a + b - S, h = a + b
// (the one-thread doubling's h = a + b, e = h - S, g = a - b, f = c2 + g).
TM_DEV int ge4_dbl_src(int c, int k) {
  return k == 0 ? pick4(c, 3, 1, 2, 3) : pick4(c, 2, 1, 2, 3);
}

TM_DEV void ge4_dbl_mix(fe &m1, fe &m2, int c, const fe &a, const fe &b,
                        const fe &t1, const fe &t2) {
  fe_lin3(m1, a, b, lane_mask(c == 1 || c == 2), t1, lane_mask(c != 1),
          lane_mask(c != 2));
  fe_lin3(m2, a, b, lane_mask(c == 0 || c == 2), t2, lane_mask(c == 0), 0u);
}

// --- the operations, exchanges included -----------------------------------

// p = p + q: p extended, q this lane's coordinate of a cached entry, or of
// a niels entry when niels is set (lane 2's q is then 1, and unused).
TM_DEV void ge4_add(fe &p, const fe &q, bool niels) {
  const int c = lane4();
  fe o, u, r;
  fe_xchg(o, p, c ^ 1);
  ge4_add_factor(u, c, p, o);
  fe_mul(r, u, q);
  if (niels) fe_pick(r, r, u, lane_mask(c == 2));
  fe p1, q1, p2, q2;
  fe_xchg(p1, r, ge4_add_src(c, 0));
  fe_xchg(q1, r, ge4_add_src(c, 1));
  fe_xchg(p2, r, ge4_add_src(c, 2));
  fe_xchg(q2, r, ge4_add_src(c, 3));
  ge4_add_mix(u, o, c, p1, q1, p2, q2);
  fe_mul(p, u, o);
}

// p = 2 p (T is not read)
TM_DEV void ge4_dbl(fe &p) {
  const int c = lane4();
  fe x, y, u, r;
  fe_xchg(x, p, 0);
  fe_xchg(y, p, 1);
  ge4_dbl_base(u, c, p, x, y);
  fe_sq(r, u);
  fe_add(u, r, r);
  fe_pick(r, r, u, lane_mask(c == 2));
  fe a, b, t1, t2;
  fe_xchg(a, r, 0);
  fe_xchg(b, r, 1);
  fe_xchg(t1, r, ge4_dbl_src(c, 0));
  fe_xchg(t2, r, ge4_dbl_src(c, 1));
  ge4_dbl_mix(x, y, c, a, b, t1, t2);
  fe_mul(p, x, y);
}

// q = p in cached form, (Y - X, Y + X, Z, 2d T)[c]
TM_DEV void ge4_to_cached(fe &q, const fe &p) {
  const int c = lane4();
  const uint32_t m0 = lane_mask(c == 0);
  fe o, f, g, u, d2, t;
  fe_xchg(o, p, c ^ 1);
  fe_pick(f, p, o, m0);
  fe_pick(g, o, p, m0);
  fe_lin3(u, f, g, m0, g, 0u, 0u);
  fe_load_const(d2, TM_FE_D2);
  fe_mul(t, p, d2);
  fe_pick(q, p, u, lane_mask(c < 2));
  fe_pick(q, q, t, lane_mask(c == 3));
}

// this lane's coordinate of -P, from the whole of P
TM_DEV void ge4_neg_coord(fe &p, int c, const ge &P) {
  fe n;
  fe_neg(n, c == 0 ? P.X : P.T);
  fe_copy(p, c == 1 ? P.Y : P.Z);
  fe_cmov(p, n, c == 0 || c == 3);
}
