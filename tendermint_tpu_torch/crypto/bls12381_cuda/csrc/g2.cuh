// Fq2 = Fq[u] / (u^2 + 1) and the complete Jacobian addition on the twist
// E'(Fq2): y^2 = x^3 + 4(u + 1), one lane per thread.
//
// Counterpart of vec.py's _f2* helpers and g2_add_vec :227 (K10's round
// body). The lane semantics are vec.py's, coordinate for coordinate, so a
// round can be held against the JAX function lane by lane:
//   - P at infinity (Z1 == 0) gives Q, whatever Q is;
//   - else Q at infinity gives P;
//   - else H == 0 and R == 0 (P == Q) gives the doubling formula;
//   - else the addition formula. A cancel lane (P == -Q: H == 0, R != 0)
//     keeps the formula's X and Y, and its Z = Z1 Z2 H is 0.
// vec.py computes both formulas in every lane and selects; here a lane
// computes only what it returns (a padding lane of the tree, Q at
// infinity, does no arithmetic). The values are the same: each
// coordinate is a fixed polynomial of the inputs, canonical mod p.
#pragma once

#include "fq.cuh"

struct fq2 {
  fq c0, c1;
};

struct g2j {
  fq2 x, y, z;
};

TM_DEV void f2_copy(fq2 &r, const fq2 &a) {
  fq_copy(r.c0, a.c0);
  fq_copy(r.c1, a.c1);
}

TM_DEV bool f2_is_zero(const fq2 &a) {
  return fq_is_zero(a.c0) && fq_is_zero(a.c1);
}

TM_DEV void f2_add(fq2 &r, const fq2 &a, const fq2 &b) {
  fq_add(r.c0, a.c0, b.c0);
  fq_add(r.c1, a.c1, b.c1);
}

TM_DEV void f2_sub(fq2 &r, const fq2 &a, const fq2 &b) {
  fq_sub(r.c0, a.c0, b.c0);
  fq_sub(r.c1, a.c1, b.c1);
}

TM_DEV void f2_dbl(fq2 &r, const fq2 &a) { f2_add(r, a, a); }

// (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0
// - a1 b1) u: 3 Fq products
TM_NOINLINE void f2_mul(fq2 &r, const fq2 &a, const fq2 &b) {
  fq ac, bd, s, t;
  fq_mul(ac, a.c0, b.c0);
  fq_mul(bd, a.c1, b.c1);
  fq_add(s, a.c0, a.c1);
  fq_add(t, b.c0, b.c1);
  fq_mul(s, s, t);
  fq_sub(r.c0, ac, bd);
  fq_sub(s, s, ac);
  fq_sub(r.c1, s, bd);
}

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 Fq products
TM_NOINLINE void f2_sqr(fq2 &r, const fq2 &a) {
  fq s, d, m;
  fq_add(s, a.c0, a.c1);
  fq_sub(d, a.c0, a.c1);
  fq_mul(m, a.c0, a.c1);
  fq_mul(r.c0, s, d);
  fq_add(r.c1, m, m);
}

TM_DEV void g2_copy(g2j &r, const g2j &a) {
  f2_copy(r.x, a.x);
  f2_copy(r.y, a.y);
  f2_copy(r.z, a.z);
}

// r = 2 P (P finite); dbl-2009-l, as vec.py's doubling lanes
TM_NOINLINE void g2_dbl_lane(g2j &r, const g2j &p) {
  fq2 a, b, s, m, t;
  f2_sqr(a, p.x);
  f2_sqr(b, p.y);
  f2_mul(s, p.x, b);
  f2_dbl(s, s);
  f2_dbl(s, s);            // S = 4 X1 B
  f2_dbl(m, a);
  f2_add(m, m, a);         // M = 3 A
  f2_sqr(t, m);
  f2_sub(t, t, s);
  f2_sub(r.x, t, s);       // Xd = M^2 - 2 S
  f2_mul(r.z, p.y, p.z);
  f2_dbl(r.z, r.z);        // Zd = 2 Y1 Z1
  f2_sqr(b, b);
  f2_dbl(b, b);
  f2_dbl(b, b);
  f2_dbl(b, b);            // 8 B^2
  f2_sub(s, s, r.x);
  f2_mul(t, m, s);
  f2_sub(r.y, t, b);       // Yd = M (S - Xd) - 8 B^2
}

// r = P + Q with vec.py's lane semantics (see the top of this file)
TM_NOINLINE void g2_add_lane(g2j &r, const g2j &p, const g2j &q) {
  if (f2_is_zero(p.z)) {
    g2_copy(r, q);
    return;
  }
  if (f2_is_zero(q.z)) {
    g2_copy(r, p);
    return;
  }
  fq2 z1z1, z2z2, u1, u2, s1, s2, h, rr, t;
  f2_sqr(z1z1, p.z);
  f2_sqr(z2z2, q.z);
  f2_mul(u1, p.x, z2z2);
  f2_mul(u2, q.x, z1z1);
  f2_mul(s1, p.y, q.z);
  f2_mul(s1, s1, z2z2);
  f2_mul(s2, q.y, p.z);
  f2_mul(s2, s2, z1z1);
  f2_sub(h, u2, u1);
  f2_sub(rr, s2, s1);
  if (f2_is_zero(h) && f2_is_zero(rr)) {
    g2_dbl_lane(r, p);
    return;
  }
  fq2 hh, hhh, v;
  f2_sqr(hh, h);
  f2_mul(hhh, h, hh);
  f2_mul(v, u1, hh);
  f2_sqr(t, rr);
  f2_sub(t, t, hhh);
  f2_sub(t, t, v);
  f2_sub(r.x, t, v);       // X3 = R^2 - HHH - 2 V
  f2_sub(t, v, r.x);
  f2_mul(t, rr, t);
  f2_mul(s1, s1, hhh);
  f2_sub(r.y, t, s1);      // Y3 = R (V - X3) - S1 HHH
  f2_mul(t, p.z, q.z);
  f2_mul(r.z, t, h);       // Z3 = Z1 Z2 H (0 on a cancel lane)
}
