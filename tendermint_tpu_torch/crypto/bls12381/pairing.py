"""Optimal ate pairing e: G1 x G2 -> mu_r in Fq12.

Miller loop runs on the twist: the accumulator T walks multiples of Q on
E'/Fq2 in Jacobian coordinates, and each tangent/chord line is evaluated at
the twisted image of P = (xP, yP) in G1.  Every line is pre-scaled by
w^3 = v*w, an element of the Fq4 subfield — legal because the final
exponentiation kills any proper-subfield factor — which gives both line
shapes the same sparse form

    l = l00 * 1  +  l11 * (v w)  +  l12 * (v^2 w),      l0x in Fq2

so one dedicated sparse multiply serves the whole loop.  Derivation (T =
(X,Y,Z) Jacobian on E', P affine in G1, twist image of P at (xP w^2, yP w^3)):

  tangent at T, scaled by 2YZ^3 then v*w:
      l00 = 2 Y Z^3 xi yP,   l11 = 3 X^3 - 2 Y^2,   l12 = -3 X^2 Z^2 xP
  chord through T and affine Q2=(x2,y2), scaled by Z*H then v*w:
      l00 = xi Z H yP,       l11 = R x2 - Z H y2,   l12 = -R xP
  with H = x2 Z^2 - X, R = y2 Z^3 - Y.

The hard part of the final exponentiation uses the fixed-multiple identity

    3 (p^4 - p^2 + 1) / r = (x-1)^2 (x+p) (x^2 + p^2 - 1) + 3

(asserted below with exact integers).  Computing e(.,.)^3 instead of e(.,.)
is itself a non-degenerate pairing (gcd(3, r) = 1), and every use here is a
product-of-pairings == 1 check, which the cube preserves.
"""

from __future__ import annotations

from .field import (P, R, X_PARAM, F12_ONE, f2mul, f2sqr, f2sub, f2scale,
                    f2mul_xi, f2add, f6add, f6mul_v, f12mul, f12sqr, f12conj,
                    f12inv, f12_frob, f12_frob2)
from .curve import G2_GEN, g2_neg, g2_to_affine

# the hard-part addition chain below computes exactly this exponent
assert ((X_PARAM - 1) ** 2 * (X_PARAM + P) * (X_PARAM ** 2 + P ** 2 - 1) + 3
        == 3 * ((P ** 4 - P ** 2 + 1) // R))

_ATE_BITS = bin(-X_PARAM)[3:]  # |x| MSB-first, leading bit dropped


def _sparse_f6(e, l11, l12):
    # (e0, e1, e2) * (0, l11, l12) in Fq6
    e0, e1, e2 = e
    return (f2mul_xi(f2add(f2mul(e1, l12), f2mul(e2, l11))),
            f2add(f2mul(e0, l11), f2mul_xi(f2mul(e2, l12))),
            f2add(f2mul(e0, l12), f2mul(e1, l11)))


def _sparse_mul(f, l00, l11, l12):
    # f * (a + b w), a = (l00,0,0), b = (0,l11,l12)
    A, B = f
    Aa = (f2mul(A[0], l00), f2mul(A[1], l00), f2mul(A[2], l00))
    Ba = (f2mul(B[0], l00), f2mul(B[1], l00), f2mul(B[2], l00))
    Ab = _sparse_f6(A, l11, l12)
    Bb = _sparse_f6(B, l11, l12)
    return (f6add(Aa, f6mul_v(Bb)), f6add(Ab, Ba))


def _dbl_step(f, T, xp, yp):
    X, Y, Z = T
    XX = f2sqr(X)
    YY = f2sqr(Y)
    ZZ = f2sqr(Z)
    l00 = f2mul_xi(f2scale(f2mul(Y, f2mul(Z, ZZ)), 2 * yp % P))
    l11 = f2sub(f2scale(f2mul(XX, X), 3), f2scale(YY, 2))
    l12 = f2scale(f2mul(XX, ZZ), -3 * xp % P)
    f = _sparse_mul(f, l00, l11, l12)
    S = f2scale(f2mul(X, YY), 4)
    M = f2scale(XX, 3)
    X3 = f2sub(f2sqr(M), f2scale(S, 2))
    Y3 = f2sub(f2mul(M, f2sub(S, X3)), f2scale(f2sqr(YY), 8))
    Z3 = f2scale(f2mul(Y, Z), 2)
    return f, (X3, Y3, Z3)


def _add_step(f, T, q_aff, xp, yp):
    X, Y, Z = T
    x2, y2 = q_aff
    ZZ = f2sqr(Z)
    H = f2sub(f2mul(x2, ZZ), X)
    Rr = f2sub(f2mul(y2, f2mul(Z, ZZ)), Y)
    ZH = f2mul(Z, H)
    l00 = f2mul_xi(f2scale(ZH, yp))
    l11 = f2sub(f2mul(Rr, x2), f2mul(ZH, y2))
    l12 = f2scale(Rr, -xp % P)
    f = _sparse_mul(f, l00, l11, l12)
    HH = f2sqr(H)
    HHH = f2mul(H, HH)
    V = f2mul(X, HH)
    X3 = f2sub(f2sub(f2sqr(Rr), HHH), f2scale(V, 2))
    Y3 = f2sub(f2mul(Rr, f2sub(V, X3)), f2mul(Y, HHH))
    return f, (X3, Y3, ZH)


def miller_loop(p_aff, q_aff):
    """f_{|x|,Q}(P), conjugated for x < 0.  Both points affine, non-infinite."""
    xp, yp = p_aff
    T = (q_aff[0], q_aff[1], (1, 0))
    f = F12_ONE
    for bit in _ATE_BITS:
        f = f12sqr(f)
        f, T = _dbl_step(f, T, xp, yp)
        if bit == "1":
            f, T = _add_step(f, T, q_aff, xp, yp)
    return f12conj(f)


def _cyc_pow_x(m):
    """m^x for cyclotomic m (x is negative: conjugate of m^|x|)."""
    r = m
    for bit in _ATE_BITS:
        r = f12sqr(r)
        if bit == "1":
            r = f12mul(r, m)
    return f12conj(r)


def final_exp(f):
    # easy part: f^((p^6-1)(p^2+1)) — lands in the cyclotomic subgroup
    f = f12mul(f12conj(f), f12inv(f))
    f = f12mul(f12_frob2(f), f)
    # hard part, exponent 3(p^4-p^2+1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3
    m = f
    t = f12mul(_cyc_pow_x(m), f12conj(m))            # m^(x-1)
    a = f12mul(_cyc_pow_x(t), f12conj(t))            # m^((x-1)^2)
    b = f12mul(_cyc_pow_x(a), f12_frob(a))           # a^(x+p)
    c = f12mul(f12mul(_cyc_pow_x(_cyc_pow_x(b)),     # b^(x^2+p^2-1)
                      f12_frob2(b)), f12conj(b))
    return f12mul(c, f12mul(f12sqr(m), m))           # * m^3


def pairing(p_aff, q_aff):
    return final_exp(miller_loop(p_aff, q_aff))


def multi_pairing_check(pairs) -> bool:
    """prod e(Pi, Qi) == 1?  One shared final exponentiation; pairs with an
    infinite point contribute the identity and are skipped."""
    f = F12_ONE
    for p_aff, q_aff in pairs:
        if p_aff is None or q_aff is None:
            continue
        f = f12mul(f, miller_loop(p_aff, q_aff))
    return final_exp(f) == F12_ONE


NEG_G2_AFF = g2_to_affine(g2_neg((G2_GEN[0], G2_GEN[1], (1, 0))))
