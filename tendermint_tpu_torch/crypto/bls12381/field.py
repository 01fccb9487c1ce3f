"""BLS12-381 extension-field tower, scalar spec (pure Python).

Layout (the standard M-twist tower, e.g. draft-irtf-cfrg-pairing-friendly):

    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = u + 1
    Fq12 = Fq6[w] / (w^2 - v)

Elements are plain tuples — Fq2 = (c0, c1) ints, Fq6 = 3-tuple of Fq2,
Fq12 = 2-tuple of Fq6 — and all ops are free functions.  This module is the
*reference semantics* for the vectorized engine in vec.py; keep it boring.
"""

from __future__ import annotations

# Field modulus p and subgroup order r (both prime); x is the BLS parameter:
#   p = (x-1)^2 (x^4 - x^2 + 1)/3 + x,   r = x^4 - x^2 + 1
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_PARAM = -0xD201000000010000

# The tower constants above are only honest if p/r really come from x.
assert R == X_PARAM ** 4 - X_PARAM ** 2 + 1
assert P == (X_PARAM - 1) ** 2 * R // 3 + X_PARAM

_INV2 = (P + 1) // 2  # 1/2 mod p


# --- Fq --------------------------------------------------------------------

def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fq_sqrt(a: int):
    """sqrt in Fq (p = 3 mod 4), or None if a is not a QR."""
    y = pow(a, (P + 1) // 4, P)
    return y if y * y % P == a % P else None


# --- Fq2 -------------------------------------------------------------------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # the Fq6 non-residue, u + 1


def f2add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2neg(x):
    return (-x[0] % P, -x[1] % P)


def f2conj(x):
    return (x[0], -x[1] % P)


def f2mul(x, y):
    a, b = x
    c, d = y
    ac = a * c % P
    bd = b * d % P
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def f2sqr(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def f2scale(x, k):
    return (x[0] * k % P, x[1] * k % P)


def f2mul_xi(x):
    # (a + bu)(1 + u) = (a - b) + (a + b)u
    a, b = x
    return ((a - b) % P, (a + b) % P)


def f2inv(x):
    a, b = x
    d = pow(a * a + b * b, P - 2, P)
    return (a * d % P, -b * d % P)


def f2pow(x, e: int):
    r = F2_ONE
    for bit in bin(e)[2:]:
        r = f2sqr(r)
        if bit == "1":
            r = f2mul(r, x)
    return r


def f2sqrt(x):
    """sqrt in Fq2 via the norm trick, or None.  Always verified by squaring."""
    a, b = x
    if b == 0:
        s = fq_sqrt(a)
        if s is not None:
            return (s, 0)
        t = fq_sqrt(-a % P)  # (tu)^2 = -t^2 = a
        return (0, t) if t is not None else None
    s = fq_sqrt((a * a + b * b) % P)  # sqrt of the norm
    if s is None:
        return None
    d = (a + s) * _INV2 % P
    c0 = fq_sqrt(d)
    if c0 is None:
        c0 = fq_sqrt((a - s) * _INV2 % P)
        if c0 is None:
            return None
    c1 = b * pow(2 * c0 % P, P - 2, P) % P
    cand = (c0, c1)
    return cand if f2sqr(cand) == (a % P, b % P) else None


# --- Fq6 -------------------------------------------------------------------

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6add(x, y):
    return (f2add(x[0], y[0]), f2add(x[1], y[1]), f2add(x[2], y[2]))


def f6sub(x, y):
    return (f2sub(x[0], y[0]), f2sub(x[1], y[1]), f2sub(x[2], y[2]))


def f6neg(x):
    return (f2neg(x[0]), f2neg(x[1]), f2neg(x[2]))


def f6mul_v(x):
    # (c0 + c1 v + c2 v^2) * v = xi c2 + c0 v + c1 v^2
    return (f2mul_xi(x[2]), x[0], x[1])


def f6mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = f2mul(a0, b0)
    t1 = f2mul(a1, b1)
    t2 = f2mul(a2, b2)
    c0 = f2add(t0, f2mul_xi(f2sub(f2mul(f2add(a1, a2), f2add(b1, b2)),
                                  f2add(t1, t2))))
    c1 = f2add(f2sub(f2mul(f2add(a0, a1), f2add(b0, b1)), f2add(t0, t1)),
               f2mul_xi(t2))
    c2 = f2add(f2sub(f2mul(f2add(a0, a2), f2add(b0, b2)), f2add(t0, t2)), t1)
    return (c0, c1, c2)


def f6sqr(x):
    return f6mul(x, x)


def f6inv(x):
    a0, a1, a2 = x
    c0 = f2sub(f2sqr(a0), f2mul_xi(f2mul(a1, a2)))
    c1 = f2sub(f2mul_xi(f2sqr(a2)), f2mul(a0, a1))
    c2 = f2sub(f2sqr(a1), f2mul(a0, a2))
    t = f2inv(f2add(f2mul(a0, c0),
                    f2mul_xi(f2add(f2mul(a2, c1), f2mul(a1, c2)))))
    return (f2mul(c0, t), f2mul(c1, t), f2mul(c2, t))


# --- Fq12 ------------------------------------------------------------------

F12_ONE = (F6_ONE, F6_ZERO)


def f12mul(x, y):
    a, b = x
    c, d = y
    ac = f6mul(a, c)
    bd = f6mul(b, d)
    return (f6add(ac, f6mul_v(bd)),
            f6sub(f6sub(f6mul(f6add(a, b), f6add(c, d)), ac), bd))


def f12sqr(x):
    a, b = x
    aa = f6mul(a, a)
    bb = f6mul(b, b)
    t = f6mul(a, b)
    return (f6add(aa, f6mul_v(bb)), f6add(t, t))


def f12conj(x):
    """The p^6-Frobenius — and the inverse, for cyclotomic-subgroup elements."""
    return (x[0], f6neg(x[1]))


def f12inv(x):
    a, b = x
    t = f6inv(f6sub(f6mul(a, a), f6mul_v(f6mul(b, b))))
    return (f6mul(a, t), f6neg(f6mul(b, t)))


def f12pow(x, e: int):
    r = F12_ONE
    for bit in bin(e)[2:]:
        r = f12sqr(r)
        if bit == "1":
            r = f12mul(r, x)
    return r


# Frobenius: coefficient of w^i picks up xi^(i(p-1)/6) after conjugation.
# Basis order: w^0,w^2,w^4 carry x[0]'s Fq2 coeffs, w^1,w^3,w^5 carry x[1]'s.
_FROB_BASE = f2pow(XI, (P - 1) // 6)
_FROB1 = [F2_ONE]
for _ in range(5):
    _FROB1.append(f2mul(_FROB1[-1], _FROB_BASE))


def f12_frob(x):
    (a0, a1, a2), (b0, b1, b2) = x
    return ((f2conj(a0),
             f2mul(f2conj(a1), _FROB1[2]),
             f2mul(f2conj(a2), _FROB1[4])),
            (f2mul(f2conj(b0), _FROB1[1]),
             f2mul(f2conj(b1), _FROB1[3]),
             f2mul(f2conj(b2), _FROB1[5])))


def f12_frob2(x):
    return f12_frob(f12_frob(x))
