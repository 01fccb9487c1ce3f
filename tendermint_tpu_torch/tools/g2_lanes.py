"""Seeded lane pairs for holding the G2-add round (``bls_g2_add_round``)
against its plain version and the curve spec, and seeded keys for holding
the tree (``bls_g2_tree_sum``) against the plain tree.

The lanes cycle through every class the round distinguishes: two
different points, the same with P at another Jacobian Z, P == Q (the
doubling), P == Q at another Z, P == -Q (the cancel), P at infinity, Q at
infinity, both at infinity, and coordinates that are no curve point (the
field arithmetic alone). Curve points come from a chain of additions, so
a few thousand lanes cost well under a second of host Python.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..crypto.bls12381 import curve
from ..crypto.bls12381.field import P, f2mul, f2sqr

INF = ((0, 0), (0, 0), (0, 0))
CLASSES = ("generic", "generic-z", "double", "double-z", "cancel", "p-inf",
           "q-inf", "both-inf", "junk")


def _fq2(rng: np.random.Generator) -> Tuple[int, int]:
    return tuple(int.from_bytes(rng.bytes(48), "little") % P
                 for _ in range(2))


def rescale(pt, z):
    """The same point with its Jacobian Z multiplied by ``z``."""
    z2 = f2sqr(z)
    return (f2mul(pt[0], z2), f2mul(pt[1], f2mul(z2, z)), f2mul(pt[2], z))


def lane_pairs(rng: np.random.Generator, n: int
               ) -> Tuple[List, List, List[str]]:
    """``n`` (P, Q) lane pairs as Jacobian points of plain ints, cycling
    through :data:`CLASSES`; returns (Ps, Qs, class of each lane)."""
    g = (curve.G2_GEN[0], curve.G2_GEN[1], (1, 0))
    pt = curve.g2_mul(g, int(rng.integers(2, 2**62)))
    step = curve.g2_mul(g, int(rng.integers(2, 2**62)))
    ps, qs, kinds = [], [], []
    for i in range(n):
        kind = CLASSES[i % len(CLASSES)]
        nxt = curve.g2_add(pt, step)
        p, q = pt, nxt
        if kind == "generic-z":
            p = rescale(p, _fq2(rng))
        elif kind == "double":
            q = p
        elif kind == "double-z":
            q = rescale(p, _fq2(rng))
        elif kind == "cancel":
            q = rescale(curve.g2_neg(p), _fq2(rng))
        elif kind == "p-inf":
            p = INF
        elif kind == "q-inf":
            q = INF
        elif kind == "both-inf":
            p = q = INF
        elif kind == "junk":
            p = tuple(_fq2(rng) for _ in range(3))
            q = tuple(_fq2(rng) for _ in range(3))
        ps.append(p)
        qs.append(q)
        kinds.append(kind)
        pt = nxt
    return ps, qs, kinds


def spec_sum(p, q):
    """The group sum P + Q by the curve spec, as an affine point or
    ``None`` for infinity (P and Q must be curve points)."""
    if p[2] == (0, 0):
        s = q
    elif q[2] == (0, 0):
        s = p
    else:
        s = curve.g2_add(p, q)
    return None if s[2] == (0, 0) else curve.g2_to_affine(s)


def tree_points(rng: np.random.Generator, n: int) -> List:
    """``n`` affine curve points (keys of an aggregate) from a chain of
    additions, with two that the tree's order sends through the special
    lanes: point 0 again at width / 2, which meets its twin at the first
    level (a doubling; width is n padded to a power of 2, at least 2); and
    the negation of point 1 where it meets point 1 (a cancel), at the first
    level (width / 2 + 1) when n reaches it, else at the second
    (width / 4 + 1, whose first-level partners are padding)."""
    g = (curve.G2_GEN[0], curve.G2_GEN[1], (1, 0))
    pt = curve.g2_mul(g, int(rng.integers(2, 2**62)))
    step = curve.g2_mul(g, int(rng.integers(2, 2**62)))
    affs = []
    for _ in range(n):
        affs.append(curve.g2_to_affine(pt))
        pt = curve.g2_add(pt, step)
    width = 2
    while width < n:
        width *= 2
    if width // 2 < n:
        affs[width // 2] = affs[0]
    for i in (width // 2 + 1, width // 4 + 1):
        if 1 < i < n and i != width // 2:
            affs[i] = curve.g2_to_affine(curve.g2_neg((*affs[1], (1, 0))))
            break
    return affs
