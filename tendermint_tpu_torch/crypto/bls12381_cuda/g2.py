"""The G2-add kernel's wrapper, its plain PyTorch version, and the host
conversions in and out of its Montgomery limbs.

:func:`g2_add_round` adds two lane arrays of Jacobian points on the twist
E'(Fq2) of BLS12-381, lane by lane, with the lane semantics of the JAX
package's ``vec.g2_add_vec`` (K10). On a CUDA tensor it launches
``bls_g2_add_round`` (``csrc/g2_add.cu``) or raises; on a CPU tensor it
runs :func:`g2_add_round_plain`, the same round on torch tensors.

Layout, for the kernel and the plain version alike: item-major
``(n, 3, 2, 12)`` uint32 tensors. Per lane the Jacobian X, Y, Z; each an
Fq2 element (c0, c1); each 12 little-endian 32-bit limbs of a canonical
Montgomery residue with R = 2^384 (the JAX package uses 2^390). Values
cross between packages only as plain integers: :func:`to_lanes` and
:func:`from_lanes` convert with Python ints (``x * R mod p``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...device import default_device
from ..bls12381.field import P
from . import build

NLIMBS = 12
R_BITS = 384
R_MONT = pow(2, R_BITS, P)
R_INV = pow(R_MONT, -1, P)
LANE_SHAPE = (3, 2, NLIMBS)

#: lanes one tree sums at most (csrc/g2_add.cu): the padded width of a
#: commit's most signers (types/vote.py MAX_VOTES_COUNT, 10,000)
TREE_MAX_LANES = 1 << 14
_TREE_WS_HEAD = 4

#: launches of the kernels by their wrappers (plain-version calls excluded)
launches = {"bls_g2_add_round": 0, "bls_g2_tree_sum": 0, "bls_fq_mul": 0}
_LAUNCH_LOCK = threading.Lock()

Fq2 = Tuple[int, int]
Jacobian = Tuple[Fq2, Fq2, Fq2]


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        launches[name] += 1


def kernel_device() -> torch.device:
    """The default device, with the kernel built and loaded when it is the
    card. Raises :class:`~tendermint_tpu_torch.device.KernelUnavailable`
    when CUDA is absent (and the CPU was not asked for) or the library does
    not build or load."""
    dev = default_device()
    if dev.type == "cuda":
        build.PACKAGE.library("g2_add")
    return dev


def _check_lanes(name: str, x) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != torch.uint32 or x.dim() != 4 \
            or tuple(x.shape[1:]) != LANE_SHAPE:
        raise TypeError(f"{name}: expected an (n, 3, 2, {NLIMBS}) uint32 "
                        f"tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def g2_add_round(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(n, 3, 2, 12) uint32 lanes P and Q -> P + Q, lane by lane."""
    _check_lanes("p", p)
    _check_lanes("q", q)
    if p.shape != q.shape or p.device != q.device:
        raise ValueError(f"p and q differ: {tuple(p.shape)} on {p.device}, "
                         f"{tuple(q.shape)} on {q.device}")
    dev = p.device
    if dev.type == "cpu":
        return g2_add_round_plain(p, q)
    if dev.type != "cuda":
        raise ValueError(f"g2_add_round: unsupported device {dev}")
    lib = build.PACKAGE.library("g2_add")
    with torch.cuda.device(dev):
        out = torch.empty_like(p)
        rc = lib.tm_bls_g2_add_round(p.data_ptr(), q.data_ptr(),
                                     out.data_ptr(), p.shape[0],
                                     _stream(dev))
    if rc != 0:
        raise RuntimeError(f"bls_g2_add_round: CUDA error {rc} at launch")
    _count("bls_g2_add_round")
    return out


# (device index, stream) -> the tree's finished-block counter and partial
# lanes: one launch at a time on a stream, so launches there share them
_TREE_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def _tree_workspace(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    ws = _TREE_WORKSPACE.get(key)
    if ws is None:
        with _LAUNCH_LOCK:
            ws = _TREE_WORKSPACE.get(key)
            if ws is None:
                blocks = int(TREE_MAX_LANES ** 0.5)
                ws = torch.zeros(_TREE_WS_HEAD + blocks * 6 * NLIMBS,
                                 dtype=torch.int32, device=dev)
                _TREE_WORKSPACE[key] = ws
    return ws


def tree_sum(lanes: torch.Tensor) -> torch.Tensor:
    """(2^k, 3, 2, 12) uint32 lanes, at most TREE_MAX_LANES -> their
    (1, 3, 2, 12) sum in one launch, with the JAX tree's order: at every
    level lane i adds lane i + half."""
    _check_lanes("lanes", lanes)
    n = lanes.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"tree_sum: {n} lanes is not a power of 2")
    if n > TREE_MAX_LANES:
        raise ValueError(f"tree_sum: {n} lanes, over {TREE_MAX_LANES}")
    dev = lanes.device
    if dev.type == "cpu":
        return tree_sum_plain(lanes)
    if dev.type != "cuda":
        raise ValueError(f"tree_sum: unsupported device {dev}")
    lib = build.PACKAGE.library("g2_add")
    with torch.cuda.device(dev):
        out = torch.empty((1, *LANE_SHAPE), dtype=torch.uint32, device=dev)
        stream = _stream(dev)
        ws = _tree_workspace(dev, stream)
        rc = lib.tm_bls_g2_tree_sum(lanes.data_ptr(), out.data_ptr(),
                                    ws.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"bls_g2_tree_sum: CUDA error {rc} at launch")
    _count("bls_g2_tree_sum")
    return out


def fq_mul(a: torch.Tensor, b: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """(n, 12) uint32 Montgomery limbs a, b -> a * b^reps * 2^(-384 reps)
    mod p: the kernels' product, repeated reps times on its own result, one
    thread an element (``bls_fq_mul``)."""
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.uint32 or x.dim() != 2 or x.shape[1] != NLIMBS \
                or not x.is_contiguous():
            raise TypeError(f"{name}: expected a contiguous (n, {NLIMBS}) "
                            f"uint32 tensor")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b differ in shape or device")
    dev = a.device
    if dev.type == "cpu":
        out = a
        for _ in range(reps):
            out = fq_mul_plain(out, b)
        return out
    lib = build.PACKAGE.library("g2_add")
    with torch.cuda.device(dev):
        out = torch.empty_like(a)
        rc = lib.tm_bls_fq_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               a.shape[0], reps, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"bls_fq_mul: CUDA error {rc} at launch")
    _count("bls_fq_mul")
    return out


# --- host conversions -----------------------------------------------------------

def fq_to_limbs(values: Sequence[int]) -> np.ndarray:
    """Plain integers mod p -> (n, 12) uint32 Montgomery limbs."""
    raw = b"".join((v * R_MONT % P).to_bytes(48, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4").reshape(len(values), NLIMBS).copy()


def fq_from_limbs(limbs) -> List[int]:
    """(n, 12) uint32 Montgomery limbs (array or tensor) -> plain ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    raw = np.ascontiguousarray(limbs, dtype="<u4").tobytes()
    return [int.from_bytes(raw[48 * i:48 * i + 48], "little") * R_INV % P
            for i in range(len(raw) // 48)]


def to_lanes(points: Sequence[Jacobian], device=None) -> torch.Tensor:
    """Jacobian points of plain ints -> (n, 3, 2, 12) uint32 lanes."""
    flat = [c for pt in points for coord in pt for c in coord]
    limbs = fq_to_limbs(flat).reshape(len(points), *LANE_SHAPE)
    t = torch.from_numpy(limbs)
    return t if device is None else t.to(device)


def from_lanes(lanes: torch.Tensor) -> List[Jacobian]:
    """(n, 3, 2, 12) uint32 lanes -> Jacobian points of plain ints."""
    vals = fq_from_limbs(lanes.reshape(-1, NLIMBS))
    return [tuple((vals[6 * i + 2 * c], vals[6 * i + 2 * c + 1])
                  for c in range(3)) for i in range(len(vals) // 6)]


# --- plain PyTorch version --------------------------------------------------------
#
# The same round on 24 x 16-bit limbs held in int64, limb-major (24, n) per
# field element, with the kernel's R = 2^384, so every output equals the
# kernel's bit for bit: each coordinate is a canonical residue. Only
# non-negative values are shifted or masked (torch's right shift is
# arithmetic); a subtraction tracks its borrow with a compare.

L16 = 24
M16 = 0xFFFF
N0_16 = (-pow(P, -1, 1 << 16)) % (1 << 16)
_P16_INTS = [(P >> (16 * i)) & M16 for i in range(L16)]
_p16_cache: Dict[torch.device, torch.Tensor] = {}


def _p16(dev: torch.device) -> torch.Tensor:
    t = _p16_cache.get(dev)
    if t is None:
        t = torch.tensor(_P16_INTS, dtype=torch.int64, device=dev)[:, None]
        _p16_cache[dev] = t
    return t


def _to16(x: torch.Tensor) -> torch.Tensor:
    """(..., 12) uint32 -> (..., 24) int64 16-bit limbs."""
    w = x.view(torch.int32).to(torch.int64)
    w = torch.where(w < 0, w + (1 << 32), w)
    return torch.stack((w & M16, w >> 16), dim=-1).flatten(-2)


def _from16(x: torch.Tensor) -> torch.Tensor:
    """(..., 24) int64 16-bit limbs -> (..., 12) uint32."""
    pairs = x.unflatten(-1, (NLIMBS, 2))
    w = pairs[..., 0] + (pairs[..., 1] << 16)
    w = torch.where(w >= (1 << 31), w - (1 << 32), w)
    return w.to(torch.int32).view(torch.uint32)


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries of non-negative limbs; the carry out of the top
    limb drops (arithmetic mod 2^384)."""
    out, c = [], None
    for row in t.unbind(0):
        x = row if c is None else row + c
        c = x >> 16
        out.append(x & M16)
    return torch.stack(out)


def _sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b of carried limbs -> (the difference mod 2^384, final borrow)."""
    out, borrow = [], None
    for ra, rb in zip(a.unbind(0), b.unbind(0)):
        x = ra - rb if borrow is None else ra - rb - borrow
        borrow = (x < 0).to(torch.int64)
        out.append(x + (borrow << 16))
    return torch.stack(out), borrow


def _reduce_once(s: torch.Tensor) -> torch.Tensor:
    d, borrow = _sub_borrow(s, _p16(s.device).expand_as(s))
    return torch.where(borrow.bool(), s, d)


def _fadd(a, b):
    return _reduce_once(_carry(a + b))


def _fsub(a, b):
    d, borrow = _sub_borrow(a, b)
    return _carry(d + borrow * _p16(a.device))


def _fmul(a, b):
    """a * b * 2^-384 mod p, word by word (CIOS on 16-bit words): the limbs
    of t grow unnormalized (below 2^39) and are carried once at the end."""
    p16 = _p16(a.device)
    n = a.shape[1]
    zero = torch.zeros((1, n), dtype=torch.int64, device=a.device)
    t = torch.zeros((L16, n), dtype=torch.int64, device=a.device)
    for ai in a.unbind(0):
        t = t + ai * b
        m = ((t[0] & M16) * N0_16) & M16
        t = t + m * p16
        c = t[0] >> 16  # t[0] is a multiple of 2^16 now
        t = torch.cat((t[1:], zero))
        t[0] += c
    return _reduce_once(_carry(t))


def _fzero(a):
    return (a == 0).all(dim=0)


def _f2add(x, y):
    return (_fadd(x[0], y[0]), _fadd(x[1], y[1]))


def _f2sub(x, y):
    return (_fsub(x[0], y[0]), _fsub(x[1], y[1]))


def _f2dbl(x):
    return _f2add(x, x)


def _f2mul(x, y):
    ac, bd = _fmul(x[0], y[0]), _fmul(x[1], y[1])
    cross = _fmul(_fadd(x[0], x[1]), _fadd(y[0], y[1]))
    return (_fsub(ac, bd), _fsub(_fsub(cross, ac), bd))


def _f2sqr(x):
    m = _fmul(x[0], x[1])
    return (_fmul(_fadd(x[0], x[1]), _fsub(x[0], x[1])), _fadd(m, m))


def _f2zero(x):
    return _fzero(x[0]) & _fzero(x[1])


def _f2where(cond, x, y):
    return (torch.where(cond, x[0], y[0]), torch.where(cond, x[1], y[1]))


def _g2_add(p, q):
    """vec.g2_add_vec's round: both formulas in every lane, then vec's
    selection (doubling, cancel, Q at infinity, P at infinity)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2 = _f2sqr(Z1), _f2sqr(Z2)
    U1, U2 = _f2mul(X1, Z2Z2), _f2mul(X2, Z1Z1)
    S1 = _f2mul(_f2mul(Y1, Z2), Z2Z2)
    S2 = _f2mul(_f2mul(Y2, Z1), Z1Z1)
    H, Rr = _f2sub(U2, U1), _f2sub(S2, S1)
    HH = _f2sqr(H)
    HHH = _f2mul(H, HH)
    V = _f2mul(U1, HH)
    X3 = _f2sub(_f2sub(_f2sqr(Rr), HHH), _f2dbl(V))
    Y3 = _f2sub(_f2mul(Rr, _f2sub(V, X3)), _f2mul(S1, HHH))
    Z3 = _f2mul(_f2mul(Z1, Z2), H)

    A, B = _f2sqr(X1), _f2sqr(Y1)
    S = _f2dbl(_f2dbl(_f2mul(X1, B)))
    M = _f2add(_f2dbl(A), A)
    Xd = _f2sub(_f2sqr(M), _f2dbl(S))
    B8 = _f2dbl(_f2dbl(_f2dbl(_f2sqr(B))))
    Yd = _f2sub(_f2mul(M, _f2sub(S, Xd)), B8)
    Zd = _f2dbl(_f2mul(Y1, Z1))

    p_inf, q_inf = _f2zero(Z1), _f2zero(Z2)
    dbl = ~p_inf & ~q_inf & _f2zero(H) & _f2zero(Rr)
    # a cancel lane (H == 0, R != 0) has Z3 = Z1 Z2 H = 0 already
    X3, Y3, Z3 = (_f2where(dbl, d, a) for d, a in ((Xd, X3), (Yd, Y3),
                                                     (Zd, Z3)))
    X3, Y3, Z3 = (_f2where(q_inf, a, b) for a, b in ((X1, X3), (Y1, Y3),
                                                      (Z1, Z3)))
    return tuple(_f2where(p_inf, a, b) for a, b in ((X2, X3), (Y2, Y3),
                                                     (Z2, Z3)))


def _unpack(x: torch.Tensor):
    """(n, 3, 2, 12) uint32 -> three Fq2 of (24, n) int64 limbs."""
    t = _to16(x).permute(1, 2, 3, 0).contiguous()
    return tuple((t[c, 0], t[c, 1]) for c in range(3))


def _pack(pt) -> torch.Tensor:
    t = torch.stack([torch.stack(coord) for coord in pt])  # (3, 2, 24, n)
    return _from16(t.permute(3, 0, 1, 2)).contiguous()


def g2_add_round_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's function on torch tensors: (n, 3, 2, 12) uint32 lanes
    P, Q -> P + Q, on the tensors' device."""
    return _pack(_g2_add(_unpack(p), _unpack(q)))


def tree_sum_plain(lanes: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`tree_sum`: the JAX tree's rounds of
    :func:`g2_add_round_plain`, on the tensor's device."""
    while lanes.shape[0] > 1:
        half = lanes.shape[0] // 2
        lanes = g2_add_round_plain(lanes[:half], lanes[half:])
    return lanes


def fq_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's Montgomery product on torch tensors: (n, 12) uint32
    limbs a, b -> a * b * 2^-384 mod p."""
    prod = _fmul(_to16(a).T.contiguous(), _to16(b).T.contiguous())
    return _from16(prod.T.contiguous())
