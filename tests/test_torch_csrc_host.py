"""The Ed25519 kernels' device arithmetic, compiled as plain C++ and run on
the host.

``tendermint_tpu_torch/crypto/ed25519_cuda/csrc/*.cuh`` compile without
``__CUDACC__`` as host functions (``common.cuh``). This file builds a small
harness over them with ``g++ -O1`` into a temporary directory and holds:

* ``fe_sq`` (55 limb products) bit-equal to ``fe_mul(f, f)`` and equal to
  Python integers mod p, on random and edge-case limbs;
* the four-lane group operations of ``lanes.cuh`` (addition, mixed
  addition with a niels entry, doubling, the cached form) against the
  port's plain ``ed25519_cuda/curve.py``. A group's four lanes run as four
  threads, and the harness's exchange (``tm_host_xchg``) hands each lane
  the field element of the lane it names, between two barriers: the same
  code as on the card, where the exchange is ``__shfl_sync``;
* the four-lane verify (``verify4.cuh``, the core of K5-K8) and K8's loop
  over it (``tally.cu``: 16 signatures a block, an item past n verifying
  the last again and storing nothing) with its tally against
  ``crypto/ed25519.py::verify`` on valid, corrupted and every adversarial
  class of ``chip_smoke.py``, in the dense and the sparse wire formats.

The CUDA kernels themselves need the card (``tests/test_torch_cuda.py``).
Skipped, with the reason, where no ``g++`` is found.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto.ed25519_cuda import curve as TC
from tendermint_tpu_torch.crypto.ed25519_cuda import field as F
from tendermint_tpu_torch.crypto.ed25519_cuda import sharded as TS
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV

CSRC = (Path(__file__).resolve().parent.parent / "tendermint_tpu_torch"
        / "crypto" / "ed25519_cuda" / "csrc")

HARNESS = r"""
#include <barrier>
#include <cstring>
#include <thread>

#include "verify4.cuh"

struct Group {
  std::barrier<> bar{4};
  uint32_t slot[4][10];
};
static thread_local Group *g_group;
static thread_local int g_lane;

int tm_host_lane() { return g_lane; }

void tm_host_xchg(uint32_t out[10], const uint32_t in[10], int src) {
  std::memcpy(g_group->slot[g_lane], in, 40);
  g_group->bar.arrive_and_wait();
  uint32_t got[10];
  std::memcpy(got, g_group->slot[src], 40);
  g_group->bar.arrive_and_wait();
  std::memcpy(out, got, 40);
}

// fn(c) on four threads, the lanes of one group
template <class Fn> static void run_group(Fn fn) {
  Group grp;
  std::thread t[4];
  for (int c = 0; c < 4; c++)
    t[c] = std::thread([&grp, &fn, c] {
      g_group = &grp;
      g_lane = c;
      fn(c);
    });
  for (auto &th : t) th.join();
}

static fe ld(const uint32_t *p) {
  fe f;
  std::memcpy(f.v, p, 40);
  return f;
}

extern "C" {

void h_fe_mul(const uint32_t *f, const uint32_t *g, uint32_t *h, int n) {
  for (int i = 0; i < n; i++) {
    fe r;
    fe_mul(r, ld(f + 10 * i), ld(g + 10 * i));
    std::memcpy(h + 10 * i, r.v, 40);
  }
}

void h_fe_sq(const uint32_t *f, uint32_t *h, int n) {
  for (int i = 0; i < n; i++) {
    fe r;
    fe_sq(r, ld(f + 10 * i));
    std::memcpy(h + 10 * i, r.v, 40);
  }
}

// points are (n, 4, 10): X, Y, Z, T; lane c takes coordinate c
// op 0: p + q (q extended, put in cached form by the lanes)
// op 1: p + niels q (q is (n, 3, 10): y + x, y - x, 2d x y)
// op 2: 2 p
// op 3: the cached form of p
void h_ge4(int op, const uint32_t *p, const uint32_t *q, uint32_t *out,
           int n) {
  run_group([&](int c) {
    for (int i = 0; i < n; i++) {
      fe a = ld(p + 40 * i + 10 * c), b;
      if (op == 0) {
        ge4_to_cached(b, ld(q + 40 * i + 10 * c));
        ge4_add(a, b, false);
      } else if (op == 1) {
        const int part = pick4(c, 1, 0, 0, 2);
        b = ld(q + 30 * i + 10 * part);
        if (c == 2) fe_one(b);
        ge4_add(a, b, true);
      } else if (op == 2) {
        ge4_dbl(a);
      } else {
        ge4_to_cached(b, a);
        a = b;
      }
      std::memcpy(out + 40 * i + 10 * c, a.v, 40);
    }
  });
}

// the four-lane verify over a dense batch (prepare_batch's arrays)
void h_verify4_dense(const uint32_t *blocks, const int32_t *nblk,
                     const uint32_t *s_words, const uint32_t *table,
                     uint8_t *out, int n, int nblk_max) {
  static uint32_t scratch[TM_V4_ROWS * 4];
  run_group([&](int c) {
    for (int i = 0; i < n; i++) {
      const bool ok = verify4_dense_item(
          blocks + (size_t)i * nblk_max * 32, nblk[i], s_words + 8 * i,
          table, scratch + c, 4);
      if (c == 0) out[i] = ok;
    }
  });
}

// the four-lane verify over a sparse batch (pack_sparse's arrays)
void h_verify4_sparse(const uint8_t *templates, int mlen_max,
                      const int32_t *cols, int ncols, const uint8_t *dvals,
                      const int32_t *mlen, const uint8_t *r, const uint8_t *a,
                      const uint8_t *s, int chunk, const uint32_t *table,
                      uint8_t *out, int n) {
  static uint32_t scratch[TM_V4_ROWS * 4];
  run_group([&](int c) {
    for (int i = 0; i < n; i++) {
      const bool ok = verify4_sparse_item(
          templates + (size_t)(i / chunk) * mlen_max, mlen_max, cols, ncols,
          dvals + (size_t)i * ncols, mlen[i], r + 32 * i, a + 32 * i,
          s + 32 * i, table, scratch + c, 4);
      if (c == 0) out[i] = ok;
    }
  });
}

// K8 over the same dense batch, as tally.cu's kernel runs it: 16 items a
// block, a group of four lanes an item; an item past n verifies the last
// again, stores nothing and adds nothing; lane 0 adds the limbs of its
// accepted item to the tally
void h_tally_dense(const uint32_t *blocks, const int32_t *nblk,
                   const uint32_t *s_words, const uint32_t *table,
                   const int32_t *limbs, uint8_t *out, int64_t *sums, int n,
                   int nblk_max) {
  static uint32_t scratch[TM_V4_ROWS * 4];
  for (int j = 0; j < 8; j++) sums[j] = 0;
  run_group([&](int c) {
    for (int item = 0; item < (n + 15) / 16 * 16; item++) {
      const int i = item < n ? item : n - 1;
      const bool ok = verify4_dense_item(
          blocks + (size_t)i * nblk_max * 32, nblk[i], s_words + 8 * i,
          table, scratch + c, 4);
      if (c == 0 && item < n) {
        out[item] = ok;
        for (int j = 0; j < 8; j++) sums[j] += ok ? limbs[8 * i + j] : 0;
      }
    }
  });
}
}
"""

P = F.P_INT
M26, M25 = (1 << 26) - 1, (1 << 25) - 1


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _build(out: Path):
    """The harness over the headers in ``CSRC``, built and loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host harness over csrc/*.cuh needs a C++ "
                    "compiler")
    src = out / "harness.cpp"
    src.write_text(HARNESS)
    so = out / "harness.so"
    subprocess.run([gxx, "-O1", "-std=c++20", "-shared", "-fPIC",
                    "-pthread", "-I", str(CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    h.h_fe_mul.argtypes = [vp, vp, vp, i]
    h.h_fe_sq.argtypes = [vp, vp, i]
    h.h_ge4.argtypes = [i, vp, vp, vp, i]
    h.h_verify4_dense.argtypes = [vp] * 5 + [i, i]
    h.h_tally_dense.argtypes = [vp] * 7 + [i, i]
    h.h_verify4_sparse.argtypes = ([vp, i, vp, i] + [vp] * 5
                                   + [i, vp, vp, i])
    return h


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("csrc_host"))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _limbs(xs) -> np.ndarray:
    return np.array([F.int_to_limbs(x % P) for x in xs], dtype=np.uint32)


# --- the field: fe_sq ------------------------------------------------------

def _edge_limbs(rng) -> np.ndarray:
    """Random carried limbs, the largest carried limbs (even limbs below
    2^26, odd below 2^25 + 2^15), and 0, 1, p - 1, p, 2^255 - 1."""
    widths = np.array(F.WIDTHS)
    rand = (rng.integers(0, 1 << 26, (200, 10)) & ((1 << widths) - 1))
    top = np.array([M26 if i % 2 == 0 else M25 + (1 << 15) - 1
                    for i in range(10)])
    mixed = rng.integers(0, 1 << 26, (50, 10)) % (top + 1)
    ints = [0, 1, P - 1, P, 2**255 - 1, 2**255 - 20, 19, 2**128]
    special = np.array([F.int_to_limbs(x) for x in ints])
    return np.concatenate([rand, mixed, top[None], special]).astype(
        np.uint32)


def test_fe_sq_matches_fe_mul_and_integers(lib):
    f = np.ascontiguousarray(_edge_limbs(np.random.default_rng(1)))
    n = f.shape[0]
    sq, mul = np.zeros_like(f), np.zeros_like(f)
    lib.h_fe_sq(_ptr(f), _ptr(sq), n)
    lib.h_fe_mul(_ptr(f), _ptr(f), _ptr(mul), n)
    assert np.array_equal(sq, mul)
    for row, got in zip(f, sq):
        x = F.limbs_to_int(row)
        assert F.limbs_to_int(got) % P == x * x % P
    # the result is carried again: a square of a square stays exact
    sq2 = np.zeros_like(f)
    lib.h_fe_sq(_ptr(sq), _ptr(sq2), n)
    for row, got in zip(f, sq2):
        assert F.limbs_to_int(got) % P == pow(F.limbs_to_int(row), 4, P)


# --- the four-lane group operations -----------------------------------------

def _points(rng, n):
    """Extended points as Python ints: multiples of B with random Z, the
    identity, low-order points, and random field elements (the formulas
    are polynomials, so they must agree off the curve as well)."""
    pts = []
    for k in range(n):
        x, y, z, t = ed._pt_mul(int(rng.integers(1, 2**62)) * (k + 1),
                                (ed.B[0], ed.B[1], 1, ed.B[0] * ed.B[1] % P))
        lam = int(rng.integers(2, 2**62))
        pts.append((x * lam % P, y * lam % P, z * lam % P, t * lam % P))
    pts.append((0, 1, 1, 0))
    pts.append((0, P - 1, 1, 0))                       # order 2
    pts.append((ed.SQRT_M1, 0, 1, 0))                  # order 4
    pts.append(tuple(int(v) for v in rng.integers(0, 2**62, 4)))
    return pts


def _as_np(pts) -> np.ndarray:
    return np.ascontiguousarray(np.stack([_limbs(p) for p in pts]))


def _as_point(pts) -> TC.Point:
    return TC.Point(*(F.from_ints([p[k] for p in pts]) for k in range(4)))


def _want(point: TC.Point):
    return [[x % P for x in F.to_ints(c)] for c in point]


def _got(arr: np.ndarray):
    return [[F.limbs_to_int(arr[i, k]) % P for i in range(arr.shape[0])]
            for k in range(4)]


def _run(lib, op, p, q, n):
    out = np.zeros((n, 4, 10), np.uint32)
    lib.h_ge4(op, _ptr(p), _ptr(q) if q is not None else None, _ptr(out), n)
    return out


def test_four_lane_add_and_double_match_plain_curve(lib):
    rng = np.random.default_rng(2)
    ps, qs = _points(rng, 12), _points(rng, 12)
    qs[0] = tuple((P - v) % P if k in (0, 3) else v
                  for k, v in enumerate(ps[0]))        # p + (-p)
    qs[1] = ps[1]                                      # p + p
    n = len(ps)
    p_np, q_np = _as_np(ps), _as_np(qs)
    P_t, Q_t = _as_point(ps), _as_point(qs)
    assert _got(_run(lib, 0, p_np, q_np, n)) == _want(TC.add(P_t, Q_t))
    assert _got(_run(lib, 2, p_np, None, n)) == _want(TC.dbl(P_t))
    cached = _got(_run(lib, 3, p_np, None, n))
    xs, ys, zs, ts = _want(P_t)
    assert cached == [[(y - x) % P for x, y in zip(xs, ys)],
                      [(y + x) % P for x, y in zip(xs, ys)], zs,
                      [t * TC.D2_INT % P for t in ts]]


def test_four_lane_mixed_add_matches_plain_curve(lib):
    """Mixed addition with entries of the fixed-base table, as [s]B reads
    them (y + x, y - x, 2d x y)."""
    rng = np.random.default_rng(3)
    ps = _points(rng, 10)
    table = TC.base_table_np()
    idx = [(int(rng.integers(0, 64)), int(rng.integers(0, 16)))
           for _ in ps]
    niels = np.ascontiguousarray(
        np.stack([table[w, d] for w, d in idx]).astype(np.uint32))
    got = _got(_run(lib, 1, _as_np(ps), niels, len(ps)))
    nt = torch.from_numpy(niels.astype(np.int64))
    want = TC.add_niels(_as_point(ps), nt[:, 0].T.contiguous(),
                        nt[:, 1].T.contiguous(), nt[:, 2].T.contiguous())
    assert got == _want(want)


# --- the whole verify ---------------------------------------------------------

def _cases():
    rng = np.random.default_rng(4)
    out = []
    for i in range(4):
        priv, pub = ed.keygen(bytes(rng.integers(0, 256, 32, np.uint8)))
        msg = bytes(rng.integers(0, 256, (20, 110, 200, 1)[i], np.uint8))
        sig = ed.sign(priv, msg)
        out.append((pub, msg, sig))
        out.append((pub, msg, sig[:40] + bytes([sig[40] ^ 2]) + sig[41:]))
        out.append((pub, msg[:-1] + bytes([msg[-1] ^ 1]), sig))
    seed = b"\x05" * 32
    priv, pub = ed.keygen(seed)
    msg = b"adversarial"
    out += chip_smoke._adversarial(ed, seed, msg, ed.sign(priv, msg))
    return out


def _dense_verdicts(lib, cases):
    """(four-lane verdicts, K8's verdicts, host mask) of ``cases``; K8's
    tally over random powers (zeroed where the host mask is false, as
    sharded.py does) is checked against the spec's verdicts here."""
    bw, nblk, sw, ok = TV.prepare_batch(*(list(x) for x in zip(*cases)))
    if len(cases) > 8:
        assert sorted(set(nblk.tolist())) == [1, 2, 3]
    args = [np.ascontiguousarray(x) for x in
            (bw, nblk.astype(np.int32), sw, TC.base_table_np())]
    n, nb = bw.shape[0], bw.shape[1]
    powers = np.random.default_rng(n).integers(1, 2**62, n) * ok
    limbs = np.ascontiguousarray(TS._power_limbs(powers))
    four, k8 = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    sums = np.zeros(8, np.int64)
    lib.h_verify4_dense(*(_ptr(x) for x in args), _ptr(four), n, nb)
    lib.h_tally_dense(*(_ptr(x) for x in args), _ptr(limbs), _ptr(k8),
                       _ptr(sums), n, nb)
    want = [ed.verify(*c) for c in cases]
    assert sum(int(s) << (8 * j) for j, s in enumerate(sums)) == \
        sum(int(p) for p, w in zip(powers, want) if w)
    return four.astype(bool), k8.astype(bool), ok


def test_four_lane_verify_matches_spec_dense(lib):
    cases = _cases()
    want = [ed.verify(*c) for c in cases]
    assert any(want) and not all(want)
    four, k8, ok = _dense_verdicts(lib, cases)
    assert four.tolist() == k8.tolist()
    assert (four & ok).tolist() == want


def test_four_lane_verify_on_random_keys(lib):
    """Public keys of 32 random bytes: about half fail decompression and
    are masked to the identity, the rest are points that did not sign;
    the four-lane verify, K8's loop over it and the spec reject every one."""
    rng = np.random.default_rng(6)
    priv, pub = ed.keygen(b"\x03" * 32)
    msg = b"random keys"
    sig = ed.sign(priv, msg)
    cases = [(pub, msg, sig)] + [
        (bytes(rng.integers(0, 256, 32, np.uint8)), msg, sig)
        for _ in range(23)]
    cases += _cases()[3:4] + _cases()[6:7]   # two- and three-block preimages
    want = [ed.verify(*c) for c in cases]
    assert want[0] and not any(want[1:24])
    four, k8, ok = _dense_verdicts(lib, cases)
    assert four.tolist() == k8.tolist()
    assert (four & ok).tolist() == want


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_k8_item_on_ragged_groups(lib, n):
    """K8 with n not a multiple of a block's 16 signatures: the groups past
    n verify the last item again, store nothing and add nothing to the
    tally; every stored verdict equals the spec's."""
    cases = _cases()
    cases = [cases[(5 * i + n) % len(cases)] for i in range(n)]
    want = [ed.verify(*c) for c in cases]
    four, k8, ok = _dense_verdicts(lib, cases)
    assert (k8 & ok).tolist() == want
    assert four.tolist() == k8.tolist()


@pytest.mark.parametrize("mlen", [20, 110, 200])
def test_four_lane_verify_matches_spec_sparse(lib, mlen):
    """K7's wire format: rows of one message shape with differing columns,
    in chunks of 4 (two templates, padded rows included), at preimages of
    1, 2 and 3 SHA-512 blocks."""
    rng = np.random.default_rng(5)
    base = bytes(rng.integers(0, 256, mlen, np.uint8))
    cases = []
    for i in range(6):
        priv, pub = ed.keygen(bytes([i + 9]) * 32)
        m = bytearray(base)
        m[mlen // 4], m[mlen - 9] = i, (7 * i) % 256
        sig = ed.sign(priv, bytes(m))
        if i % 3 == 1:
            sig = sig[:50] + bytes([sig[50] ^ 8]) + sig[51:]
        cases.append((pub, bytes(m), sig))
    want = [ed.verify(*c) for c in cases]
    packed = TV.pack_sparse(*(list(x) for x in zip(*cases)), 4)
    tpl, cols, dv, ml, r, a, s = (np.ascontiguousarray(x) for x in packed[:7])
    n = ml.shape[0]
    out = np.zeros(n, np.uint8)
    table = np.ascontiguousarray(TC.base_table_np())
    lib.h_verify4_sparse(_ptr(tpl), tpl.shape[1], _ptr(cols), cols.shape[0],
                         _ptr(dv), _ptr(ml), _ptr(r), _ptr(a), _ptr(s), 4,
                         _ptr(table), _ptr(out), n)
    assert (out[:len(cases)].astype(bool) & packed[7]).tolist() == want
