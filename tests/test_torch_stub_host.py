"""The device-profile stub kernels' lane code (P1-P3), compiled as plain C++
and run on the host.

``tendermint_tpu_torch/crypto/ed25519_cuda/csrc/stub.cuh`` compiles without
``__CUDACC__`` as host functions: a round is the C expression instead of
the card's ``mad.lo.u32``, a shuffle is an exchange between two barriers,
and a shared-memory atomic add is a host atomic. This file builds a g++
harness that runs the kernels' grid as ``stub.cu`` launches it (blocks of
four warps, the tally's per-block sums) with each warp's 32 lanes as 32
threads, and holds, bit for bit, against ``stub.py``'s plain versions:

* the verdicts, burned words and (P1 with limbs) int64 limb sums of
  ``stub_verify_dense`` and ``stub_verify_sparse`` at 0, 1, 15, 16, 17, 63,
  64, 65 and 1,000 rounds (around a block of 64 unrolled rounds), n of 1,
  31, 32, 33 and 100 (ragged warps), NBLK 1-3 and 0, 1, 4 and 5 diff
  columns;
* on arrays whose base is a row in (unaligned diff columns), a 4-byte word
  in (the dense words' scalar reads) or one byte in (the sparse bytes'
  byte reads);
* the chain alone (``stub_burn``) against the closed form at up to 20,000
  rounds.

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

from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto.ed25519_cuda import stub as ST

CSRC = (Path(__file__).resolve().parent.parent / "tendermint_tpu_torch"
        / "crypto" / "ed25519_cuda" / "csrc")

HARNESS = r"""
#include <barrier>
#include <thread>

#include "stub.cuh"

struct Warp {
  std::barrier<> bar{32};
  unsigned long long slot[32];
};
static thread_local Warp *g_warp;
static thread_local int g_lane;

int tm_host_warp_lane() { return g_lane; }
void tm_host_warp_sync() { g_warp->bar.arrive_and_wait(); }
unsigned long long tm_host_warp_from64(unsigned long long v, int src) {
  g_warp->slot[g_lane] = v;
  g_warp->bar.arrive_and_wait();
  const unsigned long long got = g_warp->slot[src];
  g_warp->bar.arrive_and_wait();
  return got;
}
uint32_t tm_host_warp_from(uint32_t v, int src) {
  return (uint32_t)tm_host_warp_from64(v, src);
}

// fn() on the 32 lanes of one warp
template <class Fn> static void run_warp(Fn fn) {
  Warp w;
  std::thread t[32];
  for (int l = 0; l < 32; l++)
    t[l] = std::thread([&w, &fn, l] {
      g_warp = &w;
      g_lane = l;
      fn();
    });
  for (auto &th : t) th.join();
}

// stub.cu's grid: blocks of 4 warps (128 threads), a warp's 32 words of
// shared accumulators, a block's 8 limb sums added to sums at its end
extern "C" void h_stub_dense(const uint32_t *blocks, const int32_t *nblk,
                             const uint32_t *s_words, const int32_t *limbs,
                             uint8_t *out, uint32_t *burned,
                             unsigned long long *sums, int n, int nblk_max,
                             int work) {
  for (int b = 0; 128 * b < n; b++) {
    unsigned long long part[STUB_LIMBS] = {0};
    for (int w = 0; w < 4; w++) {
      const int i0 = 128 * b + 32 * w, rows = n - i0 < 32 ? n - i0 : 32;
      if (rows <= 0) continue;
      uint32_t acc[32];
      run_warp([&] {
        stub_dense_lane(blocks, nblk, s_words, limbs, out, burned, i0, rows,
                        nblk_max, work, acc, part);
      });
    }
    if (limbs != nullptr)
      for (int j = 0; j < STUB_LIMBS; j++) sums[j] += part[j];
  }
}

extern "C" void h_stub_sparse(const uint8_t *dvals, int ncols,
                              const int32_t *mlen, const uint8_t *r,
                              const uint8_t *a, const uint8_t *s,
                              uint8_t *out, uint32_t *burned, int n,
                              int work) {
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int rows = n - i0 < 32 ? n - i0 : 32;
    uint32_t acc[32];
    run_warp([&] {
      stub_sparse_lane(dvals, ncols, mlen, r, a, s, out, burned, i0, rows,
                       work, acc);
    });
  }
}

extern "C" void h_stub_burn(uint32_t *x, int n, int rounds) {
  for (int i = 0; i < n; i++) x[i] = stub_burn(x[i], rounds);
}
"""

ROUNDS = (0, 1, 15, 16, 17, 63, 64, 65, 1000)
NS = (1, 31, 32, 33, 100)
#: where an input's first row starts: at an aligned base, one row in, one
#: 4-byte word in (dense) or one byte in (sparse)
BASES = ("aligned", "row", "word")
SPARSE_BASES = ("aligned", "row", "byte")


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    ST.reset_launches()
    yield
    device.set_default_device(None)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host harness over csrc/stub.cuh needs a "
                    "C++ compiler")
    out = tmp_path_factory.mktemp("stub_host")
    src = out / "harness.cpp"
    src.write_text(HARNESS)
    so = out / "harness.so"
    subprocess.run([gxx, "-O1", "-std=c++20", "-shared", "-fPIC",
                    "-pthread", "-I", str(CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    h.h_stub_dense.argtypes = [vp] * 7 + [i, i, i]
    h.h_stub_sparse.argtypes = [vp, i] + [vp] * 6 + [i, i]
    h.h_stub_burn.argtypes = [vp, i, i]
    return h


def _placed(arr: np.ndarray, base: str) -> np.ndarray:
    """A copy of ``arr`` whose first element sits where ``base`` says:
    "aligned" at a 64-byte boundary, "row" one row in (a slice of a batch),
    "word" 4 bytes and "byte" 1 byte past a 64-byte boundary."""
    if base == "row":
        pad = np.zeros((1,) + arr.shape[1:], arr.dtype)
        return np.concatenate([pad, arr])[1:]
    shift = {"aligned": 0, "word": 4, "byte": 1}[base]
    buf = np.zeros(arr.nbytes + 64 + shift, np.uint8)
    start = (-buf.ctypes.data) % 64 + shift
    out = buf[start:start + arr.nbytes].view(arr.dtype).reshape(arr.shape)
    out[...] = arr
    return out


def _ptr(a) -> int:
    return a.ctypes.data


def _cases():
    for k, (work, n) in enumerate((w, n) for w in ROUNDS for n in NS):
        yield k, work, n


def test_dense_lanes_match_plain(lib):
    """P1/P2 with and without limbs: every item's verdict and burned word
    and the limb sums equal the plain version's."""
    rng = np.random.default_rng(41)
    for k, work, n in _cases():
        for nb in (1, 2, 3):
            blocks = rng.integers(-2**31, 2**31, (n, nb, 32), np.int32)
            nblk = rng.integers(0, nb + 1, n).astype(np.int32)
            s_words = rng.integers(-2**31, 2**31, (n, 8), np.int32)
            limbs = (rng.integers(0, 2**31, (n, 8), np.int32)
                     if (k + nb) % 2 else None)
            base = BASES[(k + nb) % len(BASES)]
            args = [_placed(x, base) for x in (blocks, nblk, s_words)]
            lb = None if limbs is None else _placed(limbs, base)
            out = np.zeros(n, np.uint8)
            burned = np.zeros(n, np.uint32)
            sums = np.zeros(8, np.uint64)
            lib.h_stub_dense(*map(_ptr, args),
                             None if lb is None else _ptr(lb), _ptr(out),
                             _ptr(burned), _ptr(sums), n, nb, work)
            want = ST.stub_verify_dense_plain(
                *map(torch.from_numpy, (blocks, nblk, s_words)), work,
                None if limbs is None else torch.from_numpy(limbs))
            what = (work, n, nb, base, limbs is not None)
            assert out.astype(bool).tolist() == want[0].tolist(), what
            assert burned.view(np.int32).tolist() == want[1].tolist(), what
            if limbs is None:
                assert want[2] is None
            else:
                assert sums.view(np.int64).tolist() == want[2].tolist(), what


def test_sparse_lanes_match_plain(lib):
    """P3 at 0, 1, 4 and 5 diff columns: every item's verdict and burned
    word equal the plain version's, wherever the slice starts."""
    rng = np.random.default_rng(43)
    for k, work, n in _cases():
        for c in (0, 1, 4, 5):
            dv = rng.integers(0, 256, (n, c), np.uint8)
            ml = rng.integers(0, 1 << 16, n).astype(np.int32)
            r, a, s = (rng.integers(0, 256, (n, 32), np.uint8)
                       for _ in range(3))
            base = SPARSE_BASES[(k + c) % len(SPARSE_BASES)]
            args = [_placed(x, base) for x in (dv, ml, r, a, s)]
            out = np.zeros(n, np.uint8)
            burned = np.zeros(n, np.uint32)
            lib.h_stub_sparse(_ptr(args[0]), c, *map(_ptr, args[1:]),
                              _ptr(out), _ptr(burned), n, work)
            want = ST.stub_verify_sparse_plain(
                *map(torch.from_numpy, (dv, ml, r, a, s)), work)
            what = (work, n, c, base)
            assert out.astype(bool).tolist() == want[0].tolist(), what
            assert burned.view(np.int32).tolist() == want[1].tolist(), what


def test_unaligned_slices_start_mid_word(lib):
    """A slice of a packed (n, C) batch at every row of the first 8: the
    diff columns start at any byte, the rows' sums stay the batch's."""
    rng = np.random.default_rng(47)
    n, c, work = 70, 5, 33
    dv = rng.integers(0, 256, (n, c), np.uint8)
    ml = rng.integers(0, 1 << 16, n).astype(np.int32)
    r, a, s = (rng.integers(0, 256, (n, 32), np.uint8) for _ in range(3))
    want = ST.stub_verify_sparse_plain(
        *map(torch.from_numpy, (dv, ml, r, a, s)), work)
    for start in range(8):
        m = n - start
        out = np.zeros(m, np.uint8)
        burned = np.zeros(m, np.uint32)
        lib.h_stub_sparse(_ptr(dv[start:]), c,
                          *(_ptr(x[start:]) for x in (ml, r, a, s)),
                          _ptr(out), _ptr(burned), m, work)
        assert burned.view(np.int32).tolist() == want[1][start:].tolist()
        assert out.astype(bool).tolist() == want[0][start:].tolist()


@pytest.mark.parametrize("rounds", list(ROUNDS) + [31, 32, 20_000])
def test_chain_matches_closed_form(lib, rounds):
    x = np.arange(64, dtype=np.uint32) * np.uint32(2654435761)
    want = ST._burn_plain(torch.from_numpy(x.astype(np.int64)), rounds)
    lib.h_stub_burn(_ptr(x), len(x), rounds)
    assert x.astype(np.int64).tolist() == want.tolist()
