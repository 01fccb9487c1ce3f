"""The G2-add kernels' device arithmetic (K10), compiled as plain C++ and run
on the host.

``tendermint_tpu_torch/crypto/bls12381_cuda/csrc/{fq,g2}.cuh`` compile
without ``__CUDACC__`` as host functions: the Montgomery product runs the
card's carry-chain steps on a carry flag held in a variable, and the
harness runs a group's 16 threads as host threads, with a barrier
for the group's ``__syncwarp`` and one for the block's ``__syncthreads``.
This file builds that harness with ``g++ -O1`` into a temporary directory
and holds, bit for bit:

* ``fq_mul`` against ``g2.fq_mul_plain`` and Python integers, on random and
  edge limbs (0, 1, p - 1, Montgomery one, values just under 2^384 mod p);
* the group addition against ``g2.g2_add_round_plain`` on every class of
  ``tools/g2_lanes.lane_pairs``;
* the tree's blocks (each block's leaves g + G k summed locally, then the
  G partials) against ``g2.tree_sum_plain``, with a doubling and a cancel
  inside the tree (``g2_lanes.tree_points``), on one group a block and on
  two.

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
from tendermint_tpu_torch.crypto.bls12381 import vec as tvec
from tendermint_tpu_torch.crypto.bls12381.field import P
from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
from tendermint_tpu_torch.tools import g2_lanes

CSRC = (Path(__file__).resolve().parent.parent / "tendermint_tpu_torch"
        / "crypto" / "bls12381_cuda" / "csrc")

HARNESS = r"""
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>

#include "g2.cuh"

static thread_local std::barrier<> *g_grp;
static thread_local std::barrier<> *g_blk;

void tm_host_grp_sync() { g_grp->arrive_and_wait(); }
void tm_host_blk_sync() { g_blk->arrive_and_wait(); }

// fn(grp, lane) on ngroups groups of G2_GROUP threads: one block
template <class Fn> static void run_block(int ngroups, Fn fn) {
  std::vector<std::barrier<> *> grps;
  for (int g = 0; g < ngroups; g++)
    grps.push_back(new std::barrier<>(G2_GROUP));
  std::barrier<> blk(G2_GROUP * ngroups);
  std::vector<std::thread> th;
  for (int g = 0; g < ngroups; g++)
    for (int l = 0; l < G2_GROUP; l++)
      th.emplace_back([&, g, l] {
        g_grp = grps[g];
        g_blk = &blk;
        fn(g, l);
      });
  for (auto &t : th) t.join();
  for (auto *b : grps) delete b;
}

static void round_lanes(const uint32_t *p, const uint32_t *q,
                        uint32_t *out, int n) {
  std::vector<uint32_t> scr(G2_SCR_WORDS);
  run_block(1, [&](int, int lane) {
    for (int i = 0; i < n; i++)
      g2_add_group(out + i * G2_WORDS, p + i * G2_WORDS, q + i * G2_WORDS,
                   scr.data(), lane);
  });
}

// one block of the tree kernel: gather, then the levels over width lanes
static void tree_block(std::vector<uint32_t> &lanes, const uint32_t *in,
                       int n, int G, int g, int width, int ngroups) {
  std::vector<uint32_t> scr(ngroups * G2_SCR_WORDS);
  run_block(ngroups, [&](int grp, int lane) {
    if (in) {
      g2_tree_gather(lanes.data(), in, n, G, g, grp * G2_GROUP + lane,
                     ngroups * G2_GROUP);
      blk_sync();
    }
    g2_tree_levels(lanes.data(), width, scr.data() + grp * G2_SCR_WORDS, grp,
                   ngroups, lane);
  });
}

static void tree_lanes(const uint32_t *in, uint32_t *out, int n,
                       int ngroups) {
  int G = 1;
  while (G * G * 4 <= n) G *= 2;  // as g2_add.cu's tree_blocks
  const int L = n / G;
  std::vector<uint32_t> partials(G * G2_WORDS);
  for (int g = 0; g < G; g++) {
    std::vector<uint32_t> lanes(L * G2_WORDS);
    tree_block(lanes, in, n, G, g, L, ngroups);
    std::memcpy(&partials[g * G2_WORDS], lanes.data(), 4 * G2_WORDS);
  }
  tree_block(partials, nullptr, n, G, 0, G, ngroups);  // the last block
  std::memcpy(out, partials.data(), 4 * G2_WORDS);
}

extern "C" {

void h_fq_mul(const uint32_t *a, const uint32_t *b, uint32_t *out, int n) {
  for (int i = 0; i < n; i++) {
    fq x, y, r;
    std::memcpy(x.v, a + 12 * i, 48);
    std::memcpy(y.v, b + 12 * i, 48);
    fq_mul(r, x, y);
    std::memcpy(out + 12 * i, r.v, 48);
  }
}

// out = a + b, or a - b where neg is set
void h_fq_add_signed(const uint32_t *a, const uint32_t *b, int neg,
                     uint32_t *out, int n) {
  for (int i = 0; i < n; i++) {
    fq x, y, r;
    std::memcpy(x.v, a + 12 * i, 48);
    std::memcpy(y.v, b + 12 * i, 48);
    fq_add_signed(r, x, y, neg);
    std::memcpy(out + 12 * i, r.v, 48);
  }
}

void h_g2_round(const uint32_t *p, const uint32_t *q, uint32_t *out,
                int n) {
  round_lanes(p, q, out, n);
}

void h_g2_tree(int ngroups, const uint32_t *in, uint32_t *out, int n) {
  tree_lanes(in, out, n, ngroups);
}
}
"""


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host harness over csrc/*.cuh needs a C++ "
                    "compiler")
    out = tmp_path_factory.mktemp("bls_csrc_host")
    src = out / "harness.cpp"
    src.write_text(HARNESS)
    so = out / "harness.so"
    subprocess.run([gxx, "-O1", "-std=c++20", "-shared", "-fPIC",
                    "-pthread", "-I", str(CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    h.h_fq_mul.argtypes = [vp, vp, vp, i]
    h.h_fq_add_signed.argtypes = [vp, vp, i, vp, i]
    h.h_g2_round.argtypes = [vp, vp, vp, i]
    h.h_g2_tree.argtypes = [i, vp, vp, i]
    return h


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _edge_values(rng):
    r = pow(2, 384, P)
    under = [(2**384 - k) % P for k in (1, 2, 2**32, 2**64 + 1)]
    return ([0, 1, 2, P - 1, P - 2, r, P - r, (P + 1) // 2] + under
            + [int.from_bytes(rng.bytes(48), "little") % P
               for _ in range(48)])


def test_fq_mul_matches_plain_and_integers(lib):
    rng = np.random.default_rng(11)
    vals = _edge_values(rng)
    a_int = [x for x in vals for _ in vals]
    b_int = [y for _ in vals for y in vals]
    a = torch.from_numpy(G.fq_to_limbs(a_int))
    b = torch.from_numpy(G.fq_to_limbs(b_int))
    out = torch.empty_like(a)
    lib.h_fq_mul(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    assert torch.equal(out.view(torch.int32),
                       G.fq_mul_plain(a, b).view(torch.int32))
    assert G.fq_from_limbs(out) == [x * y % P for x, y in zip(a_int, b_int)]


def test_fq_add_signed_matches_integers(lib):
    rng = np.random.default_rng(12)
    vals = _edge_values(rng)
    a_int = [x for x in vals for _ in vals]
    b_int = [y for _ in vals for y in vals]
    a = torch.from_numpy(G.fq_to_limbs(a_int))
    b = torch.from_numpy(G.fq_to_limbs(b_int))
    for neg in (0, 1):
        out = torch.empty_like(a)
        lib.h_fq_add_signed(_ptr(a), _ptr(b), neg, _ptr(out), a.shape[0])
        sign = -1 if neg else 1
        assert G.fq_from_limbs(out) == [(x + sign * y) % P
                                        for x, y in zip(a_int, b_int)]
        # canonical: the limbs are those of the residue itself
        assert torch.equal(out.view(torch.int32), torch.from_numpy(
            G.fq_to_limbs(G.fq_from_limbs(out))).view(torch.int32))


@pytest.mark.parametrize("seed", [13, 15])
def test_group_addition_matches_plain_on_every_class(lib, seed):
    """Three cycles of the lane classes: two points, P at another Z, the
    doubling (also at another Z), the cancel, P, Q or both at infinity,
    and coordinates that are no curve point."""
    ps, qs, kinds = g2_lanes.lane_pairs(np.random.default_rng(seed), 27)
    assert set(kinds) == set(g2_lanes.CLASSES)
    p, q = G.to_lanes(ps), G.to_lanes(qs)
    out = torch.empty_like(p)
    lib.h_g2_round(_ptr(p), _ptr(q), _ptr(out), p.shape[0])
    want = G.g2_add_round_plain(p, q)
    bad = [kinds[i] for i in range(len(kinds))
           if not torch.equal(out[i].view(torch.int32),
                              want[i].view(torch.int32))]
    assert not bad


@pytest.mark.parametrize("ngroups", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 24])
def test_tree_blocks_match_plain_tree(lib, ngroups, n):
    """One group a block takes a level's additions one after another, two
    groups share them; either way the root is the plain tree's."""
    affs = g2_lanes.tree_points(np.random.default_rng(14), n)
    lanes = tvec._points_to_lanes(affs, torch.device("cpu"))
    out = torch.empty((1, *G.LANE_SHAPE), dtype=torch.uint32)
    lib.h_g2_tree(ngroups, _ptr(lanes), _ptr(out), lanes.shape[0])
    assert torch.equal(out.view(torch.int32),
                       G.tree_sum_plain(lanes).view(torch.int32))
