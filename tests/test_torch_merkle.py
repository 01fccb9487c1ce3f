"""The port's merkle fast path against the JAX package's, byte for byte.

Mirrors tests/test_merkle_fast.py: the SHA-256 kernel's plain PyTorch
version against hashlib and the JAX package's numpy and device routes,
tree roots and IncrementalMerkle over randomized op sequences, and the
MerkleKVStoreApplication app hash commit by commit. The port runs with
its device threshold lowered (levels of 16 messages or more), so a few
hundred leaves route through both of its tiers, hashlib and the device;
on the CPU the device tier runs the kernel's plain version. The JAX side
keeps its defaults (hashlib at these sizes), which its own tests hold
equal to its other routes. Every comparison is exact.
"""

import hashlib
import random

import jax
import numpy as np
import pytest
import torch

from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.example.kvstore import \
    MerkleKVStoreApplication as JMerkleApp
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.crypto import merkle_fast as jmf
from tendermint_tpu_torch import device
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.abci.example.kvstore import \
    MerkleKVStoreApplication as TMerkleApp
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.crypto import merkle_fast as tmf
from tendermint_tpu_torch.crypto.breaker import device_breaker as tbreaker
from tendermint_tpu_torch.crypto.merkle_cuda import build as tbuild
from tendermint_tpu_torch.crypto.merkle_cuda import sha256 as TS
from tendermint_tpu_torch.device import KernelUnavailable

# block-boundary edges: empty, 1, 55/56 (length spills into a second
# block), 63/64/65, 119 (last length of two blocks)
LENGTHS = [0, 1, 55, 56, 63, 64, 65, 119]


def _reset_port():
    tbreaker.reset()
    TS.reset_launches()
    for k in tmerkle.stats:
        tmerkle.stats[k] = 0


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    monkeypatch.delenv("TMTPU_MERKLE_FAST", raising=False)
    monkeypatch.delenv("TMTPU_MERKLE_DEVICE_MIN", raising=False)
    _reset_port()
    yield
    _reset_port()
    device.set_default_device(None)


@pytest.fixture
def port_tiers(monkeypatch):
    """A device threshold low enough that small trees reach both port
    tiers (the variable is read at call time, by both packages: set it
    only around port calls)."""
    def on():
        monkeypatch.setenv("TMTPU_MERKLE_DEVICE_MIN", "16")

    def off():
        monkeypatch.delenv("TMTPU_MERKLE_DEVICE_MIN")

    return on, off


def _msgs(n, length, seed):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, length, dtype=np.uint8))
            for _ in range(n)]


def _as_tensor(msgs):
    n, length = len(msgs), len(msgs[0])
    return torch.from_numpy(np.frombuffer(b"".join(msgs), dtype=np.uint8)
                            .reshape(n, length).copy())


@pytest.mark.parametrize("length", LENGTHS)
def test_sha256_plain_matches_hashlib_and_jax_numpy(length):
    msgs = _msgs(9, length, seed=length)
    want = [hashlib.sha256(m).digest() for m in msgs]
    raw = TS.sha256_many_plain(_as_tensor(msgs)).numpy().tobytes()
    assert [raw[32 * i:32 * i + 32] for i in range(9)] == want
    assert jmf.sha256_many_np(msgs) == want
    # the wrapper takes the plain version for a CPU tensor: no launch
    assert TS.sha256_many(_as_tensor(msgs)).numpy().tobytes() == raw
    assert tmf.sha256_many_device(msgs) == want
    assert TS.launches["sha256_many"] == 0


def test_sha256_plain_matches_jax_device_route():
    """The JAX package's device route (K9: ``_device_fn`` over
    ``_sha256_words`` in jax.numpy) on the CPU, at the shape
    tests/test_merkle_fast.py uses (64 messages of 65 bytes). It runs with
    jit disabled, op by op: the same traced function, without the whole-
    program XLA compile, which takes minutes on a CPU."""
    msgs = [bytes([i % 256]) * 65 for i in range(64)]
    with jax.disable_jit():
        want = jmf.sha256_many_device(msgs)
    assert want == [hashlib.sha256(m).digest() for m in msgs]
    assert tmf.sha256_many_device(msgs) == want


def test_sha256_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        TS.sha256_many(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        TS.sha256_many(torch.zeros((8, 4), dtype=torch.uint8).t())


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 16, 17, 64, 129, 300])
def test_fast_tree_matches_jax(port_tiers, n):
    items = [f"leaf-{i}".encode() * (1 + i % 4) for i in range(n)]
    want = jmerkle.fast_hash_from_byte_slices(items)
    assert want == jmerkle.hash_from_byte_slices(items)
    on, _ = port_tiers
    on()
    assert tmerkle.fast_hash_from_byte_slices(items) == want
    assert tmerkle.hash_from_byte_slices(items) == want
    if n == 300:  # 4 leaf lengths of 75; inner levels 150, 75, 37, ...
        assert tmerkle.stats["device"] and tmerkle.stats["hashlib"]


def test_merkle_fast_kill_switch(monkeypatch, port_tiers):
    items = [f"x{i}".encode() for i in range(40)]
    on, _ = port_tiers
    on()
    monkeypatch.setenv("TMTPU_MERKLE_FAST", "0")
    assert tmerkle.fast_hash_from_byte_slices(items) == \
        jmerkle.hash_from_byte_slices(items)
    assert tmerkle.stats["device"] == 0


def test_incremental_merkle_differential(port_tiers):
    """Random update/insert/delete schedule (tests/test_merkle_fast.py):
    the port's incremental root equals the JAX package's and the spec at
    every step."""
    rng = random.Random(7)
    state = {}
    jimt, timt = jmerkle.IncrementalMerkle(), tmerkle.IncrementalMerkle()
    on, off = port_tiers

    def leaf_item(k):
        return k.encode() + b"\x00" + state[k].encode()

    for step in range(120):
        dirty = set()
        for _ in range(rng.randrange(1, 6)):
            op = rng.random()
            k = f"k{rng.randrange(40)}"
            if op < 0.70 or not state:
                state[k] = f"v{step}-{rng.random()}"
                dirty.add(k)
            else:
                victim = rng.choice(sorted(state))
                del state[victim]
        keys = sorted(state)
        want = jimt.root(keys, leaf_item, set(dirty))
        on()
        got = timt.root(keys, leaf_item, set(dirty))
        off()
        assert got == want, f"incremental root diverged at step {step}"
        assert want == jmerkle.hash_from_byte_slices(
            [leaf_item(k) for k in keys])
    assert timt.patches > 0 and timt.rebuilds > 0
    assert (timt.patches, timt.rebuilds) == (jimt.patches, jimt.rebuilds)
    assert tmerkle.stats["device"] > 0


def test_incremental_merkle_patch_vs_rebuild_thresholds(port_tiers):
    state = {f"k{i:03d}": "v" for i in range(200)}
    imt = tmerkle.IncrementalMerkle()
    on, _ = port_tiers
    on()

    def leaf_item(k):
        return k.encode() + b"\x00" + state[k].encode()

    keys = sorted(state)
    imt.root(keys, leaf_item, None)
    rebuilds0 = imt.rebuilds
    state["k000"] = "v2"
    assert imt.root(keys, leaf_item, {"k000"}) == \
        jmerkle.hash_from_byte_slices([leaf_item(k) for k in keys])
    assert imt.patches == 1 and imt.rebuilds == rebuilds0
    big = {k for k in keys[:60]}
    for k in big:
        state[k] = "v3"
    assert imt.root(keys, leaf_item, big) == \
        jmerkle.hash_from_byte_slices([leaf_item(k) for k in keys])
    assert imt.rebuilds == rebuilds0 + 1


def test_incremental_merkle_empty_and_reset():
    imt = tmerkle.IncrementalMerkle()
    assert imt.root([], lambda k: b"", None) == \
        jmerkle.hash_from_byte_slices([])
    imt.reset()
    assert imt.root(["a"], lambda k: b"a=1", None) == \
        jmerkle.hash_from_byte_slices([b"a=1"])


def test_merkle_kvstore_app_matches_jax(monkeypatch, port_tiers):
    """Commit by commit, the port's app hash (incremental, both tiers)
    equals the JAX app's, and the port's kill switch (the recursive
    hashlib spec) gives the same bytes."""
    japp, tapp = JMerkleApp(interval=1), TMerkleApp(interval=1)
    spec = TMerkleApp(interval=1)
    on, off = port_tiers
    rng = random.Random(13)
    for h in range(1, 9):
        for i in range(rng.randrange(1, 30)):
            tx = f"k{rng.randrange(80)}=v{h}.{i}".encode()
            japp.deliver_tx(jabci.RequestDeliverTx(tx=tx))
            tapp.deliver_tx(tabci.RequestDeliverTx(tx=tx))
            spec.deliver_tx(tabci.RequestDeliverTx(tx=tx))
        want = japp.commit().data
        on()
        got = tapp.commit().data
        monkeypatch.setenv("TMTPU_MERKLE_FAST", "0")
        spec_hash = spec.commit().data
        monkeypatch.delenv("TMTPU_MERKLE_FAST")
        off()
        assert got == want == spec_hash, f"app hash diverged at height {h}"
    assert tapp.state == japp.state
    assert tmerkle.stats["device"] > 0


def test_missing_card_raises_at_the_caller(monkeypatch, port_tiers):
    """Default device cuda and no CUDA: the device tier raises
    KernelUnavailable at the caller; nothing is hashed on the host."""
    device.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    on, _ = port_tiers
    on()
    items = [f"leaf-{i:03d}".encode() for i in range(40)]
    with pytest.raises(KernelUnavailable, match="CUDA is not available"):
        tmerkle.fast_hash_from_byte_slices(items)
    assert tmerkle.stats["device"] == 0


def test_kernel_build_failure_raises_at_the_caller(monkeypatch, tmp_path,
                                                   port_tiers):
    """A SHA-256 kernel that does not build reaches the caller as
    KernelUnavailable: the level is not hashed on the host."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: cannot compile' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(tbuild.PACKAGE, "build_dir", tmp_path / "_build")
    monkeypatch.setattr(tbuild.PACKAGE, "libs", {})
    monkeypatch.setattr(tmf, "default_device",
                        lambda: torch.device("cuda", 0))
    on, _ = port_tiers
    on()
    with pytest.raises(KernelUnavailable, match="cannot compile"):
        tmerkle.fast_hash_from_byte_slices(
            [f"leaf-{i:03d}".encode() for i in range(40)])
    assert tmerkle.stats["device"] == 0


class _FaultAtFetch:
    """A kernel output whose device fault surfaces when it is fetched, as
    an asynchronous CUDA error does."""

    def cpu(self):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


@pytest.mark.parametrize("where", ["launch", "fetch"])
def test_running_kernel_fault_reaches_the_caller(monkeypatch, port_tiers,
                                                 where):
    """A fault of the running kernel, at its launch or surfacing at the
    fetch of its digests, reaches the caller: the level is not hashed on
    the host and the shared device breaker is left alone."""
    def broken(x):
        if where == "launch":
            raise RuntimeError("sha256_many: CUDA error 700 at launch")
        return _FaultAtFetch()

    monkeypatch.setattr(TS, "sha256_many", broken)
    on, _ = port_tiers
    on()
    items = [f"leaf-{i:03d}".encode() for i in range(40)]
    with pytest.raises(RuntimeError, match="CUDA error"):
        tmerkle.fast_hash_from_byte_slices(items)
    assert tmerkle.stats["device"] == 0
    assert tbreaker.state == "closed" and not tbreaker.stats


def test_open_device_breaker_does_not_move_merkle_to_the_host(port_tiers):
    """The shared device breaker, opened by verify faults, does not send
    the merkle device tier to the host: wide levels still take it."""
    while tbreaker.state != "open":
        tbreaker.record_failure()
    on, _ = port_tiers
    on()
    items = [f"leaf-{i:03d}".encode() for i in range(40)]
    assert tmerkle.fast_hash_from_byte_slices(items) == \
        jmerkle.hash_from_byte_slices(items)
    assert tmerkle.stats["device"] == 40 + 20
