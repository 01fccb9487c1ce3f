"""The port's SHA-512 (plain version of K3), mod-L reduction (K2) and
fixed-base table against the JAX package and the host spec, exactly."""

import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.ed25519 import L
from tendermint_tpu.crypto.ed25519_jax import curve as JC
from tendermint_tpu.crypto.ed25519_jax import scalar as JS
from tendermint_tpu.crypto.ed25519_jax import sha512 as JH
from tendermint_tpu_torch import device
from tendermint_tpu_torch.convert import base_table_from_reference
from tendermint_tpu_torch.crypto.ed25519_cuda import curve as TC
from tendermint_tpu_torch.crypto.ed25519_cuda import scalar as TS
from tendermint_tpu_torch.crypto.ed25519_cuda import sha512 as TH
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV


@pytest.fixture(autouse=True)
def _port_state():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


# preimage R || A || M crosses a block boundary at M = 48 and 176 bytes
MSG_LENS = (0, 47, 48, 175, 176, 400)


def _packed(seed):
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for n in MSG_LENS:
        pks.append(rng.integers(0, 256, 32, dtype=np.uint8).tobytes())
        msgs.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        sigs.append(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    blocks, nblk, _, _ = TV.prepare_batch(pks, msgs, sigs)
    want = [hashlib.sha512(s[:32] + p + m).digest()
            for p, m, s in zip(pks, msgs, sigs)]
    return blocks, nblk, want


def _digest_bytes(words: np.ndarray):
    """(16, n) BE u32 digest words -> n digests as bytes."""
    return [b"".join(int(w).to_bytes(4, "big") for w in words[:, i])
            for i in range(words.shape[1])]


def test_sha512_blocks_match_jax_and_hashlib():
    blocks, nblk, want = _packed(1)
    words = torch.from_numpy(blocks.astype(np.int64)).permute(1, 2, 0)
    got = TH.sha512_blocks(words, torch.from_numpy(nblk.astype(np.int64)))
    assert _digest_bytes(got.numpy()) == want
    jstate = jax.jit(JH.sha512_blocks)(
        jnp.asarray(np.ascontiguousarray(blocks.transpose(1, 2, 0))),
        jnp.asarray(nblk))
    assert _digest_bytes(np.asarray(jstate).reshape(16, -1)) == want
    # the challenge words the reduction reads
    le = TH.digest_le32(got).numpy()
    assert le.tolist() == np.asarray(JH.digest_le32(jstate)).tolist()


def test_sc_reduce_digits_matches_jax_and_ints():
    rng = random.Random(2)
    vals = [0, 1, L - 1, L, L + 1, 2**252, 2**253, 16 * L, 2**512 - 1,
            (2**512 - 1) // L * L - 1] + [rng.randrange(2**512)
                                          for _ in range(22)]
    words = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for v in vals]
                      for k in range(16)], dtype=np.uint32)
    got = TS.sc_reduce_digits(torch.from_numpy(words.astype(np.int64)))
    # eager: a jit compile of the unrolled JAX reduction costs ~20 s on a CPU
    jgot = np.asarray(JS.sc_reduce_digits(jnp.asarray(words)))
    assert got.numpy().tolist() == jgot.astype(np.int64).tolist()
    as_int = [sum(int(got[i, j]) << (4 * i) for i in range(64))
              for j in range(len(vals))]
    assert as_int == [v % L for v in vals]


def test_base_table_from_reference_matches_port_table():
    ref = JC._build_base_table()
    converted = base_table_from_reference(ref)
    assert converted.dtype == np.uint32
    assert np.array_equal(converted, TC.base_table_np())


def test_base_table_device_cache_is_int32_view():
    t = TC.base_table("cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (64, 16, 3, 10)
    assert np.array_equal(t.numpy().view(np.uint32), TC.base_table_np())
    assert TC.base_table("cpu") is t
