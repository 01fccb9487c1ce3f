"""The port's counterparts of the entry hooks in ``__graft_entry__.py``.

``entry()`` returns the main-path kernel's function, the dense verify
(``ed25519_verify_dense``, K5), with example arguments on the default
device. ``dryrun_multichip(n)`` runs the sharded verify-and-tally step
(crypto/ed25519_cuda/sharded.py, K8 on each shard) over an ``n``-device
mesh: 32 signatures with powers 1..32, then a commit-scale batch of 10,240
signatures, every 97th invalid, with powers of 2^40, so that the exact
tally is far above 2^31.

The mesh is the first ``n`` cards; the hook raises when there are fewer
(there is no CPU stand-in). A caller may pass its own ``mesh``, a list of
``torch.device`` (the tests pass CPU shards; ``[cuda:0] * 4`` shards over
one card), and a ``signer`` (``tools/commits.Signer``) whose worker
processes make the commit-scale keys and signatures.

    python -m tendermint_tpu_torch.entry            # entry() on the card
    python -m tendermint_tpu_torch.entry --multichip N
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

COMMIT_SCALE_SIGS = 10_240


def _example_sigs(n: int):
    """n deterministic (pk, msg, sig) tuples shared by both hooks."""
    from .crypto import ed25519 as ed

    pks, msgs, sigs = [], [], []
    for i in range(n):
        priv, pub = ed.keygen(i.to_bytes(2, "big") * 16)
        msg = b"vote-sign-bytes-%d" % i
        pks.append(pub)
        msgs.append(msg)
        sigs.append(ed.sign(priv, msg))
    return pks, msgs, sigs


def entry():
    """(fn, example_args): the dense verify kernel's wrapper and 64
    signatures packed for it on the default device."""
    from .crypto.ed25519_cuda import curve
    from .crypto.ed25519_cuda import verify as V
    from .device import default_device

    dev = default_device()
    blocks_w, nblk, s_words, _ok = V.prepare_batch(*_example_sigs(64))
    args = (*V._dense_args(blocks_w, nblk, s_words, dev),
            curve.base_table(dev))
    return V.verify_dense, args


def dryrun_multichip(n_devices: int, mesh: Optional[Sequence] = None,
                     signer=None) -> None:
    """Shard the verify + tally step over an ``n_devices`` mesh and run it
    at 32 signatures and at commit scale. Raises when the mesh cannot be
    built or a verdict or tally is wrong."""
    from .crypto.ed25519_cuda.sharded import batch_verify_sharded, make_mesh

    if mesh is None:
        mesh = make_mesh(n_devices)
    if len(mesh) != n_devices:
        raise ValueError(f"mesh of {len(mesh)} devices for a "
                         f"{n_devices}-device dryrun")
    n = 32
    pks, msgs, sigs = _example_sigs(n)
    powers = list(range(1, n + 1))
    verdict, total = batch_verify_sharded(pks, msgs, sigs, powers=powers,
                                          mesh=mesh)
    assert verdict.all(), f"multichip verify rejected valid sigs: {verdict}"
    assert total == sum(powers), f"tally {total} != {sum(powers)}"
    print(f"dryrun_multichip OK: {n} sigs verified over {n_devices}-device "
          f"mesh, tally = {total}", flush=True)
    _dryrun_commit_scale(mesh, n_devices, signer)


def commit_scale_batch(signer=None):
    """The commit-scale batch: 10,240 (pk, msg, sig) with every 97th
    signature's s zeroed, and the expected verdicts. The keys are the JAX
    hook's (seeds from numpy's default_rng(11))."""
    from .crypto import ed25519 as ed

    n = COMMIT_SCALE_SIGS
    rng = np.random.default_rng(11)
    seeds = [bytes(s) for s in rng.integers(0, 256, (n, 32), dtype=np.uint8)]
    msgs = [b"commit-scale-vote-%06d" % i for i in range(n)]
    if signer is not None:
        pks = signer.pubkeys(seeds)
        sigs = signer.sign(list(zip(seeds, msgs)))
    else:
        keys = [ed.keygen(s) for s in seeds]
        pks = [pub for _, pub in keys]
        sigs = [ed.sign(priv, m) for (priv, _), m in zip(keys, msgs)]
    expect = np.ones(n, dtype=bool)
    for i in range(0, n, 97):  # invalid signatures through every shard
        sigs[i] = sigs[i][:32] + bytes(32)
        expect[i] = False
    return pks, msgs, sigs, expect


def _dryrun_commit_scale(mesh, n_devices: int, signer=None) -> None:
    from .crypto.ed25519_cuda.sharded import batch_verify_sharded

    pks, msgs, sigs, expect = commit_scale_batch(signer)
    powers = [1 << 40] * len(pks)  # the exact tally is far above 2^31
    verdict, total = batch_verify_sharded(pks, msgs, sigs, powers=powers,
                                          mesh=mesh)
    assert (verdict == expect).all(), (
        f"commit-scale verdicts diverged at "
        f"{np.nonzero(verdict != expect)[0][:8]}")
    want = int(expect.sum()) << 40
    assert total == want, f"exact tally {total} != {want}"
    print(f"dryrun_multichip commit-scale OK: {len(pks)} sigs "
          f"({len(pks) - int(expect.sum())} invalid) over {n_devices}-device "
          f"mesh, exact tally = {total} (~2^{total.bit_length() - 1})",
          flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--multichip":
        dryrun_multichip(int(sys.argv[2]))
    else:
        fn, args = entry()
        out = fn(*args)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        print("entry() check:", bool(out.all()))
