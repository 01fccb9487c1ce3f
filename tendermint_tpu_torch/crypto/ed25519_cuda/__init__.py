"""Batched Ed25519 verification on an NVIDIA Hopper card.

Counterpart of ``tendermint_tpu/crypto/ed25519_jax``. ``csrc/`` holds the
hand-written CUDA kernels (``ed25519_verify_dense``,
``ed25519_verify_sparse``, ``probe_sum_u8``, the sharded verify-and-tally
``ed25519_verify_tally`` and the device-profile stubs
``stub_verify_dense`` / ``stub_verify_sparse``); field.py, scalar.py,
sha512.py and curve.py are the plain PyTorch versions of the arithmetic
inside them; verify.py packs batches, wraps the kernels and holds the entry
points; sharded.py splits a batch over a mesh with an exact power tally;
multidevice.py shards a stream across device lanes; stub.py wraps the
stubs; build.py compiles the kernels at first use.
"""

from .verify import (  # noqa: F401
    batch_verify,
    batch_verify_stream,
    prepare_batch,
)
