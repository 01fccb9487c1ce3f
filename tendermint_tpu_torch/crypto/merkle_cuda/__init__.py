"""Batched SHA-256 on an NVIDIA Hopper card, for the merkle app hash.

Counterpart of the device route of ``tendermint_tpu/crypto/merkle_fast.py``
(its jitted ``_device_fn``, K9). ``csrc/sha256.cu`` holds the hand-written
kernel ``sha256_many``; sha256.py wraps it and holds its plain PyTorch
version; build.py compiles it at first use.
"""

from .sha256 import sha256_many, sha256_many_plain  # noqa: F401
