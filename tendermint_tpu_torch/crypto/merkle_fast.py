"""Batched SHA-256 for the merkle fast path (crypto/merkle.py).

App-hash merkle trees hash many short fixed-length messages per commit —
inner nodes are always 65 bytes (0x01 || left32 || right32), leaf items of
one kvstore level mostly share a length — so a whole tree level is one
batch of equal-length messages. The messages go to the card as they are,
one (n, L) byte tensor, and the hand-written kernel ``sha256_many``
(merkle_cuda/, K9) pads and hashes each one in its own thread
(:func:`sha256_many_device`), byte-identical to hashlib. With the default
device pinned to the CPU the same call runs the kernel's plain PyTorch
version.

crypto/merkle.py routes between hashlib and the device and owns the
threshold policy.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import default_device
from .merkle_cuda import build
from .merkle_cuda import sha256 as kernel


def _digests(raw: bytes, n: int) -> List[bytes]:
    return [raw[i * 32:(i + 1) * 32] for i in range(n)]


def device() -> torch.device:
    """The default device, with the SHA-256 kernel built and loaded when it
    is the card. Raises :class:`~tendermint_tpu_torch.device.KernelUnavailable`
    when CUDA is absent (and the CPU was not asked for) or the kernel does
    not build or load."""
    dev = default_device()
    if dev.type == "cuda":
        build.PACKAGE.library("sha256")
    return dev


def sha256_many_device(msgs: List[bytes],
                       dev: Optional[torch.device] = None) -> List[bytes]:
    """One join, one pinned upload of the raw (n, L) bytes, the kernel, one
    fetch of the (n, 32) digests. All messages must share one length. Every
    device error, at launch or surfacing at the fetch, reaches the
    caller."""
    dev = device() if dev is None else dev
    n, length = len(msgs), len(msgs[0])
    raw = np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(n, length)
    if dev.type == "cuda":
        host = torch.empty((n, length), dtype=torch.uint8, pin_memory=True)
        host.numpy()[:] = raw
        x = host.to(dev, non_blocking=True)
    else:
        x = torch.from_numpy(raw.copy())
    out = kernel.sha256_many(x)
    return _digests(out.cpu().numpy().tobytes(), n)
