"""The port's default device.

Entry points run on the card. The default device is ``cuda``; it becomes
``cpu`` only through an explicit :func:`set_default_device` (the tests do
this). Without CUDA, and without that call, :func:`default_device` raises —
the port never falls back to the CPU quietly.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

_lock = threading.Lock()
_default: Optional[torch.device] = None


class KernelUnavailable(RuntimeError):
    """The card or its kernels cannot be used at all: CUDA is absent while
    the default device is ``cuda``, or a kernel library does not build or
    load. Entry points let it reach the caller, as they do every fault of
    a running kernel: nothing is re-verified on the host."""


def set_default_device(dev: Union[str, torch.device, None]) -> None:
    """Pin the device entry points run on (``"cpu"``, ``"cuda"``,
    ``"cuda:1"``); ``None`` restores the ``cuda`` default."""
    global _default
    with _lock:
        _default = None if dev is None else torch.device(dev)


def default_device() -> torch.device:
    """The device entry points run on. Raises :class:`KernelUnavailable`
    when it is a CUDA device and CUDA is unavailable."""
    dev = _default
    if dev is None:
        dev = torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise KernelUnavailable(
                "CUDA is not available; call "
                "tendermint_tpu_torch.device.set_default_device('cpu') to "
                "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_label(dev: Optional[torch.device] = None) -> str:
    """Stable metric label of a device (``'cuda:0'``, ``'cpu:0'``) for the
    ``phases.Segment`` records."""
    dev = default_device() if dev is None else torch.device(dev)
    return f"{dev.type}:{dev.index or 0}"
