"""The port's default device.

Entry points run on the card. The default device is ``cuda``; it becomes
``cpu`` only through an explicit :func:`set_default_device` (the tests do
this). Without CUDA, and without that call, :func:`default_device` raises —
the port never falls back to the CPU quietly.
"""

from __future__ import annotations

import sys
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


#: attribute a counting site sets on a fault before re-raising it
#: (``crypto.breaker.count_device_error``)
_MARK = "_tmtpu_device_fault"
#: fault sites whose armed ``InjectedFault`` stands for a fault of the card
_DEVICE_SITE_PREFIX = "device."
_DEVICE_SITES = ("crypto.bls_verify",)


def mark_device_fault(e: BaseException) -> bool:
    """Mark ``e`` as a fault of the card; False when it was marked
    already (the caller then counts nothing)."""
    if getattr(e, _MARK, False):
        return False
    try:
        setattr(e, _MARK, True)
    except AttributeError:  # an exception type without a __dict__
        pass
    return True


def is_device_fault(e: BaseException) -> bool:
    """True when ``e`` is a fault of the card or its kernels, not a
    verdict about the data: :class:`KernelUnavailable`, the multi-device
    pool's ``AllLanesFailed``, the vote batcher's ``DeviceFlushTimeout``,
    an ``InjectedFault`` of a ``device.*`` or ``crypto.bls_verify`` site,
    or any exception a counting site marked before re-raising it. Code
    that turns exceptions into verdicts (an entry's outcome, a bad
    header, a struck peer) re-raises these instead."""
    if getattr(e, _MARK, False) or isinstance(e, KernelUnavailable):
        return True
    # a class of a module that is not loaded has no instance to test
    for mod, cls in (("crypto.ed25519_cuda.multidevice", "AllLanesFailed"),
                     ("crypto.vote_batcher", "DeviceFlushTimeout")):
        m = sys.modules.get(f"{__package__}.{mod}")
        if m is not None and isinstance(e, getattr(m, cls)):
            return True
    faults = sys.modules.get(f"{__package__}.libs.faults")
    if faults is not None and isinstance(e, faults.InjectedFault):
        return (e.site.startswith(_DEVICE_SITE_PREFIX)
                or e.site in _DEVICE_SITES)
    return False


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
