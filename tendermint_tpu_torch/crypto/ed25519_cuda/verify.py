"""Batched Ed25519 verification on the card: host packing, the kernel
wrappers and their plain PyTorch versions, and the entry points.

Counterpart of ``tendermint_tpu/crypto/ed25519_jax/verify.py``. The split
of work is the same:

* host (numpy, no per-item Python crypto): length checks, the s < L
  compare, and packing of the SHA-512 preimage R || A || M (padded) plus
  the 32-byte s — dense blocks (:func:`prepare_batch`), or the sparse wire
  format of a per-chunk template plus the differing columns
  (:func:`prepare_sparse_stream`);
* device: SHA-512, the reduction mod L, decompression of A, [s]B +
  [h](-A), the encoding and the compare with R. ``csrc/verify.cu`` runs a
  group of four lanes per signature (``ed25519_verify_dense`` for K5/K6,
  ``ed25519_verify_sparse`` for K7); ``csrc/tally.cu`` the same for
  ``ed25519_verify_tally`` (K8, the dense verify plus the masked sum of
  each accepted signature's 8-bit power limbs, for sharded.py).

The verdict is ``kernel & ok``, where ``ok`` is the host mask, exactly as
in the JAX package. Arrays are item-major here (one row per signature):
a thread reads its own row, where the TPU wanted items on the 128-lane
axis.

Each wrapper takes the plain PyTorch version only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from . import curve
from . import scalar as S
from . import sha512 as H
from .. import phases
from ..ed25519 import L
from ...device import default_device, device_label

# L as 4 little-endian u64 words, for the vectorized s < L compare
_L_WORDS = np.frombuffer(L.to_bytes(32, "little"), dtype="<u8").copy()

#: launches of each kernel by its wrapper (plain-version calls excluded)
launches = {"ed25519_verify_dense": 0, "ed25519_verify_sparse": 0,
            "ed25519_verify_tally": 0, "probe_sum_u8": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        launches[name] += 1


# --- kernel wrappers --------------------------------------------------------

def _check(t: torch.Tensor, what: str, dtype, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _same_device(ts, what: str) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: inputs on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _launch_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _stream_ptr(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on_device(device: Optional[torch.device], stream=None):
    """A context in which ``device`` (a card) is the calling thread's
    current device and ``stream`` its current stream. The CUDA runtime
    launches on the current device, so a launch on another card's stream,
    and an upload meant for it, must make that card current first."""
    ctx = contextlib.ExitStack()
    if device is not None and device.type == "cuda":
        ctx.enter_context(torch.cuda.device(device))
    if stream is not None:
        ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def verify_dense(blocks: torch.Tensor, nblk: torch.Tensor,
                 s_words: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K5/K6: blocks (n, NBLK, 32) int32 (big-endian u32 words of each
    preimage, :func:`prepare_batch`), nblk (n,) int32, s_words (n, 8) int32
    (little-endian u32 words of s), table (64, 16, 3, 10) int32 -> (n,)
    bool kernel verdicts."""
    n = blocks.shape[0] if blocks.dim() == 3 else -1
    nb = blocks.shape[1] if blocks.dim() == 3 else -1
    _check(blocks, "blocks", torch.int32, (n, nb, 32))
    _check(nblk, "nblk", torch.int32, (n,))
    _check(s_words, "s_words", torch.int32, (n, 8))
    _check(table, "table", torch.int32, (64, 16, 3, 10))
    if nb < 1:
        raise ValueError("blocks: each row needs at least one 128-byte "
                         "block (R and A are read from the first)")
    dev = _same_device([blocks, nblk, s_words, table], "ed25519_verify_dense")
    if dev.type == "cpu":
        return verify_dense_plain(blocks, nblk, s_words, table)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = build.PACKAGE.library("verify")
    with _on_device(dev):
        rc = lib.tm_ed25519_verify_dense(
            blocks.data_ptr(), nblk.data_ptr(), s_words.data_ptr(),
            table.data_ptr(), out.data_ptr(), n, nb, _stream_ptr(dev))
    _launch_check(rc, "ed25519_verify_dense")
    _count("ed25519_verify_dense")
    return out.view(torch.bool)


def verify_sparse(templates: torch.Tensor, cols: torch.Tensor,
                  diff_vals: torch.Tensor, mlen: torch.Tensor,
                  r: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                  chunk: int, table: torch.Tensor) -> torch.Tensor:
    """K7: templates (K, MLEN) uint8 (one per chunk of ``chunk`` items),
    cols (C,) int32, diff_vals (n, C) uint8, mlen (n,) int32, r/a/s (n, 32)
    uint8, table (64, 16, 3, 10) int32 -> (n,) bool kernel verdicts."""
    n = mlen.shape[0] if mlen.dim() == 1 else -1
    k_tpl = -(-n // chunk) if chunk > 0 else -1
    mlen_max = templates.shape[1] if templates.dim() == 2 else -1
    c = cols.shape[0] if cols.dim() == 1 else -1
    _check(templates, "templates", torch.uint8, (k_tpl, mlen_max))
    _check(cols, "cols", torch.int32, (c,))
    _check(diff_vals, "diff_vals", torch.uint8, (n, c))
    _check(mlen, "mlen", torch.int32, (n,))
    for name, t in (("r", r), ("a", a), ("s", s)):
        _check(t, name, torch.uint8, (n, 32))
    _check(table, "table", torch.int32, (64, 16, 3, 10))
    if (mlen_max + 64) % 128:
        raise ValueError(f"templates: width {mlen_max} + 64 is not a "
                         "whole number of 128-byte blocks")
    dev = _same_device([templates, cols, diff_vals, mlen, r, a, s, table],
                       "ed25519_verify_sparse")
    if dev.type == "cpu":
        return verify_sparse_plain(templates, cols, diff_vals, mlen, r, a, s,
                                   chunk, table)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = build.PACKAGE.library("verify")
    with _on_device(dev):
        rc = lib.tm_ed25519_verify_sparse(
            templates.data_ptr(), mlen_max, cols.data_ptr(), c,
            diff_vals.data_ptr(), mlen.data_ptr(), r.data_ptr(),
            a.data_ptr(), s.data_ptr(), chunk, table.data_ptr(),
            out.data_ptr(), n, _stream_ptr(dev))
    _launch_check(rc, "ed25519_verify_sparse")
    _count("ed25519_verify_sparse")
    return out.view(torch.bool)


def verify_tally(blocks: torch.Tensor, nblk: torch.Tensor,
                 s_words: torch.Tensor, limbs: torch.Tensor,
                 table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: :func:`verify_dense`'s inputs plus limbs (n, 8) int32, the 8-bit
    limbs of each item's power (sharded._power_limbs) -> ((n,) bool kernel
    verdicts, (8,) int64 per-limb sums over the items whose verdict is
    true)."""
    n = blocks.shape[0] if blocks.dim() == 3 else -1
    nb = blocks.shape[1] if blocks.dim() == 3 else -1
    _check(blocks, "blocks", torch.int32, (n, nb, 32))
    _check(nblk, "nblk", torch.int32, (n,))
    _check(s_words, "s_words", torch.int32, (n, 8))
    _check(limbs, "limbs", torch.int32, (n, 8))
    _check(table, "table", torch.int32, (64, 16, 3, 10))
    if nb < 1:
        raise ValueError("blocks: each row needs at least one 128-byte "
                         "block (R and A are read from the first)")
    dev = _same_device([blocks, nblk, s_words, limbs, table],
                       "ed25519_verify_tally")
    if dev.type == "cpu":
        return verify_tally_plain(blocks, nblk, s_words, limbs, table)
    lib = build.PACKAGE.library("tally")
    with _on_device(dev):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        # zeroed on the stream the kernel's atomics then run on
        sums = torch.zeros(8, dtype=torch.int64, device=dev)
        rc = lib.tm_ed25519_verify_tally(
            blocks.data_ptr(), nblk.data_ptr(), s_words.data_ptr(),
            limbs.data_ptr(), table.data_ptr(), out.data_ptr(),
            sums.data_ptr(), n, nb, _stream_ptr(dev))
    _launch_check(rc, "ed25519_verify_tally")
    _count("ed25519_verify_tally")
    return out.view(torch.bool), sums


#: blocks a multiprocessor of the probe's grid, at most
PROBE_BLOCKS_PER_SM = 4
# (device index, stream) -> the probe's partials and finished-block
# counter: one launch at a time on a stream, so launches there share them
_PROBE_WORKSPACE = {}
_PROBE_LOCK = threading.Lock()


def _probe_workspace(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    ws = _PROBE_WORKSPACE.get(key)
    if ws is None:
        with _PROBE_LOCK:
            ws = _PROBE_WORKSPACE.get(key)
            if ws is None:
                ws = torch.zeros(_probe_cap(dev) + 1, dtype=torch.int32,
                                 device=dev)
                _PROBE_WORKSPACE[key] = ws
    return ws


def _probe_cap(dev: torch.device) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * PROBE_BLOCKS_PER_SM


def probe_sum(x: torch.Tensor) -> torch.Tensor:
    """K11: the int32 sum of a uint8 tensor, as a (1,) int32 tensor."""
    if x.dtype != torch.uint8 or not x.is_contiguous():
        raise TypeError("probe_sum: expected a contiguous uint8 tensor")
    dev = _same_device([x], "probe_sum_u8")
    if dev.type == "cpu":
        return probe_sum_plain(x)
    lib = build.PACKAGE.library("probe")
    with _on_device(dev):
        out = torch.empty(1, dtype=torch.int32, device=dev)
        stream = _stream_ptr(dev)
        ws = _probe_workspace(dev, stream)
        rc = lib.tm_probe_sum_u8(x.data_ptr(), x.numel(), out.data_ptr(),
                                 ws.data_ptr(), ws.numel() - 1, stream)
    _launch_check(rc, "probe_sum_u8")
    _count("probe_sum_u8")
    return out


def probe_blocks(nbytes: int, device: Optional[torch.device] = None) -> int:
    """The number of blocks :func:`probe_sum` launches over ``nbytes``
    bytes on ``device`` (the current card by default): one up to 32 KB,
    more than one from 64 KB up."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else device
    return build.PACKAGE.library("probe").tm_probe_blocks(nbytes,
                                                          _probe_cap(dev))


# --- plain PyTorch versions ------------------------------------------------

M32 = 0xFFFFFFFF


def probe_sum_plain(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).sum(dtype=torch.int32).reshape(1)


def verify_tally_plain(blocks: torch.Tensor, nblk: torch.Tensor,
                       s_words: torch.Tensor, limbs: torch.Tensor,
                       table: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The plain version of :func:`verify_tally`, on any device."""
    verdict = verify_dense_plain(blocks, nblk, s_words, table)
    masked = torch.where(verdict.unsqueeze(1), limbs.to(torch.int64), 0)
    return verdict, masked.sum(0, dtype=torch.int64)


def _be_words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """(8, *batch) int64 big-endian u32 words -> (32, *batch) bytes."""
    return torch.stack([(w[i // 4] >> (24 - 8 * (i % 4))) & 0xFF
                        for i in range(32)])


def _verify_words_plain(words: torch.Tensor, nblk: torch.Tensor,
                        s_bytes: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """words (NBLK, 32, n) int64 BE u32 preimage words, nblk (n,) int64,
    s_bytes (32, n) int64 -> (n,) bool. R and A are read back out of the
    first block, as the kernel does."""
    r_bytes = _be_words_to_bytes(words[0, 0:8])
    a_bytes = _be_words_to_bytes(words[0, 8:16])
    digest = H.sha512_blocks(words, nblk)
    h_digits = S.sc_reduce_digits(H.digest_le32(digest))
    s_digits = torch.stack([(s_bytes[i // 2] >> (4 * (i % 2))) & 15
                            for i in range(64)])
    A, ok_a = curve.decompress(a_bytes)
    # failed decompressions are off the curve, where the addition law's
    # z != 0 guarantee does not hold: mask them to the identity (their
    # verdict is already false)
    ident = curve.identity(A.x)
    A = curve.Point(*(torch.where(ok_a, c, ic) for c, ic in zip(A, ident)))
    h_neg_a = curve.scalar_mul_windowed(curve.neg(A), h_digits)
    s_b = curve.scalar_mul_base(s_digits, table)
    enc = curve.encode(curve.add(s_b, h_neg_a))
    return ok_a & (enc == r_bytes).all(dim=0)


def verify_dense_plain(blocks: torch.Tensor, nblk: torch.Tensor,
                       s_words: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`verify_dense`, on any device."""
    if blocks.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=blocks.device)
    words = (blocks.to(torch.int64) & M32).permute(1, 2, 0)
    sw = (s_words.to(torch.int64) & M32).T
    s_bytes = torch.stack([(sw[i // 4] >> (8 * (i % 4))) & 0xFF
                           for i in range(32)])
    return _verify_words_plain(words, nblk.to(torch.int64), s_bytes, table)


def assemble_blocks_plain(templates: torch.Tensor, cols: torch.Tensor,
                          diff_vals: torch.Tensor, mlen: torch.Tensor,
                          r: torch.Tensor, a: torch.Tensor, chunk: int):
    """K7's preimage assembly in plain PyTorch: -> (words (n, NBLK, 32)
    int64 BE u32 words, nblk (n,) int64), byte-identical to
    :func:`prepare_batch` (and to the JAX ``_assemble_blocks``). Write
    order: template, diff values, zero from mlen on, 0x80, bit length."""
    n = mlen.shape[0]
    mlen_max = templates.shape[1]
    dev = templates.device
    item_chunk = torch.arange(n, device=dev) // chunk
    m = templates.to(torch.int64)[item_chunk]                 # (n, MLEN)
    if cols.shape[0]:
        m[:, cols.to(torch.int64)] = diff_vals.to(torch.int64)
    ml = mlen.to(torch.int64).unsqueeze(1)
    iota = torch.arange(mlen_max, device=dev).unsqueeze(0)
    m = torch.where(iota < ml, m, torch.zeros_like(m))
    m = torch.where(iota == ml, torch.full_like(m, 0x80), m)
    bitlen = (ml + 64) * 8
    nblk = (64 + ml + 17 + 127) // 128
    last = nblk * 128 - 64   # end of the item's last block, message coords
    for k in range(8):
        m = torch.where(iota == last - 1 - k, (bitlen >> (8 * k)) & 0xFF, m)
    full = torch.cat([r.to(torch.int64), a.to(torch.int64), m], dim=1)
    b = full.reshape(n, -1, 32, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return words, nblk.squeeze(1)


def verify_sparse_plain(templates, cols, diff_vals, mlen, r, a, s, chunk,
                        table) -> torch.Tensor:
    """The plain version of :func:`verify_sparse`, on any device."""
    if mlen.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=mlen.device)
    words, nblk = assemble_blocks_plain(templates, cols, diff_vals, mlen, r,
                                        a, chunk)
    return _verify_words_plain(words.permute(1, 2, 0), nblk,
                               s.to(torch.int64).T, table)


# --- host packing -----------------------------------------------------------

# sparse path pays off when the union of differing message columns is small;
# beyond this, dense blocks transfer less
MAX_SPARSE_COLS = 96


def _c_pad_bucket(c: int) -> int:
    """Diff-column count padded to a bucket (the JAX package's ladder, so
    both packages pack a batch into the same arrays)."""
    return next(cp for cp in (4, 8, 16, 32, 64, MAX_SPARSE_COLS)
                if cp >= max(c, 1))


# content-addressed device residency for the pubkey plane: commit
# verification reuses the SAME validator keys for every block, so the
# (n, 32) key array is uploaded once and referenced by hash afterwards.
# Keyed per device; least recently used out first.
_PK_DEVICE_CACHE: "OrderedDict" = OrderedDict()
_PK_CACHE_MAX = 32
_PK_CACHE_LOCK = threading.Lock()


def _device_cached(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (hashlib.sha256(arr.tobytes()).digest(), arr.shape,
           str(arr.dtype), str(device))
    with _PK_CACHE_LOCK:
        buf = _PK_DEVICE_CACHE.get(key)
        if buf is not None:
            _PK_DEVICE_CACHE.move_to_end(key)
        else:
            if len(_PK_DEVICE_CACHE) >= _PK_CACHE_MAX:
                _PK_DEVICE_CACHE.popitem(last=False)
            buf = torch.from_numpy(np.array(arr)).to(device)
            if buf.is_cuda:
                # other segments' streams read this copy: finish it first
                torch.cuda.current_stream(device).synchronize()
            _PK_DEVICE_CACHE[key] = buf
        if buf.is_cuda:
            # the caller's stream reads it: once evicted and freed, its
            # memory must not be handed out before that stream's work ends
            buf.record_stream(torch.cuda.current_stream(device))
        return buf


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array onto ``device``: through pinned memory, asynchronously
    on the current stream, for the card; as is for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _as_i32(arr: np.ndarray) -> np.ndarray:
    """u32 words reinterpreted as int32 (torch has no uint32 arithmetic)."""
    return np.ascontiguousarray(arr).view(np.int32)


def _sig_pk_arrays(pks, sigs):
    """Shared host plumbing of the dense and sparse packers: length checks,
    zero-substitution for malformed rows, the vectorized s < L compare.
    Returns (r_arr (n,32), s_arr (n,32), pk_arr (n,32), ok (n,))."""
    n = len(pks)
    pk_lens = np.array(list(map(len, pks)), dtype=np.int64)
    sig_lens = np.array(list(map(len, sigs)), dtype=np.int64)
    ok = (pk_lens == 32) & (sig_lens == 64)
    if ok.all():
        pk_l, sig_l = pks, sigs
    else:
        zpk, zsig = b"\x00" * 32, b"\x00" * 64
        pk_l = [pk if o else zpk for pk, o in zip(pks, ok)]
        sig_l = [sg if o else zsig for sg, o in zip(sigs, ok)]
    sig_arr = np.frombuffer(b"".join(sig_l), dtype=np.uint8).reshape(n, 64)
    r_arr = np.ascontiguousarray(sig_arr[:, :32])
    s_arr = np.ascontiguousarray(sig_arr[:, 32:])
    pk_arr = np.frombuffer(b"".join(pk_l), dtype=np.uint8).reshape(n, 32)
    ok &= _s_lt_l(s_arr)
    return r_arr, s_arr, pk_arr, ok


def _sparse_from_rows(msgs, chunk: int):
    """Discover the sparse structure of a row-materialized batch: join the
    rows into one matrix and diff-scan against per-chunk templates (each
    chunk's first row).

    Returns (templates (k, MLEN) cols-zeroed, cols (C,), diff_vals (pad, C),
    mlens (n,), k, pad) or None when the rows are too dissimilar."""
    n = len(msgs)
    mlens = np.array(list(map(len, msgs)), dtype=np.int64)
    bucket = _nblk_bucket(int(mlens.max()))
    mlen_max = bucket * 128 - 64
    k = -(-n // chunk)
    pad = k * chunk
    arr = np.zeros((pad, mlen_max), dtype=np.uint8)
    if n and mlens.max() == mlens.min():
        ml = int(mlens[0])
        if ml:
            arr[:n, :ml] = np.frombuffer(
                b"".join(msgs), dtype=np.uint8).reshape(n, ml)
    else:
        flat_src = np.frombuffer(b"".join(msgs), dtype=np.uint8)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(mlens[:-1], out=starts[1:])
        within = (np.arange(flat_src.shape[0], dtype=np.int64)
                  - np.repeat(starts, mlens))
        dst = np.repeat(np.arange(n, dtype=np.int64) * mlen_max, mlens) + within
        arr.reshape(-1)[dst] = flat_src
    templates = arr[::chunk].copy()                      # (k, MLEN)
    if pad > n:  # padded rows mirror their template: no diff contribution
        arr[n:] = templates[-1]
    tiled = np.repeat(templates, chunk, axis=0)          # (pad, MLEN)
    diff = (arr != tiled).any(axis=0)
    cols = np.nonzero(diff)[0].astype(np.int32)
    if cols.shape[0] > MAX_SPARSE_COLS:
        return None
    templates[:, cols] = 0  # diff columns are fully per-item
    # padding duplicates column 0 (same value rewritten — harmless)
    c_pad = _c_pad_bucket(cols.shape[0])
    if c_pad > cols.shape[0]:
        cols = np.concatenate(
            [cols, np.zeros(c_pad - cols.shape[0], np.int32)])
    diff_vals = np.ascontiguousarray(arr[:, cols])       # (pad, C)
    return templates, cols, diff_vals, mlens, k, pad


def _sparse_from_columns(columns, chunk: int):
    """The zero-copy fast path: the caller (a VerifyCommit* plane) already
    knows the batch's columnar structure (crypto/signcols.SignColumns), so
    templates and diff values are sliced straight from the columns object.
    Same return contract as :func:`_sparse_from_rows`."""
    n = len(columns)
    base_cols = columns.cols
    if base_cols.shape[0] > MAX_SPARSE_COLS:
        return None
    bucket = _nblk_bucket(columns.mlen)
    mlen_max = bucket * 128 - 64
    k = -(-n // chunk)
    pad = k * chunk
    template = np.zeros(mlen_max, dtype=np.uint8)
    template[:columns.mlen] = columns.template
    c = base_cols.shape[0]
    c_pad = _c_pad_bucket(c)
    # duplicated pad columns repeat the first diff column (or column 0 for
    # an all-identical batch) with the SAME value per row, so scatter write
    # order cannot matter
    pad_col = int(base_cols[0]) if c else 0
    cols = np.full(c_pad, pad_col, dtype=np.int32)
    cols[:c] = base_cols
    orig_at_cols = template[cols].copy()  # pre-zeroing template bytes
    diff_vals = np.empty((pad, c_pad), dtype=np.uint8)
    if c:
        diff_vals[:n, :c] = columns.vals
        diff_vals[:n, c:] = columns.vals[:, :1]
    else:
        diff_vals[:n] = orig_at_cols
    diff_vals[n:] = orig_at_cols  # padded rows mirror the template
    template[cols] = 0
    templates = np.repeat(template[None, :], k, axis=0)
    mlens = np.full(n, columns.mlen, dtype=np.int64)
    return templates, cols, diff_vals, mlens, k, pad


def pack_sparse(pks, msgs, sigs, chunk: int, columns=None):
    """Host half of :func:`prepare_sparse_stream`: the sparse wire format as
    numpy arrays, or None when the messages are too dissimilar for it.

    Returns (templates (k, MLEN) u8, cols (C,) i32, diff_vals (pad, C) u8,
    mlen (pad,) i32, r (pad, 32) u8, a (pad, 32) u8, s (pad, 32) u8, ok
    (n,)). Padded rows carry mlen 0 and all-zero R, A and s."""
    n = len(pks)
    built = None
    if columns is not None and len(columns) == n:
        built = _sparse_from_columns(columns, chunk)
    if built is None:
        built = _sparse_from_rows(msgs, chunk)
    if built is None:
        return None
    templates, cols, diff_vals, mlens, k, pad = built
    r_arr, s_arr, pk_arr, ok = _sig_pk_arrays(pks, sigs)
    if pad > n:
        r_arr = np.pad(r_arr, ((0, pad - n), (0, 0)))
        pk_arr = np.pad(pk_arr, ((0, pad - n), (0, 0)))
        s_arr = np.pad(s_arr, ((0, pad - n), (0, 0)))
        mlens = np.pad(mlens, (0, pad - n))
    return (templates, cols, diff_vals, mlens.astype(np.int32), r_arr,
            pk_arr, s_arr, ok)


def prepare_sparse_stream(pks, msgs, sigs, chunk: int, columns=None,
                          device: Optional[torch.device] = None):
    """Pack a same-bucket batch into the sparse wire format on ``device``,
    or return None when the messages are too dissimilar for it to pay.

    ``columns`` (crypto/signcols.SignColumns, aligned 1:1 with the batch)
    short-circuits structure discovery. Returns (args for
    :func:`verify_sparse` without ``chunk`` and the table, ok mask)."""
    packed = pack_sparse(pks, msgs, sigs, chunk, columns=columns)
    if packed is None:
        return None
    templates, cols, diff_vals, mlens, r_arr, pk_arr, s_arr, ok = packed
    dev = default_device() if device is None else device
    args = (_upload(templates, dev), _upload(cols, dev),
            _upload(diff_vals, dev), _upload(mlens, dev),
            _upload(r_arr, dev), _device_cached(pk_arr, dev),
            _upload(s_arr, dev))
    return args, ok


def _s_lt_l(s_arr: np.ndarray) -> np.ndarray:
    """(n, 32) u8 LE scalars -> (n,) bool s < L (vectorized lexicographic)."""
    s64 = s_arr.view("<u8")
    n = s_arr.shape[0]
    lt = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    for w in (3, 2, 1, 0):
        lw = _L_WORDS[w]
        lt |= ~decided & (s64[:, w] < lw)
        decided |= s64[:, w] != lw
    return lt


def prepare_batch(
    pks: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes],
    rows: Optional[int] = None, min_nblk: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack (pk, msg, sig) tuples into kernel inputs + host validity mask.

    Returns (blocks (R, NBLK, 32) u32 BE, nblk (R,) i32, s_words (R, 8) u32,
    ok (N,) bool), all numpy. ``rows`` (>= n) adds padded zero rows (their
    nblk is 0) and ``min_nblk`` widens the block axis to a chosen bucket.
    """
    if not (len(pks) == len(msgs) == len(sigs)):
        raise ValueError(
            f"batch length mismatch: {len(pks)} pks, {len(msgs)} msgs, {len(sigs)} sigs"
        )
    n = len(pks)
    if n == 0:
        return (np.zeros((0, 1, 32), np.uint32), np.zeros(0, np.int32),
                np.zeros((0, 8), np.uint32), np.zeros(0, bool))
    out_rows = n if rows is None else rows
    r_arr, s_arr, pk_arr, ok = _sig_pk_arrays(pks, sigs)

    # SHA-512 preimage blocks: R || A || M || 0x80 pad || 128-bit BE bitlen
    mlens = np.array(list(map(len, msgs)), dtype=np.int64)
    nblk = ((64 + mlens + 17 + 127) // 128).astype(np.int32)
    nblk_max = int(nblk.max())
    if min_nblk is not None and min_nblk > nblk_max:
        nblk_max = min_nblk
    blocks = np.zeros((out_rows, nblk_max * 128), dtype=np.uint8)
    blocks[:n, :32] = r_arr
    blocks[:n, 32:64] = pk_arr
    if n and mlens.max() == mlens.min():
        ml = int(mlens[0])
        if ml:
            blocks[:n, 64:64 + ml] = np.frombuffer(
                b"".join(msgs), dtype=np.uint8).reshape(n, ml)
    elif int(mlens.sum()):
        # vectorized ragged scatter: flat destination index for every
        # message byte, built from cumulative offsets
        flat_src = np.frombuffer(b"".join(msgs), dtype=np.uint8)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(mlens[:-1], out=starts[1:])
        width = blocks.shape[1]
        within = np.arange(flat_src.shape[0], dtype=np.int64) - np.repeat(starts, mlens)
        dst = np.repeat(np.arange(n, dtype=np.int64) * width + 64, mlens) + within
        blocks.reshape(-1)[dst] = flat_src
    rows_idx = np.arange(n)
    blocks[rows_idx, 64 + mlens] = 0x80
    bitlen = ((64 + mlens) * 8).astype(np.uint64)
    last = nblk.astype(np.int64) * 128
    for k in range(8):
        blocks[rows_idx, last - 1 - k] = ((bitlen >> (8 * k)) & 0xFF).astype(np.uint8)

    # big-endian u32 view + native cast = one vectorized byteswap pass
    blocks_w = blocks.view(">u4").astype(np.uint32).reshape(
        out_rows, nblk_max, 32)
    s_words = np.zeros((out_rows, 8), dtype=np.uint32)
    s_words[:n] = s_arr.view("<u4")
    if out_rows > n:
        nblk = np.concatenate([nblk, np.zeros(out_rows - n, np.int32)])
    return blocks_w, nblk, s_words, ok


def _nblk_bucket(mlen: int) -> int:
    """Per-item padded SHA block count, rounded up to a power of two — the
    bucket key for grouping. Grouping bounds memory: one long message must
    not inflate every row of the (n, NBLK*128) preimage buffer."""
    nblk = (64 + mlen + 17 + 127) // 128
    b = 1
    while b < nblk:
        b *= 2
    return b


def _group_by_bucket(msgs: Sequence[bytes]):
    groups: dict = {}
    for i, m in enumerate(msgs):
        groups.setdefault(_nblk_bucket(len(m)), []).append(i)
    return groups


class _Fetch:
    """A verdict tensor on its way to the host. On the card the copy goes
    to pinned memory on the launching stream and :meth:`result` waits on
    its event, so a fetch measures a real device wait."""

    __slots__ = ("_host", "_event")

    def __init__(self, out: torch.Tensor):
        if out.is_cuda:
            self._host = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(out.device))
        else:
            self._host, self._event = out, None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _dense_args(blocks_w, nblk, s_words, dev):
    return (_upload(_as_i32(blocks_w), dev),
            _upload(np.ascontiguousarray(nblk, dtype=np.int32), dev),
            _upload(_as_i32(s_words), dev))


def batch_verify(
    pks: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes],
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """(N,) bool — batched strict Ed25519 verification on ``device`` (the
    default device unless given)."""
    n = len(pks)
    if n == 0:
        return np.zeros(0, dtype=bool)
    dev = default_device() if device is None else device
    groups = _group_by_bucket(msgs)
    if len(groups) > 1:
        out = np.zeros(n, dtype=bool)
        for idxs in groups.values():
            out[idxs] = batch_verify([pks[i] for i in idxs],
                                     [msgs[i] for i in idxs],
                                     [sigs[i] for i in idxs], device=dev)
        return out
    rec = phases.Segment(sigs=n, chunk=n, device=device_label(dev)).begin()
    blocks_w, nblk, s_words, ok = prepare_batch(pks, msgs, sigs)
    args = _dense_args(blocks_w, nblk, s_words, dev)
    rec.pack_done()
    fetch = _Fetch(verify_dense(*args, curve.base_table(dev)))
    rec.dispatched()
    try:
        t_w = time.perf_counter()
        verdict = fetch.result()[:n]
        rec.fetched(wait_s=time.perf_counter() - t_w)
    finally:
        rec.abandon()  # failed fetch must not wedge the in-flight gauge
    return verdict & ok


def _pack_stream_dense(pks, msgs, sigs, chunk: int):
    """Dense stream packing: ((blocks, nblk, s_words) padded to whole
    chunks, ok mask)."""
    n = len(pks)
    bucket = _nblk_bucket(max(map(len, msgs)))
    pad = -(-n // chunk) * chunk
    blocks_w, nblk, s_words, ok = prepare_batch(
        pks, msgs, sigs, rows=pad, min_nblk=bucket)
    return (blocks_w, nblk, s_words), ok


def _dispatch_stream(pks, msgs, sigs, chunk: int, columns=None,
                     device: Optional[torch.device] = None):
    """Pack one whole-chunk segment and launch it on the current stream of
    ``device`` (the default device unless given; the sparse path if the
    messages are template-compressible, dense otherwise). Returns (_Fetch,
    ok_mask) WITHOUT waiting — the caller decides when to block, which is
    what lets segment i+1's packing and upload overlap segment i's kernel.

    ``columns`` is the caller's columnar sign-bytes structure (skips the
    sparse path's join + diff scan)."""
    dev = default_device() if device is None else device
    table = curve.base_table(dev)
    sparse = prepare_sparse_stream(pks, msgs, sigs, chunk, columns=columns,
                                   device=dev)
    if sparse is not None:
        args, ok = sparse
        phases.mark_pack_done()
        return _Fetch(verify_sparse(*args, chunk, table)), ok
    (blocks_w, nblk, s_words), ok = _pack_stream_dense(pks, msgs, sigs, chunk)
    args = _dense_args(blocks_w, nblk, s_words, dev)
    phases.mark_pack_done()
    return _Fetch(verify_dense(*args, table)), ok


# Segmented pipelining: a second worker's pack + upload of segment i+1
# overlaps segment i's kernel. Segments of at most SEG_CHUNKS chunks each;
# the split is the JAX package's (_segment_sizes), so both packages cut a
# batch alike.
SEG_CHUNKS = max(1, int(os.environ.get("TMTPU_SEG_CHUNKS", "10")))
# below this many signatures a single launch wins
SEG_MIN_SIGS = int(os.environ.get("TMTPU_SEG_MIN_SIGS", "8192"))
_SEG_POOL = None
_SEG_POOL_LOCK = threading.Lock()


def _seg_pool():
    global _SEG_POOL
    with _SEG_POOL_LOCK:
        if _SEG_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _SEG_POOL = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="ed25519-seg")
        return _SEG_POOL


def _segment_sizes(k_total: int) -> list:
    """Split k_total chunks into near-equal pipeline segments of at most
    SEG_CHUNKS each; two segments is the minimum for overlap."""
    n_segs = max(2, -(-k_total // SEG_CHUNKS)) if k_total > 1 else 1
    base, extra = divmod(k_total, n_segs)
    return [base + (1 if i < extra else 0) for i in range(n_segs)]


def _run_dispatch(rec, pks, msgs, sigs, chunk: int, columns=None,
                  stream=None, device: Optional[torch.device] = None):
    """One segment's pack + launch with phase stamps, on whatever thread
    runs it (the caller, a pipeline worker, or a multi-device lane's
    worker), on ``device`` (the default device unless given) and on
    ``stream`` when one is given (each pipeline segment and each lane has
    its own CUDA stream). On a card the thread makes ``device`` current
    first, so uploads and launches use that card's pointers and stream.
    The active-segment slot lets _dispatch_stream close the pack phase
    from inside."""
    rec.begin()
    prev = phases.set_active(rec)
    try:
        with _on_device(device, stream):
            fetch, ok = _dispatch_stream(pks, msgs, sigs, chunk,
                                         columns=columns, device=device)
    finally:
        phases.clear_active(prev)
    rec.dispatched()
    return fetch, ok


def _verify_segmented(pks, msgs, sigs, chunk: int,
                      t_entry: float = None, columns=None) -> np.ndarray:
    n = len(pks)
    sizes = _segment_sizes(-(-n // chunk))
    col_of = ((lambda a, b: columns.slice(a, b)) if columns is not None
              else (lambda a, b: None))
    bounds, lo = [], 0
    for s in sizes:
        hi = min(lo + s * chunk, n)
        bounds.append((lo, hi))
        lo = hi
    # plane/height captured HERE (contextvars do not follow work onto the
    # pipeline workers); stamps filled on whichever thread packs/launches,
    # closed on this thread at fetch
    plane, height = phases.context()
    dev = default_device()
    dev_label = device_label(dev)
    streams = ([torch.cuda.Stream(device=dev) for _ in bounds]
               if dev.type == "cuda" else [None] * len(bounds))
    recs = [phases.Segment(sigs=b - a, chunk=chunk, seg=i,
                           n_segs=len(bounds), device=dev_label,
                           plane=plane, height=height)
            for i, (a, b) in enumerate(bounds)]
    if t_entry is not None:
        # the stream entry's host work (bucket grouping) is critical-path
        # packing: charge it to segment 0's pack phase
        recs[0].t0 = t_entry
    pool = _seg_pool()
    a0, b0 = bounds[0]
    futs = [_done_future(_run_dispatch(
        recs[0], pks[a0:b0], msgs[a0:b0], sigs[a0:b0], chunk,
        columns=col_of(a0, b0), stream=streams[0]))]
    futs += [
        pool.submit(_run_dispatch, recs[1], pks[a:b], msgs[a:b], sigs[a:b],
                    chunk, columns=col_of(a, b), stream=streams[1])
        for a, b in bounds[1:2]
    ]
    out = np.zeros(n, dtype=bool)
    try:
        for i, (a, b) in enumerate(bounds):
            t_wait0 = time.perf_counter()
            fetch, ok = futs[i].result()
            if i + 2 < len(bounds):
                a2, b2 = bounds[i + 2]
                futs.append(pool.submit(
                    _run_dispatch, recs[i + 2], pks[a2:b2], msgs[a2:b2],
                    sigs[a2:b2], chunk, columns=col_of(a2, b2),
                    stream=streams[i + 2]))
            arr = fetch.result()
            recs[i].fetched(wait_s=time.perf_counter() - t_wait0)
            out[a:b] = arr.reshape(-1)[:b - a] & ok
    finally:
        # an errored fetch (or a sibling segment's worker raising) must
        # drain the in-flight gauge for every already-launched segment
        for r in recs:
            r.abandon()
    phases.observe_overlap(recs)
    return out


def _done_future(value):
    from concurrent.futures import Future

    f = Future()
    f.set_result(value)
    return f


def batch_verify_stream(
    pks: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes],
    chunk: int = 2048, columns=None,
) -> np.ndarray:
    """(N,) bool — verify a large batch as whole chunks: one launch per
    SEG_CHUNKS-chunk segment, pipelined so segment i+1's packing and upload
    overlap segment i's kernel. Batches big enough to amortize per-device
    dispatch shard round-robin across the multi-device pool
    (multidevice.py) when there is one. ``columns``
    (crypto/signcols.SignColumns aligned 1:1 with the batch) lets
    VerifyCommit* callers hand the packer their sign-bytes structure."""
    t_entry = time.perf_counter()
    n = len(pks)
    if n == 0:
        return np.zeros(0, dtype=bool)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if columns is not None and len(columns) != n:
        columns = None
    if n <= chunk:
        return batch_verify(pks, msgs, sigs)
    groups = _group_by_bucket(msgs)
    if len(groups) > 1:  # see _nblk_bucket: memory bound
        out = np.zeros(n, dtype=bool)
        for idxs in groups.values():
            out[idxs] = batch_verify_stream([pks[i] for i in idxs],
                                            [msgs[i] for i in idxs],
                                            [sigs[i] for i in idxs], chunk)
        return out
    if n >= SEG_MIN_SIGS:
        from . import multidevice

        # no try: a pool that fails to build raises; only fewer than two
        # cards (or TMTPU_VERIFY_DEVICES <= 1) gives None
        md = multidevice.pool()
        if md is not None and md.engaged(n):
            return md.verify(pks, msgs, sigs, chunk, columns=columns,
                             t_entry=t_entry)
        return _verify_segmented(pks, msgs, sigs, chunk, t_entry=t_entry,
                                 columns=columns)
    rec = phases.Segment(sigs=n, chunk=chunk, device=device_label())
    rec.t0 = t_entry  # bucket grouping is critical-path pack cost
    fetch, ok = _run_dispatch(rec, pks, msgs, sigs, chunk, columns=columns)
    try:
        t_w = time.perf_counter()
        arr = fetch.result()
        rec.fetched(wait_s=time.perf_counter() - t_w)
    finally:
        rec.abandon()
    return arr.reshape(-1)[:n] & ok


def kernel_device() -> torch.device:
    """The default device, with the verify kernels built and loaded when it
    is the card. Raises :class:`~tendermint_tpu_torch.device.KernelUnavailable`
    when CUDA is absent (and the CPU was not asked for) or the library does
    not build or load."""
    dev = default_device()
    if dev.type == "cuda":
        build.PACKAGE.library("verify")
    return dev


def probe_dispatch_seconds(device: Optional[torch.device] = None) -> float:
    """One round trip of a fresh 32 KB payload through the K11 probe:
    upload, launch, read back. Timed with CUDA events on the card (the
    host clock on the CPU). ``crypto/batch.device_threshold`` turns it
    into the host/device break-even batch size."""
    dev = default_device() if device is None else device

    def payload() -> torch.Tensor:
        return torch.from_numpy(np.frombuffer(
            os.urandom(256 * 128), dtype=np.uint8).reshape(256, 128).copy())

    if dev.type != "cuda":
        x = payload()
        t0 = time.perf_counter()
        probe_sum(x).item()
        return time.perf_counter() - t0
    x = payload()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(dev)
    start.record(stream)
    probe_sum(x.to(dev)).cpu()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1000.0
