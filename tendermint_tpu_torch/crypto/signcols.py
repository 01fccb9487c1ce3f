"""Columnar sign-bytes: the zero-copy vote-pack fast path.

One commit's canonical sign-bytes share every byte except a handful of
timestamp positions (types/canonical.py vote_sign_bytes_batch builds them
from cached shared pieces for exactly that reason). The batched device
verifier then re-DISCOVERS that structure per segment: it joins all rows
into one (n, mlen) matrix and diff-scans it against per-chunk templates
(ed25519_cuda/verify.prepare_sparse_stream) — O(n*mlen) of memcpy + compare
per dispatch, a measurable slice of the pack share the bench gates.

:class:`SignColumns` carries the structure the encoder already knows:

* ``template`` — one full row's bytes (every row is identical outside
  ``cols``);
* ``cols``     — the int32 byte positions that vary row to row;
* ``vals``     — an (n, C) uint8 matrix of each row's bytes at ``cols``.

``types/canonical.vote_sign_bytes_columns_batch`` builds one straight from
the encoder's cached fragments (no per-row materialization, no diff scan),
``Commit.vote_sign_bytes_columns`` memoizes it per chain_id, and the
VerifyCommit* callers hand it to BatchVerifier, which threads it down to
``prepare_sparse_stream`` — the sparse wire format is assembled by slicing
these arrays instead of re-deriving them. Row reconstruction is
byte-identical to ``vote_sign_bytes_all`` (differentially tested), so
accept/reject verdicts cannot change.

numpy-only and torch-free: types/ code builds these without dragging the
device stack into encode paths.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class SignColumns:
    """A batch of equal-length messages as template + varying columns.

    Behaves as a read-only sequence of ``bytes`` rows (len / indexing /
    iteration) so host fallback paths can consume it like a message list,
    while the device pack path reads the arrays directly.
    """

    __slots__ = ("template", "cols", "vals")

    def __init__(self, template: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray):
        self.template = np.ascontiguousarray(template, dtype=np.uint8)
        self.cols = np.ascontiguousarray(cols, dtype=np.int32)
        self.vals = np.asarray(vals, dtype=np.uint8)
        if self.vals.ndim != 2 or self.vals.shape[1] != self.cols.shape[0]:
            raise ValueError(
                f"vals shape {self.vals.shape} does not match "
                f"{self.cols.shape[0]} columns")

    # -- sequence protocol (host fallback / prepare_batch compatibility) ----

    def __len__(self) -> int:
        return self.vals.shape[0]

    @property
    def mlen(self) -> int:
        return self.template.shape[0]

    def __getitem__(self, i) -> bytes:
        if isinstance(i, slice):
            raise TypeError("use .slice(a, b) for row ranges")
        row = self.template.copy()
        row[self.cols] = self.vals[i]
        return row.tobytes()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- batch views ---------------------------------------------------------

    def slice(self, a: int, b: int) -> "SignColumns":
        """Rows [a, b) — a zero-copy view (template/cols shared, vals
        sliced) for per-segment sharding."""
        return SignColumns(self.template, self.cols, self.vals[a:b])

    def subset(self, idxs: Sequence[int]) -> "SignColumns":
        """Rows at ``idxs`` in order (fancy index copies only the (k, C)
        vals block — the commit-idx candidate selection VerifyCommit*
        performs)."""
        return SignColumns(self.template, self.cols,
                           self.vals[np.asarray(idxs, dtype=np.intp)])

    def rows(self) -> list:
        """Materialized bytes rows (host fallback; O(n*mlen))."""
        n = len(self)
        arr = np.broadcast_to(self.template, (n, self.mlen)).copy()
        arr[:, self.cols] = self.vals
        return [r.tobytes() for r in arr]


def sign_columns_from_rows(rows: Sequence[bytes]) -> "Optional[SignColumns]":
    """Tx-side SignColumns analogue (mempool/ingest.py micro-batches).

    Votes get their columns from the encoder's cached fragments
    (``vote_sign_bytes_columns_batch``); tx sign-bytes have no encoder
    cache, but a micro-batch of same-shape envelopes still shares most
    bytes (magic, fee/nonce prefixes, payload padding). One vectorized
    diff-scan at PACK time — on the intake path, once per micro-batch —
    yields the same zero-copy structure, instead of the verifier
    re-discovering it per segment per dispatch.

    Returns None when there is no structure to exploit: fewer than 2
    rows, unequal lengths, or rows so dissimilar the columnar form would
    carry ≥ half the matrix anyway. Reconstruction is byte-identical to
    ``rows`` (differentially tested), so verdicts cannot change."""
    n = len(rows)
    if n < 2:
        return None
    mlen = len(rows[0])
    if mlen == 0 or any(len(r) != mlen for r in rows):
        return None
    arr = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(n, mlen)
    cols = np.flatnonzero((arr != arr[0]).any(axis=0)).astype(np.int32)
    if cols.shape[0] * 2 > mlen:
        return None
    return SignColumns(arr[0], cols, arr[:, cols])
