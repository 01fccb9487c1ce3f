"""BitArray (reference libs/bits/bit_array.go) — vote/part presence masks.

Backed by a Python int bitmask; converts to numpy bool arrays for the device
tally plane (SURVEY.md §2.15: "maps to device-friendly masks").
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


class BitArray:
    __slots__ = ("bits", "_mask")

    def __init__(self, bits: int):
        if bits < 0:
            bits = 0
        self.bits = bits
        self._mask = 0

    @staticmethod
    def from_indices(bits: int, indices) -> "BitArray":
        ba = BitArray(bits)
        for i in indices:
            ba.set_index(i, True)
        return ba

    def size(self) -> int:
        return self.bits

    def get_index(self, i: int) -> bool:
        if i >= self.bits or i < 0:
            return False
        return bool((self._mask >> i) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        if i >= self.bits or i < 0:
            return False
        if v:
            self._mask |= 1 << i
        else:
            self._mask &= ~(1 << i)
        return True

    def copy(self) -> "BitArray":
        ba = BitArray(self.bits)
        ba._mask = self._mask
        return ba

    def or_(self, other: "BitArray") -> "BitArray":
        ba = BitArray(max(self.bits, other.bits))
        ba._mask = self._mask | other._mask
        return ba

    def and_(self, other: "BitArray") -> "BitArray":
        ba = BitArray(min(self.bits, other.bits))
        ba._mask = self._mask & other._mask & ((1 << ba.bits) - 1)
        return ba

    def not_(self) -> "BitArray":
        ba = BitArray(self.bits)
        ba._mask = ~self._mask & ((1 << self.bits) - 1)
        return ba

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits in self but not in other (bit_array.go Sub)."""
        ba = BitArray(self.bits)
        mask_o = other._mask & ((1 << min(self.bits, other.bits)) - 1)
        ba._mask = self._mask & ~mask_o
        return ba

    def is_empty(self) -> bool:
        return self._mask == 0

    def is_full(self) -> bool:
        return self.bits > 0 and self._mask == (1 << self.bits) - 1

    def pick_random(self, rng: Optional[random.Random] = None) -> "tuple[int, bool]":
        """A uniformly random set bit, or (0, False) if none (bit_array.go PickRandom)."""
        idxs = self.true_indices()
        if not idxs:
            return 0, False
        r = rng or random
        return r.choice(idxs), True

    def true_indices(self) -> List[int]:
        m = self._mask
        out = []
        i = 0
        while m:
            if m & 1:
                out.append(i)
            m >>= 1
            i += 1
        return out

    def num_true(self) -> int:
        return bin(self._mask).count("1")

    def to_numpy(self) -> np.ndarray:
        out = np.zeros(self.bits, dtype=bool)
        for i in self.true_indices():
            out[i] = True
        return out

    def update(self, other: "BitArray") -> None:
        """Copy other's contents (truncated/extended to self.bits)."""
        self._mask = other._mask & ((1 << self.bits) - 1)

    def __eq__(self, other):
        return isinstance(other, BitArray) and self.bits == other.bits and self._mask == other._mask

    def __repr__(self):
        return "BA{" + "".join("x" if self.get_index(i) else "_" for i in range(self.bits)) + "}"

    def encode(self) -> bytes:
        """Proto BitArray (libs/bits/types.pb.go): int64 bits=1, repeated uint64 elems=2."""
        from . import protowire as pw

        w = pw.Writer()
        w.varint(1, self.bits)
        n_words = (self.bits + 63) // 64
        if n_words:
            # repeated uint64 packed
            body = b"".join(
                pw.encode_varint((self._mask >> (64 * k)) & ((1 << 64) - 1))
                for k in range(n_words)
            )
            w.bytes(2, body)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "BitArray":
        from . import protowire as pw

        bits = 0
        words: List[int] = []
        for fn, wt, v in pw.iter_fields(data):
            if fn == 1:
                bits = pw.varint_to_int64(v)
            elif fn == 2:
                if wt == pw.WIRE_BYTES:
                    pos = 0
                    while pos < len(v):
                        word, pos = pw.decode_varint(v, pos)
                        words.append(word)
                else:
                    words.append(v)
        ba = BitArray(bits)
        mask = 0
        for k, word in enumerate(words):
            mask |= word << (64 * k)
        ba._mask = mask & ((1 << bits) - 1) if bits else 0
        return ba
