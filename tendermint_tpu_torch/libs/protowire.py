"""Minimal protobuf (proto3) wire-format writer/reader.

The reference encodes every signed/hashed artifact with gogoproto-generated
marshalers (e.g. proto/tendermint/types/canonical.pb.go). We need the exact
bytes — sign-bytes and merkle leaves must match the reference — but not a
general protobuf stack, so this is a deliberate, small, hand-rolled codec:

* proto3 zero-value omission for scalars/bytes/strings;
* non-nullable embedded messages are ALWAYS emitted (gogoproto
  `(gogoproto.nullable) = false` semantics — see BlockID.MarshalToSizedBuffer
  in proto/tendermint/types/types.pb.go:1233-1256, which writes the
  PartSetHeader field unconditionally);
* fields emitted in ascending field-number order (gogo writes back-to-front,
  producing ascending order on the wire);
* google.protobuf.Timestamp via (seconds, nanos) with proto3 omission inside.

Reading support is the mirror image, used for storage/wire decoding.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple, Union

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5


def encode_varint(v: int) -> bytes:
    if v < 0:
        v &= (1 << 64) - 1  # negative int64 → 10-byte varint, like protobuf
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def encode_zigzag(v: int) -> bytes:
    return encode_varint((v << 1) ^ (v >> 63))


def tag(field_num: int, wire_type: int) -> bytes:
    return encode_varint((field_num << 3) | wire_type)


class Writer:
    """Append-only field writer. Call methods in ascending field order."""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    # -- scalars (proto3: zero omitted) --
    def varint(self, field: int, v: int) -> None:
        if v != 0:
            self._buf += tag(field, WIRE_VARINT) + encode_varint(v)

    def bool(self, field: int, v: bool) -> None:
        if v:
            self._buf += tag(field, WIRE_VARINT) + b"\x01"

    def sfixed64(self, field: int, v: int) -> None:
        if v != 0:
            self._buf += tag(field, WIRE_FIXED64) + (v & ((1 << 64) - 1)).to_bytes(8, "little")

    def fixed64(self, field: int, v: int) -> None:
        if v != 0:
            self._buf += tag(field, WIRE_FIXED64) + v.to_bytes(8, "little")

    def bytes(self, field: int, v: bytes) -> None:
        if v:
            self._buf += tag(field, WIRE_BYTES) + encode_varint(len(v)) + v

    def string(self, field: int, v: str) -> None:
        self.bytes(field, v.encode("utf-8"))

    # -- embedded messages --
    def message(self, field: int, body: bytes) -> None:
        """Always emitted (gogoproto nullable=false semantics)."""
        self._buf += tag(field, WIRE_BYTES) + encode_varint(len(body)) + body

    def message_opt(self, field: int, body: "Union[bytes, None]") -> None:
        """Omitted when None (nullable pointer field)."""
        if body is not None:
            self.message(field, body)

    def finish(self) -> bytes:
        return bytes(self._buf)


def timestamp(ns: int) -> bytes:
    """google.protobuf.Timestamp body from integer unix-nanoseconds.

    Matches gogo's StdTimeMarshal: seconds (field 1, int64 varint), nanos
    (field 2, int32 varint), each omitted when zero. `nanos` is always in
    [0, 1e9) per the Timestamp spec, even for pre-epoch times.
    """
    seconds, nanos = divmod(ns, 1_000_000_000)
    w = Writer()
    w.varint(1, seconds)
    w.varint(2, nanos)
    return w.finish()


def length_delimited(body: bytes) -> bytes:
    """Varint length prefix (libs/protoio MarshalDelimited — sign-bytes framing)."""
    return encode_varint(len(body)) + body


# ---------------------------------------------------------------------------
# Reading

def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def varint_to_int64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def as_bytes(v) -> bytes:
    """Guard for nested-message fields: a peer can send any wire type for
    any field number, so decoders must reject varints where they expect
    sub-messages with a clean ValueError (fuzz finding)."""
    if not isinstance(v, (bytes, bytearray)):
        raise ValueError(f"expected length-delimited field, got {type(v).__name__}")
    return bytes(v)


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_num, wire_type, value). value: int for varint/fixed, bytes for len-delimited."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = decode_varint(data, pos)
        field_num, wire_type = key >> 3, key & 7
        if wire_type == WIRE_VARINT:
            v, pos = decode_varint(data, pos)
            yield field_num, wire_type, v
        elif wire_type == WIRE_FIXED64:
            if pos + 8 > n:
                raise ValueError("truncated fixed64")
            yield field_num, wire_type, int.from_bytes(data[pos:pos + 8], "little")
            pos += 8
        elif wire_type == WIRE_BYTES:
            ln, pos = decode_varint(data, pos)
            if pos + ln > n:
                raise ValueError("truncated bytes field")
            yield field_num, wire_type, data[pos:pos + ln]
            pos += ln
        elif wire_type == WIRE_FIXED32:
            if pos + 4 > n:
                raise ValueError("truncated fixed32")
            yield field_num, wire_type, int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")


def fields_dict(data: bytes) -> Dict[int, List[Union[int, bytes]]]:
    out: Dict[int, List[Union[int, bytes]]] = {}
    for fn, _wt, v in iter_fields(data):
        out.setdefault(fn, []).append(v)
    return out


def parse_timestamp(body: bytes) -> int:
    """Timestamp message body → integer unix-nanoseconds."""
    seconds = nanos = 0
    for fn, _wt, v in iter_fields(body):
        if fn == 1:
            seconds = varint_to_int64(v)
        elif fn == 2:
            nanos = varint_to_int64(v)
    return seconds * 1_000_000_000 + nanos


def read_length_delimited(data: bytes, pos: int = 0) -> Tuple[bytes, int]:
    ln, pos = decode_varint(data, pos)
    if pos + ln > len(data):
        raise ValueError("truncated delimited message")
    return data[pos:pos + ln], pos + ln
