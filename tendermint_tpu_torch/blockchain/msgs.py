"""Block-sync wire messages (reference proto/tendermint/blockchain/types.proto
Message oneof: block_request=1, no_block_response=2, block_response=3,
status_request=4, status_response=5).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protowire as pw
from ..types.block import Block


@dataclass
class BlockRequest:
    height: int


@dataclass
class NoBlockResponse:
    height: int


@dataclass
class BlockResponse:
    block: Block


@dataclass
class StatusRequest:
    pass


@dataclass
class StatusResponse:
    height: int
    base: int


def encode_msg(msg) -> bytes:
    w = pw.Writer()
    if isinstance(msg, BlockRequest):
        b = pw.Writer()
        b.varint(1, msg.height)
        w.message(1, b.finish())
    elif isinstance(msg, NoBlockResponse):
        b = pw.Writer()
        b.varint(1, msg.height)
        w.message(2, b.finish())
    elif isinstance(msg, BlockResponse):
        b = pw.Writer()
        b.message(1, msg.block.encode())
        w.message(3, b.finish())
    elif isinstance(msg, StatusRequest):
        w.message(4, pw.Writer().finish())
    elif isinstance(msg, StatusResponse):
        b = pw.Writer()
        b.varint(1, msg.height)
        b.varint(2, msg.base)
        w.message(5, b.finish())
    else:
        raise ValueError(f"unknown blockchain message {type(msg)}")
    return w.finish()


def decode_msg(data: bytes):
    fields = list(pw.iter_fields(data))
    if len(fields) != 1:
        raise ValueError("blockchain Message must have exactly one oneof field")
    fn, _wt, body = fields[0]
    d = pw.fields_dict(body)

    def iv(n, default=0):
        vals = d.get(n)
        return pw.varint_to_int64(vals[0]) if vals else default

    if fn == 1:
        return BlockRequest(iv(1))
    if fn == 2:
        return NoBlockResponse(iv(1))
    if fn == 3:
        vals = d.get(1)
        if not vals:
            raise ValueError("BlockResponse without block")
        return BlockResponse(Block.decode(vals[0]))
    if fn == 4:
        return StatusRequest()
    if fn == 5:
        return StatusResponse(iv(1), iv(2))
    raise ValueError(f"unknown blockchain Message field {fn}")
