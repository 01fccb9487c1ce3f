"""Light-block providers (reference light/provider/provider.go + http impl).

A provider serves LightBlocks (signed header + validator set) by height.
``HTTPProvider`` pulls from a full node's RPC (commit + validators routes);
``MockProvider`` serves a fixed map for tests.
"""

from __future__ import annotations

import base64
from typing import Dict, Optional

from ..crypto import Ed25519PubKey
from ..types.basic import BlockID, BlockIDFlag, PartSetHeader
from ..types.block import Commit, CommitSig, Consensus, Header
from ..types.light_block import LightBlock, SignedHeader
from ..types.validator import Validator
from ..types.validator_set import ValidatorSet


class ProviderError(Exception):
    pass


class ErrLightBlockNotFound(ProviderError):
    pass


class Provider:
    chain_id: str = ""

    async def light_block(self, height: int) -> LightBlock:
        """height == 0 means latest."""
        raise NotImplementedError

    async def report_evidence(self, ev) -> None:  # pragma: no cover - iface
        pass

    def id(self) -> str:
        return "provider"


class MockProvider(Provider):
    def __init__(self, chain_id: str, blocks: Dict[int, LightBlock]):
        self.chain_id = chain_id
        self.blocks = dict(blocks)
        self.evidence = []

    async def light_block(self, height: int) -> LightBlock:
        if height == 0 and self.blocks:
            height = max(self.blocks)
        lb = self.blocks.get(height)
        if lb is None:
            raise ErrLightBlockNotFound(f"no light block at height {height}")
        return lb

    async def report_evidence(self, ev) -> None:
        self.evidence.append(ev)

    def id(self) -> str:
        return f"mock-{id(self) & 0xffff:x}"


class HTTPProvider(Provider):
    """(light/provider/http) over the JSON-RPC client."""

    def __init__(self, chain_id: str, client):
        self.chain_id = chain_id
        self.client = client  # rpc.client.HTTPClient or LocalClient

    def id(self) -> str:
        return getattr(self.client, "base_url", "local")

    async def light_block(self, height: int) -> LightBlock:
        commit_doc = await self.client.commit(height or None)
        sh = _decode_signed_header(commit_doc["signed_header"])
        vals_doc = await self.client.validators(sh.header.height, per_page=100)
        vals = _decode_validators(vals_doc["validators"])
        total = int(vals_doc["total"])
        page = 2
        max_pages = -(-total // 100)  # ceil; a sane provider never needs more
        while len(vals) < total:
            if page > max_pages:
                raise ProviderError(
                    f"provider returned {len(vals)}/{total} validators "
                    f"after {max_pages} pages")
            more = await self.client.validators(sh.header.height, page=page,
                                                per_page=100)
            got = _decode_validators(more["validators"])
            if not got:
                raise ProviderError("provider returned an empty validator page")
            vals.extend(got)
            page += 1
        # priorities in the RPC answer are live: rebuild WITHOUT the
        # NewValidatorSet increment (validator_set.go
        # ValidatorSetFromExistingValidators) or proposer selection on a
        # statesync-bootstrapped node diverges from the network
        return LightBlock(sh, ValidatorSet.from_existing(vals))


# -- JSON -> domain decoding (inverse of rpc/json_enc.py) --------------------

def _decode_block_id(d) -> BlockID:
    return BlockID(bytes.fromhex(d["hash"]),
                   PartSetHeader(int(d["parts"]["total"]),
                                 bytes.fromhex(d["parts"]["hash"])))


def _parse_rfc3339_ns(s: str) -> int:
    """Inverse of json_enc.rfc3339: exact nanosecond round-trip."""
    import datetime

    if s.endswith("Z"):
        s = s[:-1]
    frac_ns = 0
    if "." in s:
        s, frac = s.split(".", 1)
        frac = frac[:9].ljust(9, "0")
        frac_ns = int(frac)
    dt = datetime.datetime.fromisoformat(s).replace(tzinfo=datetime.timezone.utc)
    return int(dt.timestamp()) * 1_000_000_000 + frac_ns


def _decode_header(d) -> Header:
    return Header(
        version=Consensus(int(d["version"]["block"]), int(d["version"]["app"])),
        chain_id=d["chain_id"],
        height=int(d["height"]),
        time_ns=_parse_rfc3339_ns(d["time"]),
        last_block_id=_decode_block_id(d["last_block_id"]),
        last_commit_hash=bytes.fromhex(d["last_commit_hash"]),
        data_hash=bytes.fromhex(d["data_hash"]),
        validators_hash=bytes.fromhex(d["validators_hash"]),
        next_validators_hash=bytes.fromhex(d["next_validators_hash"]),
        consensus_hash=bytes.fromhex(d["consensus_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
        last_results_hash=bytes.fromhex(d["last_results_hash"]),
        evidence_hash=bytes.fromhex(d["evidence_hash"]),
        proposer_address=bytes.fromhex(d["proposer_address"]),
    )


def _decode_signed_header(d) -> SignedHeader:
    c = d["commit"]
    commit = Commit(
        height=int(c["height"]), round=int(c["round"]),
        block_id=_decode_block_id(c["block_id"]),
        signatures=[
            CommitSig(BlockIDFlag(int(s["block_id_flag"])),
                      bytes.fromhex(s["validator_address"]),
                      _parse_rfc3339_ns(s["timestamp"]) if s["timestamp"] else 0,
                      base64.b64decode(s["signature"] or ""))
            for s in c["signatures"]
        ])
    return SignedHeader(_decode_header(d["header"]), commit)


def _decode_validators(lst) -> list:
    out = []
    for v in lst:
        pub = Ed25519PubKey(base64.b64decode(v["pub_key"]["value"]))
        out.append(Validator(bytes.fromhex(v["address"]), pub,
                             int(v["voting_power"]),
                             int(v.get("proposer_priority", 0))))
    return out
