"""EventBus: typed envelope over libs.pubsub (reference types/event_bus.go:33).

Publishes consensus/tx events with indexable composite keys; RPC WS
subscriptions and the tx indexer both ride subscriptions on this bus.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..libs.pubsub import PubSubServer, Query, Subscription
from . import events as tme
from .block import Block, Header
from .vote import Vote


@dataclass
class EventDataNewBlock:
    block: Block
    block_id: object
    result_begin_block: object = None
    result_end_block: object = None


@dataclass
class EventDataNewBlockHeader:
    header: Header
    result_begin_block: object = None
    result_end_block: object = None


@dataclass
class EventDataTx:
    height: int
    index: int
    tx: bytes
    result: object


@dataclass
class EventDataNewEvidence:
    evidence: object
    height: int


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass
class EventDataNewRound:
    height: int
    round: int
    step: str
    proposer_address: bytes = b""
    proposer_index: int = -1


@dataclass
class EventDataCompleteProposal:
    height: int
    round: int
    step: str
    block_id: object = None


@dataclass
class EventDataVote:
    vote: Vote


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: List = field(default_factory=list)


def _abci_events_to_map(events) -> Dict[str, List[str]]:
    """Flatten app events into composite keys '<type>.<attr>' → values."""
    out: Dict[str, List[str]] = {}
    for ev in events or []:
        if not getattr(ev, "type", ""):
            continue
        for attr in getattr(ev, "attributes", []) or []:
            key = f"{ev.type}.{attr.key.decode('utf-8', errors='replace')}"
            out.setdefault(key, []).append(attr.value.decode("utf-8", errors="replace"))
    return out


class EventBus:
    def __init__(self):
        self._server = PubSubServer()

    # -- subscriptions --

    def subscribe(self, subscriber: str, query: str, out_capacity: int = 100) -> Subscription:
        return self._server.subscribe(subscriber, Query(query), out_capacity)

    def unsubscribe(self, subscriber: str, query: str) -> None:
        self._server.unsubscribe(subscriber, Query(query))

    def unsubscribe_all(self, subscriber: str) -> None:
        self._server.unsubscribe_all(subscriber)

    def num_clients(self) -> int:
        return self._server.num_clients()

    def num_client_subscriptions(self, subscriber: str) -> int:
        return self._server.num_client_subscriptions(subscriber)

    # -- publishing (event_bus.go:118+) --

    def _publish(self, event_type: str, data, extra: Optional[Dict[str, List[str]]] = None,
                 app_events=None) -> None:
        events = _abci_events_to_map(app_events)
        for k, v in (extra or {}).items():
            events.setdefault(k, []).extend(v)
        events.setdefault(tme.EVENT_TYPE_KEY, []).append(event_type)
        self._server.publish(data, events)

    def publish_event_new_block(self, block: Block, block_id, rbb, reb) -> None:
        app_events = list(getattr(rbb, "events", []) or []) + list(getattr(reb, "events", []) or [])
        self._publish(tme.EVENT_NEW_BLOCK,
                      EventDataNewBlock(block, block_id, rbb, reb),
                      {tme.BLOCK_HEIGHT_KEY: [str(block.header.height)]},
                      app_events)

    def publish_event_new_block_header(self, header: Header, rbb, reb) -> None:
        app_events = list(getattr(rbb, "events", []) or []) + list(getattr(reb, "events", []) or [])
        self._publish(tme.EVENT_NEW_BLOCK_HEADER,
                      EventDataNewBlockHeader(header, rbb, reb),
                      {tme.BLOCK_HEIGHT_KEY: [str(header.height)]},
                      app_events)

    def publish_event_new_evidence(self, evidence, height: int) -> None:
        self._publish(tme.EVENT_NEW_EVIDENCE, EventDataNewEvidence(evidence, height))

    def publish_event_tx(self, height: int, index: int, tx: bytes, result) -> None:
        import hashlib

        self._publish(tme.EVENT_TX, EventDataTx(height, index, tx, result),
                      {tme.TX_HEIGHT_KEY: [str(height)],
                       tme.TX_HASH_KEY: [hashlib.sha256(tx).hexdigest().upper()]},
                      getattr(result, "events", None))

    def publish_event_vote(self, vote: Vote) -> None:
        self._publish(tme.EVENT_VOTE, EventDataVote(vote))

    def publish_event_new_round_step(self, rs: EventDataRoundState) -> None:
        self._publish(tme.EVENT_NEW_ROUND_STEP, rs)

    def publish_event_new_round(self, nr: EventDataNewRound) -> None:
        self._publish(tme.EVENT_NEW_ROUND, nr)

    def publish_event_complete_proposal(self, cp: EventDataCompleteProposal) -> None:
        self._publish(tme.EVENT_COMPLETE_PROPOSAL, cp)

    def publish_event_timeout_propose(self, rs: EventDataRoundState) -> None:
        self._publish(tme.EVENT_TIMEOUT_PROPOSE, rs)

    def publish_event_timeout_wait(self, rs: EventDataRoundState) -> None:
        self._publish(tme.EVENT_TIMEOUT_WAIT, rs)

    def publish_event_polka(self, rs: EventDataRoundState) -> None:
        self._publish(tme.EVENT_POLKA, rs)

    def publish_event_lock(self, rs: EventDataRoundState) -> None:
        self._publish(tme.EVENT_LOCK, rs)

    def publish_event_relock(self, rs: EventDataRoundState) -> None:
        self._publish(tme.EVENT_RELOCK, rs)

    def publish_event_valid_block(self, rs: EventDataRoundState) -> None:
        self._publish(tme.EVENT_VALID_BLOCK, rs)

    def publish_event_validator_set_updates(self, updates) -> None:
        self._publish(tme.EVENT_VALIDATOR_SET_UPDATES,
                      EventDataValidatorSetUpdates(list(updates)))
