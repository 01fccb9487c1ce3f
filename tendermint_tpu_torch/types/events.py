"""Typed event names + query helpers (reference types/events.go)."""

from __future__ import annotations

# Event type values (types/events.go:16-40)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_LOCK = "Lock"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_POLKA = "Polka"
EVENT_RELOCK = "Relock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_UNLOCK = "Unlock"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_VOTE = "Vote"

# Reserved composite-key namespace (types/events.go:100+)
EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event_type: str) -> str:
    return f"{EVENT_TYPE_KEY}='{event_type}'"


QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
QUERY_NEW_BLOCK_HEADER = query_for_event(EVENT_NEW_BLOCK_HEADER)
QUERY_TX = query_for_event(EVENT_TX)
QUERY_NEW_ROUND_STEP = query_for_event(EVENT_NEW_ROUND_STEP)
QUERY_VOTE = query_for_event(EVENT_VOTE)
QUERY_VALIDATOR_SET_UPDATES = query_for_event(EVENT_VALIDATOR_SET_UPDATES)
