"""Event pubsub with the reference's query language
(reference libs/pubsub/pubsub.go:90 + query/query.peg).

Grammar (same operator set as the reference — AND only, no OR):
    cond   := tag op value
    op     := '=' | '<' | '<=' | '>' | '>=' | 'CONTAINS' | 'EXISTS'
    query  := cond (AND cond)*
    value  := 'string' | number | TIME t | DATE d
Events carry a message plus tags: Dict[str, List[str]] (composite keys like
"tx.height" → values). Matching follows libs/pubsub/query/query.go: a
condition matches if ANY value under the key satisfies it.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<and>AND\b)|(?P<op><=|>=|=|<|>|CONTAINS\b|EXISTS\b)|"
    r"(?P<str>'(?:[^'])*')|(?P<num>-?\d+(?:\.\d+)?)|"
    r"(?P<key>[A-Za-z_][A-Za-z0-9_.\-]*))"
)


@dataclass(frozen=True)
class Condition:
    key: str
    op: str
    value: Any  # str | float | None (EXISTS)


class Query:
    """Compiled query (reference libs/pubsub/query/query.go Query)."""

    def __init__(self, source: str):
        self.source = source.strip()
        self.conditions: List[Condition] = _parse(self.source) if self.source else []

    def matches(self, events: Dict[str, List[str]]) -> bool:
        return all(_match_condition(c, events) for c in self.conditions)

    def __str__(self) -> str:
        return self.source

    def __eq__(self, other):
        return isinstance(other, Query) and self.source == other.source

    def __hash__(self):
        return hash(self.source)


def _parse(s: str) -> List[Condition]:
    pos = 0
    conds: List[Condition] = []
    n = len(s)
    while pos < n:
        key, pos = _expect(s, pos, "key")
        op, pos = _expect(s, pos, "op")
        if op == "EXISTS":
            conds.append(Condition(key, op, None))
        else:
            m = _TOKEN_RE.match(s, pos)
            if not m or (not m.group("str") and not m.group("num")):
                raise ValueError(f"query parse error at {pos}: expected value in {s!r}")
            pos = m.end()
            if m.group("str"):
                conds.append(Condition(key, op, m.group("str")[1:-1]))
            else:
                conds.append(Condition(key, op, float(m.group("num"))))
        if pos < n:
            m = _TOKEN_RE.match(s, pos)
            if not m or not m.group("and"):
                raise ValueError(f"query parse error at {pos}: expected AND in {s!r}")
            pos = m.end()
    return conds


def _expect(s: str, pos: int, kind: str) -> Tuple[str, int]:
    m = _TOKEN_RE.match(s, pos)
    if not m or not m.group(kind):
        raise ValueError(f"query parse error at {pos}: expected {kind} in {s!r}")
    return m.group(kind), m.end()


def _match_condition(c: Condition, events: Dict[str, List[str]]) -> bool:
    values = events.get(c.key)
    if values is None:
        return False
    if c.op == "EXISTS":
        return True
    for v in values:
        if c.op == "=":
            if isinstance(c.value, float):
                try:
                    if float(v) == c.value:
                        return True
                except ValueError:
                    pass
            elif v == c.value:
                return True
        elif c.op == "CONTAINS":
            if isinstance(c.value, str) and c.value in v:
                return True
        else:  # numeric comparisons
            try:
                fv = float(v)
            except ValueError:
                continue
            if ((c.op == "<" and fv < c.value) or (c.op == "<=" and fv <= c.value)
                    or (c.op == ">" and fv > c.value) or (c.op == ">=" and fv >= c.value)):
                return True
    return False


# ---------------------------------------------------------------------------

@dataclass
class Message:
    data: Any
    events: Dict[str, List[str]] = field(default_factory=dict)


class Subscription:
    """Per-subscriber buffered queue (pubsub.go:29 Subscription)."""

    def __init__(self, out_capacity: int = 100):
        self.queue: "asyncio.Queue[Message]" = asyncio.Queue(maxsize=out_capacity)
        self._canceled = asyncio.Event()
        self.err: Optional[str] = None

    async def next(self) -> Message:
        get = asyncio.ensure_future(self.queue.get())
        cancel = asyncio.ensure_future(self._canceled.wait())
        done, pending = await asyncio.wait({get, cancel},
                                           return_when=asyncio.FIRST_COMPLETED)
        for p in pending:
            p.cancel()
        if get in done:
            return get.result()
        raise SubscriptionCanceled(self.err or "subscription canceled")

    def cancel(self, reason: str = "") -> None:
        self.err = reason
        self._canceled.set()

    @property
    def canceled(self) -> bool:
        return self._canceled.is_set()


class SubscriptionCanceled(Exception):
    pass


class PubSubServer:
    """(libs/pubsub/pubsub.go:90 Server) — subscriber × query routing.

    Async-native: publish never blocks the publisher; a full subscriber
    buffer cancels that subscriber (the reference's ErrOutOfCapacity path).
    """

    def __init__(self):
        # (subscriber_id, query) -> Subscription
        self._subs: Dict[Tuple[str, Query], Subscription] = {}

    def subscribe(self, subscriber: str, query: Query,
                  out_capacity: int = 100) -> Subscription:
        key = (subscriber, query)
        if key in self._subs:
            raise ValueError(f"already subscribed: {subscriber} to {query}")
        sub = Subscription(out_capacity)
        self._subs[key] = sub
        return sub

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        sub = self._subs.pop((subscriber, query), None)
        if sub is None:
            raise ValueError("subscription not found")
        sub.cancel("unsubscribed")

    def unsubscribe_all(self, subscriber: str) -> None:
        keys = [k for k in self._subs if k[0] == subscriber]
        if not keys:
            raise ValueError("subscription not found")
        for k in keys:
            self._subs.pop(k).cancel("unsubscribed")

    def num_clients(self) -> int:
        return len({k[0] for k in self._subs})

    def num_client_subscriptions(self, subscriber: str) -> int:
        return sum(1 for k in self._subs if k[0] == subscriber)

    def publish(self, data: Any, events: Optional[Dict[str, List[str]]] = None) -> None:
        events = events or {}
        msg = Message(data, events)
        dead = []
        for (subscriber, query), sub in self._subs.items():
            if sub.canceled:
                dead.append((subscriber, query))
                continue
            if query.matches(events):
                try:
                    sub.queue.put_nowait(msg)
                except asyncio.QueueFull:
                    sub.cancel("out of capacity")
                    dead.append((subscriber, query))
        for k in dead:
            self._subs.pop(k, None)
