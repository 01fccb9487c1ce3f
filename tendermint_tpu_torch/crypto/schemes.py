"""Per-chain signature-scheme registry (the scheme-agnostic crypto plane).

The consensus params of a chain (types/params.SignatureParams) say which
signature scheme its validators use and whether commits are aggregated.
Everything that builds or checks vote sign-bytes — signers, VoteSet, commit
rebuilds, evidence — asks this registry instead of assuming ed25519, keyed
by chain_id because sign-bytes only ever exist relative to a chain.

Registration happens wherever a chain's params become known:
`state_from_genesis` and `ConsensusState.update_to_state` (idempotent, so a
mid-chain param change re-registers).  An *unknown* chain_id resolves to the
ed25519 non-aggregated default, which keeps every pre-existing artifact
byte-identical: no registration, no behavior change.

Wire-side aggregated commits (types/block.AggregatedCommit) are
self-describing and verified by isinstance dispatch — a light client or
blocksync peer does not need this registry to check one.
"""

from __future__ import annotations

from dataclasses import dataclass

SCHEME_ED25519 = "ed25519"
SCHEME_BLS12381 = "bls12381"

# The timestamp every aggregated precommit signs over (unix epoch — encodes
# as an empty canonical Timestamp body).  Aggregation requires all signers
# to produce identical sign-bytes; the real timestamp travels separately as
# the commit's voting-power-weighted median.
AGG_ZERO_TS_NS = 0


@dataclass(frozen=True)
class Scheme:
    scheme: str = SCHEME_ED25519
    aggregate_commits: bool = False

    @property
    def zero_precommit_ts(self) -> bool:
        # Aggregation needs every validator to sign the *same* precommit
        # bytes, so the (per-validator) timestamp is zeroed in sign-bytes
        # and the commit carries a voting-power-weighted median instead.
        return self.aggregate_commits

    @property
    def is_default(self) -> bool:
        return self.scheme == SCHEME_ED25519 and not self.aggregate_commits


DEFAULT = Scheme()

_registry: dict = {}


def register_chain(chain_id: str, scheme) -> None:
    """Idempotent.  `scheme` is anything with .scheme / .aggregate_commits
    (crypto.schemes.Scheme or types.params.SignatureParams)."""
    sch = Scheme(scheme=scheme.scheme,
                 aggregate_commits=bool(scheme.aggregate_commits))
    if sch.is_default:
        _registry.pop(chain_id, None)
    else:
        _registry[chain_id] = sch


def for_chain(chain_id: str) -> Scheme:
    return _registry.get(chain_id, DEFAULT)


def aggregated(chain_id: str) -> bool:
    return _registry.get(chain_id, DEFAULT).aggregate_commits


def reset() -> None:
    _registry.clear()
