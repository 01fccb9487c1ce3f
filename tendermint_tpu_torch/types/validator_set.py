"""ValidatorSet: sorted set, deterministic proposer rotation, commit verification.

Semantics mirror reference types/validator_set.go exactly (int64 clipping,
priority rescale/center, update/removal merge order, error precedence in the
three VerifyCommit variants at :667/:722/:775). The difference is HOW commits
are verified: all candidate signatures are collected into one BatchVerifier
call (one batch through the CUDA verify kernels) and the scalar loop's
decisions — including VerifyCommitLight's early exit at 2/3 — are replayed
over the batch verdicts,
so accept/reject and error selection are byte-identical to the reference while
the crypto runs as one device batch instead of N host calls.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from ..crypto.batch import BatchVerifier
from ..device import is_device_fault
from .basic import BlockID, BlockIDFlag
from .errors import (
    ErrInvalidCommitHeight,
    ErrInvalidCommitSignatures,
    ErrNotEnoughVotingPowerSigned,
    ErrWrongSignature,
)
from .validator import (
    MAX_TOTAL_VOTING_POWER,
    PRIORITY_WINDOW_SIZE_FACTOR,
    Validator,
    safe_add_clip,
    safe_mul,
    safe_sub_clip,
)

# Fraction as (numerator, denominator) — reference libs/math.Fraction.
Fraction = Tuple[int, int]


def _is_aggregated(commit) -> bool:
    """Duck-typed (types.block.AggregatedCommit carries agg_sig/signers) so
    this module need not import types.block."""
    return hasattr(commit, "agg_sig")


def _observe_aggregated_wire_size(commit) -> None:
    """Feed the verified commit's encoded size into the aggregated-commit
    wire-size histogram (telemetry only; never affects the verdict)."""
    from ..crypto import phases as _phases

    m = _phases.metrics
    if m is None:
        return
    try:
        m.aggregated_commit_bytes.observe(float(len(commit.encode())))
    except Exception:
        pass


def _by_voting_power(v: Validator):
    """Sort key: power desc, address asc (reference types/validator.go ValidatorsByVotingPower)."""
    return (-v.voting_power, v.address)


class ValidatorSet:
    def __init__(self, validators: Optional[Sequence[Validator]] = None):
        """NewValidatorSet semantics (validator_set.go:70): copies, validates,
        sorts, and runs one IncrementProposerPriority(1)."""
        self.validators: List[Validator] = []
        self.proposer: Optional[Validator] = None
        self._total_voting_power: Optional[int] = None
        # structural-mutation counter: every mutator that changes membership
        # or ORDER bumps it, so the _addr_index/hash memos below cannot go
        # stale even for an in-place mutation that preserves the list
        # object's identity and length (advisor finding at _addr_index)
        self._mutations = 0
        if validators is not None:
            self._update_with_change_set([v.copy() for v in validators], allow_deletes=False)
            if len(self.validators) > 0:
                self.increment_proposer_priority(1)

    @classmethod
    def from_existing(cls, validators: Sequence[Validator]) -> "ValidatorSet":
        """(validator_set.go ValidatorSetFromExistingValidators) rebuild a
        set whose proposer priorities are ALREADY live — RPC /validators
        answers, statesync bootstrap — without NewValidatorSet's extra
        IncrementProposerPriority(1). The proposer is recovered from the
        existing priorities; re-incrementing here desynchronizes proposer
        selection from the running network (found by the statesync e2e
        manifest: the synced node rejected every proposal)."""
        vs = cls()
        vs.validators = sorted((v.copy() for v in validators),
                               key=_by_voting_power)
        vs._bump_mutations()
        if vs.validators:
            # findPreviousProposer (validator_set.go:832): the chosen
            # proposer was decremented by the total power, so it is the one
            # that LOSES the priority comparison against every other
            prev = None
            for v in vs.validators:
                if prev is None:
                    prev = v
                elif prev is prev.compare_proposer_priority(v):
                    prev = v
            vs.proposer = prev
        return vs

    # -- basic accessors ---------------------------------------------------

    def __len__(self) -> int:
        return len(self.validators)

    def size(self) -> int:
        return len(self.validators)

    def is_nil_or_empty(self) -> bool:
        return len(self.validators) == 0

    def copy(self) -> "ValidatorSet":
        vs = ValidatorSet()
        vs.validators = [v.copy() for v in self.validators]
        vs.proposer = self.proposer
        vs._total_voting_power = self._total_voting_power
        # membership and powers are identical, so the merkle hash carries
        # over (priorities are not part of bytes_for_hash); re-keyed to the
        # copy's own list + mutation count so later structural mutations
        # invalidate normally
        cache = self.__dict__.get("_hash_cache")
        if cache is not None and cache[0] is self.validators \
                and cache[1] == self._mutations \
                and cache[2] == len(self.validators):
            vs.__dict__["_hash_cache"] = (vs.validators, vs._mutations,
                                          len(vs.validators), cache[3])
        return vs

    def _bump_mutations(self) -> None:
        """Every structural mutator (membership OR order change) must call
        this; the _addr_index/hash memos key on the counter, so an in-place
        mutation that preserves list identity and length still invalidates."""
        self._mutations += 1

    def _addr_index(self) -> dict:
        """address -> index, rebuilt whenever the validators list object is
        replaced, resized, or a structural mutator bumps ``_mutations``
        (priority updates mutate Validator objects but never addresses or
        order, so the cache stays valid across IncrementProposerPriority).
        At light-client/commit-verification scale the linear scan was the
        single hottest host-side cost (1000-validator sets x 32k lookups)."""
        cache = self.__dict__.get("_addr_cache")
        if (cache is None or cache[0] is not self.validators
                or cache[1] != self._mutations
                or cache[2] != len(self.validators)):
            idx: dict = {}
            for i, v in enumerate(self.validators):
                idx.setdefault(v.address, i)  # first match wins, like the scan
            cache = (self.validators, self._mutations, len(self.validators),
                     idx)
            self.__dict__["_addr_cache"] = cache
        return cache[3]

    def has_address(self, address: bytes) -> bool:
        return address in self._addr_index()

    def get_by_address(self, address: bytes) -> Tuple[int, Optional[Validator]]:
        i = self._addr_index().get(address)
        if i is None:
            return -1, None
        return i, self.validators[i].copy()

    def get_by_index(self, index: int) -> Tuple[bytes, Optional[Validator]]:
        if index < 0 or index >= len(self.validators):
            return b"", None
        v = self.validators[index]
        return v.address, v.copy()

    def total_voting_power(self) -> int:
        if self._total_voting_power is None:
            self._update_total_voting_power()
        return self._total_voting_power

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total = safe_add_clip(total, v.voting_power)
            if total > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power cannot be guarded to not exceed {MAX_TOTAL_VOTING_POWER}; got: {total}"
                )
        self._total_voting_power = total

    def hash(self) -> bytes:
        """Merkle root of SimpleValidator encodings (validator_set.go:347).

        Memoized under the same invalidation contract as _addr_index (list
        identity + length + the structural mutation counter): priority
        rotation — the only in-place mutation that doesn't bump the counter
        — does not touch bytes_for_hash. validate_block hashes two
        1000-validator sets per block, and copy() propagates the memo, so
        steady-state fast sync pays the merkle pass only when membership
        actually changes."""
        cache = self.__dict__.get("_hash_cache")
        if (cache is None or cache[0] is not self.validators
                or cache[1] != self._mutations
                or cache[2] != len(self.validators)):
            from ..crypto import merkle

            h = merkle.hash_from_byte_slices(
                [v.bytes_for_hash() for v in self.validators])
            cache = (self.validators, self._mutations, len(self.validators), h)
            self.__dict__["_hash_cache"] = cache
        return cache[3]

    def validate_basic(self) -> None:
        if self.is_nil_or_empty():
            raise ValueError("validator set is nil or empty")
        for idx, v in enumerate(self.validators):
            try:
                v.validate_basic()
            except ValueError as e:
                raise ValueError(f"invalid validator #{idx}: {e}")
        if self.proposer is None:
            raise ValueError("proposer failed validate basic, error: nil validator")
        self.proposer.validate_basic()

    # -- proposer rotation (validator_set.go:107-256) ----------------------

    def get_proposer(self) -> Optional[Validator]:
        if len(self.validators) == 0:
            return None
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer.copy()

    def _find_proposer(self) -> Validator:
        proposer = None
        for v in self.validators:
            proposer = v if proposer is None else proposer.compare_proposer_priority(v)
        return proposer

    def increment_proposer_priority(self, times: int) -> None:
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("cannot call IncrementProposerPriority with non-positive times")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        c = self.copy()
        c.increment_proposer_priority(times)
        return c

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = safe_add_clip(v.proposer_priority, v.voting_power)
        mostest = self._find_proposer()
        mostest.proposer_priority = safe_sub_clip(mostest.proposer_priority, self.total_voting_power())
        return mostest

    def rescale_priorities(self, diff_max: int) -> None:
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if diff_max <= 0:
            return
        diff = self._max_min_priority_diff()
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                # Go int division truncates toward zero; Python floors.
                p = v.proposer_priority
                v.proposer_priority = -((-p) // ratio) if p < 0 else p // ratio

    def _max_min_priority_diff(self) -> int:
        mx = max(v.proposer_priority for v in self.validators)
        mn = min(v.proposer_priority for v in self.validators)
        return abs(mx - mn)

    def _compute_avg_proposer_priority(self) -> int:
        n = len(self.validators)
        s = sum(v.proposer_priority for v in self.validators)
        # Go big.Int Div floors (Euclidean for positive divisor) — matches //.
        return s // n

    def _shift_by_avg_proposer_priority(self) -> None:
        avg = self._compute_avg_proposer_priority()
        for v in self.validators:
            v.proposer_priority = safe_sub_clip(v.proposer_priority, avg)

    # -- updates (validator_set.go:371-665) --------------------------------

    def update_with_change_set(self, changes: Sequence[Validator]) -> None:
        self._update_with_change_set([c.copy() for c in changes], allow_deletes=True)

    def _update_with_change_set(self, changes: List[Validator], allow_deletes: bool) -> None:
        if len(changes) == 0:
            return
        updates, deletes = _process_changes(changes)
        if not allow_deletes and deletes:
            raise ValueError(f"cannot process validators with voting power 0: {deletes}")
        num_new = sum(1 for u in updates if not self.has_address(u.address))
        if num_new == 0 and len(self.validators) == len(deletes):
            raise ValueError("applying the validator changes would result in empty set")
        removed_power = self._verify_removals(deletes)
        tvp_after_updates = self._verify_updates(updates, removed_power)
        self._compute_new_priorities(updates, tvp_after_updates)
        self._apply_updates(updates)
        self._apply_removals(deletes)
        self._total_voting_power = None
        self._update_total_voting_power()
        self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        # reassign (not in-place sort) AND bump: either alone invalidates
        # the _addr_index/hash memos; both keeps the invariant obvious
        self.validators = sorted(self.validators, key=_by_voting_power)
        self._bump_mutations()

    def _verify_removals(self, deletes: List[Validator]) -> int:
        removed = 0
        for d in deletes:
            _, val = self.get_by_address(d.address)
            if val is None:
                raise ValueError(f"failed to find validator {d.address.hex().upper()} to remove")
            removed += val.voting_power
        if len(deletes) > len(self.validators):
            raise ValueError("more deletes than validators")
        return removed

    def _verify_updates(self, updates: List[Validator], removed_power: int) -> int:
        def delta(u: Validator) -> int:
            _, val = self.get_by_address(u.address)
            return u.voting_power - val.voting_power if val is not None else u.voting_power

        ordered = sorted(updates, key=delta)
        tvp_after_removals = self.total_voting_power() - removed_power
        for u in ordered:
            tvp_after_removals += delta(u)
            if tvp_after_removals > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power of resulting valset exceeds max {MAX_TOTAL_VOTING_POWER}"
                )
        return tvp_after_removals + removed_power

    def _compute_new_priorities(self, updates: List[Validator], updated_tvp: int) -> None:
        for u in updates:
            _, val = self.get_by_address(u.address)
            if val is None:
                # -1.125*totalVotingPower so rejoining validators can't reset
                # their priority (validator_set.go:483-490).
                u.proposer_priority = -(updated_tvp + (updated_tvp >> 3))
            else:
                u.proposer_priority = val.proposer_priority

    def _apply_updates(self, updates: List[Validator]) -> None:
        existing = sorted(self.validators, key=lambda v: v.address)
        merged: List[Validator] = []
        i = j = 0
        while i < len(existing) and j < len(updates):
            if existing[i].address < updates[j].address:
                merged.append(existing[i])
                i += 1
            else:
                merged.append(updates[j])
                if existing[i].address == updates[j].address:
                    i += 1
                j += 1
        merged.extend(existing[i:])
        merged.extend(updates[j:])
        self.validators = merged

    def _apply_removals(self, deletes: List[Validator]) -> None:
        if not deletes:
            return
        dset = {d.address for d in deletes}
        self.validators = [v for v in self.validators if v.address not in dset]

    # -- commit verification (validator_set.go:667-821) --------------------
    #
    # Each variant: one batched device call over the candidate signatures,
    # then a sequential replay of the reference's scalar loop over the
    # verdicts so error precedence and early exits match exactly.

    def verify_commit(self, chain_id: str, block_id: BlockID, height: int, commit) -> None:
        """All signatures checked; absent skipped; nil votes verified but not
        tallied (validator_set.go:667)."""
        self._check_commit_shape(commit, height, block_id)
        if _is_aggregated(commit):
            return self._verify_aggregated(chain_id, commit, mode="full")
        idxs = [i for i, cs in enumerate(commit.signatures) if not cs.absent()]
        ok = self._batch_verify(chain_id, commit, idxs)
        tallied = 0
        needed = self.total_voting_power() * 2 // 3
        for pos, idx in enumerate(idxs):
            cs = commit.signatures[idx]
            if not ok[pos]:
                raise ErrWrongSignature(idx, cs.signature)
            if cs.for_block():
                tallied += self.validators[idx].voting_power
        if tallied <= needed:
            raise ErrNotEnoughVotingPowerSigned(tallied, needed)

    def verify_commit_light(self, chain_id: str, block_id: BlockID, height: int, commit) -> None:
        """Stops at 2/3: signatures after the early-exit point are never
        examined (validator_set.go:722) — the replay preserves that."""
        self._check_commit_shape(commit, height, block_id)
        if _is_aggregated(commit):
            # one pairing over the whole bitmap: there is no cheaper
            # early-exit prefix to stop at
            return self._verify_aggregated(chain_id, commit, mode="light")
        idxs = [i for i, cs in enumerate(commit.signatures) if cs.for_block()]
        ok = self._batch_verify(chain_id, commit, idxs, plane="light")
        tallied = 0
        needed = self.total_voting_power() * 2 // 3
        for pos, idx in enumerate(idxs):
            if not ok[pos]:
                raise ErrWrongSignature(idx, commit.signatures[idx].signature)
            tallied += self.validators[idx].voting_power
            if tallied > needed:
                return
        raise ErrNotEnoughVotingPowerSigned(tallied, needed)

    def verify_commit_light_trusting(self, chain_id: str, commit,
                                     trust_level: Fraction,
                                     commit_vals: "ValidatorSet" = None) -> None:
        """Address-lookup variant over a *trusted* set (validator_set.go:775).

        `commit_vals` is only consulted for aggregated commits: the aggregate
        signature covers every key in the signer bitmap — positioned by index
        into the COMMIT's validator set, which the trusted set (self) may not
        contain — so the pairing needs the commit-height set while the
        trust-level tally intersects the bitmap with self."""
        numer, denom = trust_level
        if denom == 0:
            raise ValueError("trustLevel has zero Denominator")
        total_mul, overflow = safe_mul(self.total_voting_power(), numer)
        if overflow:
            raise OverflowError(
                "int64 overflow while calculating voting power needed. "
                "please provide smaller trustLevel numerator"
            )
        needed = total_mul // denom

        if _is_aggregated(commit):
            return self._verify_aggregated_trusting(
                chain_id, commit, needed, commit_vals)

        # Candidates: for-block sigs whose address is in the trusted set.
        cand: List[Tuple[int, int, Validator]] = []  # (commit idx, val idx, val)
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            val_idx, val = self.get_by_address(cs.validator_address)
            if val is not None:
                cand.append((idx, val_idx, val))
        ok = self._batch_verify(chain_id, commit, [c[0] for c in cand],
                                pubkeys=[c[2].pub_key for c in cand],
                                plane="light")
        tallied = 0
        seen = {}
        for pos, (idx, val_idx, val) in enumerate(cand):
            if val_idx in seen:
                raise ValueError(f"double vote from {val}: ({seen[val_idx]} and {idx})")
            seen[val_idx] = idx
            if not ok[pos]:
                raise ErrWrongSignature(idx, commit.signatures[idx].signature)
            tallied += val.voting_power
            if tallied > needed:
                return
        raise ErrNotEnoughVotingPowerSigned(tallied, needed)

    def _check_commit_shape(self, commit, height: int, block_id: BlockID) -> None:
        # commit.size(): CommitSig rows for plain commits, signer-bitmap
        # length for aggregated ones — both must equal the set size
        if self.size() != commit.size():
            raise ErrInvalidCommitSignatures(self.size(), commit.size())
        if height != commit.height:
            raise ErrInvalidCommitHeight(height, commit.height)
        if block_id != commit.block_id:
            raise ValueError(
                f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
            )

    def _verify_aggregated(self, chain_id: str, commit,
                           mode: str = "full") -> None:
        """One fast-aggregate-verify replaces the per-signature batch: apk
        over the bitmap's pubkeys, pairing against the shared zero-timestamp
        sign-bytes. Error precedence mirrors the scalar replay — shape
        (caller), then signature (ErrWrongSignature), then the 2/3 tally
        (ErrNotEnoughVotingPowerSigned)."""
        from ..crypto.bls12381.vec import fast_aggregate_verify_routed

        _observe_aggregated_wire_size(commit)
        signer_idxs = commit.signers.true_indices()
        pks = [self.validators[i].pub_key.bytes() for i in signer_idxs]
        msg = commit.sign_message(chain_id)
        if not fast_aggregate_verify_routed(pks, msg, commit.agg_sig,
                                            mode=mode):
            raise ErrWrongSignature(-1, commit.agg_sig)
        tallied = sum(self.validators[i].voting_power for i in signer_idxs)
        needed = self.total_voting_power() * 2 // 3
        if tallied <= needed:
            raise ErrNotEnoughVotingPowerSigned(tallied, needed)

    def _verify_aggregated_trusting(self, chain_id: str, commit, needed: int,
                                    commit_vals: "ValidatorSet") -> None:
        """Trusting-mode aggregate check: the pairing must run over the FULL
        bitmap (the aggregate covers every signer), keyed by the commit
        validator set; only the trusted intersection tallies toward the
        trust level."""
        from ..crypto.bls12381.vec import fast_aggregate_verify_routed

        if commit_vals is None:
            # self must BE the commit-height set then (e.g. evidence checks
            # against the recorded set); a size mismatch means it is not
            commit_vals = self
        if commit_vals.size() != commit.size():
            raise ErrInvalidCommitSignatures(commit_vals.size(), commit.size())
        _observe_aggregated_wire_size(commit)
        signer_idxs = commit.signers.true_indices()
        pks = [commit_vals.validators[i].pub_key.bytes() for i in signer_idxs]
        msg = commit.sign_message(chain_id)
        if not fast_aggregate_verify_routed(pks, msg, commit.agg_sig,
                                            mode="trusting"):
            raise ErrWrongSignature(-1, commit.agg_sig)
        addr_idx = self._addr_index()
        tallied = 0
        for i in signer_idxs:
            val_idx = addr_idx.get(commit_vals.validators[i].address)
            if val_idx is None:
                continue
            tallied += self.validators[val_idx].voting_power
            if tallied > needed:
                return
        raise ErrNotEnoughVotingPowerSigned(tallied, needed)

    def _batch_verify(self, chain_id: str, commit, idxs: Sequence[int],
                      pubkeys: Optional[Sequence] = None,
                      plane: str = "votes") -> List[bool]:
        if not idxs:
            return []
        bv = BatchVerifier(plane=plane)
        # amortized sign-bytes: one shared-field encode for the whole commit
        # instead of len(idxs) canonical encodes (the host-side cost floor)
        sb = (commit.vote_sign_bytes_all(chain_id) if len(idxs) > 32
              else None)
        for pos, idx in enumerate(idxs):
            pk = pubkeys[pos] if pubkeys is not None else self.validators[idx].pub_key
            msg = sb[idx] if sb is not None else commit.vote_sign_bytes(chain_id, idx)
            bv.add(pk, msg, commit.signatures[idx].signature)
        if sb is not None:
            # columnar fast path: hand the device packer the commit's
            # sign-bytes structure (template + varying timestamp columns)
            # so it skips the per-segment join + diff re-discovery. None
            # for structurally non-uniform commits (nil votes mixed in).
            cols = commit.vote_sign_bytes_columns(chain_id)
            if cols is not None:
                bv.set_columns(cols.subset(idxs))
        _, per_item = bv.verify()
        return [bool(b) for b in per_item]

    # -- proto ------------------------------------------------------------

    def encode(self) -> bytes:
        from ..libs import protowire as pw

        w = pw.Writer()
        for v in self.validators:
            w.message(1, v.encode())
        if self.proposer is not None:
            w.message(2, self.proposer.encode())
        w.varint(3, self.total_voting_power())
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "ValidatorSet":
        from ..libs import protowire as pw

        vs = ValidatorSet()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                vs.validators.append(Validator.decode(v))
            elif fn == 2:
                vs.proposer = Validator.decode(v)
        vs._total_voting_power = None
        vs._bump_mutations()
        return vs


def verify_commit_light_batched(
    entries: Sequence[Tuple["ValidatorSet", str, BlockID, int, object]],
) -> List[Optional[Exception]]:
    """Window-batched VerifyCommitLight: many (valset, commit) pairs, ONE
    device call.

    The fast-sync replay path (reference blockchain/v0/reactor.go:255 verifies
    one commit per loop iteration) is the TPU batch opportunity: all candidate
    signatures across a window of contiguous blocks go to the device together,
    then each commit's scalar precedence loop — including the 2/3 early exit —
    is replayed over its verdict slice. Per-entry outcome is None (ok) or the
    exact exception verify_commit_light would have raised.

    Entries: (val_set, chain_id, block_id, height, commit).
    """
    bv = BatchVerifier(plane="light")
    slices: List[Tuple[int, List[int]]] = []  # (batch offset, candidate idxs)
    shape_errors: List[Optional[Exception]] = []
    agg_done: dict = {}  # entry position -> result for aggregated commits
    off = 0
    for pos_e, (val_set, chain_id, block_id, height, commit) in enumerate(entries):
        if _is_aggregated(commit):
            # already one pairing per commit — nothing to fold into the
            # ed25519 batch; verify inline and record the outcome
            try:
                val_set.verify_commit_light(chain_id, block_id, height, commit)
                agg_done[pos_e] = None
            except Exception as e:
                if is_device_fault(e):
                    raise  # a fault of the card is no verdict on the entry
                agg_done[pos_e] = e
            shape_errors.append(None)
            slices.append((off, []))
            continue
        try:
            val_set._check_commit_shape(commit, height, block_id)
        except Exception as e:  # shape errors surface per-entry, not batch-wide
            shape_errors.append(e)
            slices.append((off, []))
            continue
        shape_errors.append(None)
        idxs = [i for i, cs in enumerate(commit.signatures) if cs.for_block()]
        sb = commit.vote_sign_bytes_all(chain_id)
        vals = val_set.validators
        for idx in idxs:
            bv.add(vals[idx].pub_key, sb[idx], commit.signatures[idx].signature)
        slices.append((off, idxs))
        off += len(idxs)
    _, per_item = bv.verify()

    results: List[Optional[Exception]] = []
    for pos_e, (entry, shape_err, (start, idxs)) in enumerate(
            zip(entries, shape_errors, slices)):
        if pos_e in agg_done:
            results.append(agg_done[pos_e])
            continue
        if shape_err is not None:
            results.append(shape_err)
            continue
        val_set, chain_id, block_id, height, commit = entry
        tallied = 0
        needed = val_set.total_voting_power() * 2 // 3
        err: Optional[Exception] = None
        for pos, idx in enumerate(idxs):
            if not per_item[start + pos]:
                err = ErrWrongSignature(idx, commit.signatures[idx].signature)
                break
            tallied += val_set.validators[idx].voting_power
            if tallied > needed:
                break
        else:
            err = ErrNotEnoughVotingPowerSigned(tallied, needed)
        results.append(err)
    return results


def verify_commit_light_trusting_batched(
    entries: Sequence[Tuple["ValidatorSet", str, object, "Fraction"]],
) -> List[Optional[Exception]]:
    """Window-batched VerifyCommitLightTrusting: the light client's bisection
    walk verifies a chain of headers against a *trusted* set
    (validator_set.go:775, light/verifier.go:32) — all candidate signatures
    across the window ride one batched device call, then each commit's
    scalar precedence loop (address lookup, duplicate-vote check, trust-level
    tally with early exit) replays over its verdict slice.

    Entries: (trusted_val_set, chain_id, commit, trust_level) or, for
    aggregated commits crossing a valset change, the 5-tuple
    (..., commit_vals) carrying the commit-height validator set — the
    bitmap indexes into THAT set, so the pairing needs it whenever it
    differs from the trusted set (mirrors light/verifier.py
    verify_non_adjacent).  Per-entry outcome is None (ok) or the exact
    exception verify_commit_light_trusting would have raised.
    """
    bv = BatchVerifier(plane="light")
    slices: List[Tuple[int, List[Tuple[int, int, Validator]]]] = []
    pre_errors: List[Optional[Exception]] = []
    needed_list: List[int] = []
    agg_done: dict = {}  # entry position -> result for aggregated commits
    off = 0
    for pos_e, entry in enumerate(entries):
        val_set, chain_id, commit, trust_level = entry[:4]
        if _is_aggregated(commit):
            commit_vals = entry[4] if len(entry) > 4 else None
            try:
                val_set.verify_commit_light_trusting(chain_id, commit,
                                                     trust_level,
                                                     commit_vals=commit_vals)
                agg_done[pos_e] = None
            except Exception as e:
                if is_device_fault(e):
                    raise  # a fault of the card is no verdict on the entry
                agg_done[pos_e] = e
            pre_errors.append(None)
            slices.append((off, []))
            needed_list.append(0)
            continue
        numer, denom = trust_level
        if denom == 0:
            pre_errors.append(ValueError("trustLevel has zero Denominator"))
            slices.append((off, []))
            needed_list.append(0)
            continue
        total_mul, overflow = safe_mul(val_set.total_voting_power(), numer)
        if overflow:
            pre_errors.append(OverflowError(
                "int64 overflow while calculating voting power needed. "
                "please provide smaller trustLevel numerator"
            ))
            slices.append((off, []))
            needed_list.append(0)
            continue
        pre_errors.append(None)
        needed_list.append(total_mul // denom)
        sb = commit.vote_sign_bytes_all(chain_id)
        addr_idx = val_set._addr_index()
        vals = val_set.validators
        cand: List[Tuple[int, int, Validator]] = []
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            val_idx = addr_idx.get(cs.validator_address)
            if val_idx is not None:
                val = vals[val_idx]
                cand.append((idx, val_idx, val))
                bv.add(val.pub_key, sb[idx], cs.signature)
        slices.append((off, cand))
        off += len(cand)
    _, per_item = bv.verify()

    results: List[Optional[Exception]] = []
    for pos_e, (entry, pre_err, (start, cand), needed) in enumerate(zip(
            entries, pre_errors, slices, needed_list)):
        if pos_e in agg_done:
            results.append(agg_done[pos_e])
            continue
        if pre_err is not None:
            results.append(pre_err)
            continue
        commit = entry[2]
        tallied = 0
        seen: dict = {}
        err: Optional[Exception] = None
        for pos, (idx, val_idx, val) in enumerate(cand):
            if val_idx in seen:
                err = ValueError(
                    f"double vote from {val}: ({seen[val_idx]} and {idx})")
                break
            seen[val_idx] = idx
            if not per_item[start + pos]:
                err = ErrWrongSignature(idx, commit.signatures[idx].signature)
                break
            tallied += val.voting_power
            if tallied > needed:
                break
        else:
            err = ErrNotEnoughVotingPowerSigned(tallied, needed)
        results.append(err)
    return results


def _process_changes(changes: List[Validator]) -> Tuple[List[Validator], List[Validator]]:
    """Sort by address, reject dups/negatives, split updates/removals
    (validator_set.go:373)."""
    ordered = sorted(changes, key=lambda v: v.address)
    updates: List[Validator] = []
    removals: List[Validator] = []
    prev_addr = None
    for u in ordered:
        if u.address == prev_addr:
            raise ValueError(f"duplicate entry {u} in {ordered}")
        if u.voting_power < 0:
            raise ValueError(f"voting power can't be negative: {u.voting_power}")
        if u.voting_power > MAX_TOTAL_VOTING_POWER:
            raise ValueError(
                f"to prevent clipping/overflow, voting power can't be higher than "
                f"{MAX_TOTAL_VOTING_POWER}, got {u.voting_power}"
            )
        (removals if u.voting_power == 0 else updates).append(u)
        prev_addr = u.address
    return updates, removals
