"""Phase0 LMD-GHOST fork choice: the ``Store``, its handlers and the
proposer re-org helpers.

Counterpart of ``consensus_specs_tpu/forks/fork_choice.py``, with the
same behavior as ``specs/phase0/fork-choice.md``: the ``Store`` event
machine (``:113``), ``get_forkchoice_store`` (``:157``), weight
accounting with proposer boost (``get_weight`` ``:249``,
``get_proposer_score`` ``:237``), viable-branch filtering with pulled-up
voting sources (``filter_block_tree`` ``:292``, ``get_voting_source``
``:273``), head selection (``get_head`` ``:361``), the proposer re-org
helpers (``get_proposer_head`` ``:474``), pull-up tips
(``compute_pulled_up_tip`` ``:523``) and the four handlers ``on_tick``
(``:636``), ``on_block`` (``:649``), ``on_attestation`` (``:699``) and
``on_attester_slashing`` (``:724``), plus ``specs/fork_choice/safe-block.md``.

As in the JAX package: ``get_ancestor`` is iterative; ``filter_block_tree``
walks an explicit stack over a parent->children index; the
``checkpoint_states`` are keyed by ``(epoch, root)`` tuples.  The method
bodies stay spec-shaped.  ``install_forkchoice_accel`` at the bottom
(``forkchoice/proto_array.py``) wraps them from the outside:
``get_head``, ``get_weight`` and ``get_filtered_block_tree`` go to the
proto-array engine (``use_spec()`` sends them to the spec loops), and
the handlers feed it.

``on_block`` runs the fork's data-availability hook and
``state_transition`` in one ``bls.batched_verification()`` scope: a
Deneb block's blob batch and an EIP-7594 block's cell batches join the
block's signature checks in one product pairing, flushed (and
``assert_valid``) before the store is written.  Opened inside a caller's
``bls.scoped_batch``, the scope joins the caller's batch, so the caller
reads the flush's ``pairings`` and ``last_results``.  The forks override
the two hooks: Bellatrix's merge-block check (Capella's no-op), Deneb's
data-availability check (EIP-7594's sampling reaches it through its own
``is_data_available``).  The JAX package's tracing install is not
carried.
"""
from dataclasses import dataclass, field
from typing import Dict, Set, Tuple

from ..forkchoice.proto_array import install_forkchoice_accel
from ..utils import bls
from ..utils.ssz import hash_tree_root

INTERVALS_PER_SLOT = 3


@dataclass(eq=True, frozen=True)
class LatestMessage:
    epoch: int
    root: bytes


@dataclass
class Store:
    time: int
    genesis_time: int
    justified_checkpoint: object
    finalized_checkpoint: object
    unrealized_justified_checkpoint: object
    unrealized_finalized_checkpoint: object
    proposer_boost_root: bytes
    equivocating_indices: Set[int]
    blocks: Dict[bytes, object] = field(default_factory=dict)
    block_states: Dict[bytes, object] = field(default_factory=dict)
    block_timeliness: Dict[bytes, bool] = field(default_factory=dict)
    checkpoint_states: Dict[Tuple[int, bytes], object] = field(default_factory=dict)
    latest_messages: Dict[int, LatestMessage] = field(default_factory=dict)
    unrealized_justifications: Dict[bytes, object] = field(default_factory=dict)


def _ckpt_key(checkpoint) -> Tuple[int, bytes]:
    return (int(checkpoint.epoch), bytes(checkpoint.root))


class ForkChoiceMixin:
    """Fork-choice methods mixed into the per-fork spec classes."""

    LatestMessage = LatestMessage
    Store = Store
    INTERVALS_PER_SLOT = INTERVALS_PER_SLOT

    # -- store construction -------------------------------------------------

    def get_forkchoice_store(self, anchor_state, anchor_block) -> Store:
        assert bytes(anchor_block.state_root) == hash_tree_root(anchor_state)
        anchor_root = hash_tree_root(anchor_block)
        anchor_epoch = self.get_current_epoch(anchor_state)
        justified = self.Checkpoint(epoch=anchor_epoch, root=anchor_root)
        finalized = self.Checkpoint(epoch=anchor_epoch, root=anchor_root)
        return Store(
            time=int(anchor_state.genesis_time
                     + self.config.SECONDS_PER_SLOT * anchor_state.slot),
            genesis_time=int(anchor_state.genesis_time),
            justified_checkpoint=justified,
            finalized_checkpoint=finalized,
            unrealized_justified_checkpoint=justified.copy(),
            unrealized_finalized_checkpoint=finalized.copy(),
            proposer_boost_root=b"\x00" * 32,
            equivocating_indices=set(),
            blocks={anchor_root: anchor_block.copy()},
            block_states={anchor_root: anchor_state.copy()},
            checkpoint_states={_ckpt_key(justified): anchor_state.copy()},
            unrealized_justifications={anchor_root: justified.copy()},
        )

    # -- time helpers -------------------------------------------------------

    def get_slots_since_genesis(self, store) -> int:
        return (store.time - store.genesis_time) // int(self.config.SECONDS_PER_SLOT)

    def get_current_slot(self, store):
        return self.Slot(self.GENESIS_SLOT + self.get_slots_since_genesis(store))

    def get_current_store_epoch(self, store):
        return self.compute_epoch_at_slot(self.get_current_slot(store))

    def compute_slots_since_epoch_start(self, slot) -> int:
        return int(slot - self.compute_start_slot_at_epoch(
            self.compute_epoch_at_slot(slot)))

    def is_previous_epoch_justified(self, store) -> bool:
        return (store.justified_checkpoint.epoch + 1
                == self.get_current_store_epoch(store))

    # -- chain walking ------------------------------------------------------

    def get_ancestor(self, store, root, slot):
        root = bytes(root)
        block = store.blocks[root]
        while block.slot > slot:
            root = bytes(block.parent_root)
            block = store.blocks[root]
        return self.Root(root)

    def get_checkpoint_block(self, store, root, epoch):
        """Root of the checkpoint block at ``epoch`` on the chain of ``root``."""
        return self.get_ancestor(store, root,
                                 self.compute_start_slot_at_epoch(epoch))

    # -- weights ------------------------------------------------------------

    def calculate_committee_fraction(self, state, committee_percent):
        committee_weight = (self.get_total_active_balance(state)
                            // self.SLOTS_PER_EPOCH)
        return self.Gwei(committee_weight * committee_percent // 100)

    def get_proposer_score(self, store):
        justified_state = store.checkpoint_states[_ckpt_key(store.justified_checkpoint)]
        committee_weight = (self.get_total_active_balance(justified_state)
                            // self.SLOTS_PER_EPOCH)
        return self.Gwei(committee_weight * self.config.PROPOSER_SCORE_BOOST // 100)

    def get_weight(self, store, root):
        state = store.checkpoint_states[_ckpt_key(store.justified_checkpoint)]
        root = bytes(root)
        block_slot = store.blocks[root].slot
        score = 0
        for i in self.get_active_validator_indices(state, self.get_current_epoch(state)):
            if state.validators[i].slashed:
                continue
            msg = store.latest_messages.get(int(i))
            if msg is None or int(i) in store.equivocating_indices:
                continue
            if bytes(self.get_ancestor(store, msg.root, block_slot)) == root:
                score += int(state.validators[i].effective_balance)
        if bytes(store.proposer_boost_root) != b"\x00" * 32:
            if bytes(self.get_ancestor(
                    store, store.proposer_boost_root, block_slot)) == root:
                score += int(self.get_proposer_score(store))
        return self.Gwei(score)

    # -- viability filtering ------------------------------------------------

    def get_voting_source(self, store, block_root):
        """The justification a vote for ``block_root`` would carry
        (pulled up for blocks from prior epochs)."""
        block_root = bytes(block_root)
        block = store.blocks[block_root]
        if self.get_current_store_epoch(store) > self.compute_epoch_at_slot(block.slot):
            return store.unrealized_justifications[block_root]
        return store.block_states[block_root].current_justified_checkpoint

    def _children_index(self, store) -> Dict[bytes, list]:
        children: Dict[bytes, list] = {}
        for root, block in store.blocks.items():
            children.setdefault(bytes(block.parent_root), []).append(root)
        return children

    def _leaf_viable(self, store, block_root) -> bool:
        current_epoch = self.get_current_store_epoch(store)
        voting_source = self.get_voting_source(store, block_root)
        correct_justified = (
            store.justified_checkpoint.epoch == self.GENESIS_EPOCH
            or voting_source.epoch == store.justified_checkpoint.epoch
            or voting_source.epoch + 2 >= current_epoch)
        finalized_block = self.get_checkpoint_block(
            store, block_root, store.finalized_checkpoint.epoch)
        correct_finalized = (
            store.finalized_checkpoint.epoch == self.GENESIS_EPOCH
            or bytes(store.finalized_checkpoint.root) == bytes(finalized_block))
        return correct_justified and correct_finalized

    def filter_block_tree(self, store, block_root, blocks) -> bool:
        """Keep subtrees whose leaves carry the expected justification and
        finalization; explicit post-order walk instead of recursion."""
        children = self._children_index(store)
        viable: Dict[bytes, bool] = {}
        order = []
        stack = [bytes(block_root)]
        while stack:
            r = stack.pop()
            order.append(r)
            stack.extend(children.get(r, []))
        for r in reversed(order):
            kids = children.get(r, [])
            if kids:
                ok = any(viable[k] for k in kids)
            else:
                ok = self._leaf_viable(store, r)
            viable[r] = ok
            if ok:
                blocks[r] = store.blocks[r]
        return viable[bytes(block_root)]

    def get_filtered_block_tree(self, store):
        base = bytes(store.justified_checkpoint.root)
        blocks: Dict[bytes, object] = {}
        self.filter_block_tree(store, base, blocks)
        return blocks

    def get_head(self, store):
        blocks = self.get_filtered_block_tree(store)
        head = bytes(store.justified_checkpoint.root)
        children_of: Dict[bytes, list] = {}
        for root, block in blocks.items():
            children_of.setdefault(bytes(block.parent_root), []).append(root)
        while True:
            children = children_of.get(head, [])
            if not children:
                return self.Root(head)
            head = max(children,
                       key=lambda r: (int(self.get_weight(store, r)), r))

    def get_safe_beacon_block_root(self, store):
        """specs/fork_choice/safe-block.md — the engine-API ``safe`` tag:
        the most recent justified block (reorging it needs a slashable
        supermajority equivocation)."""
        return self.Root(store.justified_checkpoint.root)

    def get_safe_execution_payload_hash(self, store):
        """safe-block.md — the safe block's payload hash, or the zero
        hash for pre-merge blocks."""
        safe_block_root = self.get_safe_beacon_block_root(store)
        safe_block = store.blocks[safe_block_root]
        body = safe_block.body
        if hasattr(body, "execution_payload"):
            return self.Hash32(body.execution_payload.block_hash)
        return self.Hash32()

    # -- checkpoint bookkeeping --------------------------------------------

    def update_checkpoints(self, store, justified_checkpoint, finalized_checkpoint):
        if justified_checkpoint.epoch > store.justified_checkpoint.epoch:
            store.justified_checkpoint = justified_checkpoint.copy()
        if finalized_checkpoint.epoch > store.finalized_checkpoint.epoch:
            store.finalized_checkpoint = finalized_checkpoint.copy()

    def update_unrealized_checkpoints(self, store, unrealized_justified,
                                      unrealized_finalized):
        if unrealized_justified.epoch > store.unrealized_justified_checkpoint.epoch:
            store.unrealized_justified_checkpoint = unrealized_justified.copy()
        if unrealized_finalized.epoch > store.unrealized_finalized_checkpoint.epoch:
            store.unrealized_finalized_checkpoint = unrealized_finalized.copy()

    def compute_pulled_up_tip(self, store, block_root) -> None:
        """Eagerly run FFG processing on the block's post-state, recording
        the unrealized justification it would realize at the boundary."""
        state = store.block_states[bytes(block_root)].copy()
        self.process_justification_and_finalization(state)
        store.unrealized_justifications[bytes(block_root)] = \
            state.current_justified_checkpoint.copy()
        self.update_unrealized_checkpoints(
            store, state.current_justified_checkpoint, state.finalized_checkpoint)
        block_epoch = self.compute_epoch_at_slot(store.blocks[bytes(block_root)].slot)
        if block_epoch < self.get_current_store_epoch(store):
            self.update_checkpoints(
                store, state.current_justified_checkpoint, state.finalized_checkpoint)

    # -- proposer re-org helpers -------------------------------------------

    def is_head_late(self, store, head_root) -> bool:
        return not store.block_timeliness[bytes(head_root)]

    def is_shuffling_stable(self, slot) -> bool:
        return slot % self.SLOTS_PER_EPOCH != 0

    def is_ffg_competitive(self, store, head_root, parent_root) -> bool:
        return (store.unrealized_justifications[bytes(head_root)]
                == store.unrealized_justifications[bytes(parent_root)])

    def is_finalization_ok(self, store, slot) -> bool:
        epochs = (self.compute_epoch_at_slot(slot)
                  - store.finalized_checkpoint.epoch)
        return epochs <= self.config.REORG_MAX_EPOCHS_SINCE_FINALIZATION

    def is_proposing_on_time(self, store) -> bool:
        time_into_slot = ((store.time - store.genesis_time)
                          % int(self.config.SECONDS_PER_SLOT))
        cutoff = int(self.config.SECONDS_PER_SLOT) // INTERVALS_PER_SLOT // 2
        return time_into_slot <= cutoff

    def is_head_weak(self, store, head_root) -> bool:
        justified_state = store.checkpoint_states[_ckpt_key(store.justified_checkpoint)]
        threshold = self.calculate_committee_fraction(
            justified_state, self.config.REORG_HEAD_WEIGHT_THRESHOLD)
        return self.get_weight(store, head_root) < threshold

    def is_parent_strong(self, store, parent_root) -> bool:
        justified_state = store.checkpoint_states[_ckpt_key(store.justified_checkpoint)]
        threshold = self.calculate_committee_fraction(
            justified_state, self.config.REORG_PARENT_WEIGHT_THRESHOLD)
        return self.get_weight(store, parent_root) > threshold

    def get_proposer_head(self, store, head_root, slot):
        """Single-slot re-org rule: build on the parent when the late, weak
        head can be safely orphaned by our boosted proposal."""
        head_root = bytes(head_root)
        head_block = store.blocks[head_root]
        parent_root = bytes(head_block.parent_root)
        parent_block = store.blocks[parent_root]
        assert bytes(store.proposer_boost_root) != head_root  # boost worn off
        conditions = (
            self.is_head_late(store, head_root),
            self.is_shuffling_stable(slot),
            self.is_ffg_competitive(store, head_root, parent_root),
            self.is_finalization_ok(store, slot),
            self.is_proposing_on_time(store),
            parent_block.slot + 1 == head_block.slot,
            head_block.slot + 1 == slot,
            self.is_head_weak(store, head_root),
            self.is_parent_strong(store, parent_root),
        )
        return self.Root(parent_root if all(conditions) else head_root)

    # -- handlers -----------------------------------------------------------

    def _on_block_merge_check(self, pre_state, block) -> None:
        """Pre-merge forks: nothing to validate (overridden in bellatrix)."""

    def _on_block_data_availability_check(self, block) -> None:
        """Pre-blob forks: nothing to check (overridden in deneb)."""

    def on_tick_per_slot(self, store, time) -> None:
        previous_slot = self.get_current_slot(store)
        store.time = int(time)
        current_slot = self.get_current_slot(store)
        if current_slot > previous_slot:
            store.proposer_boost_root = b"\x00" * 32
            if self.compute_slots_since_epoch_start(current_slot) == 0:
                self.update_checkpoints(store,
                                        store.unrealized_justified_checkpoint,
                                        store.unrealized_finalized_checkpoint)

    def on_tick(self, store, time) -> None:
        # catch up slot by slot so every boundary runs its per-slot logic
        tick_slot = (int(time) - store.genesis_time) // int(self.config.SECONDS_PER_SLOT)
        while self.get_current_slot(store) < tick_slot:
            previous_time = (store.genesis_time
                             + (int(self.get_current_slot(store)) + 1)
                             * int(self.config.SECONDS_PER_SLOT))
            self.on_tick_per_slot(store, previous_time)
        self.on_tick_per_slot(store, time)

    def on_block(self, store, signed_block) -> None:
        block = signed_block.message
        assert bytes(block.parent_root) in store.block_states
        pre_state = store.block_states[bytes(block.parent_root)].copy()
        assert self.get_current_slot(store) >= block.slot
        finalized_slot = self.compute_start_slot_at_epoch(
            store.finalized_checkpoint.epoch)
        assert block.slot > finalized_slot
        finalized_block = self.get_checkpoint_block(
            store, block.parent_root, store.finalized_checkpoint.epoch)
        assert bytes(store.finalized_checkpoint.root) == bytes(finalized_block)

        # One batched-verification scope spans the data-availability
        # check and the state transition: the blob-KZG batch (Deneb) or
        # the cell batches (EIP-7594) defer into the same flush as the
        # block's signature checks, so the whole on_block verifies with
        # one product pairing (utils/bls.py).  state_transition's nested
        # scope joins this batch and flushes it before any store write
        # below; inside a caller's scoped_batch, this scope joins that.
        with bls.batched_verification() as batch:
            # deneb+: blob data-availability check
            # (deneb/fork-choice.md:70); no-op pre-deneb
            self._on_block_data_availability_check(block)

            state = pre_state
            block_root = hash_tree_root(block)
            self.state_transition(state, signed_block, True)
        batch.assert_valid()
        # bellatrix+: merge-transition validation hook
        # (specs/bellatrix/fork-choice.md:266); no-op pre-merge
        self._on_block_merge_check(store.block_states[bytes(block.parent_root)],
                                   block)
        store.blocks[block_root] = block.copy()
        store.block_states[block_root] = state

        time_into_slot = ((store.time - store.genesis_time)
                          % int(self.config.SECONDS_PER_SLOT))
        is_before_attesting_interval = (
            time_into_slot < int(self.config.SECONDS_PER_SLOT) // INTERVALS_PER_SLOT)
        is_timely = (self.get_current_slot(store) == block.slot
                     and is_before_attesting_interval)
        store.block_timeliness[block_root] = is_timely
        if is_timely and bytes(store.proposer_boost_root) == b"\x00" * 32:
            store.proposer_boost_root = block_root

        self.update_checkpoints(store, state.current_justified_checkpoint,
                                state.finalized_checkpoint)
        self.compute_pulled_up_tip(store, block_root)

    def validate_target_epoch_against_current_time(self, store, attestation) -> None:
        target = attestation.data.target
        current_epoch = self.get_current_store_epoch(store)
        previous_epoch = (current_epoch - 1 if current_epoch > self.GENESIS_EPOCH
                          else self.GENESIS_EPOCH)
        assert target.epoch in (current_epoch, previous_epoch)

    def validate_on_attestation(self, store, attestation, is_from_block) -> None:
        target = attestation.data.target
        if not is_from_block:
            self.validate_target_epoch_against_current_time(store, attestation)
        assert target.epoch == self.compute_epoch_at_slot(attestation.data.slot)
        assert bytes(target.root) in store.blocks
        assert bytes(attestation.data.beacon_block_root) in store.blocks
        # votes for future blocks or unreached slots are delayed, not applied
        assert (store.blocks[bytes(attestation.data.beacon_block_root)].slot
                <= attestation.data.slot)
        assert bytes(target.root) == bytes(self.get_checkpoint_block(
            store, attestation.data.beacon_block_root, target.epoch))
        assert self.get_current_slot(store) >= attestation.data.slot + 1

    def store_target_checkpoint_state(self, store, target) -> None:
        key = _ckpt_key(target)
        if key not in store.checkpoint_states:
            base_state = store.block_states[bytes(target.root)].copy()
            start = self.compute_start_slot_at_epoch(target.epoch)
            if base_state.slot < start:
                self.process_slots(base_state, start)
            store.checkpoint_states[key] = base_state

    def update_latest_messages(self, store, attesting_indices, attestation) -> None:
        target = attestation.data.target
        root = bytes(attestation.data.beacon_block_root)
        for i in attesting_indices:
            i = int(i)
            if i in store.equivocating_indices:
                continue
            prev = store.latest_messages.get(i)
            if prev is None or target.epoch > prev.epoch:
                store.latest_messages[i] = LatestMessage(
                    epoch=int(target.epoch), root=root)

    def on_attestation(self, store, attestation, is_from_block=False) -> None:
        self.validate_on_attestation(store, attestation, is_from_block)
        self.store_target_checkpoint_state(store, attestation.data.target)
        target_state = store.checkpoint_states[_ckpt_key(attestation.data.target)]
        indexed = self.get_indexed_attestation(target_state, attestation)
        assert self.is_valid_indexed_attestation(target_state, indexed)
        self.update_latest_messages(store, indexed.attesting_indices, attestation)

    def on_attester_slashing(self, store, attester_slashing) -> None:
        att1 = attester_slashing.attestation_1
        att2 = attester_slashing.attestation_2
        assert self.is_slashable_attestation_data(att1.data, att2.data)
        state = store.block_states[bytes(store.justified_checkpoint.root)]
        assert self.is_valid_indexed_attestation(state, att1)
        assert self.is_valid_indexed_attestation(state, att2)
        for index in (set(map(int, att1.attesting_indices))
                      & set(map(int, att2.attesting_indices))):
            store.equivocating_indices.add(index)


# the proto-array dispatch and the store bookkeeping, wrapped from the
# outside so that the method bodies above stay spec-shaped
install_forkchoice_accel(ForkChoiceMixin)
