"""Bellatrix (Merge) beacon-chain spec runtime: execution payloads, the
engine protocol, the merge transition.

Counterpart of ``consensus_specs_tpu/forks/bellatrix.py``.  Behavioral
sources: ``specs/bellatrix/beacon-chain.md`` (containers :100-200,
``is_merge_transition_complete`` :218, ``process_execution_payload`` :384,
modified ``slash_validator`` :279 / ``process_slashings`` :421 /
``get_inactivity_penalty_deltas`` :255), ``specs/bellatrix/fork.md``
(``upgrade_to_bellatrix`` :69) and ``specs/bellatrix/fork-choice.md``
(``PowBlock`` :180, ``is_valid_terminal_pow_block`` :195,
``validate_merge_block`` :204).  The Noop execution engine mirrors
``pysetup/spec_builders/bellatrix.py:40-65``.  Fork inheritance is class
inheritance over :class:`AltairSpec`; only the Bellatrix deltas live
here.

Epoch processing goes through the port's engine first, as on Altair:
``ops/epoch_kernels.py`` reads the spec's fork lineage and hands K13 the
Bellatrix inactivity quotient and K12 the Bellatrix slashing multiplier.
The merge-block checks override fork choice's hook
(``_on_block_merge_check``, ``forks/fork_choice.py``): ``on_block`` of a
merge block validates its terminal PoW block.
"""
from dataclasses import field, make_dataclass
from typing import Optional

from ..utils.ssz import (
    hash_tree_root, uint64, uint256, Bytes32, ByteList, ByteVector, List, Container,
)
from ..utils import bls
from ..ops import epoch_kernels
from . import register_fork
from .altair import AltairSpec, PROPOSER_WEIGHT, TIMELY_TARGET_FLAG_INDEX, WEIGHT_DENOMINATOR
from .optimistic_sync import OptimisticSyncMixin
from .base_types import Epoch, Gwei, ValidatorIndex, Hash32, ExecutionAddress


# the default of every field a fork's ``NewPayloadRequest`` may carry
_REQUEST_DEFAULTS = {"execution_payload": None, "versioned_hashes": (),
                     "parent_beacon_block_root": b"\x00" * 32}


@register_fork("bellatrix")
class BellatrixSpec(OptimisticSyncMixin, AltairSpec):
    fork = "bellatrix"
    previous_fork = "altair"

    uint256 = uint256
    ExecutionAddress = ExecutionAddress

    # -- type construction ---------------------------------------------------

    def _build_types(self):
        S = self

        self.Transaction = ByteList[S.MAX_BYTES_PER_TRANSACTION]
        self.ExecutionPayload = type("ExecutionPayload", (Container,), {
            "__annotations__": self._execution_payload_fields()})
        self.ExecutionPayloadHeader = type("ExecutionPayloadHeader", (Container,), {
            "__annotations__": self._execution_payload_header_fields()})

        class PowBlock(Container):
            block_hash: Hash32
            parent_hash: Hash32
            total_difficulty: uint256

        self.PowBlock = PowBlock
        super()._build_types()
        self._build_engine()

    def _execution_payload_common_fields(self) -> dict:
        """Execution block header fields shared by payload and header
        (beacon-chain.md:110-140)."""
        S = self
        return {
            "parent_hash": Hash32,
            "fee_recipient": ExecutionAddress,
            "state_root": Bytes32,
            "receipts_root": Bytes32,
            "logs_bloom": ByteVector[S.BYTES_PER_LOGS_BLOOM],
            "prev_randao": Bytes32,
            "block_number": uint64,
            "gas_limit": uint64,
            "gas_used": uint64,
            "timestamp": uint64,
            "extra_data": ByteList[S.MAX_EXTRA_DATA_BYTES],
            "base_fee_per_gas": uint256,
            "block_hash": Hash32,
        }

    def _execution_payload_fields(self) -> dict:
        fields = self._execution_payload_common_fields()
        fields["transactions"] = List[self.Transaction, self.MAX_TRANSACTIONS_PER_PAYLOAD]
        return fields

    def _execution_payload_header_fields(self) -> dict:
        fields = self._execution_payload_common_fields()
        fields["transactions_root"] = Bytes32
        return fields

    def _block_body_fields(self, t) -> dict:
        fields = super()._block_body_fields(t)
        fields["execution_payload"] = self.ExecutionPayload
        return fields

    def _state_fields(self, t) -> dict:
        fields = super()._state_fields(t)
        fields["latest_execution_payload_header"] = self.ExecutionPayloadHeader
        return fields

    # -- execution engine (protocol + noop stub) -----------------------------

    def _new_payload_request_fields(self):
        """The fields of ``NewPayloadRequest`` (beacon-chain.md:236); a
        later fork adds its own (Deneb: the versioned hashes and the parent
        beacon block root)."""
        return ("execution_payload",)

    def _build_engine(self):
        NewPayloadRequest = make_dataclass("NewPayloadRequest", [
            (name, object, field(default=_REQUEST_DEFAULTS[name]))
            for name in self._new_payload_request_fields()])

        class NoopExecutionEngine:
            """Every payload is valid (``pysetup/spec_builders/bellatrix.py:40-65``)."""

            def notify_new_payload(self, *args, **kwargs) -> bool:
                return True

            def notify_forkchoice_updated(self, head_block_hash, safe_block_hash,
                                          finalized_block_hash, payload_attributes):
                return None

            def get_payload(self, payload_id):
                raise NotImplementedError("no default block production")

            def is_valid_block_hash(self, *args, **kwargs) -> bool:
                return True

            def is_valid_versioned_hashes(self, new_payload_request) -> bool:
                return True

            def verify_and_notify_new_payload(self, new_payload_request) -> bool:
                return True

        self.NewPayloadRequest = NewPayloadRequest
        self.NoopExecutionEngine = NoopExecutionEngine
        self.EXECUTION_ENGINE = NoopExecutionEngine()

    # -- predicates (beacon-chain.md:218-234) --------------------------------

    def is_merge_transition_complete(self, state) -> bool:
        return state.latest_execution_payload_header != self.ExecutionPayloadHeader()

    def is_merge_transition_block(self, state, body) -> bool:
        return (not self.is_merge_transition_complete(state)
                and body.execution_payload != self.ExecutionPayload())

    def is_execution_enabled(self, state, body) -> bool:
        return self.is_merge_transition_block(state, body) \
            or self.is_merge_transition_complete(state)

    def compute_timestamp_at_slot(self, state, slot) -> uint64:
        slots_since_genesis = slot - self.GENESIS_SLOT
        return uint64(state.genesis_time + slots_since_genesis * self.config.SECONDS_PER_SLOT)

    # -- modified accessors and mutators -------------------------------------

    def get_inactivity_penalty_deltas(self, state):
        """beacon-chain.md:255: ``INACTIVITY_PENALTY_QUOTIENT_BELLATRIX``."""
        rewards = [Gwei(0)] * len(state.validators)
        penalties = [Gwei(0)] * len(state.validators)
        previous_epoch = self.get_previous_epoch(state)
        matching_target_indices = self.get_unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, previous_epoch)
        for index in self.get_eligible_validator_indices(state):
            if index not in matching_target_indices:
                penalty_numerator = (state.validators[index].effective_balance
                                     * state.inactivity_scores[index])
                penalty_denominator = (self.config.INACTIVITY_SCORE_BIAS
                                       * self.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX)
                penalties[index] += Gwei(penalty_numerator // penalty_denominator)
        return rewards, penalties

    def slash_validator(self, state, slashed_index, whistleblower_index=None):
        """beacon-chain.md:279: ``MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX``."""
        epoch = self.get_current_epoch(state)
        self.initiate_validator_exit(state, slashed_index)
        validator = state.validators[slashed_index]
        validator.slashed = True
        validator.withdrawable_epoch = max(
            validator.withdrawable_epoch, Epoch(epoch + self.EPOCHS_PER_SLASHINGS_VECTOR))
        state.slashings[epoch % self.EPOCHS_PER_SLASHINGS_VECTOR] += validator.effective_balance
        slashing_penalty = (validator.effective_balance
                            // self.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX)
        self.decrease_balance(state, slashed_index, slashing_penalty)

        proposer_index = self.get_beacon_proposer_index(state)
        if whistleblower_index is None:
            whistleblower_index = proposer_index
        whistleblower_reward = Gwei(validator.effective_balance
                                    // self.WHISTLEBLOWER_REWARD_QUOTIENT)
        proposer_reward = Gwei(whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR)
        self.increase_balance(state, proposer_index, proposer_reward)
        self.increase_balance(state, whistleblower_index,
                              Gwei(whistleblower_reward - proposer_reward))

    def process_slashings(self, state):
        """beacon-chain.md:421: ``PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX``."""
        if epoch_kernels.try_process_slashings(self, state):
            return
        epoch = self.get_current_epoch(state)
        total_balance = self.get_total_active_balance(state)
        adjusted_total_slashing_balance = min(
            sum(state.slashings) * self.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX,
            total_balance)
        for index, validator in enumerate(state.validators):
            if validator.slashed and epoch + self.EPOCHS_PER_SLASHINGS_VECTOR // 2 \
                    == validator.withdrawable_epoch:
                increment = self.EFFECTIVE_BALANCE_INCREMENT
                penalty_numerator = (validator.effective_balance // increment
                                     * adjusted_total_slashing_balance)
                penalty = penalty_numerator // total_balance * increment
                self.decrease_balance(state, ValidatorIndex(index), penalty)

    # -- block processing ----------------------------------------------------

    def process_block(self, state, block):
        """beacon-chain.md:370: the execution payload before the randao;
        the block's signatures join one flush, as on Altair."""
        with bls.batched_verification() as batch:
            self.process_block_header(state, block)
            if self.is_execution_enabled(state, block.body):
                self.process_execution_payload(state, block.body, self.EXECUTION_ENGINE)
            self.process_randao(state, block.body)
            self.process_eth1_data(state, block.body)
            self.process_operations(state, block.body)
            self.process_sync_aggregate(state, block.body.sync_aggregate)
        batch.assert_valid()

    def process_execution_payload(self, state, body, execution_engine):
        """beacon-chain.md:384"""
        payload = body.execution_payload
        # consistency of the parent hash with the previous header
        if self.is_merge_transition_complete(state):
            assert payload.parent_hash == state.latest_execution_payload_header.block_hash
        assert payload.prev_randao == self.get_randao_mix(state, self.get_current_epoch(state))
        assert payload.timestamp == self.compute_timestamp_at_slot(state, state.slot)
        assert execution_engine.verify_and_notify_new_payload(
            self.NewPayloadRequest(execution_payload=payload))
        state.latest_execution_payload_header = self._payload_to_header(payload)

    def _payload_to_header(self, payload):
        return self.ExecutionPayloadHeader(
            parent_hash=payload.parent_hash,
            fee_recipient=payload.fee_recipient,
            state_root=payload.state_root,
            receipts_root=payload.receipts_root,
            logs_bloom=payload.logs_bloom,
            prev_randao=payload.prev_randao,
            block_number=payload.block_number,
            gas_limit=payload.gas_limit,
            gas_used=payload.gas_used,
            timestamp=payload.timestamp,
            extra_data=payload.extra_data,
            base_fee_per_gas=payload.base_fee_per_gas,
            block_hash=payload.block_hash,
            transactions_root=hash_tree_root(payload.transactions),
        )

    # -- the merge block (fork-choice.md) ------------------------------------

    def get_pow_block(self, block_hash) -> Optional[object]:
        """The test stub of ``pysetup/spec_builders/bellatrix.py:21-23``."""
        return self.PowBlock(block_hash=block_hash, parent_hash=Bytes32(),
                             total_difficulty=uint256(0))

    def is_valid_terminal_pow_block(self, block, parent) -> bool:
        """fork-choice.md:195"""
        is_total_difficulty_reached = \
            block.total_difficulty >= self.config.TERMINAL_TOTAL_DIFFICULTY
        is_parent_total_difficulty_valid = \
            parent.total_difficulty < self.config.TERMINAL_TOTAL_DIFFICULTY
        return is_total_difficulty_reached and is_parent_total_difficulty_valid

    def validate_merge_block(self, block) -> None:
        """fork-choice.md:204"""
        if self.config.TERMINAL_BLOCK_HASH != Hash32():
            # the terminal-hash override: its activation epoch must be reached
            assert self.compute_epoch_at_slot(block.slot) >= \
                self.config.TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH
            assert block.body.execution_payload.parent_hash == self.config.TERMINAL_BLOCK_HASH
            return
        pow_block = self.get_pow_block(block.body.execution_payload.parent_hash)
        assert pow_block is not None
        pow_parent = self.get_pow_block(pow_block.parent_hash)
        assert pow_parent is not None
        assert self.is_valid_terminal_pow_block(pow_block, pow_parent)

    def _on_block_merge_check(self, pre_state, block) -> None:
        """The hook ``ForkChoiceMixin.on_block`` calls (fork-choice.md:266):
        a merge block's terminal PoW block."""
        if self.is_merge_transition_block(pre_state, block.body):
            self.validate_merge_block(block)

    # -- fork upgrade (fork.md:69) -------------------------------------------

    def upgrade_to_bellatrix(self, pre):
        epoch = self.get_current_epoch(pre)
        return self.BeaconState(
            genesis_time=pre.genesis_time,
            genesis_validators_root=pre.genesis_validators_root,
            slot=pre.slot,
            fork=self.Fork(
                previous_version=pre.fork.current_version,
                current_version=self.config.BELLATRIX_FORK_VERSION,
                epoch=epoch,
            ),
            latest_block_header=pre.latest_block_header,
            block_roots=pre.block_roots,
            state_roots=pre.state_roots,
            historical_roots=pre.historical_roots,
            eth1_data=pre.eth1_data,
            eth1_data_votes=pre.eth1_data_votes,
            eth1_deposit_index=pre.eth1_deposit_index,
            validators=pre.validators,
            balances=pre.balances,
            randao_mixes=pre.randao_mixes,
            slashings=pre.slashings,
            previous_epoch_participation=pre.previous_epoch_participation,
            current_epoch_participation=pre.current_epoch_participation,
            justification_bits=pre.justification_bits,
            previous_justified_checkpoint=pre.previous_justified_checkpoint,
            current_justified_checkpoint=pre.current_justified_checkpoint,
            finalized_checkpoint=pre.finalized_checkpoint,
            inactivity_scores=pre.inactivity_scores,
            current_sync_committee=pre.current_sync_committee,
            next_sync_committee=pre.next_sync_committee,
            latest_execution_payload_header=self.ExecutionPayloadHeader(),
        )

    # -- genesis -------------------------------------------------------------

    def initialize_beacon_state_from_eth1(self, eth1_block_hash, eth1_timestamp, deposits,
                                          execution_payload_header=None):
        """The testing variant of beacon-chain.md: genesis at this fork's
        version; an empty (default) payload header boots a pre-merge
        chain, a non-empty one starts after the transition."""
        state = super().initialize_beacon_state_from_eth1(
            eth1_block_hash, eth1_timestamp, deposits)
        version = getattr(self.config, f"{self.fork.upper()}_FORK_VERSION")
        state.fork.previous_version = version
        state.fork.current_version = version
        if execution_payload_header is not None:
            state.latest_execution_payload_header = execution_payload_header
        return state

    def post_mock_genesis(self, state):
        """A harness-built state after the merge: a non-empty header."""
        super().post_mock_genesis(state)
        state.latest_execution_payload_header = self.default_payload_header()

    def default_payload_header(self):
        """A minimal non-empty header marking the merge as complete."""
        return self.ExecutionPayloadHeader(
            block_hash=Hash32(b"\x42" * 32),
            state_root=Bytes32(b"\x20" * 32),
            transactions_root=hash_tree_root(
                List[self.Transaction, self.MAX_TRANSACTIONS_PER_PAYLOAD]()),
        )
