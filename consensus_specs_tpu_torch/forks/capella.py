"""Capella beacon-chain spec runtime: withdrawals, BLS-to-execution
changes, historical summaries.

Counterpart of ``consensus_specs_tpu/forks/capella.py``.  Behavioral
sources: ``specs/capella/beacon-chain.md`` (``Withdrawal`` :102,
``BLSToExecutionChange`` :112, ``HistoricalSummary`` :129, the
withdrawal predicates :260-291, ``get_expected_withdrawals`` :346,
``process_withdrawals`` :380, the modified ``process_execution_payload``
:411, ``process_bls_to_execution_change`` :466,
``process_historical_summaries_update`` :318) and ``specs/capella/fork.md``
(``upgrade_to_capella`` :77).  Fork inheritance is class inheritance over
:class:`BellatrixSpec`, whose epoch constants Capella keeps.

A BLS-to-execution change verifies through ``bls.Verify`` inside the
block's ``batched_verification`` scope: each change is one more item of
the block's one product pairing.  The light-client overrides of the JAX
package are not carried (the port's Altair runtime has no light-client
mixin for them to override).
"""
from ..utils.ssz import hash_tree_root, uint64, Bytes32, List, Container
from ..utils import bls
from ..utils.hash_function import hash
from . import register_fork
from .bellatrix import BellatrixSpec
from .base_types import (
    Epoch, Gwei, ValidatorIndex, Root, ExecutionAddress, BLSPubkey, BLSSignature,
    BLS_WITHDRAWAL_PREFIX, ETH1_ADDRESS_WITHDRAWAL_PREFIX, DOMAIN_BLS_TO_EXECUTION_CHANGE,
)

WithdrawalIndex = uint64


@register_fork("capella")
class CapellaSpec(BellatrixSpec):
    fork = "capella"
    previous_fork = "bellatrix"

    WithdrawalIndex = WithdrawalIndex
    DOMAIN_BLS_TO_EXECUTION_CHANGE = DOMAIN_BLS_TO_EXECUTION_CHANGE

    # -- type construction ---------------------------------------------------

    def _build_types(self):
        class Withdrawal(Container):
            index: WithdrawalIndex
            validator_index: ValidatorIndex
            address: ExecutionAddress
            amount: Gwei

        class BLSToExecutionChange(Container):
            validator_index: ValidatorIndex
            from_bls_pubkey: BLSPubkey
            to_execution_address: ExecutionAddress

        class SignedBLSToExecutionChange(Container):
            message: BLSToExecutionChange
            signature: BLSSignature

        class HistoricalSummary(Container):
            # hash_tree_root-compatible with phase0's HistoricalBatch
            block_summary_root: Root
            state_summary_root: Root

        self.Withdrawal = Withdrawal
        self.BLSToExecutionChange = BLSToExecutionChange
        self.SignedBLSToExecutionChange = SignedBLSToExecutionChange
        self.HistoricalSummary = HistoricalSummary
        super()._build_types()

    def _execution_payload_fields(self) -> dict:
        """The withdrawals list (beacon-chain.md:160)."""
        fields = super()._execution_payload_fields()
        fields["withdrawals"] = List[self.Withdrawal, self.MAX_WITHDRAWALS_PER_PAYLOAD]
        return fields

    def _execution_payload_header_fields(self) -> dict:
        fields = super()._execution_payload_header_fields()
        fields["withdrawals_root"] = Bytes32
        return fields

    def _block_body_fields(self, t) -> dict:
        fields = super()._block_body_fields(t)
        fields["bls_to_execution_changes"] = List[
            self.SignedBLSToExecutionChange, self.MAX_BLS_TO_EXECUTION_CHANGES]
        return fields

    def _state_fields(self, t) -> dict:
        fields = super()._state_fields(t)
        fields["next_withdrawal_index"] = WithdrawalIndex
        fields["next_withdrawal_validator_index"] = ValidatorIndex
        fields["historical_summaries"] = List[self.HistoricalSummary,
                                              self.HISTORICAL_ROOTS_LIMIT]
        return fields

    # -- withdrawal predicates (beacon-chain.md:260-291) ---------------------

    def has_eth1_withdrawal_credential(self, validator) -> bool:
        return bytes(validator.withdrawal_credentials[:1]) == ETH1_ADDRESS_WITHDRAWAL_PREFIX

    def is_fully_withdrawable_validator(self, validator, balance, epoch) -> bool:
        return (self.has_eth1_withdrawal_credential(validator)
                and validator.withdrawable_epoch <= epoch
                and balance > 0)

    def is_partially_withdrawable_validator(self, validator, balance) -> bool:
        has_max_effective_balance = validator.effective_balance == self.MAX_EFFECTIVE_BALANCE
        has_excess_balance = balance > self.MAX_EFFECTIVE_BALANCE
        return (self.has_eth1_withdrawal_credential(validator)
                and has_max_effective_balance and has_excess_balance)

    # -- epoch processing ----------------------------------------------------

    def process_epoch(self, state):
        """beacon-chain.md:300: historical summaries replace the roots."""
        self.process_justification_and_finalization(state)
        self.process_inactivity_updates(state)
        self.process_rewards_and_penalties(state)
        self.process_registry_updates(state)
        self.process_slashings(state)
        self.process_eth1_data_reset(state)
        self.process_effective_balance_updates(state)
        self.process_slashings_reset(state)
        self.process_randao_mixes_reset(state)
        self.process_historical_summaries_update(state)
        self.process_participation_flag_updates(state)
        self.process_sync_committee_updates(state)

    def process_historical_summaries_update(self, state):
        """beacon-chain.md:318"""
        next_epoch = Epoch(self.get_current_epoch(state) + 1)
        if next_epoch % (self.SLOTS_PER_HISTORICAL_ROOT // self.SLOTS_PER_EPOCH) == 0:
            state.historical_summaries.append(self.HistoricalSummary(
                block_summary_root=hash_tree_root(state.block_roots),
                state_summary_root=hash_tree_root(state.state_roots),
            ))

    def process_historical_roots_update(self, state):
        raise AttributeError("replaced by process_historical_summaries_update")

    # -- block processing ----------------------------------------------------

    def process_block(self, state, block):
        """beacon-chain.md:332: the withdrawals first, and no
        execution-enabled gate (Capella is after the merge)."""
        with bls.batched_verification() as batch:
            self.process_block_header(state, block)
            self.process_withdrawals(state, block.body.execution_payload)
            self.process_execution_payload(state, block.body, self.EXECUTION_ENGINE)
            self.process_randao(state, block.body)
            self.process_eth1_data(state, block.body)
            self.process_operations(state, block.body)
            self.process_sync_aggregate(state, block.body.sync_aggregate)
        batch.assert_valid()

    def get_expected_withdrawals(self, state):
        """beacon-chain.md:346: a bounded sweep from the rotating cursor."""
        epoch = self.get_current_epoch(state)
        withdrawal_index = state.next_withdrawal_index
        validator_index = state.next_withdrawal_validator_index
        withdrawals = []
        bound = min(len(state.validators), self.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
        for _ in range(bound):
            validator = state.validators[validator_index]
            balance = state.balances[validator_index]
            if self.is_fully_withdrawable_validator(validator, balance, epoch):
                amount = balance
            elif self.is_partially_withdrawable_validator(validator, balance):
                amount = balance - self.MAX_EFFECTIVE_BALANCE
            else:
                amount = None
            if amount is not None:
                withdrawals.append(self.Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=ExecutionAddress(bytes(validator.withdrawal_credentials[12:])),
                    amount=amount,
                ))
                withdrawal_index = WithdrawalIndex(withdrawal_index + 1)
            if len(withdrawals) == self.MAX_WITHDRAWALS_PER_PAYLOAD:
                break
            validator_index = ValidatorIndex((validator_index + 1) % len(state.validators))
        return withdrawals

    def process_withdrawals(self, state, payload):
        """beacon-chain.md:380"""
        expected_withdrawals = self.get_expected_withdrawals(state)
        assert len(payload.withdrawals) == len(expected_withdrawals)
        for expected_withdrawal, withdrawal in zip(expected_withdrawals, payload.withdrawals):
            assert withdrawal == expected_withdrawal
            self.decrease_balance(state, withdrawal.validator_index, withdrawal.amount)
        # the next withdrawal index, if this block carried withdrawals
        if len(expected_withdrawals) != 0:
            state.next_withdrawal_index = WithdrawalIndex(expected_withdrawals[-1].index + 1)
        # the next validator index of the sweep
        if len(expected_withdrawals) == self.MAX_WITHDRAWALS_PER_PAYLOAD:
            next_index = expected_withdrawals[-1].validator_index + 1
        else:
            next_index = (state.next_withdrawal_validator_index
                          + self.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
        state.next_withdrawal_validator_index = ValidatorIndex(
            next_index % len(state.validators))

    def process_execution_payload(self, state, body, execution_engine):
        """beacon-chain.md:411: no merge-transition check; Capella's header
        (``withdrawals_root``)."""
        payload = body.execution_payload
        assert payload.parent_hash == state.latest_execution_payload_header.block_hash
        assert payload.prev_randao == self.get_randao_mix(state, self.get_current_epoch(state))
        assert payload.timestamp == self.compute_timestamp_at_slot(state, state.slot)
        assert execution_engine.verify_and_notify_new_payload(
            self.NewPayloadRequest(execution_payload=payload))
        state.latest_execution_payload_header = self._payload_to_header(payload)

    def _payload_to_header(self, payload):
        header = super()._payload_to_header(payload)
        header.withdrawals_root = hash_tree_root(payload.withdrawals)
        return header

    def process_operations(self, state, body):
        """beacon-chain.md:447: the BLS-to-execution changes after the
        other operations."""
        super().process_operations(state, body)
        for operation in body.bls_to_execution_changes:
            self.process_bls_to_execution_change(state, operation)

    def process_bls_to_execution_change(self, state, signed_address_change):
        """beacon-chain.md:466"""
        address_change = signed_address_change.message
        assert address_change.validator_index < len(state.validators)
        validator = state.validators[address_change.validator_index]
        assert bytes(validator.withdrawal_credentials[:1]) == BLS_WITHDRAWAL_PREFIX
        assert bytes(validator.withdrawal_credentials[1:]) == \
            hash(address_change.from_bls_pubkey)[1:]
        # a fork-agnostic domain: address changes are valid across forks
        domain = self.compute_domain(DOMAIN_BLS_TO_EXECUTION_CHANGE,
                                     genesis_validators_root=state.genesis_validators_root)
        signing_root = self.compute_signing_root(address_change, domain)
        assert bls.Verify(address_change.from_bls_pubkey, signing_root,
                          signed_address_change.signature)
        validator.withdrawal_credentials = (
            ETH1_ADDRESS_WITHDRAWAL_PREFIX + b"\x00" * 11
            + bytes(address_change.to_execution_address))

    def _on_block_merge_check(self, pre_state, block) -> None:
        """``ForkChoiceMixin.on_block``'s hook: the merge is complete,
        nothing to validate."""

    # -- fork upgrade (fork.md:77) -------------------------------------------

    def upgrade_to_capella(self, pre):
        epoch = self.get_current_epoch(pre)
        pre_header = pre.latest_execution_payload_header
        latest_execution_payload_header = self.ExecutionPayloadHeader(
            parent_hash=pre_header.parent_hash,
            fee_recipient=pre_header.fee_recipient,
            state_root=pre_header.state_root,
            receipts_root=pre_header.receipts_root,
            logs_bloom=pre_header.logs_bloom,
            prev_randao=pre_header.prev_randao,
            block_number=pre_header.block_number,
            gas_limit=pre_header.gas_limit,
            gas_used=pre_header.gas_used,
            timestamp=pre_header.timestamp,
            extra_data=pre_header.extra_data,
            base_fee_per_gas=pre_header.base_fee_per_gas,
            block_hash=pre_header.block_hash,
            transactions_root=pre_header.transactions_root,
            withdrawals_root=Root(),
        )
        return self.BeaconState(
            genesis_time=pre.genesis_time,
            genesis_validators_root=pre.genesis_validators_root,
            slot=pre.slot,
            fork=self.Fork(
                previous_version=pre.fork.current_version,
                current_version=self.config.CAPELLA_FORK_VERSION,
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
            latest_execution_payload_header=latest_execution_payload_header,
            next_withdrawal_index=WithdrawalIndex(0),
            next_withdrawal_validator_index=ValidatorIndex(0),
            historical_summaries=List[self.HistoricalSummary, self.HISTORICAL_ROOTS_LIMIT](),
        )
