"""Altair beacon-chain spec runtime: sync committees, participation-flag
accounting, inactivity scores.

Counterpart of ``consensus_specs_tpu/forks/altair.py``.  Behavioral
source: ``specs/altair/beacon-chain.md`` (containers, the flag helpers,
``get_next_sync_committee_indices``, ``process_sync_aggregate``, the
flag-based epoch accounting), ``specs/altair/bls.md``
(``eth_aggregate_pubkeys``, ``eth_fast_aggregate_verify``) and
``specs/altair/fork.md`` (``translate_participation``,
``upgrade_to_altair``).  Fork inheritance is class inheritance over
:class:`Phase0Spec`; only the Altair deltas live here.

The light-client and sync-duty mixins of the JAX package are not carried
(neither changes a ``BeaconState`` or ``BeaconBlock`` root), but for the
light-client mixin's fork-version ladder, ``compute_fork_version``, which
the EIP-7594 runtime extends.  Epoch
processing goes through the port's engine first (``ops/epoch_kernels.py``:
K14 for the inactivity scores, K13 for the flag and inactivity deltas,
K11/K12 as in phase0) and falls to the spec loops below.

Four registry-wide host passes are written over columns, with the spec's
values (the tests hold them to the JAX package's):
``get_unslashed_participating_indices`` reads the state column store's
registry and flag columns; ``translate_participation`` ORs each pending
attestation's flags into one uint8 column and writes it packed;
``process_participation_flag_updates`` and ``upgrade_to_altair`` build
their zero lists packed (``basic_sequence_from_column``); and
``process_sync_aggregate`` finds the committee's indices through one
first-occurrence map of the registry's pubkeys instead of a linear
``list.index`` per member.
"""
import numpy as np

from ..utils import bls
from ..utils.lru import LRUDict
from ..utils.ssz import (
    hash_tree_root, uint64, Bitvector, Vector, List, Container,
    basic_sequence_from_column, sequence_items,
)
from ..ops import epoch_kernels
from ..state import arrays as state_arrays
from . import register_fork
from .phase0 import Phase0Spec
from .base_types import (
    Slot, ValidatorIndex, Gwei, BLSPubkey, BLSSignature, ParticipationFlags,
    GENESIS_EPOCH, DOMAIN_SYNC_COMMITTEE, DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_CONTRIBUTION_AND_PROOF,
)

# incentivization weights (beacon-chain.md "Incentivization weights")
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
TIMELY_SOURCE_WEIGHT = uint64(14)
TIMELY_TARGET_WEIGHT = uint64(26)
TIMELY_HEAD_WEIGHT = uint64(14)
SYNC_REWARD_WEIGHT = uint64(2)
PROPOSER_WEIGHT = uint64(8)
WEIGHT_DENOMINATOR = uint64(64)
PARTICIPATION_FLAG_WEIGHTS = [TIMELY_SOURCE_WEIGHT, TIMELY_TARGET_WEIGHT, TIMELY_HEAD_WEIGHT]

G2_POINT_AT_INFINITY = BLSSignature(b"\xc0" + b"\x00" * 95)


@register_fork("altair")
class AltairSpec(Phase0Spec):
    fork = "altair"
    previous_fork = "phase0"

    TIMELY_SOURCE_FLAG_INDEX = TIMELY_SOURCE_FLAG_INDEX
    TIMELY_TARGET_FLAG_INDEX = TIMELY_TARGET_FLAG_INDEX
    TIMELY_HEAD_FLAG_INDEX = TIMELY_HEAD_FLAG_INDEX
    TIMELY_SOURCE_WEIGHT = TIMELY_SOURCE_WEIGHT
    TIMELY_TARGET_WEIGHT = TIMELY_TARGET_WEIGHT
    TIMELY_HEAD_WEIGHT = TIMELY_HEAD_WEIGHT
    SYNC_REWARD_WEIGHT = SYNC_REWARD_WEIGHT
    PROPOSER_WEIGHT = PROPOSER_WEIGHT
    WEIGHT_DENOMINATOR = WEIGHT_DENOMINATOR
    PARTICIPATION_FLAG_WEIGHTS = PARTICIPATION_FLAG_WEIGHTS
    G2_POINT_AT_INFINITY = G2_POINT_AT_INFINITY
    DOMAIN_SYNC_COMMITTEE = DOMAIN_SYNC_COMMITTEE
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF
    DOMAIN_CONTRIBUTION_AND_PROOF = DOMAIN_CONTRIBUTION_AND_PROOF
    ParticipationFlags = ParticipationFlags

    def __init__(self, preset: dict, config: dict, preset_name: str = "custom"):
        super().__init__(preset, config, preset_name)
        self._caches["pubkey_index"] = LRUDict(4)

    # -- type construction ---------------------------------------------------

    def _build_types(self):
        # the sync-committee containers exist before the base builder runs:
        # it consults the overridden _block_body_fields/_state_fields
        S = self

        class SyncAggregate(Container):
            sync_committee_bits: Bitvector[S.SYNC_COMMITTEE_SIZE]
            sync_committee_signature: BLSSignature

        class SyncCommittee(Container):
            pubkeys: Vector[BLSPubkey, S.SYNC_COMMITTEE_SIZE]
            aggregate_pubkey: BLSPubkey

        self.SyncAggregate = SyncAggregate
        self.SyncCommittee = SyncCommittee
        super()._build_types()

    def _block_body_fields(self, t) -> dict:
        fields = super()._block_body_fields(t)
        fields["sync_aggregate"] = self.SyncAggregate
        return fields

    def _state_fields(self, t) -> dict:
        """Altair ``BeaconState``: participation lists in the place of the
        pending attestations, inactivity scores and the two sync
        committees at the tail."""
        S = self
        out = {}
        for k, v in super()._state_fields(t).items():
            if k == "previous_epoch_attestations":
                out["previous_epoch_participation"] = \
                    List[ParticipationFlags, S.VALIDATOR_REGISTRY_LIMIT]
                out["current_epoch_participation"] = \
                    List[ParticipationFlags, S.VALIDATOR_REGISTRY_LIMIT]
            elif k != "current_epoch_attestations":
                out[k] = v
        out["inactivity_scores"] = List[uint64, S.VALIDATOR_REGISTRY_LIMIT]
        out["current_sync_committee"] = self.SyncCommittee
        out["next_sync_committee"] = self.SyncCommittee
        return out

    # -- crypto wrappers (bls.md) -------------------------------------------

    def eth_aggregate_pubkeys(self, pubkeys):
        """bls.md: the aggregate of one or more pubkeys."""
        assert len(pubkeys) > 0
        return bls.AggregatePKs(pubkeys)

    def eth_fast_aggregate_verify(self, pubkeys, message, signature) -> bool:
        """bls.md: an empty set with the infinity signature verifies."""
        if len(pubkeys) == 0 and signature == G2_POINT_AT_INFINITY:
            return True
        return bls.FastAggregateVerify(pubkeys, message, signature)

    # -- participation flags -------------------------------------------------

    def add_flag(self, flags, flag_index):
        return ParticipationFlags(flags | (2 ** flag_index))

    def has_flag(self, flags, flag_index) -> bool:
        flag = 2 ** flag_index
        return flags & flag == flag

    # -- sync committee selection ---------------------------------------------

    def get_next_sync_committee_indices(self, state):
        """Effective-balance-weighted sampling over the shuffled active set."""
        epoch = self.Epoch(self.get_current_epoch(state) + 1)
        MAX_RANDOM_BYTE = 2 ** 8 - 1
        active_validator_indices = self.get_active_validator_indices(state, epoch)
        active_validator_count = uint64(len(active_validator_indices))
        seed = self.get_seed(state, epoch, DOMAIN_SYNC_COMMITTEE)
        i = 0
        sync_committee_indices = []
        while len(sync_committee_indices) < self.SYNC_COMMITTEE_SIZE:
            shuffled_index = self.compute_shuffled_index(
                uint64(i % active_validator_count), active_validator_count, seed)
            candidate_index = active_validator_indices[shuffled_index]
            random_byte = self.hash(seed + self.uint_to_bytes(uint64(i // 32)))[i % 32]
            effective_balance = state.validators[candidate_index].effective_balance
            if effective_balance * MAX_RANDOM_BYTE >= self.MAX_EFFECTIVE_BALANCE * random_byte:
                sync_committee_indices.append(candidate_index)
            i += 1
        return sync_committee_indices

    def get_next_sync_committee(self, state):
        indices = self.get_next_sync_committee_indices(state)
        pubkeys = [state.validators[index].pubkey for index in indices]
        return self.SyncCommittee(pubkeys=pubkeys,
                                  aggregate_pubkey=self.eth_aggregate_pubkeys(pubkeys))

    # -- participation / reward helpers --------------------------------------

    def get_base_reward_per_increment(self, state):
        return Gwei(self.EFFECTIVE_BALANCE_INCREMENT * self.BASE_REWARD_FACTOR
                    // self.integer_squareroot(self.get_total_active_balance(state)))

    def get_base_reward(self, state, index):
        increments = (state.validators[index].effective_balance
                      // self.EFFECTIVE_BALANCE_INCREMENT)
        return Gwei(increments * self.get_base_reward_per_increment(state))

    def get_unslashed_participating_indices(self, state, flag_index, epoch):
        """The spec's set (active at ``epoch``, holding the flag, not
        slashed), from the store's registry and flag columns."""
        assert epoch in (self.get_previous_epoch(state), self.get_current_epoch(state))
        which = "current" if epoch == self.get_current_epoch(state) else "previous"
        store = state_arrays.of(state)
        cols = store.registry()
        flags = store.participation(which)
        e = np.uint64(int(epoch))
        mask = (cols["act"] <= e) & (e < cols["ext"]) & ~cols["sl"] \
            & (((flags >> np.uint8(flag_index)) & np.uint8(1)) == np.uint8(1))
        return set(np.nonzero(mask)[0].tolist())

    def filter_out_slashed(self, state, indices):
        return [index for index in indices if not state.validators[index].slashed]

    def get_attestation_participation_flag_indices(self, state, data, inclusion_delay):
        """The flags an attestation earns by its correctness and timeliness."""
        if data.target.epoch == self.get_current_epoch(state):
            justified_checkpoint = state.current_justified_checkpoint
        else:
            justified_checkpoint = state.previous_justified_checkpoint
        is_matching_source = data.source == justified_checkpoint
        is_matching_target = is_matching_source and bytes(data.target.root) == \
            bytes(self.get_block_root(state, data.target.epoch))
        is_matching_head = is_matching_target and bytes(data.beacon_block_root) == \
            bytes(self.get_block_root_at_slot(state, data.slot))
        assert is_matching_source

        participation_flag_indices = []
        if is_matching_source and inclusion_delay <= \
                self.integer_squareroot(self.SLOTS_PER_EPOCH):
            participation_flag_indices.append(TIMELY_SOURCE_FLAG_INDEX)
        if is_matching_target and inclusion_delay <= self.SLOTS_PER_EPOCH:
            participation_flag_indices.append(TIMELY_TARGET_FLAG_INDEX)
        if is_matching_head and inclusion_delay == self.MIN_ATTESTATION_INCLUSION_DELAY:
            participation_flag_indices.append(TIMELY_HEAD_FLAG_INDEX)
        return participation_flag_indices

    def get_flag_index_deltas(self, state, flag_index):
        """Reward and penalty deltas for one participation flag."""
        rewards = [Gwei(0)] * len(state.validators)
        penalties = [Gwei(0)] * len(state.validators)
        previous_epoch = self.get_previous_epoch(state)
        unslashed_participating_indices = self.get_unslashed_participating_indices(
            state, flag_index, previous_epoch)
        weight = PARTICIPATION_FLAG_WEIGHTS[flag_index]
        unslashed_participating_balance = self.get_total_balance(
            state, unslashed_participating_indices)
        unslashed_participating_increments = (
            unslashed_participating_balance // self.EFFECTIVE_BALANCE_INCREMENT)
        active_increments = (self.get_total_active_balance(state)
                             // self.EFFECTIVE_BALANCE_INCREMENT)
        for index in self.get_eligible_validator_indices(state):
            base_reward = self.get_base_reward(state, index)
            if index in unslashed_participating_indices:
                if not self.is_in_inactivity_leak(state):
                    reward_numerator = base_reward * weight * unslashed_participating_increments
                    rewards[index] += Gwei(reward_numerator
                                           // (active_increments * WEIGHT_DENOMINATOR))
            elif flag_index != TIMELY_HEAD_FLAG_INDEX:
                penalties[index] += Gwei(base_reward * weight // WEIGHT_DENOMINATOR)
        return rewards, penalties

    def get_inactivity_penalty_deltas(self, state):
        """Altair inactivity penalties, scaled by the inactivity scores."""
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
                                       * self.INACTIVITY_PENALTY_QUOTIENT_ALTAIR)
                penalties[index] += Gwei(penalty_numerator // penalty_denominator)
        return rewards, penalties

    # -- mutators --------------------------------------------------------------

    def slash_validator(self, state, slashed_index, whistleblower_index=None):
        """Altair's slashing quotient and proposer-reward weighting."""
        epoch = self.get_current_epoch(state)
        self.initiate_validator_exit(state, slashed_index)
        validator = state.validators[slashed_index]
        validator.slashed = True
        validator.withdrawable_epoch = max(
            validator.withdrawable_epoch, self.Epoch(epoch + self.EPOCHS_PER_SLASHINGS_VECTOR))
        state.slashings[epoch % self.EPOCHS_PER_SLASHINGS_VECTOR] += validator.effective_balance
        slashing_penalty = validator.effective_balance // self.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR
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

    # -- block processing --------------------------------------------------------

    def process_block(self, state, block):
        # phase0's batched-signature discipline; the sync aggregate's
        # verification (up to 512 keys) joins the block's one flush
        with bls.batched_verification() as batch:
            self.process_block_header(state, block)
            self.process_randao(state, block.body)
            self.process_eth1_data(state, block.body)
            self.process_operations(state, block.body)
            self.process_sync_aggregate(state, block.body.sync_aggregate)
        batch.assert_valid()

    def process_attestation(self, state, attestation):
        """Flags and the immediate proposer reward."""
        data = attestation.data
        assert data.target.epoch in (self.get_previous_epoch(state),
                                     self.get_current_epoch(state))
        assert data.target.epoch == self.compute_epoch_at_slot(data.slot)
        assert (data.slot + self.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot
                <= data.slot + self.SLOTS_PER_EPOCH)
        assert data.index < self.get_committee_count_per_slot(state, data.target.epoch)

        committee = self.get_beacon_committee(state, data.slot, data.index)
        assert len(attestation.aggregation_bits) == len(committee)

        participation_flag_indices = self.get_attestation_participation_flag_indices(
            state, data, state.slot - data.slot)

        assert self.is_valid_indexed_attestation(
            state, self.get_indexed_attestation(state, attestation))

        if data.target.epoch == self.get_current_epoch(state):
            epoch_participation = state.current_epoch_participation
        else:
            epoch_participation = state.previous_epoch_participation

        proposer_reward_numerator = 0
        for index in self.get_attesting_indices(state, data, attestation.aggregation_bits):
            for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
                if flag_index in participation_flag_indices and \
                        not self.has_flag(epoch_participation[index], flag_index):
                    epoch_participation[index] = self.add_flag(
                        epoch_participation[index], flag_index)
                    proposer_reward_numerator += self.get_base_reward(state, index) * weight

        proposer_reward_denominator = ((WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
                                       * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT)
        proposer_reward = Gwei(proposer_reward_numerator // proposer_reward_denominator)
        self.increase_balance(state, self.get_beacon_proposer_index(state), proposer_reward)

    def add_validator_to_registry(self, state, pubkey, withdrawal_credentials, amount):
        super().add_validator_to_registry(state, pubkey, withdrawal_credentials, amount)
        state.previous_epoch_participation.append(ParticipationFlags(0))
        state.current_epoch_participation.append(ParticipationFlags(0))
        state.inactivity_scores.append(uint64(0))

    def registry_pubkey_indices(self, state) -> dict:
        """{pubkey: the first registry index holding it}, one pass over the
        registry's pubkeys (later duplicates are overwritten by earlier
        ones: what ``list.index`` returns), cached by the registry's root."""
        key = hash_tree_root(state.validators)
        cached = self._caches["pubkey_index"].get(key)
        if cached is None:
            validators = sequence_items(state.validators)
            n = len(validators)
            cached = dict(zip((bytes(v.pubkey) for v in reversed(validators)),
                              range(n - 1, -1, -1)))
            self._caches["pubkey_index"][key] = cached
        return cached

    def process_sync_aggregate(self, state, sync_aggregate):
        """One aggregate verification over up to 512 keys, then the
        participants' rewards and penalties."""
        committee_pubkeys = state.current_sync_committee.pubkeys
        participant_pubkeys = [pubkey for pubkey, bit in
                               zip(committee_pubkeys, sync_aggregate.sync_committee_bits)
                               if bit]
        previous_slot = max(state.slot, Slot(1)) - Slot(1)
        domain = self.get_domain(state, DOMAIN_SYNC_COMMITTEE,
                                 self.compute_epoch_at_slot(previous_slot))
        signing_root = self.compute_signing_root(
            self.get_block_root_at_slot(state, previous_slot), domain)
        assert self.eth_fast_aggregate_verify(
            participant_pubkeys, signing_root, sync_aggregate.sync_committee_signature)

        total_active_increments = (self.get_total_active_balance(state)
                                   // self.EFFECTIVE_BALANCE_INCREMENT)
        total_base_rewards = Gwei(self.get_base_reward_per_increment(state)
                                  * total_active_increments)
        max_participant_rewards = Gwei(total_base_rewards * SYNC_REWARD_WEIGHT
                                       // WEIGHT_DENOMINATOR // self.SLOTS_PER_EPOCH)
        participant_reward = Gwei(max_participant_rewards // self.SYNC_COMMITTEE_SIZE)
        proposer_reward = Gwei(participant_reward * PROPOSER_WEIGHT
                               // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT))

        # the spec's all_pubkeys.index(pubkey) per member, as one map
        first_index = self.registry_pubkey_indices(state)
        committee_indices = []
        for pubkey in state.current_sync_committee.pubkeys:
            index = first_index.get(bytes(pubkey))
            if index is None:
                raise ValueError("sync committee pubkey not in the registry")
            committee_indices.append(ValidatorIndex(index))
        for participant_index, participation_bit in zip(
                committee_indices, sync_aggregate.sync_committee_bits):
            if participation_bit:
                self.increase_balance(state, participant_index, participant_reward)
                self.increase_balance(state, self.get_beacon_proposer_index(state),
                                      proposer_reward)
            else:
                self.decrease_balance(state, participant_index, participant_reward)

    # -- epoch processing ------------------------------------------------------------

    def process_epoch(self, state):
        self.process_justification_and_finalization(state)
        self.process_inactivity_updates(state)
        self.process_rewards_and_penalties(state)
        self.process_registry_updates(state)
        self.process_slashings(state)
        self.process_eth1_data_reset(state)
        self.process_effective_balance_updates(state)
        self.process_slashings_reset(state)
        self.process_randao_mixes_reset(state)
        self.process_historical_roots_update(state)
        self.process_participation_flag_updates(state)
        self.process_sync_committee_updates(state)

    def process_justification_and_finalization(self, state):
        """Driven by the target flags."""
        if self.get_current_epoch(state) <= GENESIS_EPOCH + 1:
            return
        previous_indices = self.get_unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, self.get_previous_epoch(state))
        current_indices = self.get_unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, self.get_current_epoch(state))
        total_active_balance = self.get_total_active_balance(state)
        previous_target_balance = self.get_total_balance(state, previous_indices)
        current_target_balance = self.get_total_balance(state, current_indices)
        self.weigh_justification_and_finalization(
            state, total_active_balance, previous_target_balance, current_target_balance)

    def process_inactivity_updates(self, state):
        if epoch_kernels.try_process_inactivity_updates(self, state):
            return
        if self.get_current_epoch(state) == GENESIS_EPOCH:
            return
        participating = self.get_unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, self.get_previous_epoch(state))
        for index in self.get_eligible_validator_indices(state):
            if index in participating:
                state.inactivity_scores[index] -= min(uint64(1), state.inactivity_scores[index])
            else:
                state.inactivity_scores[index] += self.config.INACTIVITY_SCORE_BIAS
            if not self.is_in_inactivity_leak(state):
                state.inactivity_scores[index] -= min(
                    self.config.INACTIVITY_SCORE_RECOVERY_RATE, state.inactivity_scores[index])

    def process_rewards_and_penalties(self, state):
        if epoch_kernels.try_process_rewards_and_penalties(self, state):
            return
        if self.get_current_epoch(state) == GENESIS_EPOCH:
            return
        flag_deltas = [self.get_flag_index_deltas(state, flag_index)
                       for flag_index in range(len(PARTICIPATION_FLAG_WEIGHTS))]
        deltas = flag_deltas + [self.get_inactivity_penalty_deltas(state)]
        for (rewards, penalties) in deltas:
            for index in range(len(state.validators)):
                self.increase_balance(state, ValidatorIndex(index), rewards[index])
                self.decrease_balance(state, ValidatorIndex(index), penalties[index])

    def process_slashings(self, state):
        if epoch_kernels.try_process_slashings(self, state):
            return
        epoch = self.get_current_epoch(state)
        total_balance = self.get_total_active_balance(state)
        adjusted_total_slashing_balance = min(
            sum(state.slashings) * self.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR, total_balance)
        for index, validator in enumerate(state.validators):
            if validator.slashed and epoch + self.EPOCHS_PER_SLASHINGS_VECTOR // 2 \
                    == validator.withdrawable_epoch:
                increment = self.EFFECTIVE_BALANCE_INCREMENT
                penalty_numerator = (validator.effective_balance // increment
                                     * adjusted_total_slashing_balance)
                penalty = penalty_numerator // total_balance * increment
                self.decrease_balance(state, ValidatorIndex(index), penalty)

    def process_participation_flag_updates(self, state):
        """The current flags become the previous; the new current list is
        built packed (registry-wide zeros)."""
        state.previous_epoch_participation = state.current_epoch_participation
        state.current_epoch_participation = basic_sequence_from_column(
            type(state.current_epoch_participation),
            np.zeros(len(state.validators), dtype=np.uint8))

    def process_sync_committee_updates(self, state):
        next_epoch = self.get_current_epoch(state) + self.Epoch(1)
        if next_epoch % self.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
            state.current_sync_committee = state.next_sync_committee
            state.next_sync_committee = self.get_next_sync_committee(state)

    def process_participation_record_updates(self, state):
        raise AttributeError("phase0 only (replaced by participation flags)")

    # -- fork upgrade (fork.md) --------------------------------------------------------

    def compute_fork_version(self, epoch):
        """Fork version schedule (``specs/altair/fork.md`` pattern),
        walking the configured fork ladder newest-first.  In the JAX
        package it belongs to the light-client mixin
        (``forks/light_client.py``); the port carries no such mixin yet,
        so it sits here and moves there when the mixin is ported."""
        ladder = (("DENEB_FORK_EPOCH", "DENEB_FORK_VERSION"),
                  ("CAPELLA_FORK_EPOCH", "CAPELLA_FORK_VERSION"),
                  ("BELLATRIX_FORK_EPOCH", "BELLATRIX_FORK_VERSION"),
                  ("ALTAIR_FORK_EPOCH", "ALTAIR_FORK_VERSION"))
        for epoch_name, version_name in ladder:
            fork_epoch = getattr(self.config, epoch_name, None)
            if fork_epoch is not None and epoch >= fork_epoch:
                return getattr(self.config, version_name)
        return self.config.GENESIS_FORK_VERSION

    def translate_participation(self, post, pending_attestations):
        """fork.md: the flags of the pending phase0 attestations, ORed into
        one column of the previous epoch's flags and written packed."""
        if len(pending_attestations) == 0:
            return
        seq = post.previous_epoch_participation
        flags = np.fromiter(sequence_items(seq), dtype=np.uint8, count=len(seq))
        for attestation in pending_attestations:
            data = attestation.data
            participation_flag_indices = self.get_attestation_participation_flag_indices(
                post, data, attestation.inclusion_delay)
            bits = sum(1 << f for f in participation_flag_indices)
            indices = self.get_attesting_indices(post, data, attestation.aggregation_bits)
            if bits and indices:
                flags[np.fromiter(indices, dtype=np.int64, count=len(indices))] |= \
                    np.uint8(bits)
        post.previous_epoch_participation = basic_sequence_from_column(type(seq), flags)

    def upgrade_to_altair(self, pre):
        """fork.md: a phase0 ``BeaconState`` into an Altair one."""
        epoch = self.get_current_epoch(pre)
        zeros = np.zeros(len(pre.validators), dtype=np.uint8)
        fields = self.BeaconState._fields
        post = self.BeaconState(
            genesis_time=pre.genesis_time,
            genesis_validators_root=pre.genesis_validators_root,
            slot=pre.slot,
            fork=self.Fork(
                previous_version=pre.fork.current_version,
                current_version=self.config.ALTAIR_FORK_VERSION,
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
            previous_epoch_participation=basic_sequence_from_column(
                fields["previous_epoch_participation"], zeros),
            current_epoch_participation=basic_sequence_from_column(
                fields["current_epoch_participation"], zeros),
            justification_bits=pre.justification_bits,
            previous_justified_checkpoint=pre.previous_justified_checkpoint,
            current_justified_checkpoint=pre.current_justified_checkpoint,
            finalized_checkpoint=pre.finalized_checkpoint,
            inactivity_scores=basic_sequence_from_column(
                fields["inactivity_scores"], zeros.astype(np.uint64)),
        )
        self.translate_participation(post, pre.previous_epoch_attestations)
        sync_committee = self.get_next_sync_committee(post)
        post.current_sync_committee = sync_committee
        post.next_sync_committee = self.get_next_sync_committee(post)
        return post

    # -- genesis ---------------------------------------------------------------------

    def initialize_beacon_state_from_eth1(self, eth1_block_hash, eth1_timestamp, deposits):
        """The testing variant of beacon-chain.md: genesis at the Altair
        fork version, both sync committees filled (equal at genesis)."""
        state = super().initialize_beacon_state_from_eth1(
            eth1_block_hash, eth1_timestamp, deposits)
        state.fork.previous_version = self.config.ALTAIR_FORK_VERSION
        state.fork.current_version = self.config.ALTAIR_FORK_VERSION
        state.current_sync_committee = self.get_next_sync_committee(state)
        state.next_sync_committee = self.get_next_sync_committee(state)
        return state

    def post_mock_genesis(self, state):
        """Fill the Altair-only genesis fields of a harness-built state."""
        for _ in range(len(state.validators)):
            state.previous_epoch_participation.append(ParticipationFlags(0))
            state.current_epoch_participation.append(ParticipationFlags(0))
            state.inactivity_scores.append(uint64(0))
        sync_committee = self.get_next_sync_committee(state)
        state.current_sync_committee = sync_committee
        state.next_sync_committee = self.get_next_sync_committee(state)
