"""Deneb beacon-chain spec runtime: blobs (EIP-4844), KZG commitments,
EIP-7044, EIP-7045 and EIP-7514.

Counterpart of ``consensus_specs_tpu/forks/deneb.py``.  Behavioral
sources: ``specs/deneb/beacon-chain.md`` (``blob_kzg_commitments`` :118,
``kzg_commitment_to_versioned_hash`` :176, the modified
``get_attestation_participation_flag_indices`` :186,
``get_validator_activation_churn_limit`` :220, the modified
``process_attestation`` :317, ``process_execution_payload`` :359,
``process_voluntary_exit`` :411 and ``process_registry_updates`` :438),
``specs/deneb/fork.md`` (``upgrade_to_deneb`` :77),
``specs/deneb/fork-choice.md`` (``is_data_available`` :53, the modified
``on_block`` :70) and the KZG library of
``specs/deneb/polynomial-commitments.md`` through :mod:`..ops.kzg`.
Fork inheritance is class inheritance over :class:`CapellaSpec`.

A block's blobs verify through ``is_data_available``, which fork
choice's ``on_block`` calls through ``_on_block_data_availability_check``
(this fork's override of the mixin's hook) in the batch scope it opens
around ``state_transition``: the KZG batch's pairing joins the block's
one product pairing (``ops/kzg.py``).  The registry updates go through
the epoch engine first, which caps the activations at
``MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT`` on this fork.  The
light-client override ``is_valid_light_client_header`` is not carried
(the port's Altair runtime has no light-client mixin for it to
override).
"""
from ..utils.hash_function import hash
from ..utils.ssz import hash_tree_root, uint64, Bytes32, ByteVector, Vector, List, Container
from ..utils import bls
from ..ops import kzg as _kzg
from ..ops import epoch_kernels
from . import register_fork
from .altair import (
    PARTICIPATION_FLAG_WEIGHTS, PROPOSER_WEIGHT, TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX, TIMELY_TARGET_FLAG_INDEX, WEIGHT_DENOMINATOR,
)
from .capella import CapellaSpec
from .base_types import (
    Epoch, Gwei, ValidatorIndex, Root, KZGCommitment, KZGProof, DOMAIN_VOLUNTARY_EXIT,
)

VERSIONED_HASH_VERSION_KZG = b"\x01"
MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT = uint64(2**3)
VersionedHash = Bytes32
BlobIndex = uint64


@register_fork("deneb")
class DenebSpec(CapellaSpec):
    fork = "deneb"
    previous_fork = "capella"

    VERSIONED_HASH_VERSION_KZG = VERSIONED_HASH_VERSION_KZG
    MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT = MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT
    VersionedHash = VersionedHash
    BlobIndex = BlobIndex
    KZGCommitment = KZGCommitment
    KZGProof = KZGProof
    BLS_MODULUS = _kzg.BLS_MODULUS
    BYTES_PER_FIELD_ELEMENT = _kzg.BYTES_PER_FIELD_ELEMENT
    G1_POINT_AT_INFINITY = _kzg.G1_POINT_AT_INFINITY

    # -- type construction ---------------------------------------------------

    def _build_types(self):
        S = self
        self.BYTES_PER_BLOB = _kzg.BYTES_PER_FIELD_ELEMENT * S.FIELD_ELEMENTS_PER_BLOB
        self.Blob = ByteVector[self.BYTES_PER_BLOB]
        super()._build_types()

        class BlobSidecar(Container):
            index: BlobIndex
            blob: S.Blob
            kzg_commitment: KZGCommitment
            kzg_proof: KZGProof
            signed_block_header: S.SignedBeaconBlockHeader
            kzg_commitment_inclusion_proof: Vector[Bytes32, S.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH]

        class BlobIdentifier(Container):
            block_root: Root
            index: BlobIndex

        self.BlobSidecar = BlobSidecar
        self.BlobIdentifier = BlobIdentifier

    def _execution_payload_fields(self) -> dict:
        fields = super()._execution_payload_fields()
        fields["blob_gas_used"] = uint64
        fields["excess_blob_gas"] = uint64
        return fields

    def _execution_payload_header_fields(self) -> dict:
        fields = super()._execution_payload_header_fields()
        fields["blob_gas_used"] = uint64
        fields["excess_blob_gas"] = uint64
        return fields

    def _block_body_fields(self, t) -> dict:
        fields = super()._block_body_fields(t)
        fields["blob_kzg_commitments"] = List[KZGCommitment, self.MAX_BLOB_COMMITMENTS_PER_BLOCK]
        return fields

    def _new_payload_request_fields(self):
        """beacon-chain.md:236: the versioned hashes and the parent beacon
        block root join the payload."""
        return ("execution_payload", "versioned_hashes", "parent_beacon_block_root")

    # -- the KZG library (polynomial-commitments.md), bound to the preset ----

    @property
    def kzg_setup(self):
        return _kzg.trusted_setup(self.preset_name)

    def blob_to_kzg_commitment(self, blob) -> bytes:
        return KZGCommitment(_kzg.blob_to_kzg_commitment(bytes(blob), self.kzg_setup))

    def compute_kzg_proof(self, blob, z_bytes):
        proof, y = _kzg.compute_kzg_proof(bytes(blob), bytes(z_bytes), self.kzg_setup)
        return KZGProof(proof), Bytes32(y)

    def compute_blob_kzg_proof(self, blob, commitment_bytes) -> bytes:
        return KZGProof(_kzg.compute_blob_kzg_proof(bytes(blob), bytes(commitment_bytes),
                                                    self.kzg_setup))

    def verify_kzg_proof(self, commitment_bytes, z_bytes, y_bytes, proof_bytes) -> bool:
        return _kzg.verify_kzg_proof(bytes(commitment_bytes), bytes(z_bytes), bytes(y_bytes),
                                     bytes(proof_bytes), self.kzg_setup)

    def verify_blob_kzg_proof(self, blob, commitment_bytes, proof_bytes) -> bool:
        return _kzg.verify_blob_kzg_proof(bytes(blob), bytes(commitment_bytes),
                                          bytes(proof_bytes), self.kzg_setup)

    def verify_blob_kzg_proof_batch(self, blobs, commitments, proofs) -> bool:
        return _kzg.verify_blob_kzg_proof_batch(
            [bytes(b) for b in blobs], [bytes(c) for c in commitments],
            [bytes(p) for p in proofs], self.kzg_setup)

    # -- misc (beacon-chain.md:176) ------------------------------------------

    def kzg_commitment_to_versioned_hash(self, kzg_commitment) -> bytes:
        return VersionedHash(VERSIONED_HASH_VERSION_KZG + hash(kzg_commitment)[1:])

    # -- modified accessors --------------------------------------------------

    def get_attestation_participation_flag_indices(self, state, data, inclusion_delay):
        """EIP-7045 (beacon-chain.md:186): the target flag is no longer
        bounded by the inclusion delay."""
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
        if is_matching_target:      # [Modified in Deneb:EIP7045]
            participation_flag_indices.append(TIMELY_TARGET_FLAG_INDEX)
        if is_matching_head and inclusion_delay == self.MIN_ATTESTATION_INCLUSION_DELAY:
            participation_flag_indices.append(TIMELY_HEAD_FLAG_INDEX)
        return participation_flag_indices

    def get_validator_activation_churn_limit(self, state) -> uint64:
        """EIP-7514 (beacon-chain.md:220)."""
        return min(MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT, self.get_validator_churn_limit(state))

    # -- block processing ----------------------------------------------------

    def process_attestation(self, state, attestation):
        """EIP-7045 (beacon-chain.md:317): an attestation of the previous
        or current epoch may be included at any later slot."""
        data = attestation.data
        assert data.target.epoch in (self.get_previous_epoch(state),
                                     self.get_current_epoch(state))
        assert data.target.epoch == self.compute_epoch_at_slot(data.slot)
        # [Modified in Deneb:EIP7045] no upper bound on the inclusion delay
        assert data.slot + self.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot
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

    def process_execution_payload(self, state, body, execution_engine):
        """beacon-chain.md:359: the blob cap, and the versioned hashes and
        the parent root handed to the engine."""
        payload = body.execution_payload
        assert payload.parent_hash == state.latest_execution_payload_header.block_hash
        assert payload.prev_randao == self.get_randao_mix(state, self.get_current_epoch(state))
        assert payload.timestamp == self.compute_timestamp_at_slot(state, state.slot)
        # [New in Deneb:EIP4844] the commitments are under the limit
        assert len(body.blob_kzg_commitments) <= self.MAX_BLOBS_PER_BLOCK
        # [Modified in Deneb:EIP4844] the versioned hashes and the parent root
        versioned_hashes = [self.kzg_commitment_to_versioned_hash(c)
                            for c in body.blob_kzg_commitments]
        assert execution_engine.verify_and_notify_new_payload(self.NewPayloadRequest(
            execution_payload=payload, versioned_hashes=versioned_hashes,
            parent_beacon_block_root=state.latest_block_header.parent_root))
        state.latest_execution_payload_header = self._payload_to_header(payload)

    def _payload_to_header(self, payload):
        header = super()._payload_to_header(payload)
        header.blob_gas_used = payload.blob_gas_used
        header.excess_blob_gas = payload.excess_blob_gas
        return header

    def process_voluntary_exit(self, state, signed_voluntary_exit):
        """EIP-7044 (beacon-chain.md:411): signed under the Capella fork
        domain, whatever the state's fork."""
        voluntary_exit = signed_voluntary_exit.message
        validator = state.validators[voluntary_exit.validator_index]
        assert self.is_active_validator(validator, self.get_current_epoch(state))
        assert validator.exit_epoch == self.FAR_FUTURE_EPOCH
        assert self.get_current_epoch(state) >= voluntary_exit.epoch
        assert self.get_current_epoch(state) >= validator.activation_epoch \
            + self.config.SHARD_COMMITTEE_PERIOD
        # [Modified in Deneb:EIP7044]
        domain = self.compute_domain(DOMAIN_VOLUNTARY_EXIT, self.config.CAPELLA_FORK_VERSION,
                                     state.genesis_validators_root)
        signing_root = self.compute_signing_root(voluntary_exit, domain)
        assert bls.Verify(validator.pubkey, signing_root, signed_voluntary_exit.signature)
        self.initiate_validator_exit(state, voluntary_exit.validator_index)

    # -- epoch processing ----------------------------------------------------

    def process_registry_updates(self, state):
        """EIP-7514 (beacon-chain.md:438): the activations capped by the
        activation churn limit; the epoch engine first."""
        if epoch_kernels.try_process_registry_updates(self, state):
            return
        for index, validator in enumerate(state.validators):
            if self.is_eligible_for_activation_queue(validator):
                validator.activation_eligibility_epoch = Epoch(self.get_current_epoch(state) + 1)
            if (self.is_active_validator(validator, self.get_current_epoch(state))
                    and validator.effective_balance <= self.config.EJECTION_BALANCE):
                self.initiate_validator_exit(state, ValidatorIndex(index))
        activation_queue = sorted([
            index for index, validator in enumerate(state.validators)
            if self.is_eligible_for_activation(state, validator)
        ], key=lambda index: (state.validators[index].activation_eligibility_epoch, index))
        # [Modified in Deneb:EIP7514]
        for index in activation_queue[:self.get_validator_activation_churn_limit(state)]:
            validator = state.validators[index]
            validator.activation_epoch = self.compute_activation_exit_epoch(
                self.get_current_epoch(state))

    # -- data availability (fork-choice.md:53) -------------------------------

    def retrieve_blobs_and_proofs(self, beacon_block_root):
        """The test stub of ``pysetup/spec_builders/deneb.py:24-28``: a
        caller with blobs replaces it."""
        return [], []

    def is_data_available(self, beacon_block_root, blob_kzg_commitments) -> bool:
        blobs, proofs = self.retrieve_blobs_and_proofs(beacon_block_root)
        return self.verify_blob_kzg_proof_batch(blobs, blob_kzg_commitments, proofs)

    def _on_block_data_availability_check(self, block) -> None:
        """The hook ``ForkChoiceMixin.on_block`` calls: the check Deneb's
        ``on_block`` adds (fork-choice.md:70)."""
        assert self.is_data_available(hash_tree_root(block), block.body.blob_kzg_commitments)

    # -- fork upgrade (fork.md:77) -------------------------------------------

    def upgrade_to_deneb(self, pre):
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
            withdrawals_root=pre_header.withdrawals_root,
            blob_gas_used=uint64(0),        # [New in Deneb:EIP4844]
            excess_blob_gas=uint64(0),      # [New in Deneb:EIP4844]
        )
        return self.BeaconState(
            genesis_time=pre.genesis_time,
            genesis_validators_root=pre.genesis_validators_root,
            slot=pre.slot,
            fork=self.Fork(
                previous_version=pre.fork.current_version,
                current_version=self.config.DENEB_FORK_VERSION,
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
            next_withdrawal_index=pre.next_withdrawal_index,
            next_withdrawal_validator_index=pre.next_withdrawal_validator_index,
            historical_summaries=pre.historical_summaries,
        )
