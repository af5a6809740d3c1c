"""phase0 beacon-chain spec runtime.

Counterpart of ``consensus_specs_tpu/forks/phase0.py``: everything
``state_transition`` reaches, and the fork choice of
:class:`~.fork_choice.ForkChoiceMixin` (``forks/fork_choice.py``, over
the proto-array engine of ``forkchoice/proto_array.py``).  The
validator-guide mixin is not carried yet.  Epoch processing goes
through the port's vectorized epoch engine first (``ops/epoch_kernels.py``: each
``try_process_*`` returns True when the engine committed the
sub-transition, on the card or on the plain versions), inside the state
column store's ``commit_scope`` (``state/arrays.py``), and falls to the
spec loops below when the engine is off or a guard declines.  The
engine's exactness contract (loops and engine give identical roots) is
what the tests hold the port to.  Committees slice one vectorized
swap-or-not permutation of the epoch's active set, computed once per
seed (``_shuffled_positions``), instead of shuffling member by member.

Behavioral port of ``specs/phase0/beacon-chain.md`` (reference, v1.4.0-beta.7)
re-architected as a preset-bound spec class: constants are instance
attributes, SSZ container types are built per preset at construction, and
fork inheritance is class inheritance. Function names, signatures and
semantics match the reference markdown (cited per method) so harness code
and vectors are interchangeable.

Exception-as-invalidity: processing functions raise AssertionError (or
IndexError/ValueError from SSZ bounds) on invalid input — the harness's
``expect_assertion_error`` and fork-choice invalid-block handling rely on it
(reference: ``test/context.py:299-310``).
"""
from types import SimpleNamespace
from typing import Dict, Sequence, Set

import numpy as np

from ..utils.hash_function import hash
from ..utils.ssz import (
    hash_tree_root, uint_to_bytes, copy as ssz_copy,
    boolean, uint8, uint32, uint64, Bytes32,
    Bitlist, Bitvector, Vector, List, Container,
)
from ..utils import bls
from ..utils.lru import LRUDict
from ..utils.ssz.forest import hash_forest
from ..ops import epoch_kernels
from ..state import arrays as state_arrays
from . import register_fork
from .fork_choice import ForkChoiceMixin
from .base_types import (
    Slot, Epoch, CommitteeIndex, ValidatorIndex, Gwei, Root, Hash32, Version,
    DomainType, ForkDigest, Domain, BLSPubkey, BLSSignature,
    GENESIS_SLOT, GENESIS_EPOCH, FAR_FUTURE_EPOCH, BASE_REWARDS_PER_EPOCH,
    DEPOSIT_CONTRACT_TREE_DEPTH, JUSTIFICATION_BITS_LENGTH,
    BLS_WITHDRAWAL_PREFIX, ETH1_ADDRESS_WITHDRAWAL_PREFIX,
    DOMAIN_BEACON_PROPOSER, DOMAIN_BEACON_ATTESTER, DOMAIN_RANDAO,
    DOMAIN_DEPOSIT, DOMAIN_VOLUNTARY_EXIT, DOMAIN_SELECTION_PROOF,
    DOMAIN_AGGREGATE_AND_PROOF,
)

def _bytes_of(hexstr, width):
    if isinstance(hexstr, str) and hexstr.startswith("0x"):
        raw = bytes.fromhex(hexstr[2:])
    elif isinstance(hexstr, int):
        raw = hexstr.to_bytes(width, "big")
    else:
        raw = bytes(hexstr)
    if len(raw) != width:
        raise ValueError(f"expected {width} bytes, got {len(raw)}")
    return raw


@register_fork("phase0")
class Phase0Spec(ForkChoiceMixin):
    fork = "phase0"
    previous_fork = None

    # re-exported SSZ/crypto surface so harness code can do spec.hash_tree_root
    hash = staticmethod(hash)
    hash_tree_root = staticmethod(hash_tree_root)
    uint_to_bytes = staticmethod(uint_to_bytes)
    copy = staticmethod(ssz_copy)
    bls = bls

    # types
    Slot, Epoch, CommitteeIndex, ValidatorIndex = Slot, Epoch, CommitteeIndex, ValidatorIndex
    Gwei, Root, Hash32, Version, DomainType = Gwei, Root, Hash32, Version, DomainType
    ForkDigest, Domain, BLSPubkey, BLSSignature = ForkDigest, Domain, BLSPubkey, BLSSignature
    uint8, uint64 = uint8, uint64
    Bytes32 = Bytes32

    # constants
    GENESIS_SLOT, GENESIS_EPOCH, FAR_FUTURE_EPOCH = GENESIS_SLOT, GENESIS_EPOCH, FAR_FUTURE_EPOCH
    BASE_REWARDS_PER_EPOCH = BASE_REWARDS_PER_EPOCH
    DEPOSIT_CONTRACT_TREE_DEPTH = DEPOSIT_CONTRACT_TREE_DEPTH
    JUSTIFICATION_BITS_LENGTH = JUSTIFICATION_BITS_LENGTH
    BLS_WITHDRAWAL_PREFIX = BLS_WITHDRAWAL_PREFIX
    ETH1_ADDRESS_WITHDRAWAL_PREFIX = ETH1_ADDRESS_WITHDRAWAL_PREFIX
    DOMAIN_BEACON_PROPOSER = DOMAIN_BEACON_PROPOSER
    DOMAIN_BEACON_ATTESTER = DOMAIN_BEACON_ATTESTER
    DOMAIN_RANDAO = DOMAIN_RANDAO
    DOMAIN_DEPOSIT = DOMAIN_DEPOSIT
    DOMAIN_VOLUNTARY_EXIT = DOMAIN_VOLUNTARY_EXIT
    DOMAIN_SELECTION_PROOF = DOMAIN_SELECTION_PROOF
    DOMAIN_AGGREGATE_AND_PROOF = DOMAIN_AGGREGATE_AND_PROOF

    def __init__(self, preset: dict, config: dict, preset_name: str = "custom"):
        self.preset_name = preset_name
        self._preset = dict(preset)
        for k, v in preset.items():
            setattr(self, k, v)
        self.config = self._build_config(config)
        self._build_types()
        # Bounded like the reference's lru-dict caches
        # (pysetup/spec_builders/phase0.py:59-105); unbounded dicts would grow
        # without limit across a long generator run.
        self._caches: Dict[str, LRUDict] = {
            "committee": LRUDict(512),
            "proposer": LRUDict(512),
            "active_indices": LRUDict(128),
            "total_balance": LRUDict(128),
            "shuffling": LRUDict(16),
        }

    # -- config ------------------------------------------------------------
    def _build_config(self, config: dict) -> SimpleNamespace:
        c = SimpleNamespace()
        for k, v in config.items():
            if k.endswith("_FORK_VERSION") or k == "GENESIS_FORK_VERSION":
                v = Version(_bytes_of(v, 4))
            elif k in ("TERMINAL_BLOCK_HASH",):
                v = Hash32(_bytes_of(v, 32))
            elif k in ("DEPOSIT_CONTRACT_ADDRESS",):
                v = _bytes_of(v, 20)
            elif k.startswith("MESSAGE_DOMAIN_"):
                v = DomainType(_bytes_of(v, 4))
            setattr(c, k, v)
        return c

    # -- SSZ containers (preset-parameterized) ------------------------------
    def _build_types(self):
        """Containers from ``specs/phase0/beacon-chain.md`` ("Containers")."""
        S = self

        class Fork(Container):
            previous_version: Version
            current_version: Version
            epoch: Epoch

        class ForkData(Container):
            current_version: Version
            genesis_validators_root: Root

        class Checkpoint(Container):
            epoch: Epoch
            root: Root

        Validator = type("Validator", (Container,), {
            "__annotations__": self._validator_fields()})

        AttestationData = type("AttestationData", (Container,), {
            "__annotations__": self._attestation_data_fields(locals())})

        class IndexedAttestation(Container):
            attesting_indices: List[ValidatorIndex, S.MAX_VALIDATORS_PER_COMMITTEE]
            data: AttestationData
            signature: BLSSignature

        class PendingAttestation(Container):
            aggregation_bits: Bitlist[S.MAX_VALIDATORS_PER_COMMITTEE]
            data: AttestationData
            inclusion_delay: Slot
            proposer_index: ValidatorIndex

        class Eth1Data(Container):
            deposit_root: Root
            deposit_count: uint64
            block_hash: Hash32

        class HistoricalBatch(Container):
            block_roots: Vector[Root, S.SLOTS_PER_HISTORICAL_ROOT]
            state_roots: Vector[Root, S.SLOTS_PER_HISTORICAL_ROOT]

        class DepositMessage(Container):
            pubkey: BLSPubkey
            withdrawal_credentials: Bytes32
            amount: Gwei

        class DepositData(Container):
            pubkey: BLSPubkey
            withdrawal_credentials: Bytes32
            amount: Gwei
            signature: BLSSignature

        class BeaconBlockHeader(Container):
            slot: Slot
            proposer_index: ValidatorIndex
            parent_root: Root
            state_root: Root
            body_root: Root

        class SigningData(Container):
            object_root: Root
            domain: Domain

        class SignedBeaconBlockHeader(Container):
            message: BeaconBlockHeader
            signature: BLSSignature

        class ProposerSlashing(Container):
            signed_header_1: SignedBeaconBlockHeader
            signed_header_2: SignedBeaconBlockHeader

        class AttesterSlashing(Container):
            attestation_1: IndexedAttestation
            attestation_2: IndexedAttestation

        class Attestation(Container):
            aggregation_bits: Bitlist[S.MAX_VALIDATORS_PER_COMMITTEE]
            data: AttestationData
            signature: BLSSignature

        class Deposit(Container):
            proof: Vector[Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1]
            data: DepositData

        class VoluntaryExit(Container):
            epoch: Epoch
            validator_index: ValidatorIndex

        class SignedVoluntaryExit(Container):
            message: VoluntaryExit
            signature: BLSSignature

        body_fields = self._block_body_fields(locals())
        BeaconBlockBody = type("BeaconBlockBody", (Container,), {
            "__annotations__": body_fields})

        class BeaconBlock(Container):
            slot: Slot
            proposer_index: ValidatorIndex
            parent_root: Root
            state_root: Root
            body: BeaconBlockBody

        class SignedBeaconBlock(Container):
            message: BeaconBlock
            signature: BLSSignature

        state_fields = self._state_fields(locals())
        BeaconState = type("BeaconState", (Container,), {
            "__annotations__": state_fields})

        class Eth1Block(Container):
            timestamp: uint64
            deposit_root: Root
            deposit_count: uint64

        class AggregateAndProof(Container):
            aggregator_index: ValidatorIndex
            aggregate: Attestation
            selection_proof: BLSSignature

        class SignedAggregateAndProof(Container):
            message: AggregateAndProof
            signature: BLSSignature

        for name, typ in list(locals().items()):
            if isinstance(typ, type) and issubclass(typ, Container):
                setattr(self, name, typ)

    def _validator_fields(self) -> dict:
        """``Validator`` fields (beacon-chain.md "Validator"); research
        forks (custody_game) append via override."""
        return {
            "pubkey": BLSPubkey,
            "withdrawal_credentials": Bytes32,
            "effective_balance": Gwei,
            "slashed": boolean,
            "activation_eligibility_epoch": Epoch,
            "activation_epoch": Epoch,
            "exit_epoch": Epoch,
            "withdrawable_epoch": Epoch,
        }

    def _attestation_data_fields(self, t) -> dict:
        """``AttestationData`` fields; the legacy sharding lineage appends
        ``shard_transition_root`` via override."""
        return {
            "slot": Slot,
            "index": CommitteeIndex,
            "beacon_block_root": Root,
            "source": t["Checkpoint"],
            "target": t["Checkpoint"],
        }

    def _block_body_fields(self, t) -> dict:
        S = self
        return {
            "randao_reveal": BLSSignature,
            "eth1_data": t["Eth1Data"],
            "graffiti": Bytes32,
            "proposer_slashings": List[t["ProposerSlashing"], S.MAX_PROPOSER_SLASHINGS],
            "attester_slashings": List[t["AttesterSlashing"], S.MAX_ATTESTER_SLASHINGS],
            "attestations": List[t["Attestation"], S.MAX_ATTESTATIONS],
            "deposits": List[t["Deposit"], S.MAX_DEPOSITS],
            "voluntary_exits": List[t["SignedVoluntaryExit"], S.MAX_VOLUNTARY_EXITS],
        }

    def _state_fields(self, t) -> dict:
        S = self
        return {
            "genesis_time": uint64,
            "genesis_validators_root": Root,
            "slot": Slot,
            "fork": t["Fork"],
            "latest_block_header": t["BeaconBlockHeader"],
            "block_roots": Vector[Root, S.SLOTS_PER_HISTORICAL_ROOT],
            "state_roots": Vector[Root, S.SLOTS_PER_HISTORICAL_ROOT],
            "historical_roots": List[Root, S.HISTORICAL_ROOTS_LIMIT],
            "eth1_data": t["Eth1Data"],
            "eth1_data_votes": List[t["Eth1Data"],
                                    S.EPOCHS_PER_ETH1_VOTING_PERIOD * S.SLOTS_PER_EPOCH],
            "eth1_deposit_index": uint64,
            "validators": List[t["Validator"], S.VALIDATOR_REGISTRY_LIMIT],
            "balances": List[Gwei, S.VALIDATOR_REGISTRY_LIMIT],
            "randao_mixes": Vector[Bytes32, S.EPOCHS_PER_HISTORICAL_VECTOR],
            "slashings": Vector[Gwei, S.EPOCHS_PER_SLASHINGS_VECTOR],
            "previous_epoch_attestations": List[t["PendingAttestation"],
                                                S.MAX_ATTESTATIONS * S.SLOTS_PER_EPOCH],
            "current_epoch_attestations": List[t["PendingAttestation"],
                                               S.MAX_ATTESTATIONS * S.SLOTS_PER_EPOCH],
            "justification_bits": Bitvector[JUSTIFICATION_BITS_LENGTH],
            "previous_justified_checkpoint": t["Checkpoint"],
            "current_justified_checkpoint": t["Checkpoint"],
            "finalized_checkpoint": t["Checkpoint"],
        }

    # ======================================================================
    # Math & crypto helpers (beacon-chain.md "Helper functions")
    # ======================================================================

    def integer_squareroot(self, n) -> uint64:
        """beacon-chain.md:597"""
        if n == 2**64 - 1:
            return uint64(4294967295)
        x, y = n, (n + 1) // 2
        while y < x:
            x, y = y, (y + n // y) // 2
        return uint64(x)

    def xor(self, bytes_1: bytes, bytes_2: bytes) -> Bytes32:
        return Bytes32(bytes(a ^ b for a, b in zip(bytes_1, bytes_2)))

    def bytes_to_uint64(self, data: bytes) -> uint64:
        return uint64(int.from_bytes(data, "little"))

    # -- predicates --------------------------------------------------------

    def is_active_validator(self, validator, epoch) -> bool:
        """beacon-chain.md:625 (is_active_validator)"""
        return validator.activation_epoch <= epoch < validator.exit_epoch

    def is_eligible_for_activation_queue(self, validator) -> bool:
        return (validator.activation_eligibility_epoch == FAR_FUTURE_EPOCH
                and validator.effective_balance == self.MAX_EFFECTIVE_BALANCE)

    def is_eligible_for_activation(self, state, validator) -> bool:
        return (validator.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
                and validator.activation_epoch == FAR_FUTURE_EPOCH)

    def is_slashable_validator(self, validator, epoch) -> bool:
        return (not validator.slashed) and (
            validator.activation_epoch <= epoch < validator.withdrawable_epoch)

    def is_slashable_attestation_data(self, data_1, data_2) -> bool:
        return (
            # double vote
            (data_1 != data_2 and data_1.target.epoch == data_2.target.epoch)
            # surround vote
            or (data_1.source.epoch < data_2.source.epoch
                and data_2.target.epoch < data_1.target.epoch)
        )

    def is_valid_indexed_attestation(self, state, indexed_attestation) -> bool:
        """beacon-chain.md:739"""
        indices = list(indexed_attestation.attesting_indices)
        if len(indices) == 0 or not indices == sorted(set(indices)):
            return False
        pubkeys = [state.validators[i].pubkey for i in indices]
        domain = self.get_domain(state, DOMAIN_BEACON_ATTESTER,
                                 indexed_attestation.data.target.epoch)
        signing_root = self.compute_signing_root(indexed_attestation.data, domain)
        return bls.FastAggregateVerify(pubkeys, signing_root, indexed_attestation.signature)

    def is_valid_merkle_branch(self, leaf, branch, depth, index, root) -> bool:
        """beacon-chain.md:757"""
        value = leaf
        for i in range(depth):
            if index // (2**i) % 2:
                value = hash(branch[i] + value)
            else:
                value = hash(value + branch[i])
        return value == root

    # -- misc --------------------------------------------------------------

    def compute_shuffled_index(self, index, index_count, seed) -> uint64:
        """Swap-or-not shuffle (beacon-chain.md:775)."""
        assert index < index_count
        for current_round in range(self.SHUFFLE_ROUND_COUNT):
            pivot = self.bytes_to_uint64(
                hash(seed + uint_to_bytes(uint8(current_round)))[0:8]) % index_count
            flip = (pivot + index_count - index) % index_count
            position = max(index, flip)
            source = hash(seed + uint_to_bytes(uint8(current_round))
                          + uint_to_bytes(uint32(position // 256)))
            byte_val = source[(position % 256) // 8]
            bit = (byte_val >> (position % 8)) % 2
            index = flip if bit else index
        return uint64(index)

    def compute_proposer_index(self, state, indices, seed) -> ValidatorIndex:
        """beacon-chain.md:799"""
        assert len(indices) > 0
        MAX_RANDOM_BYTE = 2**8 - 1
        i = uint64(0)
        total = uint64(len(indices))
        while True:
            candidate_index = indices[self.compute_shuffled_index(i % total, total, seed)]
            random_byte = hash(seed + uint_to_bytes(uint64(i // 32)))[i % 32]
            effective_balance = state.validators[candidate_index].effective_balance
            if effective_balance * MAX_RANDOM_BYTE >= self.MAX_EFFECTIVE_BALANCE * random_byte:
                return ValidatorIndex(candidate_index)
            i = uint64(i + 1)

    def _shuffled_positions(self, index_count, seed) -> np.ndarray:
        """``compute_shuffled_index(i, index_count, seed)`` for every i at
        once: the same swap-or-not rounds over the whole index array, one
        hash per 256 positions per round instead of two per index.
        Cached per (seed, index_count): an epoch's committees all slice
        one permutation."""
        n = int(index_count)
        key = (bytes(seed), n)
        cached = self._caches["shuffling"].get(key)
        if cached is not None:
            return cached
        idx = np.arange(n, dtype=np.int64)
        for current_round in range(self.SHUFFLE_ROUND_COUNT):
            prefix = seed + uint_to_bytes(uint8(current_round))
            pivot = self.bytes_to_uint64(hash(prefix)[0:8]) % n
            flip = (pivot + n - idx) % n
            position = np.maximum(idx, flip)
            source = np.frombuffer(b"".join(
                hash(prefix + uint_to_bytes(uint32(b)))
                for b in range((n - 1) // 256 + 1)), dtype=np.uint8).reshape(-1, 32)
            byte_val = source[position >> 8, (position & 255) >> 3]
            bit = (byte_val >> (position & 7).astype(np.uint8)) & 1
            idx = np.where(bit == 1, flip, idx)
        self._caches["shuffling"][key] = idx
        return idx

    def compute_committee(self, indices, seed, index, count) -> Sequence[ValidatorIndex]:
        """beacon-chain.md:823"""
        start = (len(indices) * index) // count
        end = (len(indices) * (index + 1)) // count
        if start == end:
            return []
        perm = self._shuffled_positions(len(indices), seed)
        return [indices[i] for i in perm[start:end].tolist()]

    def compute_epoch_at_slot(self, slot) -> Epoch:
        return Epoch(slot // self.SLOTS_PER_EPOCH)

    def compute_start_slot_at_epoch(self, epoch) -> Slot:
        return Slot(epoch * self.SLOTS_PER_EPOCH)

    def compute_activation_exit_epoch(self, epoch) -> Epoch:
        return Epoch(epoch + 1 + self.MAX_SEED_LOOKAHEAD)

    def compute_fork_data_root(self, current_version, genesis_validators_root) -> Root:
        return hash_tree_root(self.ForkData(
            current_version=current_version,
            genesis_validators_root=genesis_validators_root,
        ))

    def compute_fork_digest(self, current_version, genesis_validators_root) -> ForkDigest:
        return ForkDigest(
            self.compute_fork_data_root(current_version, genesis_validators_root)[:4])

    def compute_domain(self, domain_type, fork_version=None,
                       genesis_validators_root=None) -> Domain:
        """beacon-chain.md:890"""
        if fork_version is None:
            fork_version = self.config.GENESIS_FORK_VERSION
        if genesis_validators_root is None:
            genesis_validators_root = Root()
        fork_data_root = self.compute_fork_data_root(fork_version, genesis_validators_root)
        return Domain(bytes(domain_type) + fork_data_root[:28])

    def compute_signing_root(self, ssz_object, domain) -> Root:
        """beacon-chain.md:906"""
        return hash_tree_root(self.SigningData(
            object_root=hash_tree_root(ssz_object),
            domain=domain,
        ))

    # -- accessors ---------------------------------------------------------

    def get_current_epoch(self, state) -> Epoch:
        return self.compute_epoch_at_slot(state.slot)

    def get_previous_epoch(self, state) -> Epoch:
        current_epoch = self.get_current_epoch(state)
        return GENESIS_EPOCH if current_epoch == GENESIS_EPOCH else Epoch(current_epoch - 1)

    def get_block_root(self, state, epoch) -> Root:
        return self.get_block_root_at_slot(state, self.compute_start_slot_at_epoch(epoch))

    def get_block_root_at_slot(self, state, slot) -> Root:
        assert slot < state.slot <= slot + self.SLOTS_PER_HISTORICAL_ROOT
        return state.block_roots[slot % self.SLOTS_PER_HISTORICAL_ROOT]

    def get_randao_mix(self, state, epoch) -> Bytes32:
        return state.randao_mixes[epoch % self.EPOCHS_PER_HISTORICAL_VECTOR]

    def get_active_validator_indices(self, state, epoch) -> Sequence[ValidatorIndex]:
        key = (hash_tree_root(state.validators), epoch)
        cached = self._caches["active_indices"].get(key)
        if cached is None:
            cached = tuple(ValidatorIndex(i)
                           for i, v in enumerate(state.validators)
                           if self.is_active_validator(v, epoch))
            self._caches["active_indices"][key] = cached
        # an immutable tuple, returned without the old per-call O(n)
        # defensive list() copy: callers can index/iterate but cannot
        # poison the cache by mutating the returned sequence
        return cached

    def get_validator_churn_limit(self, state) -> uint64:
        active = self.get_active_validator_indices(state, self.get_current_epoch(state))
        return uint64(max(self.config.MIN_PER_EPOCH_CHURN_LIMIT,
                          len(active) // self.config.CHURN_LIMIT_QUOTIENT))

    def get_seed(self, state, epoch, domain_type) -> Bytes32:
        """beacon-chain.md (get_seed)"""
        mix = self.get_randao_mix(
            state, Epoch(epoch + self.EPOCHS_PER_HISTORICAL_VECTOR
                         - self.MIN_SEED_LOOKAHEAD - 1))
        return hash(bytes(domain_type) + uint_to_bytes(uint64(epoch)) + mix)

    def get_committee_count_per_slot(self, state, epoch) -> uint64:
        return uint64(max(1, min(
            self.MAX_COMMITTEES_PER_SLOT,
            len(self.get_active_validator_indices(state, epoch))
            // self.SLOTS_PER_EPOCH // self.TARGET_COMMITTEE_SIZE,
        )))

    def get_beacon_committee(self, state, slot, index) -> Sequence[ValidatorIndex]:
        """beacon-chain.md:1017; LRU-cached like pysetup/spec_builders/phase0.py:59-105"""
        key = (hash_tree_root(state.validators), hash_tree_root(state.randao_mixes),
               int(slot), int(index))
        cached = self._caches["committee"].get(key)
        if cached is None:
            epoch = self.compute_epoch_at_slot(slot)
            committees_per_slot = self.get_committee_count_per_slot(state, epoch)
            cached = tuple(self.compute_committee(
                indices=self.get_active_validator_indices(state, epoch),
                seed=self.get_seed(state, epoch, DOMAIN_BEACON_ATTESTER),
                index=(slot % self.SLOTS_PER_EPOCH) * committees_per_slot + index,
                count=committees_per_slot * self.SLOTS_PER_EPOCH,
            ))
            self._caches["committee"][key] = cached
        # immutable, uncopied: see get_active_validator_indices
        return cached

    def get_beacon_proposer_index(self, state) -> ValidatorIndex:
        key = (hash_tree_root(state.validators), hash_tree_root(state.randao_mixes),
               int(state.slot))
        cached = self._caches["proposer"].get(key)
        if cached is None:
            epoch = self.get_current_epoch(state)
            seed = hash(self.get_seed(state, epoch, DOMAIN_BEACON_PROPOSER)
                        + uint_to_bytes(uint64(state.slot)))
            indices = self.get_active_validator_indices(state, epoch)
            cached = self.compute_proposer_index(state, indices, seed)
            self._caches["proposer"][key] = cached
        return cached

    def get_total_balance(self, state, indices) -> Gwei:
        return Gwei(max(self.EFFECTIVE_BALANCE_INCREMENT,
                        sum(state.validators[index].effective_balance for index in indices)))

    def get_total_active_balance(self, state) -> Gwei:
        # root-keyed like the committee caches (reference analog:
        # pysetup's lru-cached get_total_active_balance): per-validator
        # reward loops call this once per index, and the O(validators)
        # sum would otherwise make every epoch function quadratic
        key = (hash_tree_root(state.validators), self.get_current_epoch(state))
        cached = self._caches["total_balance"].get(key)
        if cached is None:
            cached = self.get_total_balance(
                state,
                set(self.get_active_validator_indices(
                    state, self.get_current_epoch(state))))
            self._caches["total_balance"][key] = cached
        return cached

    def get_domain(self, state, domain_type, epoch=None) -> Domain:
        epoch = self.get_current_epoch(state) if epoch is None else epoch
        fork_version = (state.fork.previous_version if epoch < state.fork.epoch
                        else state.fork.current_version)
        return self.compute_domain(domain_type, fork_version, state.genesis_validators_root)

    def get_indexed_attestation(self, state, attestation):
        """beacon-chain.md:1085"""
        attesting_indices = self.get_attesting_indices(
            state, attestation.data, attestation.aggregation_bits)
        return self.IndexedAttestation(
            attesting_indices=sorted(attesting_indices),
            data=attestation.data,
            signature=attestation.signature,
        )

    def get_attesting_indices(self, state, data, bits) -> Set[ValidatorIndex]:
        """beacon-chain.md:1101"""
        committee = self.get_beacon_committee(state, data.slot, data.index)
        return set(index for i, index in enumerate(committee) if bits[i])

    # -- mutators ----------------------------------------------------------

    def increase_balance(self, state, index, delta) -> None:
        state.balances[index] += delta

    def decrease_balance(self, state, index, delta) -> None:
        state.balances[index] = (
            0 if delta > state.balances[index] else state.balances[index] - delta)

    def initiate_validator_exit(self, state, index) -> None:
        """beacon-chain.md:1133"""
        validator = state.validators[index]
        if validator.exit_epoch != FAR_FUTURE_EPOCH:
            return
        exit_epochs = [v.exit_epoch for v in state.validators
                       if v.exit_epoch != FAR_FUTURE_EPOCH]
        exit_queue_epoch = max(
            exit_epochs + [self.compute_activation_exit_epoch(self.get_current_epoch(state))])
        exit_queue_churn = len(
            [v for v in state.validators if v.exit_epoch == exit_queue_epoch])
        if exit_queue_churn >= self.get_validator_churn_limit(state):
            exit_queue_epoch = Epoch(exit_queue_epoch + 1)
        validator.exit_epoch = exit_queue_epoch
        validator.withdrawable_epoch = Epoch(
            validator.exit_epoch + self.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)

    def slash_validator(self, state, slashed_index, whistleblower_index=None) -> None:
        """beacon-chain.md:1157"""
        epoch = self.get_current_epoch(state)
        self.initiate_validator_exit(state, slashed_index)
        validator = state.validators[slashed_index]
        validator.slashed = True
        validator.withdrawable_epoch = max(
            validator.withdrawable_epoch, Epoch(epoch + self.EPOCHS_PER_SLASHINGS_VECTOR))
        state.slashings[epoch % self.EPOCHS_PER_SLASHINGS_VECTOR] += validator.effective_balance
        slashing_penalty = validator.effective_balance // self.MIN_SLASHING_PENALTY_QUOTIENT
        self.decrease_balance(state, slashed_index, slashing_penalty)

        proposer_index = self.get_beacon_proposer_index(state)
        if whistleblower_index is None:
            whistleblower_index = proposer_index
        whistleblower_reward = Gwei(
            validator.effective_balance // self.WHISTLEBLOWER_REWARD_QUOTIENT)
        proposer_reward = Gwei(whistleblower_reward // self.PROPOSER_REWARD_QUOTIENT)
        self.increase_balance(state, proposer_index, proposer_reward)
        self.increase_balance(
            state, whistleblower_index, Gwei(whistleblower_reward - proposer_reward))

    # ======================================================================
    # Genesis (beacon-chain.md:1195)
    # ======================================================================

    def initialize_beacon_state_from_eth1(self, eth1_block_hash, eth1_timestamp, deposits):
        fork = self.Fork(
            previous_version=self.config.GENESIS_FORK_VERSION,
            current_version=self.config.GENESIS_FORK_VERSION,
            epoch=GENESIS_EPOCH,
        )
        state = self.BeaconState(
            genesis_time=eth1_timestamp + self.config.GENESIS_DELAY,
            fork=fork,
            eth1_data=self.Eth1Data(
                block_hash=eth1_block_hash, deposit_count=uint64(len(deposits))),
            latest_block_header=self.BeaconBlockHeader(
                body_root=hash_tree_root(self.BeaconBlockBody())),
            randao_mixes=[eth1_block_hash] * self.EPOCHS_PER_HISTORICAL_VECTOR,
        )
        # Process genesis deposits
        leaves = [d.data for d in deposits]
        DepositDataList = List[self.DepositData, 2**(DEPOSIT_CONTRACT_TREE_DEPTH)]
        for index, deposit in enumerate(deposits):
            deposit_data_list = DepositDataList(leaves[:index + 1])
            state.eth1_data.deposit_root = hash_tree_root(deposit_data_list)
            self.process_deposit(state, deposit)
        # Process activations
        for index, validator in enumerate(state.validators):
            balance = state.balances[index]
            validator.effective_balance = min(
                balance - balance % self.EFFECTIVE_BALANCE_INCREMENT,
                self.MAX_EFFECTIVE_BALANCE)
            if validator.effective_balance == self.MAX_EFFECTIVE_BALANCE:
                validator.activation_eligibility_epoch = GENESIS_EPOCH
                validator.activation_epoch = GENESIS_EPOCH
        # Set genesis validators root for domain separation and chain versioning
        state.genesis_validators_root = hash_tree_root(state.validators)
        return state

    def is_valid_genesis_state(self, state) -> bool:
        if state.genesis_time < self.config.MIN_GENESIS_TIME:
            return False
        if len(self.get_active_validator_indices(state, GENESIS_EPOCH)) \
                < self.config.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT:
            return False
        return True

    # ======================================================================
    # State transition (beacon-chain.md:1256)
    # ======================================================================

    def state_transition(self, state, signed_block, validate_result=True) -> None:
        block = signed_block.message
        # Process slots (including those with no blocks) since block
        self.process_slots(state, block.slot)
        # One batched signature dispatch covers the proposer signature and
        # the whole block body (see utils/bls.py batched_verification).
        with bls.batched_verification() as batch:
            # Verify signature
            if validate_result:
                assert self.verify_block_signature(state, signed_block)
            # Process block
            self.process_block(state, block)
        batch.assert_valid()
        # Verify state root
        if validate_result:
            with hash_forest():
                assert block.state_root == hash_tree_root(state)

    def verify_block_signature(self, state, signed_block) -> bool:
        proposer = state.validators[signed_block.message.proposer_index]
        signing_root = self.compute_signing_root(
            signed_block.message, self.get_domain(state, DOMAIN_BEACON_PROPOSER))
        return bls.Verify(proposer.pubkey, signing_root, signed_block.signature)

    def process_slots(self, state, slot) -> None:
        assert state.slot < slot
        while state.slot < slot:
            self.process_slot(state)
            # Process epoch on the start slot of the next epoch; the
            # engine's balance writes reach SSZ once, at scope exit
            if (state.slot + 1) % self.SLOTS_PER_EPOCH == 0:
                with state_arrays.commit_scope(state):
                    self.process_epoch(state)
            state.slot = Slot(state.slot + 1)

    def process_slot(self, state) -> None:
        # Cache state root.  The forest scope batches the dirty re-hash
        # level-aligned across every mutated tree of the state (balances,
        # roots vectors, registry, ...) — see utils/ssz/forest.py.
        with hash_forest():
            previous_state_root = hash_tree_root(state)
        state.state_roots[state.slot % self.SLOTS_PER_HISTORICAL_ROOT] = previous_state_root
        # Cache latest block header state root
        if state.latest_block_header.state_root == Bytes32():
            state.latest_block_header.state_root = previous_state_root
        # Cache block root
        state.block_roots[state.slot % self.SLOTS_PER_HISTORICAL_ROOT] = \
            hash_tree_root(state.latest_block_header)

    # -- epoch processing --------------------------------------------------

    def process_epoch(self, state) -> None:
        """beacon-chain.md:1304"""
        self.process_justification_and_finalization(state)
        self.process_rewards_and_penalties(state)
        self.process_registry_updates(state)
        self.process_slashings(state)
        self.process_eth1_data_reset(state)
        self.process_effective_balance_updates(state)
        self.process_slashings_reset(state)
        self.process_randao_mixes_reset(state)
        self.process_historical_roots_update(state)
        self.process_participation_record_updates(state)

    def get_matching_source_attestations(self, state, epoch):
        assert epoch in (self.get_previous_epoch(state), self.get_current_epoch(state))
        return (state.current_epoch_attestations
                if epoch == self.get_current_epoch(state)
                else state.previous_epoch_attestations)

    def get_matching_target_attestations(self, state, epoch):
        return [a for a in self.get_matching_source_attestations(state, epoch)
                if a.data.target.root == self.get_block_root(state, epoch)]

    def get_matching_head_attestations(self, state, epoch):
        return [a for a in self.get_matching_target_attestations(state, epoch)
                if a.data.beacon_block_root == self.get_block_root_at_slot(state, a.data.slot)]

    def get_unslashed_attesting_indices(self, state, attestations) -> Set[ValidatorIndex]:
        # the spec's ``output = output.union(...)`` copies the growing set
        # once per attestation: quadratic, ~22 s per call for an epoch's
        # 2048 attestations at 2^18 validators.  The in-place union is
        # the same set in linear time.
        output = set()
        for a in attestations:
            output |= self.get_attesting_indices(state, a.data, a.aggregation_bits)
        return set(filter(lambda index: not state.validators[index].slashed, output))

    def get_attesting_balance(self, state, attestations) -> Gwei:
        return self.get_total_balance(
            state, self.get_unslashed_attesting_indices(state, attestations))

    def process_justification_and_finalization(self, state) -> None:
        """beacon-chain.md:1359"""
        # Initial FFG checkpoint values have a `0x00` stub for `root`.
        # Skip FFG updates in the first two epochs to avoid corner cases.
        if self.get_current_epoch(state) <= GENESIS_EPOCH + 1:
            return
        previous_attestations = self.get_matching_target_attestations(
            state, self.get_previous_epoch(state))
        current_attestations = self.get_matching_target_attestations(
            state, self.get_current_epoch(state))
        total_active_balance = self.get_total_active_balance(state)
        previous_target_balance = self.get_attesting_balance(state, previous_attestations)
        current_target_balance = self.get_attesting_balance(state, current_attestations)
        self.weigh_justification_and_finalization(
            state, total_active_balance, previous_target_balance, current_target_balance)

    def weigh_justification_and_finalization(self, state, total_active_balance,
                                             previous_epoch_target_balance,
                                             current_epoch_target_balance) -> None:
        previous_epoch = self.get_previous_epoch(state)
        current_epoch = self.get_current_epoch(state)
        old_previous_justified_checkpoint = state.previous_justified_checkpoint
        old_current_justified_checkpoint = state.current_justified_checkpoint

        # Process justifications
        state.previous_justified_checkpoint = state.current_justified_checkpoint
        bits = list(state.justification_bits)
        state.justification_bits = [False] + bits[:JUSTIFICATION_BITS_LENGTH - 1]
        if previous_epoch_target_balance * 3 >= total_active_balance * 2:
            state.current_justified_checkpoint = self.Checkpoint(
                epoch=previous_epoch, root=self.get_block_root(state, previous_epoch))
            state.justification_bits[1] = True
        if current_epoch_target_balance * 3 >= total_active_balance * 2:
            state.current_justified_checkpoint = self.Checkpoint(
                epoch=current_epoch, root=self.get_block_root(state, current_epoch))
            state.justification_bits[0] = True

        # Process finalizations
        bits = state.justification_bits
        # The 2nd/3rd/4th most recent epochs are justified, the 2nd using the 4th as source
        if all(bits[1:4]) and old_previous_justified_checkpoint.epoch + 3 == current_epoch:
            state.finalized_checkpoint = old_previous_justified_checkpoint
        if all(bits[1:3]) and old_previous_justified_checkpoint.epoch + 2 == current_epoch:
            state.finalized_checkpoint = old_previous_justified_checkpoint
        if all(bits[0:3]) and old_current_justified_checkpoint.epoch + 2 == current_epoch:
            state.finalized_checkpoint = old_current_justified_checkpoint
        if all(bits[0:2]) and old_current_justified_checkpoint.epoch + 1 == current_epoch:
            state.finalized_checkpoint = old_current_justified_checkpoint

    # -- rewards and penalties (beacon-chain.md:1414) ----------------------

    def get_base_reward(self, state, index) -> Gwei:
        total_balance = self.get_total_active_balance(state)
        effective_balance = state.validators[index].effective_balance
        return Gwei(effective_balance * self.BASE_REWARD_FACTOR
                    // self.integer_squareroot(total_balance) // BASE_REWARDS_PER_EPOCH)

    def get_proposer_reward(self, state, attesting_index) -> Gwei:
        return Gwei(self.get_base_reward(state, attesting_index)
                    // self.PROPOSER_REWARD_QUOTIENT)

    def get_finality_delay(self, state) -> uint64:
        return self.get_previous_epoch(state) - state.finalized_checkpoint.epoch

    def is_in_inactivity_leak(self, state) -> bool:
        return self.get_finality_delay(state) > self.MIN_EPOCHS_TO_INACTIVITY_PENALTY

    def get_eligible_validator_indices(self, state) -> Sequence[ValidatorIndex]:
        previous_epoch = self.get_previous_epoch(state)
        return [ValidatorIndex(index) for index, v in enumerate(state.validators)
                if self.is_active_validator(v, previous_epoch)
                or (v.slashed and previous_epoch + 1 < v.withdrawable_epoch)]

    def get_attestation_component_deltas(self, state, attestations):
        """Helper with shared logic for use by get source/target/head deltas"""
        rewards = [Gwei(0)] * len(state.validators)
        penalties = [Gwei(0)] * len(state.validators)
        total_balance = self.get_total_active_balance(state)
        unslashed_attesting_indices = self.get_unslashed_attesting_indices(
            state, attestations)
        attesting_balance = self.get_total_balance(state, unslashed_attesting_indices)
        for index in self.get_eligible_validator_indices(state):
            if index in unslashed_attesting_indices:
                increment = self.EFFECTIVE_BALANCE_INCREMENT
                if self.is_in_inactivity_leak(state):
                    # Full base reward will be canceled out by inactivity penalty deltas
                    rewards[index] += self.get_base_reward(state, index)
                else:
                    reward_numerator = self.get_base_reward(state, index) \
                        * (attesting_balance // increment)
                    rewards[index] += reward_numerator // (total_balance // increment)
            else:
                penalties[index] += self.get_base_reward(state, index)
        return rewards, penalties

    def get_source_deltas(self, state):
        matching_source_attestations = self.get_matching_source_attestations(
            state, self.get_previous_epoch(state))
        return self.get_attestation_component_deltas(state, matching_source_attestations)

    def get_target_deltas(self, state):
        matching_target_attestations = self.get_matching_target_attestations(
            state, self.get_previous_epoch(state))
        return self.get_attestation_component_deltas(state, matching_target_attestations)

    def get_head_deltas(self, state):
        matching_head_attestations = self.get_matching_head_attestations(
            state, self.get_previous_epoch(state))
        return self.get_attestation_component_deltas(state, matching_head_attestations)

    def get_inclusion_delay_deltas(self, state):
        rewards = [Gwei(0)] * len(state.validators)
        matching_source_attestations = self.get_matching_source_attestations(
            state, self.get_previous_epoch(state))
        for index in self.get_unslashed_attesting_indices(state, matching_source_attestations):
            attestation = min([
                a for a in matching_source_attestations
                if index in self.get_attesting_indices(state, a.data, a.aggregation_bits)
            ], key=lambda a: a.inclusion_delay)
            rewards[attestation.proposer_index] += self.get_proposer_reward(state, index)
            max_attester_reward = Gwei(
                self.get_base_reward(state, index) - self.get_proposer_reward(state, index))
            rewards[index] += Gwei(max_attester_reward // attestation.inclusion_delay)
        # No penalties associated with inclusion delay
        penalties = [Gwei(0)] * len(state.validators)
        return rewards, penalties

    def get_inactivity_penalty_deltas(self, state):
        penalties = [Gwei(0)] * len(state.validators)
        if self.is_in_inactivity_leak(state):
            matching_target_attestations = self.get_matching_target_attestations(
                state, self.get_previous_epoch(state))
            matching_target_attesting_indices = self.get_unslashed_attesting_indices(
                state, matching_target_attestations)
            for index in self.get_eligible_validator_indices(state):
                # If validator is performing optimally this cancels all rewards for a neutral balance
                base_reward = self.get_base_reward(state, index)
                penalties[index] += Gwei(
                    BASE_REWARDS_PER_EPOCH * base_reward
                    - self.get_proposer_reward(state, index))
                if index not in matching_target_attesting_indices:
                    effective_balance = state.validators[index].effective_balance
                    penalties[index] += Gwei(
                        effective_balance * self.get_finality_delay(state)
                        // self.INACTIVITY_PENALTY_QUOTIENT)
        rewards = [Gwei(0)] * len(state.validators)
        return rewards, penalties

    def get_attestation_deltas(self, state):
        source_rewards, source_penalties = self.get_source_deltas(state)
        target_rewards, target_penalties = self.get_target_deltas(state)
        head_rewards, head_penalties = self.get_head_deltas(state)
        inclusion_delay_rewards, _ = self.get_inclusion_delay_deltas(state)
        _, inactivity_penalties = self.get_inactivity_penalty_deltas(state)
        rewards = [source_rewards[i] + target_rewards[i] + head_rewards[i]
                   + inclusion_delay_rewards[i] for i in range(len(state.validators))]
        penalties = [source_penalties[i] + target_penalties[i] + head_penalties[i]
                     + inactivity_penalties[i] for i in range(len(state.validators))]
        return rewards, penalties

    def process_rewards_and_penalties(self, state) -> None:
        if epoch_kernels.try_process_rewards_and_penalties(self, state):
            return
        # No rewards are applied at the end of `GENESIS_EPOCH` because rewards
        # are for work done in the previous epoch
        if self.get_current_epoch(state) == GENESIS_EPOCH:
            return
        rewards, penalties = self.get_attestation_deltas(state)
        for index in range(len(state.validators)):
            self.increase_balance(state, ValidatorIndex(index), rewards[index])
            self.decrease_balance(state, ValidatorIndex(index), penalties[index])

    # -- registry / slashings / resets -------------------------------------

    def process_registry_updates(self, state) -> None:
        """beacon-chain.md:1592"""
        if epoch_kernels.try_process_registry_updates(self, state):
            return
        # Process activation eligibility and ejections
        for index, validator in enumerate(state.validators):
            if self.is_eligible_for_activation_queue(validator):
                validator.activation_eligibility_epoch = Epoch(
                    self.get_current_epoch(state) + 1)
            if (self.is_active_validator(validator, self.get_current_epoch(state))
                    and validator.effective_balance <= self.config.EJECTION_BALANCE):
                self.initiate_validator_exit(state, ValidatorIndex(index))
        # Queue validators eligible for activation and not yet dequeued for activation
        activation_queue = sorted([
            index for index, validator in enumerate(state.validators)
            if self.is_eligible_for_activation(state, validator)
            # Order by the sequence of activation_eligibility_epoch setting and then index
        ], key=lambda index: (state.validators[index].activation_eligibility_epoch, index))
        # Dequeued validators for activation up to churn limit
        for index in activation_queue[:self.get_validator_churn_limit(state)]:
            validator = state.validators[index]
            validator.activation_epoch = self.compute_activation_exit_epoch(
                self.get_current_epoch(state))

    def process_slashings(self, state) -> None:
        """beacon-chain.md:1619"""
        if epoch_kernels.try_process_slashings(self, state):
            return
        epoch = self.get_current_epoch(state)
        total_balance = self.get_total_active_balance(state)
        adjusted_total_slashing_balance = min(
            sum(state.slashings) * self.PROPORTIONAL_SLASHING_MULTIPLIER, total_balance)
        for index, validator in enumerate(state.validators):
            if validator.slashed and epoch + self.EPOCHS_PER_SLASHINGS_VECTOR // 2 \
                    == validator.withdrawable_epoch:
                increment = self.EFFECTIVE_BALANCE_INCREMENT
                penalty_numerator = (validator.effective_balance // increment
                                     * adjusted_total_slashing_balance)
                penalty = penalty_numerator // total_balance * increment
                self.decrease_balance(state, ValidatorIndex(index), penalty)

    def process_eth1_data_reset(self, state) -> None:
        next_epoch = Epoch(self.get_current_epoch(state) + 1)
        if next_epoch % self.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
            state.eth1_data_votes = type(state.eth1_data_votes)()

    def process_effective_balance_updates(self, state) -> None:
        if epoch_kernels.try_process_effective_balance_updates(self, state):
            return
        for index, validator in enumerate(state.validators):
            balance = state.balances[index]
            HYSTERESIS_INCREMENT = uint64(
                self.EFFECTIVE_BALANCE_INCREMENT // self.HYSTERESIS_QUOTIENT)
            DOWNWARD_THRESHOLD = HYSTERESIS_INCREMENT * self.HYSTERESIS_DOWNWARD_MULTIPLIER
            UPWARD_THRESHOLD = HYSTERESIS_INCREMENT * self.HYSTERESIS_UPWARD_MULTIPLIER
            if (balance + DOWNWARD_THRESHOLD < validator.effective_balance
                    or validator.effective_balance + UPWARD_THRESHOLD < balance):
                validator.effective_balance = min(
                    balance - balance % self.EFFECTIVE_BALANCE_INCREMENT,
                    self.MAX_EFFECTIVE_BALANCE)

    def process_slashings_reset(self, state) -> None:
        next_epoch = Epoch(self.get_current_epoch(state) + 1)
        state.slashings[next_epoch % self.EPOCHS_PER_SLASHINGS_VECTOR] = Gwei(0)

    def process_randao_mixes_reset(self, state) -> None:
        current_epoch = self.get_current_epoch(state)
        next_epoch = Epoch(current_epoch + 1)
        state.randao_mixes[next_epoch % self.EPOCHS_PER_HISTORICAL_VECTOR] = \
            self.get_randao_mix(state, current_epoch)

    def process_historical_roots_update(self, state) -> None:
        next_epoch = Epoch(self.get_current_epoch(state) + 1)
        if next_epoch % (self.SLOTS_PER_HISTORICAL_ROOT // self.SLOTS_PER_EPOCH) == 0:
            historical_batch = self.HistoricalBatch(
                block_roots=state.block_roots, state_roots=state.state_roots)
            state.historical_roots.append(hash_tree_root(historical_batch))

    def process_participation_record_updates(self, state) -> None:
        state.previous_epoch_attestations = state.current_epoch_attestations
        state.current_epoch_attestations = type(state.current_epoch_attestations)()

    # ======================================================================
    # Block processing (beacon-chain.md:1701)
    # ======================================================================

    def process_block(self, state, block) -> None:
        # Batch the block's assert-style signature checks (randao +
        # slashings + up to MAX_ATTESTATIONS aggregates + exits) into one
        # RLC product pairing on the card, in place of the reference's
        # serial per-operation loop (beacon-chain.md:1757-1774).
        with bls.batched_verification() as batch:
            self.process_block_header(state, block)
            self.process_randao(state, block.body)
            self.process_eth1_data(state, block.body)
            self.process_operations(state, block.body)
        batch.assert_valid()

    def process_block_header(self, state, block) -> None:
        # Verify that the slots match
        assert block.slot == state.slot
        # Verify that the block is newer than latest block header
        assert block.slot > state.latest_block_header.slot
        # Verify that proposer index is the correct index
        assert block.proposer_index == self.get_beacon_proposer_index(state)
        # Verify that the parent matches
        assert block.parent_root == hash_tree_root(state.latest_block_header)
        # Cache current block as the new latest block
        state.latest_block_header = self.BeaconBlockHeader(
            slot=block.slot,
            proposer_index=block.proposer_index,
            parent_root=block.parent_root,
            state_root=Bytes32(),  # Overwritten in the next process_slot call
            body_root=hash_tree_root(block.body),
        )
        # Verify proposer is not slashed
        proposer = state.validators[block.proposer_index]
        assert not proposer.slashed

    def process_randao(self, state, body) -> None:
        epoch = self.get_current_epoch(state)
        # Verify RANDAO reveal
        proposer = state.validators[self.get_beacon_proposer_index(state)]
        signing_root = self.compute_signing_root(
            uint64(epoch), self.get_domain(state, DOMAIN_RANDAO))
        assert bls.Verify(proposer.pubkey, signing_root, body.randao_reveal)
        # Mix in RANDAO reveal
        mix = self.xor(self.get_randao_mix(state, epoch), hash(body.randao_reveal))
        state.randao_mixes[epoch % self.EPOCHS_PER_HISTORICAL_VECTOR] = mix

    def process_eth1_data(self, state, body) -> None:
        state.eth1_data_votes.append(body.eth1_data)
        if list(state.eth1_data_votes).count(body.eth1_data) * 2 \
                > self.EPOCHS_PER_ETH1_VOTING_PERIOD * self.SLOTS_PER_EPOCH:
            state.eth1_data = body.eth1_data

    def process_operations(self, state, body) -> None:
        """beacon-chain.md:1757"""
        # Verify that outstanding deposits are processed up to the maximum
        assert len(body.deposits) == min(
            self.MAX_DEPOSITS,
            state.eth1_data.deposit_count - state.eth1_deposit_index)

        def for_ops(operations, fn):
            for operation in operations:
                fn(state, operation)

        for_ops(body.proposer_slashings, self.process_proposer_slashing)
        for_ops(body.attester_slashings, self.process_attester_slashing)
        for_ops(body.attestations, self.process_attestation)
        for_ops(body.deposits, self.process_deposit)
        for_ops(body.voluntary_exits, self.process_voluntary_exit)

    def process_proposer_slashing(self, state, proposer_slashing) -> None:
        header_1 = proposer_slashing.signed_header_1.message
        header_2 = proposer_slashing.signed_header_2.message
        # Verify header slots match
        assert header_1.slot == header_2.slot
        # Verify header proposer indices match
        assert header_1.proposer_index == header_2.proposer_index
        # Verify the headers are different
        assert header_1 != header_2
        # Verify the proposer is slashable
        proposer = state.validators[header_1.proposer_index]
        assert self.is_slashable_validator(proposer, self.get_current_epoch(state))
        # Verify signatures
        for signed_header in (proposer_slashing.signed_header_1,
                              proposer_slashing.signed_header_2):
            domain = self.get_domain(
                state, DOMAIN_BEACON_PROPOSER,
                self.compute_epoch_at_slot(signed_header.message.slot))
            signing_root = self.compute_signing_root(signed_header.message, domain)
            assert bls.Verify(proposer.pubkey, signing_root, signed_header.signature)
        self.slash_validator(state, header_1.proposer_index)

    def process_attester_slashing(self, state, attester_slashing) -> None:
        attestation_1 = attester_slashing.attestation_1
        attestation_2 = attester_slashing.attestation_2
        assert self.is_slashable_attestation_data(attestation_1.data, attestation_2.data)
        assert self.is_valid_indexed_attestation(state, attestation_1)
        assert self.is_valid_indexed_attestation(state, attestation_2)

        slashed_any = False
        indices = set(attestation_1.attesting_indices).intersection(
            attestation_2.attesting_indices)
        for index in sorted(indices):
            if self.is_slashable_validator(
                    state.validators[index], self.get_current_epoch(state)):
                self.slash_validator(state, index)
                slashed_any = True
        assert slashed_any

    def process_attestation(self, state, attestation) -> None:
        """beacon-chain.md:1822"""
        data = attestation.data
        assert data.target.epoch in (
            self.get_previous_epoch(state), self.get_current_epoch(state))
        assert data.target.epoch == self.compute_epoch_at_slot(data.slot)
        assert data.slot + self.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot \
            <= data.slot + self.SLOTS_PER_EPOCH
        assert data.index < self.get_committee_count_per_slot(state, data.target.epoch)

        committee = self.get_beacon_committee(state, data.slot, data.index)
        assert len(attestation.aggregation_bits) == len(committee)

        pending_attestation = self.PendingAttestation(
            data=data,
            aggregation_bits=attestation.aggregation_bits,
            inclusion_delay=state.slot - data.slot,
            proposer_index=self.get_beacon_proposer_index(state),
        )

        if data.target.epoch == self.get_current_epoch(state):
            assert data.source == state.current_justified_checkpoint
            state.current_epoch_attestations.append(pending_attestation)
        else:
            assert data.source == state.previous_justified_checkpoint
            state.previous_epoch_attestations.append(pending_attestation)

        # Verify signature
        assert self.is_valid_indexed_attestation(
            state, self.get_indexed_attestation(state, attestation))

    def get_validator_from_deposit(self, pubkey, withdrawal_credentials, amount):
        """beacon-chain.md:1853"""
        effective_balance = min(
            amount - amount % self.EFFECTIVE_BALANCE_INCREMENT, self.MAX_EFFECTIVE_BALANCE)
        return self.Validator(
            pubkey=pubkey,
            withdrawal_credentials=withdrawal_credentials,
            activation_eligibility_epoch=FAR_FUTURE_EPOCH,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
            effective_balance=effective_balance,
        )

    def add_validator_to_registry(self, state, pubkey, withdrawal_credentials, amount) -> None:
        state.validators.append(
            self.get_validator_from_deposit(pubkey, withdrawal_credentials, amount))
        state.balances.append(amount)

    def apply_deposit(self, state, pubkey, withdrawal_credentials, amount, signature) -> None:
        """beacon-chain.md:1877"""
        validator_pubkeys = [v.pubkey for v in state.validators]
        if pubkey not in validator_pubkeys:
            # Verify the deposit signature (proof of possession) which is not
            # checked by the deposit contract
            deposit_message = self.DepositMessage(
                pubkey=pubkey,
                withdrawal_credentials=withdrawal_credentials,
                amount=amount,
            )
            # Fork-agnostic domain since deposits are valid across forks
            domain = self.compute_domain(DOMAIN_DEPOSIT)
            signing_root = self.compute_signing_root(deposit_message, domain)
            # Eager: this boolean steers state (invalid PoP skips the
            # validator, it does NOT invalidate the block) so it cannot
            # join the deferred block batch.
            if bls.VerifyEager(pubkey, signing_root, signature):
                self.add_validator_to_registry(
                    state, pubkey, withdrawal_credentials, amount)
        else:
            # Increase balance by deposit amount
            index = ValidatorIndex(validator_pubkeys.index(pubkey))
            self.increase_balance(state, index, amount)

    def process_deposit(self, state, deposit) -> None:
        """beacon-chain.md:1901"""
        # Verify the Merkle branch
        assert self.is_valid_merkle_branch(
            leaf=hash_tree_root(deposit.data),
            branch=deposit.proof,
            depth=DEPOSIT_CONTRACT_TREE_DEPTH + 1,  # add 1 for the List length mix-in
            index=state.eth1_deposit_index,
            root=state.eth1_data.deposit_root,
        )
        # Deposits must be processed in order
        state.eth1_deposit_index += 1
        self.apply_deposit(
            state=state,
            pubkey=deposit.data.pubkey,
            withdrawal_credentials=deposit.data.withdrawal_credentials,
            amount=deposit.data.amount,
            signature=deposit.data.signature,
        )

    def process_voluntary_exit(self, state, signed_voluntary_exit) -> None:
        voluntary_exit = signed_voluntary_exit.message
        validator = state.validators[voluntary_exit.validator_index]
        # Verify the validator is active
        assert self.is_active_validator(validator, self.get_current_epoch(state))
        # Verify exit has not been initiated
        assert validator.exit_epoch == FAR_FUTURE_EPOCH
        # Exits must specify an epoch when they become valid; they are not valid before then
        assert self.get_current_epoch(state) >= voluntary_exit.epoch
        # Verify the validator has been active long enough
        assert self.get_current_epoch(state) >= validator.activation_epoch \
            + self.config.SHARD_COMMITTEE_PERIOD
        # Verify signature
        domain = self.get_domain(state, DOMAIN_VOLUNTARY_EXIT, voluntary_exit.epoch)
        signing_root = self.compute_signing_root(voluntary_exit, domain)
        assert bls.Verify(validator.pubkey, signing_root, signed_voluntary_exit.signature)
        # Initiate exit
        self.initiate_validator_exit(state, voluntary_exit.validator_index)
