"""Custom SSZ type aliases and fork-independent constants.

Counterpart of ``consensus_specs_tpu/forks/base_types.py``.  Reference:
"Custom types" + "Constants" tables of ``specs/phase0/beacon-chain.md``
(lines ~290-350).
"""
from ..utils.ssz import (
    uint8, uint64, Bytes4, Bytes20, Bytes32, Bytes48, Bytes96,
)

# custom types (aliases of basic/byte types)
Slot = uint64
Epoch = uint64
CommitteeIndex = uint64
ValidatorIndex = uint64
Gwei = uint64
Root = Bytes32
Hash32 = Bytes32
Version = Bytes4
DomainType = Bytes4
ForkDigest = Bytes4
Domain = Bytes32
BLSPubkey = Bytes48
BLSSignature = Bytes96
ExecutionAddress = Bytes20
ParticipationFlags = uint8
KZGCommitment = Bytes48
KZGProof = Bytes48

# constants (fork-independent, not preset/config)
GENESIS_SLOT = Slot(0)
GENESIS_EPOCH = Epoch(0)
FAR_FUTURE_EPOCH = Epoch(2**64 - 1)
BASE_REWARDS_PER_EPOCH = uint64(4)
DEPOSIT_CONTRACT_TREE_DEPTH = 2**5
JUSTIFICATION_BITS_LENGTH = 4
ENDIANNESS = "little"

BLS_WITHDRAWAL_PREFIX = b"\x00"
ETH1_ADDRESS_WITHDRAWAL_PREFIX = b"\x01"

DOMAIN_BEACON_PROPOSER = DomainType("0x00000000")
DOMAIN_BEACON_ATTESTER = DomainType("0x01000000")
DOMAIN_RANDAO = DomainType("0x02000000")
DOMAIN_DEPOSIT = DomainType("0x03000000")
DOMAIN_VOLUNTARY_EXIT = DomainType("0x04000000")
DOMAIN_SELECTION_PROOF = DomainType("0x05000000")
DOMAIN_AGGREGATE_AND_PROOF = DomainType("0x06000000")
DOMAIN_SYNC_COMMITTEE = DomainType("0x07000000")
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = DomainType("0x08000000")
DOMAIN_CONTRIBUTION_AND_PROOF = DomainType("0x09000000")
DOMAIN_BLS_TO_EXECUTION_CHANGE = DomainType("0x0A000000")
DOMAIN_APPLICATION_MASK = DomainType("0x00000001")
