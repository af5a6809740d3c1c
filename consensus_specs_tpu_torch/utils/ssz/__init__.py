"""SSZ: SimpleSerialize types, serialization and merkleization.

Counterpart of ``consensus_specs_tpu/utils/ssz`` (reference:
``eth2spec.utils.ssz``; normative spec ``ssz/simple-serialize.md``).
Merkle proofs (``proofs.py``) are not carried yet: phase0 does not use
them.
"""
from .types import (
    SSZValue, BasicValue, boolean, byte,
    uint8, uint16, uint32, uint64, uint128, uint256,
    ByteVector, ByteList,
    Bytes1, Bytes4, Bytes8, Bytes20, Bytes32, Bytes48, Bytes96,
    Bitvector, Bitlist, Vector, List, Container, Union,
    sequence_items, replace_basic_items, basic_sequence_from_column,
)
from .impl import serialize, hash_tree_root, uint_to_bytes, copy, deserialize
from .merkle import merkleize_chunks, mix_in_length, mix_in_selector, zero_hashes

__all__ = [
    "SSZValue", "BasicValue", "boolean", "byte",
    "uint8", "uint16", "uint32", "uint64", "uint128", "uint256",
    "ByteVector", "ByteList",
    "Bytes1", "Bytes4", "Bytes8", "Bytes20", "Bytes32", "Bytes48", "Bytes96",
    "Bitvector", "Bitlist", "Vector", "List", "Container", "Union",
    "sequence_items", "replace_basic_items", "basic_sequence_from_column",
    "serialize", "hash_tree_root", "uint_to_bytes", "copy", "deserialize",
    "merkleize_chunks", "mix_in_length", "mix_in_selector", "zero_hashes",
]
