"""Functional SSZ entrypoints used by spec code.

Counterpart of ``consensus_specs_tpu/utils/ssz/impl.py`` (reference:
``tests/core/pyspec/eth2spec/utils/ssz/ssz_impl.py:8-25``,
serialize / hash_tree_root / uint_to_bytes / copy).
"""
from .types import SSZValue, BasicValue, Bytes32


def serialize(obj: SSZValue) -> bytes:
    return obj.serialize()


def hash_tree_root(obj: SSZValue) -> Bytes32:
    return Bytes32(obj.hash_tree_root())


def uint_to_bytes(n: BasicValue) -> bytes:
    """Serialize a uint to its type's byte length, little-endian."""
    return n.serialize()


def copy(obj: SSZValue) -> SSZValue:
    return obj.copy()


def deserialize(typ, data: bytes) -> SSZValue:
    return typ.decode_bytes(data)
