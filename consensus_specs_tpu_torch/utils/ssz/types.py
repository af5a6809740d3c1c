"""SSZ type system: typed values with serialize / hash_tree_root.

Counterpart of ``consensus_specs_tpu/utils/ssz/types.py`` without its
telemetry counters.  The state column store (``state/arrays.py``) reads
through ``sequence_items``, commits through ``replace_basic_items`` and
rides along ``Container.copy``.  Lists and vectors of uint8-uint64 and
of fixed-size containers (the validator registry) decode and pack column
by column through numpy, with the values of the element-by-element
path; a container whose fields are all immutable leaves (a
``Validator``) copies, and coerces into another fork's class of the same
field types, as one dict update that keeps its cached root.  A
from-scratch equivalent of the reference's ``remerkleable`` dependency
(reference: ``tests/core/pyspec/eth2spec/utils/ssz/ssz_typing.py``
re-exports; normative rules in ``ssz/simple-serialize.md``). Provides:

  basic:      uint8/16/32/64/128/256, boolean
  bytes:      ByteVector[N] (Bytes1/4/20/32/48/96 aliases), ByteList[LIMIT]
  bitfields:  Bitvector[N], Bitlist[LIMIT]
  composite:  Vector[elem, N], List[elem, LIMIT], Container, Union[...]

Values are mutable python objects with assignment-time validation: writing an
out-of-range value into a uint64 field raises, which is how the spec's
"uint64 overflow ⇒ invalid state transition" rule (reference:
``specs/phase0/beacon-chain.md:1253``) is enforced.

Every composite memoizes its hash_tree_root, invalidated precisely by
parent-pointer dirty propagation (see the note below) — so registry-scale
merkleization re-hashes only mutated subtree paths.
"""
import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .merkle import (
    IncrementalTree,
    merkleize_chunks,
    mix_in_length,
    mix_in_selector,
    pack_bytes_into_chunks,
)

OFFSET_BYTE_LENGTH = 4

# Root caching uses parent-pointer dirty propagation: every mutable
# composite knows the single location that owns it (value semantics:
# storing always snapshots, so ownership is unique), and a mutation walks
# the ownership chain invalidating only the ancestors' caches, while
# sequences additionally record WHICH child index changed so
# re-merkleization re-hashes only the dirty root paths
# (``merkle.IncrementalTree``).  This is the remerkleable role in the
# reference (``setup.py:549``): per-slot state roots cost O(mutations *
# log n) hashes, not O(registry).
class SSZValue:
    """Marker base for all SSZ value instances."""
    __slots__ = ()


def _set_owner(value, parent, key) -> None:
    """Record that ``value`` is stored at ``parent[key]`` (field index or
    element index).  Only mutable composites track ownership; leaves
    (ints/bytes) are immutable and need none."""
    if isinstance(value, (Container, _SequenceBase, _BitsBase, UnionBase)):
        object.__setattr__(value, "_owner", (weakref.ref(parent), key))


def _notify_owner(value) -> None:
    """Propagate a dirty mark from ``value`` up the ownership chain."""
    owner = getattr(value, "_owner", None)
    if owner is not None:
        parent = owner[0]()
        if parent is not None:
            parent._mark_child_dirty(owner[1])


# ---------------------------------------------------------------------------
# basic types
# ---------------------------------------------------------------------------

class BasicValue(int, SSZValue):
    byte_length = 0

    def __new__(cls, value=0):
        if isinstance(value, bytes):
            value = int.from_bytes(value, "little")
        value = int(value)
        if not 0 <= value < (1 << (cls.byte_length * 8)):
            raise ValueError(f"{cls.__name__} out of range: {value}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_byte_length(cls):
        return cls.byte_length

    @classmethod
    def default(cls):
        return cls(0)

    @classmethod
    def coerce(cls, value):
        return value if type(value) is cls else cls(value)

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != cls.byte_length:
            raise ValueError(f"{cls.__name__}: wrong byte length {len(data)}")
        # every pattern of byte_length bytes is in range: no range check
        return int.__new__(cls, int.from_bytes(data, "little"))

    def serialize(self) -> bytes:
        return int(self).to_bytes(self.byte_length, "little")

    def hash_tree_root(self) -> bytes:
        return int(self).to_bytes(self.byte_length, "little").ljust(32, b"\x00")

    def copy(self):
        return self


class uint8(BasicValue):
    byte_length = 1


class uint16(BasicValue):
    byte_length = 2


class uint32(BasicValue):
    byte_length = 4


class uint64(BasicValue):
    byte_length = 8


class uint128(BasicValue):
    byte_length = 16


class uint256(BasicValue):
    byte_length = 32


class boolean(BasicValue):
    byte_length = 1

    def __new__(cls, value=0):
        if isinstance(value, bytes):
            value = int.from_bytes(value, "little")
        value = int(value)
        if value not in (0, 1):
            raise ValueError(f"boolean must be 0 or 1, got {value}")
        return int.__new__(cls, value)

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != 1:
            raise ValueError(f"boolean: wrong byte length {len(data)}")
        return cls(data[0])

    def __bool__(self):
        return int(self) != 0


byte = uint8


# ---------------------------------------------------------------------------
# byte vectors / lists
# ---------------------------------------------------------------------------

def _to_bytes(value) -> bytes:
    if isinstance(value, str) and value.startswith("0x"):
        return bytes.fromhex(value[2:])
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes(value)
    if isinstance(value, Sequence):
        return bytes(value)
    raise TypeError(f"cannot convert {type(value)} to bytes")


class ByteVectorBase(bytes, SSZValue):
    length = 0

    def __new__(cls, value=None):
        if value is None:
            value = b"\x00" * cls.length
        value = _to_bytes(value)
        if len(value) != cls.length:
            raise ValueError(f"{cls.__name__}: need {cls.length} bytes, got {len(value)}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_byte_length(cls):
        return cls.length

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, value):
        return value if type(value) is cls else cls(value)

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != cls.length:
            raise ValueError(f"{cls.__name__}: need {cls.length} bytes, got {len(data)}")
        return bytes.__new__(cls, data)

    def serialize(self) -> bytes:
        return bytes(self)

    def hash_tree_root(self) -> bytes:
        return merkleize_chunks(pack_bytes_into_chunks(bytes(self)))

    def copy(self):
        return self

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


_byte_vector_cache: Dict[int, type] = {}


class _ParamMeta(type):
    def __getitem__(cls, params):
        return cls._make(params)


class ByteVector(ByteVectorBase, metaclass=_ParamMeta):
    @classmethod
    def _make(cls, length: int):
        t = _byte_vector_cache.get(length)
        if t is None:
            t = type(f"ByteVector{length}", (ByteVectorBase,), {"length": length})
            _byte_vector_cache[length] = t
        return t


class ByteListBase(bytes, SSZValue):
    limit = 0

    def __new__(cls, value=b""):
        value = _to_bytes(value)
        if len(value) > cls.limit:
            raise ValueError(f"{cls.__name__}: {len(value)} bytes exceeds limit {cls.limit}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, value):
        return value if type(value) is cls else cls(value)

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls(data)

    def serialize(self) -> bytes:
        return bytes(self)

    def hash_tree_root(self) -> bytes:
        limit_chunks = (self.limit + 31) // 32
        root = merkleize_chunks(pack_bytes_into_chunks(bytes(self)), limit=max(limit_chunks, 1))
        return mix_in_length(root, len(self))

    def copy(self):
        return self

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


_byte_list_cache: Dict[int, type] = {}


class ByteList(ByteListBase, metaclass=_ParamMeta):
    @classmethod
    def _make(cls, limit: int):
        t = _byte_list_cache.get(limit)
        if t is None:
            t = type(f"ByteList{limit}", (ByteListBase,), {"limit": limit})
            _byte_list_cache[limit] = t
        return t


Bytes1 = ByteVector[1]
Bytes4 = ByteVector[4]
Bytes8 = ByteVector[8]
Bytes20 = ByteVector[20]
Bytes32 = ByteVector[32]
Bytes48 = ByteVector[48]
Bytes96 = ByteVector[96]


def _immutable(typ) -> bool:
    """Values of ``typ`` are immutable leaves: shared, never copied, and
    owned by no one (copies and decodes skip them)."""
    return issubclass(typ, (BasicValue, ByteVectorBase, ByteListBase))


_FLAT: Dict[type, bool] = {}


def _flat(typ) -> bool:
    """``typ`` is a container whose every field is an immutable leaf (a
    ``Validator``): a copy of one shares its field values and its cached
    root, so it is one dict update (cached per class)."""
    flat = _FLAT.get(typ)
    if flat is None:
        flat = _FLAT[typ] = isinstance(typ, type) and issubclass(typ, Container) and all(
            immutable for _, _, _, immutable in typ._plan()[0])
    return flat


def _flat_copies(values, cls, parent):
    """Copies of the flat containers ``values`` as ``cls`` (each of ``cls``
    or of a class with the same field types, so the same root), owned by
    ``parent`` at their indices; None when one is of another class."""
    ref = weakref.ref(parent)
    new_ = object.__new__
    fields = cls._fields
    out = []
    for i, v in enumerate(values):
        t = type(v)
        if t is not cls and not (_flat(t) and t._fields == fields):
            return None
        c = new_(cls)
        d = c.__dict__
        d.update(v.__dict__)
        d["_owner"] = (ref, i)
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# bitfields
# ---------------------------------------------------------------------------

class _BitsBase(SSZValue):
    __slots__ = ("_bits", "_owner")

    def _init_bits(self, value, fixed_len: Optional[int]):
        if value is None:
            bits = [False] * (fixed_len or 0)
        elif isinstance(value, _BitsBase):
            bits = list(value._bits)
        else:
            bits = [bool(b) for b in value]
        if fixed_len is not None and len(bits) != fixed_len:
            raise ValueError(f"{type(self).__name__}: need {fixed_len} bits, got {len(bits)}")
        self._bits = bits

    def __len__(self):
        return len(self._bits)

    def __iter__(self):
        return iter(self._bits)

    def __getitem__(self, i):
        return self._bits[i]

    def __setitem__(self, i, v):
        self._bits[i] = bool(v)
        _notify_owner(self)

    def __eq__(self, other):
        if isinstance(other, _BitsBase):
            return self._bits == other._bits
        if isinstance(other, (list, tuple)):
            return self._bits == [bool(b) for b in other]
        return NotImplemented

    def __hash__(self):
        return hash((type(self).__name__, tuple(self._bits)))

    def _bitfield_bytes(self, with_delimiter: bool) -> bytes:
        n = len(self._bits)
        nbytes = (n + (1 if with_delimiter else 0) + 7) // 8
        buf = bytearray(nbytes)
        for i, b in enumerate(self._bits):
            if b:
                buf[i // 8] |= 1 << (i % 8)
        if with_delimiter:
            buf[n // 8] |= 1 << (n % 8)
        return bytes(buf)

    def __repr__(self):
        return f"{type(self).__name__}({self._bits})"


class BitvectorBase(_BitsBase):
    length = 0

    def __init__(self, value=None):
        self._init_bits(value, type(self).length)

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_byte_length(cls):
        return (cls.length + 7) // 8

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, value):
        # value semantics on assignment (remerkleable-compatible): snapshot
        return cls(value)

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != (cls.length + 7) // 8:
            raise ValueError(f"{cls.__name__}: wrong byte length")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(cls.length)]
        # padding bits beyond length must be zero
        for i in range(cls.length, len(data) * 8):
            if (data[i // 8] >> (i % 8)) & 1:
                raise ValueError(f"{cls.__name__}: nonzero padding bit")
        return cls(bits)

    def serialize(self) -> bytes:
        return self._bitfield_bytes(with_delimiter=False)

    def hash_tree_root(self) -> bytes:
        chunk_count = (self.length + 255) // 256
        return merkleize_chunks(
            pack_bytes_into_chunks(self.serialize()), limit=max(chunk_count, 1))

    def copy(self):
        return type(self)(self._bits)


_bitvector_cache: Dict[int, type] = {}


class Bitvector(BitvectorBase, metaclass=_ParamMeta):
    @classmethod
    def _make(cls, length: int):
        t = _bitvector_cache.get(length)
        if t is None:
            t = type(f"Bitvector{length}", (BitvectorBase,), {"length": length})
            _bitvector_cache[length] = t
        return t


class BitlistBase(_BitsBase):
    limit = 0

    def __init__(self, value=None):
        self._init_bits(value if value is not None else [], None)
        if len(self._bits) > type(self).limit:
            raise ValueError(f"{type(self).__name__}: {len(self._bits)} bits exceeds limit")

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, value):
        # value semantics on assignment (remerkleable-compatible): snapshot
        return cls(value)

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) == 0:
            raise ValueError("Bitlist: empty serialization (delimiter missing)")
        if data[-1] == 0:
            raise ValueError("Bitlist: last byte zero (delimiter missing)")
        total_bits = (len(data) - 1) * 8 + data[-1].bit_length() - 1
        if total_bits > cls.limit:
            raise ValueError(f"Bitlist: {total_bits} bits exceeds limit {cls.limit}")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(total_bits)]
        return cls(bits)

    def append(self, v):
        if len(self._bits) >= type(self).limit:
            raise ValueError("Bitlist: append past limit")
        self._bits.append(bool(v))
        _notify_owner(self)

    def serialize(self) -> bytes:
        return self._bitfield_bytes(with_delimiter=True)

    def hash_tree_root(self) -> bytes:
        chunk_count = (type(self).limit + 255) // 256
        root = merkleize_chunks(
            pack_bytes_into_chunks(self._bitfield_bytes(with_delimiter=False) if self._bits else b""),
            limit=max(chunk_count, 1))
        return mix_in_length(root, len(self._bits))

    def copy(self):
        return type(self)(self._bits)


_bitlist_cache: Dict[int, type] = {}


class Bitlist(BitlistBase, metaclass=_ParamMeta):
    @classmethod
    def _make(cls, limit: int):
        t = _bitlist_cache.get(limit)
        if t is None:
            t = type(f"Bitlist{limit}", (BitlistBase,), {"limit": limit})
            _bitlist_cache[limit] = t
        return t


# ---------------------------------------------------------------------------
# homogeneous sequences
# ---------------------------------------------------------------------------

def _numpy_width(elem_type) -> bool:
    """Element types whose values numpy holds and any of whose byte
    patterns decodes: uint8 to uint64 (not boolean: only 0 and 1 decode)."""
    return elem_type.byte_length <= 8 and not issubclass(elem_type, boolean)


def _pack_basic(values, elem_type) -> bytes:
    size = elem_type.byte_length
    if size <= 8:
        return np.fromiter(values, dtype=np.uint64, count=len(values)) \
            .astype(f"<u{size}").tobytes()
    return b"".join(int(v).to_bytes(size, "little") for v in values)


class _SequenceBase(SSZValue):
    __slots__ = ("_items", "_root_memo", "_tree", "_dirty", "_owner", "_gen",
                 "_hash_memo")
    elem_type: type = None

    @classmethod
    def _adopt(cls, items):
        """A sequence over freshly decoded items that nothing else holds:
        no coercion copy, only the owner links of mutable items."""
        new = object.__new__(cls)
        new._items = items
        if not _immutable(cls.elem_type):
            for i, x in enumerate(items):
                _set_owner(x, new, i)
        return new

    def _copy_items_into(self, new) -> None:
        et = type(self).elem_type
        if _immutable(et):
            new._items = list(self._items)
        elif _flat(et):
            new._items = _flat_copies(self._items, et, new)
        else:
            new._items = [x.copy() for x in self._items]
            for i, x in enumerate(new._items):
                _set_owner(x, new, i)
        self._copy_tree_into(new)

    def _coerce_items(self, values):
        et = type(self).elem_type
        if _flat(et) and isinstance(values, (list, tuple)):
            items = _flat_copies(values, et, self)
            if items is not None:
                return items
        items = [et.coerce(v) for v in values]
        for i, v in enumerate(items):
            _set_owner(v, self, i)
        return items

    def _mark_child_dirty(self, key) -> None:
        tree = getattr(self, "_tree", None)
        if tree is not None:
            self._dirty.add(key)
        self._root_memo = None
        # mutation generation: validates forest-stashed column snapshots
        self._gen = getattr(self, "_gen", 0) + 1
        _notify_owner(self)

    def _drop_tree(self) -> None:
        """Structural change the incremental path doesn't model (full
        replacement, empty shrink): fall back to a rebuild on next root."""
        object.__setattr__(self, "_tree", None)
        self._root_memo = None
        self._gen = getattr(self, "_gen", 0) + 1
        _notify_owner(self)

    def _chunks_for_items(self, indices):
        """Leaf chunks for the element ``indices`` as {chunk_idx: bytes}.
        Wide composite sets go columnar (one batched reduction for all
        dirty element roots); full builds use :meth:`_leaf_data`."""
        et = type(self).elem_type
        if issubclass(et, BasicValue):
            per = 32 // et.byte_length
            out = {}
            for ci in {i // per for i in indices}:
                seg = self._items[ci * per:(ci + 1) * per]
                out[ci] = _pack_basic(seg, et).ljust(32, b"\x00")
            return out
        if len(indices) >= forest._COLUMNAR_MIN:
            idx = sorted(indices)
            data = forest.bulk_element_root_bytes(
                [self._items[i] for i in idx], et)
            if data is not None:
                return {i: data[k * 32:(k + 1) * 32]
                        for k, i in enumerate(idx)}
        return {i: self._items[i].hash_tree_root() for i in indices}

    def _leaf_data(self):
        """The full leaf layer as one packed byte buffer (the zero-copy
        bulk-build path: no per-chunk dict or list is materialized)."""
        et = type(self).elem_type
        if issubclass(et, BasicValue):
            return _pack_basic(self._items, et)   # tree pads to chunks
        data = forest.bulk_element_root_bytes(self._items, et, self)
        if data is not None:
            return data
        return b"".join(x.hash_tree_root() for x in self._items)

    def _limit_chunks(self) -> int:
        et = type(self).elem_type
        bound = getattr(type(self), "limit", 0) or getattr(
            type(self), "length", 0)
        if issubclass(et, BasicValue):
            return max((bound * et.byte_length + 31) // 32, 1)
        return max(bound, 1)

    def _copy_tree_into(self, new) -> None:
        """Carry the cached chunk tree (and pending dirt) into a copy."""
        tree = getattr(self, "_tree", None)
        object.__setattr__(new, "_tree",
                           tree.copy() if tree is not None else None)
        object.__setattr__(new, "_dirty", set(getattr(self, "_dirty", ())))
        new._root_memo = getattr(self, "_root_memo", None)

    def _apply_dirty_leaves(self):
        """Flush pending dirty chunks into the backing tree's leaf layer
        and return ``(tree, sorted_dirty_parents)`` for the deferred
        level re-hash — the forest scope's per-tree entry point, so the
        upward hashing can be gathered across sibling trees.  None when
        nothing is pending."""
        tree = getattr(self, "_tree", None)
        if tree is None or not self._dirty:
            return None
        et = type(self).elem_type
        per = 32 // et.byte_length if issubclass(et, BasicValue) else 1
        n_chunks = (len(self._items) + per - 1) // per
        if tree.count > n_chunks:
            tree.truncate(n_chunks)
        live = {i for i in self._dirty if i < len(self._items)}
        self._dirty.clear()
        parents = tree.apply_leaves(self._chunks_for_items(live))
        return (tree, parents) if parents else None

    def _tree_root(self) -> bytes:
        """Chunk-tree root (before any length mix-in), incrementally
        maintained: only dirty chunk paths re-hash, level-batched."""
        tree = getattr(self, "_tree", None)
        if tree is None:
            tree = IncrementalTree(self._leaf_data(), self._limit_chunks())
            object.__setattr__(self, "_tree", tree)
            object.__setattr__(self, "_dirty", set())
        elif self._dirty:
            job = self._apply_dirty_leaves()
            if job is not None:
                job[0].rehash_up(job[1])
        return tree.root()

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __setitem__(self, i, v):
        if i < 0:
            i += len(self._items)
        value = type(self).elem_type.coerce(v)
        self._items[i] = value
        _set_owner(value, self, i)
        self._mark_child_dirty(i)

    def _cached_root(self, finish):
        """Memoized root: the memo is cleared EXPLICITLY by every mutation
        (own mutators + child dirty notifications), so validity is exact -
        no global clock involved."""
        memo = getattr(self, "_root_memo", None)
        if memo is not None:
            return memo
        root = finish(self._tree_root())
        self._root_memo = root
        return root

    def __eq__(self, other):
        if isinstance(other, _SequenceBase):
            return type(self).elem_type is type(other).elem_type and self._items == other._items
        if isinstance(other, (list, tuple)):
            return list(self._items) == list(other)
        return NotImplemented

    def __hash__(self):
        # Must stay consistent with __eq__, which compares only
        # (elem_type, items) — NOT the sequence class's limit/length — so
        # a List[u64, 8] equals a List[u64, 16] with the same values and
        # they must hash alike; the tree root (which commits to the
        # limit) is therefore NOT a valid hash key.  The content hash is
        # memoized against the mutation generation, so repeated hashing
        # is O(1); the old form serialized every element on each call.
        memo = getattr(self, "_hash_memo", None)
        gen = getattr(self, "_gen", 0)
        if memo is not None and memo[0] == gen:
            return memo[1]
        h = hash(tuple(self._items))
        self._hash_memo = (gen, h)
        return h

    def index(self, v):
        return self._items.index(v)

    def __contains__(self, v):
        return v in self._items

    def _serialize_elems(self) -> bytes:
        et = type(self).elem_type
        if issubclass(et, BasicValue):
            return _pack_basic(self._items, et)
        if et.is_fixed_size():
            if _flat(et) and self._items:
                return et._serialize_many(self._items)
            return b"".join(x.serialize() for x in self._items)
        parts = [x.serialize() for x in self._items]
        offset = OFFSET_BYTE_LENGTH * len(parts)
        head = bytearray()
        for p in parts:
            head += offset.to_bytes(OFFSET_BYTE_LENGTH, "little")
            offset += len(p)
        return bytes(head) + b"".join(parts)

    @classmethod
    def _decode_elems(cls, data: bytes):
        et = cls.elem_type
        if et.is_fixed_size():
            size = et.fixed_byte_length()
            if len(data) % size != 0:
                raise ValueError(f"{cls.__name__}: bad byte length {len(data)}")
            if issubclass(et, BasicValue) and _numpy_width(et):
                new = int.__new__
                return [new(et, v) for v in np.frombuffer(data, dtype=f"<u{size}").tolist()]
            if issubclass(et, Container) and data:
                return et._decode_many(data, size)
            return [et.decode_bytes(data[i:i + size]) for i in range(0, len(data), size)]
        if len(data) == 0:
            return []
        first_offset = int.from_bytes(data[:OFFSET_BYTE_LENGTH], "little")
        if (first_offset % OFFSET_BYTE_LENGTH != 0 or first_offset > len(data)
                or first_offset < OFFSET_BYTE_LENGTH):
            raise ValueError(f"{cls.__name__}: bad first offset {first_offset}")
        n = first_offset // OFFSET_BYTE_LENGTH
        offsets = [int.from_bytes(data[i * 4:(i + 1) * 4], "little") for i in range(n)]
        offsets.append(len(data))
        items = []
        for i in range(n):
            if offsets[i + 1] < offsets[i] or offsets[i + 1] > len(data):
                raise ValueError(f"{cls.__name__}: bad offsets")
            items.append(et.decode_bytes(data[offsets[i]:offsets[i + 1]]))
        return items

class VectorBase(_SequenceBase):
    length = 0

    def __init__(self, value=None):
        if value is None:
            et = type(self).elem_type
            self._items = [et.default() for _ in range(type(self).length)]
            for i, x in enumerate(self._items):
                _set_owner(x, self, i)
        else:
            self._items = self._coerce_items(value)
            if len(self._items) != type(self).length:
                raise ValueError(
                    f"{type(self).__name__}: need {type(self).length} elements, got {len(self._items)}")

    @classmethod
    def is_fixed_size(cls):
        return cls.elem_type.is_fixed_size()

    @classmethod
    def fixed_byte_length(cls):
        if not cls.is_fixed_size():
            raise TypeError("variable-size vector")
        return cls.elem_type.fixed_byte_length() * cls.length

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, value):
        # value semantics on assignment (remerkleable-compatible): snapshot
        return value.copy() if type(value) is cls else cls(value)

    @classmethod
    def decode_bytes(cls, data: bytes):
        items = cls._decode_elems(data)
        if len(items) != cls.length:
            raise ValueError(f"{cls.__name__}: wrong element count")
        return cls._adopt(items)

    def serialize(self) -> bytes:
        return self._serialize_elems()

    def hash_tree_root(self) -> bytes:
        return self._cached_root(lambda root: root)

    def copy(self):
        new = object.__new__(type(self))
        self._copy_items_into(new)
        return new

    def __repr__(self):
        return f"{type(self).__name__}({self._items!r})"


_vector_cache: Dict[Tuple[type, int], type] = {}


class Vector(VectorBase, metaclass=_ParamMeta):
    @classmethod
    def _make(cls, params):
        elem, length = params
        key = (elem, length)
        t = _vector_cache.get(key)
        if t is None:
            t = type(f"Vector[{elem.__name__},{length}]", (VectorBase,),
                     {"elem_type": elem, "length": length})
            _vector_cache[key] = t
        return t


class ListBase(_SequenceBase):
    limit = 0

    def __init__(self, *args):
        if len(args) == 1 and not isinstance(args[0], (SSZValue, int, bytes)) \
                and hasattr(args[0], "__iter__"):
            values = list(args[0])
        else:
            values = list(args)
        self._items = self._coerce_items(values)
        if len(self._items) > type(self).limit:
            raise ValueError(f"{type(self).__name__}: {len(self._items)} exceeds limit")

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, value):
        # value semantics on assignment (remerkleable-compatible): snapshot
        if type(value) is cls:
            return value.copy()
        if isinstance(value, _SequenceBase):
            # cross-class sequence (e.g. same-shape List from another fork's
            # spec instance): rebuild elementwise, never as a single element
            return cls(list(value))
        return cls(value)

    @classmethod
    def decode_bytes(cls, data: bytes):
        items = cls._decode_elems(data)
        if len(items) > cls.limit:
            raise ValueError(f"{cls.__name__}: too many elements")
        return cls._adopt(items)

    def append(self, v):
        if len(self._items) >= type(self).limit:
            raise ValueError(f"{type(self).__name__}: append past limit")
        value = type(self).elem_type.coerce(v)
        self._items.append(value)
        _set_owner(value, self, len(self._items) - 1)
        self._mark_child_dirty(len(self._items) - 1)

    def pop(self):
        v = self._items.pop()
        if self._items and getattr(self, "_tree", None) is not None:
            # shrink-by-one is modeled incrementally: marking the new
            # right-edge element dirty makes the next flush truncate the
            # tree and rewrite the (possibly partial) edge chunk
            self._mark_child_dirty(len(self._items) - 1)
        else:
            self._drop_tree()
        return v

    def serialize(self) -> bytes:
        return self._serialize_elems()

    def hash_tree_root(self) -> bytes:
        return self._cached_root(
            lambda root: mix_in_length(root, len(self._items)))

    def copy(self):
        new = object.__new__(type(self))
        self._copy_items_into(new)
        return new

    def __repr__(self):
        return f"{type(self).__name__}({self._items!r})"


_list_cache: Dict[Tuple[type, int], type] = {}


class List(ListBase, metaclass=_ParamMeta):
    @classmethod
    def _make(cls, params):
        elem, limit = params
        key = (elem, limit)
        t = _list_cache.get(key)
        if t is None:
            t = type(f"List[{elem.__name__},{limit}]", (ListBase,),
                     {"elem_type": elem, "limit": limit})
            _list_cache[key] = t
        return t


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------

class _ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields: Dict[str, type] = {}
        for base in reversed(cls.__mro__):
            anns = base.__dict__.get("__annotations__", {})
            for fname, ftype in anns.items():
                if fname.startswith("_"):
                    continue  # internal bookkeeping, not an SSZ field
                if not isinstance(ftype, type):
                    raise TypeError(
                        f"{name}.{fname}: SSZ field annotations must be live types "
                        f"(got {ftype!r}); string/postponed annotations are not supported")
                fields[fname] = ftype
        cls._fields = fields
        return cls


# Container class -> its field plan (Container._plan)
_PLANS: Dict[type, tuple] = {}


class Container(SSZValue, metaclass=_ContainerMeta):
    """SSZ container. Declare fields with class annotations:

        class Checkpoint(Container):
            epoch: uint64
            root: Bytes32
    """
    _fields: Dict[str, type] = {}

    def __init__(self, **kwargs):
        fields = type(self)._fields
        for k in kwargs:
            if k not in fields:
                raise TypeError(f"{type(self).__name__}: unknown field {k}")
        for fname, ftype in fields.items():
            if fname in kwargs:
                value = ftype.coerce(kwargs[fname])
            else:
                value = ftype.default()
            object.__setattr__(self, fname, value)
            _set_owner(value, self, fname)
        object.__setattr__(self, "_root_cache", None)

    def __setattr__(self, name, value):
        ftype = type(self)._fields.get(name)
        if ftype is None:
            raise AttributeError(f"{type(self).__name__}: no field {name}")
        value = ftype.coerce(value)
        object.__setattr__(self, name, value)
        _set_owner(value, self, name)
        object.__setattr__(self, "_root_cache", None)
        _notify_owner(self)

    def _mark_child_dirty(self, key) -> None:
        object.__setattr__(self, "_root_cache", None)
        _notify_owner(self)

    @classmethod
    def fields(cls) -> Dict[str, type]:
        return dict(cls._fields)

    @classmethod
    def is_fixed_size(cls):
        return all(t.is_fixed_size() for t in cls._fields.values())

    @classmethod
    def fixed_byte_length(cls):
        if not cls.is_fixed_size():
            raise TypeError("variable-size container")
        return sum(t.fixed_byte_length() for t in cls._fields.values())

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, value):
        # value semantics on assignment (remerkleable-compatible): snapshot
        if type(value) is cls:
            return value.copy()
        if isinstance(value, Container) and type(value)._fields == cls._fields:
            # another class of the same field types (one spec's Validator
            # into another's): the field values coerce as they are
            return cls._adopt({f: getattr(value, f) if immutable else getattr(value, f).copy()
                               for f, _, _, immutable in cls._plan()[0]})
        if isinstance(value, Container) and type(value)._fields.keys() == cls._fields.keys():
            return cls(**{k: getattr(value, k) for k in cls._fields})
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"cannot coerce {type(value)} to {cls.__name__}")

    @classmethod
    def _plan(cls):
        """((name, type, fixed byte size or None, immutable) per field, the
        fixed part's byte length), cached per class."""
        plan = _PLANS.get(cls)
        if plan is None:
            fields = tuple((f, t, t.fixed_byte_length() if t.is_fixed_size() else None,
                            _immutable(t)) for f, t in cls._fields.items())
            plan = (fields, sum(OFFSET_BYTE_LENGTH if size is None else size
                                for _, _, size, _ in fields))
            _PLANS[cls] = plan
        return plan

    @classmethod
    def _adopt(cls, parts: dict):
        """A container over freshly decoded field values that nothing else
        holds: no coercion copy, only the owner links of mutable fields."""
        new = object.__new__(cls)
        for fname, _, _, immutable in cls._plan()[0]:
            v = parts[fname]
            object.__setattr__(new, fname, v)
            if not immutable:
                _set_owner(v, new, fname)
        object.__setattr__(new, "_root_cache", None)
        return new

    @classmethod
    def _decode_many(cls, data: bytes, size: int) -> list:
        """The fixed-size elements of one List or Vector, decoded field by
        field over all of them (uint fields through numpy, byte vectors
        by slicing), then assembled: the same values as one
        ``decode_bytes`` per element, for a registry of 2^20 validators
        in a fraction of the time."""
        fields, _ = cls._plan()
        n = len(data) // size
        rows = np.frombuffer(data, dtype=np.uint8).reshape(n, size)
        cols, pos = [], 0
        for fname, ftype, fsize, immutable in fields:
            if issubclass(ftype, BasicValue) and _numpy_width(ftype):
                vals = np.ascontiguousarray(rows[:, pos:pos + fsize]) \
                    .view(f"<u{fsize}").reshape(n).tolist()
                new = int.__new__
                col = [new(ftype, v) for v in vals]
            elif issubclass(ftype, ByteVectorBase):
                new = bytes.__new__
                col = [new(ftype, data[o:o + fsize]) for o in range(pos, n * size, size)]
            else:
                dec = ftype.decode_bytes
                col = [dec(data[o:o + fsize]) for o in range(pos, n * size, size)]
            cols.append((fname, col, immutable))
            pos += fsize
        out = []
        setattr_ = object.__setattr__
        for i in range(n):
            new = object.__new__(cls)
            for fname, col, immutable in cols:
                v = col[i]
                setattr_(new, fname, v)
                if not immutable:
                    _set_owner(v, new, fname)
            setattr_(new, "_root_cache", None)
            out.append(new)
        return out

    @classmethod
    def _serialize_many(cls, items) -> bytes:
        """Fixed-size flat elements of one List or Vector (every field an
        immutable leaf) serialized field by field over all of them (uint
        fields through numpy, byte vectors joined) into one row each: the
        same bytes as one ``serialize`` per element."""
        fields, size = cls._plan()
        n = len(items)
        rows = np.empty((n, size), dtype=np.uint8)
        pos = 0
        for fname, ftype, fsize, _ in fields:
            vals = [getattr(x, fname) for x in items]
            if issubclass(ftype, BasicValue) and fsize <= 8:
                col = np.fromiter(vals, dtype=np.uint64, count=n).astype(f"<u{fsize}")
            else:
                col = np.frombuffer(b"".join(v if isinstance(v, bytes) else v.serialize()
                                             for v in vals), dtype=np.uint8)
            rows[:, pos:pos + fsize] = col.view(np.uint8).reshape(n, fsize)
            pos += fsize
        return rows.tobytes()

    @classmethod
    def decode_bytes(cls, data: bytes):
        fields, fixed_total = cls._plan()
        if len(data) < fixed_total:
            raise ValueError(f"{cls.__name__}: truncated")
        pos = 0
        offsets = []
        fixed_parts = {}
        for fname, ftype, size, _ in fields:
            if size is not None:
                fixed_parts[fname] = ftype.decode_bytes(data[pos:pos + size])
                pos += size
            else:
                offsets.append((fname, ftype, int.from_bytes(
                    data[pos:pos + OFFSET_BYTE_LENGTH], "little")))
                pos += OFFSET_BYTE_LENGTH
        if offsets:
            if offsets[0][2] != fixed_total:
                raise ValueError(f"{cls.__name__}: bad first offset")
            bounds = [o[2] for o in offsets] + [len(data)]
            for i, (fname, ftype, off) in enumerate(offsets):
                if bounds[i + 1] < off or bounds[i + 1] > len(data):
                    raise ValueError(f"{cls.__name__}: bad offsets")
                fixed_parts[fname] = ftype.decode_bytes(data[off:bounds[i + 1]])
        elif len(data) != fixed_total:
            raise ValueError(f"{cls.__name__}: trailing bytes")
        return cls._adopt(fixed_parts)

    def serialize(self) -> bytes:
        fields, fixed_total = type(self)._plan()
        head = bytearray()
        tail = bytearray()
        offset = fixed_total
        for fname, _, size, _ in fields:
            v = getattr(self, fname)
            if size is not None:
                head += v.serialize()
            else:
                part = v.serialize()
                head += offset.to_bytes(OFFSET_BYTE_LENGTH, "little")
                offset += len(part)
                tail += part
        return bytes(head + tail)

    def hash_tree_root(self) -> bytes:
        # Safe to cache on EVERY container: any mutation below this node
        # (field assignment, nested setitem/append/bit flip) walks the
        # ownership chain and clears this cache precisely.
        cached = object.__getattribute__(self, "_root_cache")
        if cached is not None:
            return cached
        if forest.scope_active():
            # batch scope: flush every dirty subtree of this forest
            # level-aligned before the recursive walk reads their roots
            forest.flush_container(self)
        chunks = [getattr(self, f).hash_tree_root() for f in type(self)._fields]
        root = merkleize_chunks(chunks)
        object.__setattr__(self, "_root_cache", root)
        return root

    def copy(self):
        if _flat(type(self)):
            # every field an immutable leaf: shared, and so is the root
            new = object.__new__(type(self))
            new.__dict__.update(self.__dict__)
            new.__dict__.pop("_owner", None)
            return new
        # A state carrying a column store (state/arrays.py) commits its
        # pending column writes before the field snapshot, so the copy's
        # SSZ content matches, and hands the store's columns to the copy
        # after it, copy-on-write.  Duck-typed on the attribute: this
        # module needs no upward import.
        store = self.__dict__.get("_state_arrays")
        if store is not None:
            store.commit_for_copy()
        new = object.__new__(type(self))
        for f, _, _, immutable in type(self)._plan()[0]:
            fv = getattr(self, f)
            if not immutable:
                fv = fv.copy()
                _set_owner(fv, new, f)
            object.__setattr__(new, f, fv)
        # field copies have identical roots, so the memoized root carries over
        object.__setattr__(new, "_root_cache",
                           object.__getattribute__(self, "_root_cache"))
        if store is not None:
            store.fork(new)
        return new

    def __eq__(self, other):
        if not isinstance(other, Container):
            return NotImplemented
        if type(self)._fields.keys() != type(other)._fields.keys():
            return False
        return all(getattr(self, f) == getattr(other, f) for f in type(self)._fields)

    def __hash__(self):
        return hash(self.hash_tree_root())

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in type(self)._fields)
        return f"{type(self).__name__}({inner})"


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

class UnionBase(SSZValue):
    __slots__ = ("_selector", "_value", "_owner")
    options: Tuple[Optional[type], ...] = ()

    def __init__(self, selector: int = 0, value=None):
        options = type(self).options
        if not 0 <= selector < len(options):
            raise ValueError("Union: bad selector")
        opt = options[selector]
        if opt is None:
            if value is not None:
                raise ValueError("Union: None option takes no value")
            self._value = None
        else:
            self._value = opt.coerce(value) if value is not None else opt.default()
            _set_owner(self._value, self, 0)
        self._selector = selector

    def _mark_child_dirty(self, key) -> None:
        _notify_owner(self)

    @property
    def selector(self):
        return self._selector

    @property
    def value(self):
        return self._value

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def default(cls):
        return cls(0)

    @classmethod
    def coerce(cls, value):
        if type(value) is cls:
            return value.copy()
        if isinstance(value, tuple) and len(value) == 2:
            return cls(value[0], value[1])
        raise TypeError(
            f"cannot coerce {type(value).__name__} to {cls.__name__}; "
            "pass a Union instance or a (selector, value) tuple")

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) == 0:
            raise ValueError("Union: empty")
        selector = data[0]
        if selector >= len(cls.options):
            raise ValueError("Union: bad selector")
        opt = cls.options[selector]
        if opt is None:
            if len(data) != 1:
                raise ValueError("Union: None option with payload")
            return cls(0)
        return cls(selector, opt.decode_bytes(data[1:]))

    def serialize(self) -> bytes:
        payload = b"" if self._value is None else self._value.serialize()
        return bytes([self._selector]) + payload

    def hash_tree_root(self) -> bytes:
        root = b"\x00" * 32 if self._value is None else self._value.hash_tree_root()
        return mix_in_selector(root, self._selector)

    def copy(self):
        new = object.__new__(type(self))
        new._selector = self._selector
        new._value = None if self._value is None else self._value.copy()
        if new._value is not None:
            _set_owner(new._value, new, 0)
        return new

    def __eq__(self, other):
        return (isinstance(other, UnionBase) and self._selector == other._selector
                and self._value == other._value)

    def __hash__(self):
        return hash(self.hash_tree_root())


_union_cache: Dict[Tuple, type] = {}


class Union(UnionBase, metaclass=_ParamMeta):
    @classmethod
    def _make(cls, params):
        if not isinstance(params, tuple):
            params = (params,)
        key = tuple(params)
        t = _union_cache.get(key)
        if t is None:
            t = type(f"Union[{','.join('None' if p is None else p.__name__ for p in params)}]",
                     (UnionBase,), {"options": tuple(params)})
            _union_cache[key] = t
        return t


# ---------------------------------------------------------------------------
# columnar access (state/arrays.py: the state column store)
# ---------------------------------------------------------------------------

def sequence_items(seq):
    """The backing element list of a List/Vector, uncopied, for columnar
    extraction.  Read-only: every write goes through the sequence API or
    :func:`replace_basic_items`, so dirty tracking stays exact."""
    if not isinstance(seq, _SequenceBase):
        raise TypeError(f"sequence_items: want List/Vector, got {type(seq)}")
    return seq._items


def replace_basic_items(seq, items, packed=None) -> None:
    """Swap every element of a basic-element List/Vector at once.

    ``items``: already-coerced ``elem_type`` instances.  ``packed``, when
    given, is their little-endian serialization (``column.astype('<u8')
    .tobytes()``): the chunk tree is then rebuilt from it level by level
    through the batched hasher.  Without it the tree is dropped and
    rebuilt on the next root.  Bumps the mutation generation."""
    et = type(seq).elem_type
    if not issubclass(et, BasicValue):
        raise TypeError("replace_basic_items: basic element types only")
    limit = getattr(type(seq), "limit", 0)
    length = getattr(type(seq), "length", 0)
    if length and len(items) != length:
        raise ValueError(f"{type(seq).__name__}: need {length} elements")
    if limit and len(items) > limit:
        raise ValueError(f"{type(seq).__name__}: {len(items)} exceeds limit")
    if items and not (isinstance(items[0], et) and isinstance(items[-1], et)):
        raise TypeError(f"replace_basic_items: want {et.__name__} elements")
    if packed is not None and len(packed) != len(items) * et.byte_length:
        # checked before the swap: a refused commit leaves the sequence
        # (items, tree, memo) untouched
        raise ValueError("replace_basic_items: packed length mismatch")
    object.__setattr__(seq, "_items", list(items))
    if packed is None:
        seq._drop_tree()
        return
    tree = getattr(seq, "_tree", None)
    if tree is None:
        object.__setattr__(seq, "_tree",
                           IncrementalTree(packed, seq._limit_chunks()))
    else:
        tree.set_leaves(packed)
    object.__setattr__(seq, "_dirty", set())
    seq._root_memo = None
    seq._gen = getattr(seq, "_gen", 0) + 1
    _notify_owner(seq)


def basic_sequence_from_column(typ, column):
    """A new ``typ`` (a List or Vector of a basic element of at most 8
    bytes) holding the values of the numpy ``column``, built without a
    per-element coercion: one element object per distinct value, and the
    chunk tree from the packed column (:func:`replace_basic_items`).
    Equal, root and serialization alike, to ``typ(list of values)``;
    the epoch transition builds its registry-wide flag and score lists
    this way (2^20 elements)."""
    import numpy as np
    et = typ.elem_type
    if not issubclass(et, BasicValue) or et.byte_length > 8:
        raise TypeError("basic_sequence_from_column: basic elements of <= 8 bytes only")
    col = np.ascontiguousarray(column).astype(f"<u{et.byte_length}", copy=False)
    vals, inv = np.unique(col, return_inverse=True)
    pool = [et(v) for v in vals.tolist()]
    seq = typ()
    replace_basic_items(seq, [pool[i] for i in inv.tolist()], packed=col.tobytes())
    return seq


# Bottom import: forest.py needs the class definitions above (it walks
# Container/_SequenceBase instances); by this point the module namespace
# is complete, so the circular reference resolves either import order.
from . import forest  # noqa: E402
