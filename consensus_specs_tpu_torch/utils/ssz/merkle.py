"""Merkleization engine.

Counterpart of ``consensus_specs_tpu/utils/ssz/merkle.py``.  Implements
the SSZ merkleization rules (reference: ``ssz/simple-serialize.md``
"Merkleization"): chunkify, pad to the chunk-count limit with
zero-subtree roots, binary-tree hash, plus ``mix_in_length`` /
``mix_in_selector``.

Each tree level is hashed through :func:`hash_layer`, one contiguous
buffer of 64-byte parent inputs: the batch boundary of the SHA-256
kernel K5 (``ops/sha256.py``, installed with
``sha256.install_merkle_hasher``), so a 2^20-leaf tree is ~20 kernel
calls instead of ~2^20 scalar hashes.  :class:`IncrementalTree` applies
the same idea to dirty re-hashing: each level's dirty sibling pairs are
gathered into one ``(n, 64)`` buffer and hashed in one dispatch
(:func:`hash_rows`).

Batches below the JAX package's size thresholds (``_BATCH_THRESHOLD``
parent inputs, ``_PAIR_BATCH_MIN`` dirty pairs) go to a hashlib loop: a
size rule, not a fallback.  There is no fallback on failure: a kernel
that fails raises.  The JAX package's native C hasher, mesh span
builds, supervisor, fault sites and telemetry series are not carried;
:func:`stats` keeps plain module counters of who hashed how many pairs.
"""
from bisect import bisect_right
from hashlib import sha256
from typing import List, Optional, Sequence

import numpy as np

ZERO_CHUNK = b"\x00" * 32

# zero_hashes[i] = root of an all-zero subtree of depth i
zero_hashes: List[bytes] = [ZERO_CHUNK]
for _ in range(64):
    zero_hashes.append(sha256(zero_hashes[-1] + zero_hashes[-1]).digest())

# Parent inputs per layer at or above which layer hashing goes to the
# batched hasher, and dirty pairs per level at or above which the
# incremental engine gathers the level into one batched dispatch (the
# JAX package's defaults; tests move them with set_batch_thresholds).
_BATCH_THRESHOLD = 256
_PAIR_BATCH_MIN = 32

_batched_hasher = None
_batched_hasher_np = None

# Dispatch accounting (plain counters, read through stats()):
#   pairs_batched / pairs_hashlib - 64-byte parent inputs hashed by the
#       installed batched hasher / by hashlib
#   layer_calls / layer_scalar - batched dispatches / layer nodes that
#       went through the hashlib loop
#   pair_batch_calls / pair_batch_pairs - batched dispatches of gathered
#       rows (incremental engine, forest flushes, columnar roots) and the
#       pairs they covered
#   pair_scalar / pair_scalar_max - dirty pairs hashed one at a time, and
#       the largest such batch (it stays below the pair threshold)
_STATS_KEYS = ("pairs_batched", "pairs_hashlib", "layer_calls",
               "layer_scalar", "pair_batch_calls", "pair_batch_pairs",
               "pair_scalar", "pair_scalar_max")
_stats = dict.fromkeys(_STATS_KEYS, 0)


def stats() -> dict:
    return dict(_stats)


def reset_stats() -> None:
    for k in _STATS_KEYS:
        _stats[k] = 0


def set_batch_thresholds(layer: Optional[int] = None,
                         pairs: Optional[int] = None) -> None:
    """Override the batching thresholds (tests force both the batched and
    the scalar code paths through this)."""
    global _BATCH_THRESHOLD, _PAIR_BATCH_MIN
    if layer is not None:
        _BATCH_THRESHOLD = layer
    if pairs is not None:
        _PAIR_BATCH_MIN = pairs


def batch_thresholds() -> tuple:
    return (_BATCH_THRESHOLD, _PAIR_BATCH_MIN)


def can_batch_pairs(n: int) -> bool:
    """True when a batched hasher will take ``n`` gathered pairs: one is
    installed and ``n`` reaches ``_BATCH_THRESHOLD`` (below it the gather
    would only feed a hashlib loop)."""
    return ((_batched_hasher is not None or _batched_hasher_np is not None)
            and n >= _BATCH_THRESHOLD)


def set_batched_hasher(fn) -> None:
    """Install a batched hasher: fn(data: bytes, n: int) -> bytes, ``n``
    concatenated 64-byte blocks in, ``n`` 32-byte digests out (None
    uninstalls)."""
    global _batched_hasher
    _batched_hasher = fn


def set_batched_hasher_np(fn) -> None:
    """Install the array variant: fn(rows: (n, 64) uint8) -> (n, 32) uint8
    (None uninstalls)."""
    global _batched_hasher_np
    _batched_hasher_np = fn


def hash_layer(data: bytes) -> bytes:
    """Hash a full tree layer: data is n*64 bytes -> n*32 bytes."""
    n = len(data) // 64
    if _batched_hasher is not None and n >= _BATCH_THRESHOLD:
        _stats["layer_calls"] += 1
        _stats["pairs_batched"] += n
        return _batched_hasher(data, n)
    _stats["layer_scalar"] += n
    _stats["pairs_hashlib"] += n
    out = bytearray(n * 32)
    for i in range(n):
        out[i * 32:(i + 1) * 32] = sha256(data[i * 64:(i + 1) * 64]).digest()
    return bytes(out)


def hash_rows(rows: np.ndarray) -> np.ndarray:
    """Hash an ``(m, 64)`` uint8 array of parent inputs into ``(m, 32)``
    digests in one batched dispatch: the entry point for gathered
    dirty-pair buffers, forest flushes and columnar container roots."""
    m = rows.shape[0]
    if _batched_hasher_np is not None and m >= _BATCH_THRESHOLD:
        _stats["pair_batch_calls"] += 1
        _stats["pair_batch_pairs"] += m
        _stats["layer_calls"] += 1
        _stats["pairs_batched"] += m
        return _batched_hasher_np(np.ascontiguousarray(rows))
    before = _stats["layer_scalar"]
    digests = hash_layer(rows.tobytes())
    scalar = _stats["layer_scalar"] - before
    if scalar:
        _stats["pair_scalar"] += scalar
        _stats["pair_scalar_max"] = max(_stats["pair_scalar_max"], scalar)
    else:
        _stats["pair_batch_calls"] += 1
        _stats["pair_batch_pairs"] += m
    return np.frombuffer(digests, dtype=np.uint8).reshape(m, 32)


def next_power_of_two(v: int) -> int:
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def ceil_log2(v: int) -> int:
    return (v - 1).bit_length() if v > 1 else 0


def _padded_layer(layer, level: int) -> bytes:
    """A layer as bytes, zero-subtree-padded to an even chunk count."""
    if (len(layer) // 32) % 2 == 1:
        return bytes(layer) + zero_hashes[level]
    return layer if type(layer) is bytes else bytes(layer)


def merkleize_chunks(chunks: Sequence[bytes], limit: Optional[int] = None) -> bytes:
    """Merkleize 32-byte chunks, padding (virtually) to ``limit`` chunks.

    ``limit=None`` pads to the next power of two of ``len(chunks)``; a
    limit below the chunk count is an error.  Virtual zero-padding uses
    ``zero_hashes``, so a 2^40-chunk limit costs 40 extra hashes.
    """
    count = len(chunks)
    if limit is None:
        limit = next_power_of_two(count)
    else:
        if count > limit:
            raise ValueError(f"chunk count {count} exceeds limit {limit}")
        limit = next_power_of_two(limit)
    depth = ceil_log2(limit)

    if count == 0:
        return zero_hashes[depth]

    layer = b"".join(chunks)
    for level in range(depth):
        layer = hash_layer(_padded_layer(layer, level))
    return layer


class IncrementalTree:
    """Cached Merkle tree over a growable chunk list, virtually padded to
    ``limit`` chunks with zero subtrees.

    A mutation at chunk ``i`` re-hashes only the ``depth`` nodes on its
    root path.  Levels store only the occupied prefix; everything to the
    right is a ``zero_hashes`` entry.  Bulk construction goes through
    :func:`hash_layer`; incremental updates gather each level's dirty
    sibling pairs into one batched dispatch from ``_PAIR_BATCH_MIN``
    pairs up, and hash a handful of pairs with hashlib.
    """

    __slots__ = ("depth", "levels")

    def __init__(self, chunks, limit: int):
        """``chunks``: a sequence of 32-byte chunks, or a packed bytes-like
        leaf buffer (whole chunks; the zero-copy bulk path)."""
        self.depth = ceil_log2(next_power_of_two(limit))
        self._build(chunks)

    def _build(self, chunks) -> None:
        if isinstance(chunks, (bytes, bytearray, memoryview)):
            data = chunks
            if len(data) % 32 != 0:   # right-pad a packed buffer to chunks
                data = bytes(data) + b"\x00" * (32 - len(data) % 32)
        else:
            data = b"".join(chunks)
        levels = [bytearray(data)]
        for level in range(self.depth):
            levels.append(bytearray(hash_layer(_padded_layer(
                levels[-1], level))))
        self.levels = levels

    @property
    def count(self) -> int:
        return len(self.levels[0]) // 32

    def root(self) -> bytes:
        if self.count == 0:
            return zero_hashes[self.depth]
        return bytes(self.levels[self.depth][:32])

    # -- incremental dirty-pair engine ----------------------------------

    def apply_leaves(self, updates: dict) -> list:
        """Write ``{chunk_index: chunk_bytes}`` into the leaf layer (indices
        may extend the occupied prefix; gaps zero-fill) and return the
        sorted dirty parent indices for :meth:`rehash_up`."""
        if not updates:
            return []
        level0 = self.levels[0]
        hi = max(updates)
        if hi >= (1 << self.depth):
            raise ValueError("chunk index beyond tree limit")
        if (hi + 1) * 32 > len(level0):
            level0.extend(ZERO_CHUNK * (hi + 1 - len(level0) // 32))
        for i, chunk in updates.items():
            level0[i * 32:(i + 1) * 32] = chunk
        return sorted({i >> 1 for i in updates})

    def level_parents(self, level: int, parents: list) -> list:
        """The prefix of (sorted) ``parents`` whose children are at least
        partly occupied at ``level``, with the parent layer grown to
        cover them."""
        occ = len(self.levels[level]) // 32
        if occ == 0:
            return []
        ps = parents[:bisect_right(parents, (occ - 1) // 2)]
        if ps:
            parent = self.levels[level + 1]
            if (ps[-1] + 1) * 32 > len(parent):
                parent.extend(zero_hashes[level + 1]
                              * (ps[-1] + 1 - len(parent) // 32))
        return ps

    def gather_pairs(self, level: int, ps: list) -> np.ndarray:
        """The sibling pairs under parents ``ps`` as one contiguous
        ``(n, 64)`` buffer (virtual right siblings read the level's
        zero-subtree hash)."""
        cur = self.levels[level]
        occ = len(cur) // 32
        arr = np.frombuffer(cur, dtype=np.uint8).reshape(-1, 32)
        idx = np.asarray(ps, dtype=np.int64)
        buf = np.empty((len(ps), 64), dtype=np.uint8)
        buf[:, :32] = arr[2 * idx]
        ri = 2 * idx + 1
        real = ri < occ
        buf[real, 32:] = arr[ri[real]]
        if not real.all():
            buf[~real, 32:] = np.frombuffer(zero_hashes[level],
                                            dtype=np.uint8)
        return buf

    def scatter_level(self, level: int, ps: list, digests) -> list:
        """Write ``digests`` ((n, 32) uint8) into the parent layer at
        ``ps`` and return the sorted grandparent set."""
        parent = self.levels[level + 1]
        out = np.frombuffer(parent, dtype=np.uint8).reshape(-1, 32)
        out[np.asarray(ps, dtype=np.int64)] = digests
        nxt, last = [], -1
        for p in ps:
            g = p >> 1
            if g != last:
                nxt.append(g)
                last = g
        return nxt

    def _rehash_level(self, level: int, ps: list) -> list:
        """Re-hash the parent nodes ``ps`` at one level: one batched
        dispatch from the pair threshold up, per-pair hashlib below it."""
        n = len(ps)
        if n >= _PAIR_BATCH_MIN and can_batch_pairs(n):
            digests = hash_rows(self.gather_pairs(level, ps))
            return self.scatter_level(level, ps, digests)
        _stats["pair_scalar"] += n
        _stats["pair_scalar_max"] = max(_stats["pair_scalar_max"], n)
        _stats["pairs_hashlib"] += n
        cur, parent = self.levels[level], self.levels[level + 1]
        occ = len(cur) // 32
        nxt, last = [], -1
        for p in ps:
            li, ri = 2 * p, 2 * p + 1
            left = bytes(cur[li * 32:(li + 1) * 32])
            right = bytes(cur[ri * 32:(ri + 1) * 32]) \
                if ri < occ else zero_hashes[level]
            parent[p * 32:(p + 1) * 32] = sha256(left + right).digest()
            g = p >> 1
            if g != last:
                nxt.append(g)
                last = g
        return nxt

    def rehash_up(self, parents: list) -> None:
        """Propagate dirty parent indices to the root, one level-batched
        re-hash per level."""
        for level in range(self.depth):
            parents = self.level_parents(level, parents)
            if not parents:
                return
            parents = self._rehash_level(level, parents)

    def truncate(self, count: int) -> None:
        """Shrink the occupied prefix to ``count`` chunks (pop support) and
        re-hash the right edge."""
        old = self.count
        if count >= old:
            return
        self.levels[0] = self.levels[0][:count * 32]
        for level in range(self.depth):
            cur = self.levels[level]
            n_parent = (len(cur) // 32 + 1) // 2
            self.levels[level + 1] = self.levels[level + 1][:n_parent * 32]
            if n_parent == 0:
                continue
            self._rehash_level(level, [n_parent - 1])

    def set_leaves(self, data) -> None:
        """Replace the whole leaf layer with a packed byte buffer (right-
        padded to whole chunks) and rebuild the upper levels through
        :func:`hash_layer`: the chunk-level commit of a column write."""
        if (len(data) + 31) // 32 > (1 << self.depth):
            raise ValueError("chunk count beyond tree limit")
        self._build(data)

    def copy(self) -> "IncrementalTree":
        new = object.__new__(IncrementalTree)
        new.depth = self.depth
        new.levels = [bytearray(l) for l in self.levels]
        return new


def mix_in_length(root: bytes, length: int) -> bytes:
    return sha256(root + length.to_bytes(32, "little")).digest()


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return sha256(root + selector.to_bytes(32, "little")).digest()


def pack_bytes_into_chunks(data: bytes) -> List[bytes]:
    """Right-pad ``data`` with zeros to a multiple of 32 and split."""
    if len(data) % 32 != 0:
        data = data + b"\x00" * (32 - len(data) % 32)
    return [data[i:i + 32] for i in range(0, len(data), 32)] or []
