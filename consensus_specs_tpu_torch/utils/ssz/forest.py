"""Hash-forest batch scope: cross-tree, level-aligned merkleization.

Counterpart of ``consensus_specs_tpu/utils/ssz/forest.py`` without its
telemetry series and environment switch (the scope is always on).

The incremental engine (:class:`.merkle.IncrementalTree`) batches the
dirty sibling pairs of ONE tree per level.  A beacon state is a forest:
validators, balances, roots vectors, ... all re-hash when a slot closes.
Inside a :func:`hash_forest` scope, a container root computation first
flushes every dirty subtree of the forest together - each level's dirty
pairs from ALL trees are gathered into one buffer and hashed in a single
batched dispatch - so the kernel sees ~tree-depth large calls per
state, not per field.

The module also carries the columnar container-root path
(:func:`bulk_element_root_bytes`): all N element roots of a
``List[Validator, ...]``-style sequence come from vectorized field
serialization plus batched layer hashes over an ``(N, fields, 32)``
chunk cube, instead of N per-object merkleizations.  A column provider
(:func:`set_column_provider`) may hand it committed uint64 columns: the
state column store registers ``peek_registry`` (``state/arrays.py``), so
a full build of a registry whose columns the store holds skips the
per-field walk of the typed views.
"""
from contextlib import contextmanager

import numpy as np

from . import merkle
from .types import BasicValue, ByteVectorBase, Container, _SequenceBase

# Element count from which a composite sequence's element roots are
# computed columnar instead of per-object.
_COLUMNAR_MIN = 256

_scope_depth = 0
_in_flush = False


def scope_active() -> bool:
    """True when a hash_forest scope is open (and not already flushing)."""
    return _scope_depth > 0 and not _in_flush


@contextmanager
def hash_forest():
    """Batch scope: while open, ``hash_tree_root`` on a container first
    flushes all its dirty subtrees level-aligned (one batched hash call
    per level across the whole forest).  Reentrant."""
    global _scope_depth
    _scope_depth += 1
    try:
        yield
    finally:
        _scope_depth -= 1


def flush_container(obj) -> None:
    """Bring every dirty sequence tree under ``obj`` up to date with one
    gathered hash dispatch per tree level."""
    global _in_flush
    if _in_flush:
        return
    _in_flush = True
    try:
        jobs = []
        _collect_jobs(obj, jobs)
        if jobs:
            _flush_jobs(jobs)
    finally:
        _in_flush = False


def _collect_jobs(container, jobs) -> None:
    """Walk the dirty-container spine gathering (tree, dirty-parents)
    jobs; containers with a warm root cache hide no dirty sequence."""
    for fname in type(container)._fields:
        v = object.__getattribute__(container, fname)
        if isinstance(v, Container):
            if object.__getattribute__(v, "_root_cache") is None:
                _collect_jobs(v, jobs)
        elif isinstance(v, _SequenceBase):
            job = v._apply_dirty_leaves()
            if job is not None:
                jobs.append(job)


def _flush_jobs(jobs) -> None:
    """Level-synchronous re-hash across trees: at each level, the dirty
    sibling pairs of every tree go into one buffer and one dispatch."""
    frontier = [(t, ps) for t, ps in jobs if ps]
    level = 0
    while frontier:
        live = []
        for t, ps in frontier:
            if level >= t.depth:
                continue
            ps = t.level_parents(level, ps)
            if ps:
                live.append((t, ps))
        if not live:
            return
        total = sum(len(ps) for _, ps in live)
        nxt = []
        if len(live) > 1 and total >= merkle._PAIR_BATCH_MIN \
                and merkle.can_batch_pairs(total):
            bufs = [t.gather_pairs(level, ps) for t, ps in live]
            digests = merkle.hash_rows(np.concatenate(bufs))
            off = 0
            for t, ps in live:
                n = len(ps)
                nxt.append((t, t.scatter_level(
                    level, ps, digests[off:off + n])))
                off += n
        else:
            for t, ps in live:
                nxt.append((t, t._rehash_level(level, ps)))
        frontier = nxt
        level += 1


# ---------------------------------------------------------------------------
# Columnar container roots
# ---------------------------------------------------------------------------

def _columnar_plan(ctype):
    """Per-field column strategy for a container type, cached on the
    class:  ``uint``   - BasicValue of at most 8 bytes, chunk from an
                         int column;
            ``bytes``  - ByteVector of at most 32, chunk is the value;
            ``hash64`` - ByteVector of at most 64, one batched hash each;
            ``root``   - anything else, per-object field root."""
    plan = ctype.__dict__.get("_columnar_plan")
    if plan is None:
        plan = []
        for fname, ftype in ctype._fields.items():
            if issubclass(ftype, BasicValue) and ftype.byte_length <= 8:
                plan.append((fname, "uint", ftype.byte_length))
            elif issubclass(ftype, ByteVectorBase) and ftype.length <= 32:
                plan.append((fname, "bytes", ftype.length))
            elif issubclass(ftype, ByteVectorBase) and ftype.length <= 64:
                plan.append((fname, "hash64", ftype.length))
            else:
                plan.append((fname, "root", 32))
        ctype._columnar_plan = plan
    return plan


def bulk_element_root_bytes(items, et, owner=None) -> bytes:
    """All element roots of a homogeneous composite sequence as one
    ``n*32`` byte buffer, or None when the columnar path does not apply
    (small n or an unsupported element type).  For containers, the
    per-container chunk trees of all ``n`` elements are reduced together:
    one ``(n * width/2, 64)`` batched hash per container level.
    ``owner`` (the sequence, on full builds) keys the column provider."""
    n = len(items)
    if n < _COLUMNAR_MIN or not isinstance(et, type):
        return None
    if issubclass(et, ByteVectorBase):
        size = et.length
        if size > 64:
            return None
        raw = np.frombuffer(b"".join(items), dtype=np.uint8)
        if size == 32:
            return raw.tobytes()
        if size < 32:
            out = np.zeros((n, 32), dtype=np.uint8)
            out[:, :size] = raw.reshape(n, size)
            return out.tobytes()
        buf = np.zeros((n, 64), dtype=np.uint8)
        buf[:, :size] = raw.reshape(n, size)
        return merkle.hash_rows(buf).tobytes()
    if issubclass(et, Container):
        return _container_root_bytes(items, et, owner)
    return None


def _container_root_bytes(items, et, owner) -> bytes:
    n = len(items)
    plan = _columnar_plan(et)
    width = merkle.next_power_of_two(max(len(plan), 1))
    cols = np.zeros((n, width, 32), dtype=np.uint8)
    provided = _column_provider(owner) \
        if owner is not None and _column_provider is not None else None
    if provided is not None \
            and any(c.shape[0] != n for c in provided.values()):
        provided = None     # shape desync: never trust a short column
    for j, (fname, kind, size) in enumerate(plan):
        if kind == "uint":
            vals = provided.get(fname) if provided is not None else None
            if vals is None:
                vals = np.fromiter((int(getattr(x, fname)) for x in items),
                                   dtype=np.uint64, count=n)
            # value < 2**(8*size), so bytes past `size` are zero anyway
            cols[:, j, :8] = np.ascontiguousarray(vals, dtype="<u8") \
                .view(np.uint8).reshape(n, 8)
        elif kind == "bytes":
            raw = b"".join(getattr(x, fname) for x in items)
            cols[:, j, :size] = np.frombuffer(
                raw, dtype=np.uint8).reshape(n, size)
        elif kind == "hash64":
            raw = b"".join(getattr(x, fname) for x in items)
            buf = np.zeros((n, 64), dtype=np.uint8)
            buf[:, :size] = np.frombuffer(raw, dtype=np.uint8).reshape(n, size)
            cols[:, j] = merkle.hash_rows(buf)
        else:
            raw = b"".join(getattr(x, fname).hash_tree_root() for x in items)
            cols[:, j] = np.frombuffer(raw, dtype=np.uint8).reshape(n, 32)
    while cols.shape[1] > 1:
        half = cols.shape[1] // 2
        cols = merkle.hash_rows(cols.reshape(n * half, 64)) \
            .reshape(n, half, 32)
    return cols.tobytes()


# Maps an owning sequence to its committed ``{ssz field name: uint64
# column}`` view, or None (registered by ``state/arrays.py``).
_column_provider = None


def set_column_provider(fn) -> None:
    global _column_provider
    _column_provider = fn
