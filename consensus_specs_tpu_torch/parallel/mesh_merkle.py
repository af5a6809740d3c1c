"""Span merkleization on the card: kernel K18 ``merkle_levels`` with its
plain version, and :func:`build_levels` behind ``IncrementalTree``.

Counterpart of ``consensus_specs_tpu/parallel/mesh_merkle.py``.  A full
tree build (a cold root of the validators, balances, inactivity scores,
participation or randao mixes; a column commit's ``set_leaves``) hashes
every level.  The merkle engine alone launches K5 once per level and
reads each level back before it builds the next.  Here the leaf layer,
zero-padded to ``next_power_of_two(count)`` chunks, is split into ``S``
equal power-of-two spans (``mesh_state``; one card: ``S`` = 1), and K18
hashes every level of each span's subtree on the card: the JAX
``_program`` (:62), ``local_depth`` levels of ``ops/sha256.py:54``
``_compress`` twice per pair.  All levels land in one card buffer and
come back in one copy into pinned memory; the host then combines the
top ``log2(S)`` levels and the virtual-zero tail up to the tree's depth
as the sequential build does (``_padded_layer``).

Byte identity: zero chunks hash to ``zero_hashes``, so the padded spans
compute the values the sequential build reads from its table, and each
level is cut back to its occupied prefix (``ceil(count / 2^i)`` nodes),
so ``IncrementalTree.levels`` equals the sequential build's and every
later incremental update sees the same tree.

K18 (``csrc/mesh_merkle.cu``): one launch a tree, in tiers.  A CTA of T
threads folds up to 2T nodes, each level written once, and the last of
each group of sibling CTAs to finish goes on up with their nodes, to
each span's root (:func:`tiers`; the CTA size and the first tier's
depth by tree size: :func:`launch_plan`).  Bound: 32-bit integer
operations (``sha256.hash64_int_ops`` per node), and the chain of a
span's depth in dependent hashes (:func:`merkle_levels_chain`).

The span build runs where the merkle engine's batched hasher runs
(``merkle.batched_hasher_device``): with no batched hasher installed
every level stays on hashlib.  ``build_levels`` declines (None: the
caller builds sequentially) when the engine is off, the tree is below
the ``CS_TPU_MESH_MERKLE_MIN`` floor, or ``count`` is below ``2 * S``.
Not carried: the supervisor, fault sites, audits and metrics.
"""
import threading

import numpy as np
import torch

from .. import _build
from ..ops import sha256
from ..utils.ssz import merkle
from . import mesh_state

LOG_KEEP = 5                    # from BULK_LEAVES on, a first-tier CTA keeps 2^5 nodes
MAX_THREADS = 512               # csrc/mesh_merkle.cu MERKLE_MAX_THREADS


def _local_depth(n: int, spans: int) -> int:
    if spans < 1 or spans & (spans - 1) or n & (n - 1) or n < 2 * spans:
        raise ValueError(f"merkle_levels: {n} leaves in {spans} spans (powers of two, "
                         f"at least two leaves a span)")
    return (n // spans).bit_length() - 1


@torch.inference_mode()
def merkle_levels_plain(leaves, spans: int = 1):
    """Plain K18: every level of each span's subtree, one ``hash64_plain``
    per level."""
    depth = _local_depth(leaves.shape[0], spans)
    cur, out = leaves, []
    for _ in range(depth):
        cur = sha256.hash64_plain(cur.reshape(-1, 64))
        out.append(cur)
    return torch.cat(out)


def tiers(depth: int, threads: int, first: int) -> list:
    """K18's schedule for spans of ``depth`` levels and CTAs of ``threads``
    (a power of two): one ``(input level, levels folded, input nodes of
    a CTA)`` a tier.  A CTA's whole subtree is 2 x ``threads`` nodes, k =
    log2(2 x ``threads``) levels.  The first tier folds ``first`` levels
    (1 to k; :func:`launch_plan` picks it), each later tier whole
    subtrees of up to k levels, its CTA the last of its siblings to
    finish, the last one ending at each span's root."""
    k = (2 * threads).bit_length() - 1
    if depth <= k:
        return [(0, depth, 1 << depth)]
    if not 1 <= first <= k:
        raise ValueError(f"merkle_levels: a first tier of {first} levels (1 to {k})")
    out, s = [(0, first, 1 << k)], first
    while s < depth:
        fold = min(k, depth - s)
        out.append((s, fold, 1 << fold))
        s += fold
    return out


def pack_plan(plan: list) -> int:
    """``tiers`` as the kernel's 64-bit plan: a byte a tier, the levels
    folded in its low 4 bits, log2 of a CTA's input nodes in the high 4."""
    if len(plan) > 8:
        raise ValueError(f"merkle_levels: {len(plan)} tiers (at most 8)")
    return sum((fold | (width.bit_length() - 1) << 4) << (8 * r)
               for r, (_, fold, width) in enumerate(plan))


def tier_counters(n: int, plan: list) -> int:
    """Arrival counters of a launch over ``n`` leaves: one per CTA of every
    tier after the first."""
    return sum((n >> s) // width for s, _, width in plan[1:])


BULK_LEAVES = 1 << 19            # from here on the bulk of the hashing binds, not the top


def launch_plan(n: int, depth: int) -> tuple:
    """``(threads, tiers)`` of a launch over ``n`` leaves in spans of
    ``depth`` levels, as measured on the H100 (``chip_smoke.py --probe``):
    below ``BULK_LEAVES`` the chain of the top levels binds, so a CTA of
    128 threads (up to 2^14 leaves: a CTA for each SM) or 256 folds its
    whole subtree and one more tier the rest; from ``BULK_LEAVES`` on the
    first tier's CTAs of 512 threads keep a warp's width of nodes, so the
    narrow levels of their subtrees go to the few CTAs of the later
    tiers."""
    threads = 128 if n <= 1 << 14 else 256 if n < BULK_LEAVES else MAX_THREADS
    k = (2 * threads).bit_length() - 1
    return threads, tiers(depth, threads, k if n < BULK_LEAVES else k - LOG_KEEP)


def merkle_levels(leaves, spans: int = 1):
    """K18.  ``leaves``: uint8 (N, 32) chunks, N a power of two (at most
    2^30 on the card) and at least ``2 * spans``, ``spans`` a power of
    two.  Returns uint8 (N - spans, 32): levels 1 to ``log2(N / spans)``
    of every span's subtree, level by level (level i holds N >> i nodes,
    the spans' nodes in span order).  One launch."""
    dev = _build.same_device(leaves)
    n = leaves.shape[0]
    _build.check(leaves, "leaves", torch.uint8, (n, 32))
    depth = _local_depth(n, spans)
    if dev.type == "cpu":
        return merkle_levels_plain(leaves, spans)
    return _launch(leaves, *launch_plan(n, depth))


def _launch(leaves, threads: int, plan: list):
    """One K18 launch with CTAs of ``threads`` following ``plan``
    (``tiers``)."""
    if leaves.data_ptr() % 16:
        raise ValueError("leaves: the kernel loads 16-byte words; the data must start on a "
                         "16-byte boundary")
    n = leaves.shape[0]
    depth = sum(fold for _, fold, _ in plan)
    spans = n >> depth
    out = torch.empty((n - spans, 32), dtype=torch.uint8, device=leaves.device)
    arrived = _counters(leaves.device, tier_counters(n, plan))
    _build.launch("merkle_levels", leaves, out, arrived, n, depth, threads, pack_plan(plan))
    return out


_arrival = {}


def _counters(dev, n: int) -> torch.Tensor:
    """Zeroed arrival counters for a launch: one buffer per device and
    stream, zeroed once when made or grown and kept, since every launch
    leaves them zero (each group's last CTA resets its own)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _arrival.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=dev)
        _arrival[key] = buf
    return buf


def merkle_levels_chain(n: int, spans: int = 1) -> int:
    """K18's chain floor: a span's depth in dependent hashes (each level's
    node waits for its two children)."""
    return _local_depth(n, spans)


def merkle_levels_hashes(count: int, spans: int, full_width: int) -> int:
    """Nodes of the occupied prefix that K18's levels hold for a leaf
    layer of ``count`` chunks padded to ``full_width``: what the result
    needs (the zero-padded remainder is the ``zero_hashes`` table)."""
    hashes, occ = 0, count
    for _ in range(_local_depth(full_width, spans)):
        occ = (occ + 1) // 2
        hashes += occ
    return hashes


def merkle_levels_ops(count: int, spans: int, full_width: int) -> int:
    return sha256.hash64_int_ops(merkle_levels_hashes(count, spans, full_width))


def merkle_levels_bytes(count: int, spans: int, full_width: int) -> int:
    """The leaves read once and the occupied nodes written once."""
    return 32 * (count + merkle_levels_hashes(count, spans, full_width))


# ---------------------------------------------------------------------------
# build_levels
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_pinned = {}


def _staging(key: str, nbytes: int) -> torch.Tensor:
    """A pinned host buffer of at least ``nbytes``, grown and kept."""
    buf = _pinned.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8, pin_memory=True)
        _pinned[key] = buf
    return buf[:nbytes]


def _span_build(data, count: int, full_width: int, spans: int, dev) -> np.ndarray:
    """K18 over the zero-padded leaves; all levels as one host array."""
    if dev.type == "cpu":
        leaves = torch.zeros((full_width, 32), dtype=torch.uint8)
        leaves.view(-1)[:count * 32] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        return merkle_levels(leaves, spans).numpy().reshape(-1)
    with _lock:
        host = _staging("leaves", full_width * 32)
        arr = host.numpy()
        arr[:count * 32] = np.frombuffer(data, dtype=np.uint8, count=count * 32)
        arr[count * 32:] = 0
        out = merkle_levels(host.to(dev, non_blocking=True).view(full_width, 32), spans)
        back = _staging("levels", out.numel())
        back.copy_(out.view(-1), non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        return back.numpy().copy()


def build_levels(data, depth: int, spans: int = None):
    """All ``depth + 1`` levels of a whole-chunk leaf buffer, or None when
    the span build declines (module docstring); byte-identical to the
    sequential build.  ``spans``: the span count (None: ``n_shards``)."""
    count = len(data) // 32
    if count == 0 or not mesh_state.merkle_engaged(count):
        return None
    dev = merkle.batched_hasher_device()
    if dev is None:
        return None
    spans = mesh_state.n_shards() if spans is None else spans
    full_width = merkle.next_power_of_two(count)
    if full_width < 2 * spans or depth < merkle.ceil_log2(full_width):
        return None
    raw = _span_build(data, count, full_width, spans, dev)
    local_depth = merkle.ceil_log2(full_width // spans)
    # each level cut to its occupied prefix: the nodes right of it are
    # virtual (zero_hashes) in the sequential representation
    levels = [bytearray(data)]
    occ, nodes, off = count, full_width, 0
    for _ in range(local_depth):
        occ, nodes = (occ + 1) // 2, nodes // 2
        levels.append(bytearray(raw[off * 32:(off + occ) * 32]))
        off += nodes
    # the top log2(S) levels over the span roots and the virtual-zero
    # tail up to the tree's depth, as the sequential build does
    for level in range(local_depth, depth):
        levels.append(bytearray(merkle.hash_layer(merkle._padded_layer(levels[-1], level))))
    return levels
