"""Epoch reductions and scans on the card: kernels K15 ``epoch_reduce``,
K16 ``incl_scan`` and K17 ``registry_scan`` with their plain versions,
and the mesh engine's sub-transitions.

Counterpart of ``consensus_specs_tpu/parallel/mesh_epoch.py``.  The JAX
package runs the epoch engine's columnar bodies as ``shard_map``
programs over ``S`` validator spans; the port runs them on one card
(``mesh_state``: ``S`` = 1).  Its elementwise programs are K10-K14
(``ops/epoch_kernels.py``); the reduction and scan programs are here:

  K15 ``epoch_reduce``   ``_p_altair_sums`` (:151), ``_p_masked_sums``
                         (:179), ``_p_active_sums`` (:204): the
                         active-at-current balance and the per-flag (or
                         per-row) masked balances, exact uint64 sums
                         across spans; ``_p_shard_stats`` (:239): per-span
                         maxima of up to three columns.  It also writes
                         the byte columns K10, K12, K13 and K14 read
                         (eligible, active and unslashed, the slashings
                         target), so no mask built on the host crosses
  K16 ``incl_scan``      ``_p_incl_scan`` (:279): a scatter-min of
                         ``delay << 32 | ordinal`` keys per lane
  K17 ``registry_scan``  ``_p_registry_scan`` (:504): the queue, eject
                         and eligible families compacted ascending into
                         ``cap`` slots per span, their counts, the active
                         count

The CUDA side is ``csrc/mesh.cu``; bound: bytes (``*_bytes`` below).
Columns are int64 tensors holding uint64 bits.  ``FAR_FUTURE_EPOCH``
(2^64 - 1) and K16's sentinel are -1 as int64, so every comparison here
is unsigned: the kernels read uint64, and the plain versions flip the
sign bit (:func:`_flip`) before comparing.

Sub-transitions (``try_*``, carrying JAX ``mesh_epoch.py:657-1179``):
``ops/epoch_kernels.py``'s ``try_process_*`` offer each one here first.
A commit runs the same fused kernels as the columnar engine on the
store's card columns, with the masks, sums and guard maxima computed on
the card instead of in host numpy.  The guard set is the JAX engine's
(``_guard(n * max_eff)`` before any sum is used, and so on) beside the
port's own lane bounds.  A decline returns False and the columnar
engine serves the call: the engine is off, the registry is below the
floor, a guard trips, or a registry family outgrows its cap.  These are
size and guard rules; a kernel that fails raises.

Dispatch choices: ``S`` = 1, and K17's cap is :data:`SCAN_CAP`, None:
the span's lane count, not the JAX ``_SCAN_CAP`` of 256 (a mainnet epoch
that ejects thousands would always decline at 256; the results are the
same either way).  The dispatch asks K17 for no fill slots: only the
counted prefix of each buffer is written and crosses back.  At the
span's lane count no family can outgrow the cap, so the overflow
decline is reachable only at a smaller cap, such as the JAX one.  The
inclusion entries are not padded to a power of two: a launch takes any
length.

Not carried: the supervisor, fault sites, sentinel audits, the psum
census and the obs counters (:func:`stats` keeps plain counts).
"""
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..state import arrays as state_arrays
from ..utils.ssz import sequence_items
from . import mesh_state

_U64 = 1 << 64
_SIGN = -(1 << 63)                  # int64 with the top bit alone
INCL_SENTINEL = _U64 - 1            # K16: a lane no entry reaches
SCAN_TILE = 2048                    # K17 lanes per CTA (csrc/mesh.cu)
REDUCE_SCRATCH = 4096 * 7           # K15 partials: blocks x (4 sums, 3 maxima)
SCAN_CAP = None                     # K17's cap in the dispatch (None: the span's lanes)
MASKS = ("eligible", "active", "target")

_STATS = {"commits": 0, "off": 0, "floor": 0, "guard": 0, "overflow": 0}


def stats() -> dict:
    """``commits``: sub-transitions the mesh engine committed; declines:
    ``off`` (engine off), ``floor`` (registry below the floor), ``guard``
    (a guard tripped), ``overflow`` (a registry family outgrew its cap)."""
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def _ek():
    """The columnar engine (kernels, guards, the registry body), imported
    late: it dispatches into this module."""
    from ..ops import epoch_kernels
    return epoch_kernels


# ---------------------------------------------------------------------------
# Unsigned order on int64 bits (plain versions)
# ---------------------------------------------------------------------------

def _flip(t):
    """uint64 bits -> int64 whose signed order is the unsigned order."""
    return t ^ _SIGN


def _key(v: int) -> int:
    """A python uint64 in the flipped order of :func:`_flip`."""
    return v % _U64 - (1 << 63)


def bits64(v: int) -> int:
    """A python uint64 as the int64 holding its bits."""
    v %= _U64
    return v - _U64 if v >= 1 << 63 else v


def active_at_plain(act, ext, epoch: int):
    """``act <= epoch < ext``, unsigned."""
    return (_flip(act) <= _key(epoch)) & (_key(epoch) < _flip(ext))


def _sum_u64(col, mask) -> int:
    """Exact sum mod 2^64 of the masked lanes (32-bit halves, so no int64
    sum can overflow)."""
    sel = torch.where(mask, col, torch.zeros_like(col))
    lo = int((sel & 0xFFFFFFFF).sum())
    hi = int(((sel >> 32) & 0xFFFFFFFF).sum())
    return (lo + (hi << 32)) % _U64


# ---------------------------------------------------------------------------
# K15 epoch_reduce
# ---------------------------------------------------------------------------

class Reduced(NamedTuple):
    """K15's outputs (None where not asked for)."""
    sums: object        # (1 + k,) int64 bits: active balance at cur, then k sums
    maxes: object       # (len(max_cols), S) int64 bits: per-span maxima
    eligible: object    # (V,) bool: active at prev, or slashed with prev + 1 < wd
    active: object      # (V,) bool: active at prev and unslashed
    target: object      # (V,) bool: slashed with wd == tgt


def _lanes(reg, max_cols) -> int:
    for t in (reg or {}).values():
        return t.shape[0]
    return max_cols[0].shape[0]


@torch.inference_mode()
def epoch_reduce_plain(reg=None, *, max_cols=(), sums=False, part=None, n_flags=0,
                       rows=None, masks=(), prev=0, cur=0, tgt=0, spans=1) -> Reduced:
    """Plain K15 (see :func:`epoch_reduce`)."""
    n = _lanes(reg, max_cols)
    out_sums = out_max = None
    found = {}
    if sums or masks:
        act, ext = reg["act"], reg["ext"]
        active_prev = active_at_plain(act, ext, prev)
    if sums:
        eff = reg["eff"]
        vals = [_sum_u64(eff, active_at_plain(act, ext, cur))]
        if part is not None:
            unslashed = active_prev & ~reg["sl"]
            vals += [_sum_u64(eff, unslashed & ((part >> f) & 1).bool()) for f in range(n_flags)]
        elif rows is not None:
            vals += [_sum_u64(eff, r) for r in rows]
        out_sums = torch.tensor([bits64(v) for v in vals], dtype=torch.int64, device=eff.device)
    if max_cols:
        n_local = n // spans
        if n_local:
            out_max = torch.stack([_flip(_flip(c).reshape(spans, n_local).amax(dim=1))
                                   for c in max_cols])
        else:
            out_max = torch.zeros((len(max_cols), spans), dtype=torch.int64,
                                  device=max_cols[0].device)
    if "eligible" in masks:
        found["eligible"] = active_prev | (reg["sl"] & (_key(prev + 1) < _flip(reg["wd"])))
    if "active" in masks:
        found["active"] = active_prev & ~reg["sl"]
    if "target" in masks:
        found["target"] = reg["sl"] & (reg["wd"] == bits64(tgt))
    return Reduced(out_sums, out_max, found.get("eligible"), found.get("active"),
                   found.get("target"))


def epoch_reduce(reg=None, *, max_cols=(), sums=False, part=None, n_flags=0, rows=None,
                 masks=(), prev=0, cur=0, tgt=0, spans=1) -> Reduced:
    """K15.  ``reg``: {"eff", "act", "ext", "wd": (V,) int64 holding uint64
    bits, "sl": (V,) bool} (the columns the asked outputs need), V a
    multiple of ``spans``.  ``sums``: the effective balance of the lanes
    active at ``cur``, then either ``n_flags`` flag sums (``part``: (V,)
    uint8 flags; lanes active at ``prev``, unslashed, with the flag) or one
    sum per row of ``rows`` ((k, V) bool).  ``max_cols``: up to three (V,)
    int64 columns, their unsigned maxima per span.  ``masks``: any of
    :data:`MASKS`.  CUDA: one launch, compiled for each of the epoch
    engine's five calls (``K15_MODES`` in csrc/mesh.cu); any other
    combination raises.  The blocks' partials go to a scratch buffer of
    :data:`REDUCE_SCRATCH` int64 words.  Bound: bytes
    (:func:`epoch_reduce_bytes`)."""
    n = _lanes(reg, max_cols)
    k = n_flags if part is not None else (rows.shape[0] if rows is not None else 0)
    if spans < 1 or n % spans or len(max_cols) > 3 or k > 3 or not set(masks) <= set(MASKS):
        raise ValueError(f"epoch_reduce: V={n} spans={spans} max_cols={len(max_cols)} "
                         f"k={k} masks={masks}")
    args = [t for t in (reg or {}).values()] + list(max_cols) \
        + [t for t in (part, rows) if t is not None]
    dev = _build.same_device(*args)
    for name, t in (reg or {}).items():
        _build.check(t, name, torch.bool if name == "sl" else torch.int64, (n,))
    for t in max_cols:
        _build.check(t, "max_cols", torch.int64, (n,))
    if part is not None:
        _build.check(part, "part", torch.uint8, (n,))
    if rows is not None:
        _build.check(rows, "rows", torch.bool, (k, n))
    if dev.type == "cpu":
        return epoch_reduce_plain(reg, max_cols=max_cols, sums=sums, part=part, n_flags=n_flags,
                                  rows=rows, masks=masks, prev=prev, cur=cur, tgt=tgt,
                                  spans=spans)
    reg = reg or {}
    out_sums = torch.empty(1 + k, dtype=torch.int64, device=dev) if sums else None
    out_max = torch.empty((len(max_cols), spans), dtype=torch.int64, device=dev) \
        if max_cols else None
    found = {m: torch.empty(n, dtype=torch.bool, device=dev) for m in masks}
    scratch = torch.empty(REDUCE_SCRATCH, dtype=torch.int64, device=dev)
    cols = list(max_cols) + [None] * (3 - len(max_cols))
    _build.launch("epoch_reduce", reg.get("eff"), reg.get("act"), reg.get("ext"), reg.get("wd"),
                  reg.get("sl"), part, rows, *cols, out_sums, out_max, found.get("eligible"),
                  found.get("active"), found.get("target"), scratch, REDUCE_SCRATCH,
                  n // spans, spans, k if sums else 0, int(part is not None), len(max_cols),
                  prev % _U64, cur % _U64, tgt % _U64)
    return Reduced(out_sums, out_max, found.get("eligible"), found.get("active"),
                   found.get("target"))


def epoch_reduce_bytes(n: int, *, sums=False, flags=False, k=0, max_cols=(), masks=()) -> int:
    """Bytes K15's function must move for V = ``n`` lanes: each input
    column read once (eff, act, ext 8 B each for the sums; sl and the
    flags, or k mask rows, 1 B each; wd 8 B for the eligible or target
    mask; 8 B per max column) and each byte mask written once.
    ``max_cols``: the max columns' names; one that is also a registry
    input (the rewards' ``eff``) is read once, not twice."""
    u64 = set()
    small = 0
    if sums:
        u64 |= {"eff", "act", "ext"}
        small += 2 if flags else k
    if masks:
        u64 |= {"act", "ext"}
        small += 0 if sums and flags else 1           # sl
    if {"eligible", "target"} & set(masks):
        u64.add("wd")
    u64 |= set(max_cols)
    return n * (8 * len(u64) + small + len(masks))


def epoch_reduce_names(reg, max_cols) -> tuple:
    """Names for :func:`epoch_reduce_bytes`: a max column that is one of
    ``reg``'s tensors takes its key, any other a name of its own."""
    reg = reg or {}
    return tuple(next((k for k, v in reg.items() if v is c), f"max{i}")
                 for i, c in enumerate(max_cols))


def epoch_reduce_ops(n: int, *, sums=False, k=0, n_max=0, masks=()) -> int:
    """64-bit operations, one each: per lane for the sums the two
    compares and the add of the active balance and a test and an add per
    sum, a compare per max column, two compares per mask."""
    return n * ((3 + 2 * k if sums else 0) + n_max + 2 * len(masks))


# ---------------------------------------------------------------------------
# K16 incl_scan
# ---------------------------------------------------------------------------

@torch.inference_mode()
def incl_scan_plain(idx, keys, n: int, spans: int = 1):
    """Plain K16: the unsigned minimum key per lane, the sentinel where
    no entry lands; entries off ``[0, n)`` (pad entries are -1) dropped."""
    base = torch.full((n,), _key(INCL_SENTINEL), dtype=torch.int64, device=idx.device)
    ok = (idx >= 0) & (idx < n)
    base.scatter_reduce_(0, idx[ok], _flip(keys[ok]), "amin", include_self=True)
    return _flip(base)


def incl_scan(idx, keys, n: int, spans: int = 1):
    """K16.  ``idx``: (m,) int64 lane indices (-1: a pad entry); ``keys``:
    (m,) int64 holding uint64 keys ``delay << 32 | ordinal``; ``n``: lanes,
    a multiple of ``spans``.  Returns (n,) int64: each lane's least key,
    ``2^64 - 1`` (-1) where no entry lands.  The spec's ordered strict-<
    update keeps the first attestation at the least delay; the least key
    is that one.  CUDA: one cooperative launch, the sentinel fill, a
    grid-wide barrier, then one atomic minimum per entry; a launch the card
    refuses raises.  Bound: bytes (:func:`incl_scan_bytes`)."""
    dev = _build.same_device(idx, keys)
    m = idx.shape[0]
    _build.check(idx, "idx", torch.int64, (m,))
    _build.check(keys, "keys", torch.int64, (m,))
    if spans < 1 or n % spans:
        raise ValueError(f"incl_scan: n={n} spans={spans}")
    if dev.type == "cpu":
        return incl_scan_plain(idx, keys, n, spans)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _build.launch("incl_scan", idx, keys, m, out, n // spans, spans)
    return out


def incl_scan_bytes(m: int, n: int) -> int:
    """16 B per entry read, 8 B per lane written."""
    return 16 * m + 8 * n


def incl_scan_ops(m: int, n: int) -> int:
    """A range test and a compare-and-min per entry, a store per lane."""
    return 2 * m + n


# ---------------------------------------------------------------------------
# K17 registry_scan
# ---------------------------------------------------------------------------

class Scan(NamedTuple):
    """K17's outputs: three (S * cap,) int64 index buffers, the (3, S)
    true counts and the (1,) active count.  Without fill only each span's
    counted prefix of a buffer is defined (:func:`scan_defined`)."""
    queue: torch.Tensor
    eject: torch.Tensor
    eligible: torch.Tensor
    counts: torch.Tensor
    active: torch.Tensor


def registry_families_plain(aee, act, ext, eff, *, cur, finalized, far, max_eb, ejection):
    """The three candidate masks and the active-at-current mask."""
    active = active_at_plain(act, ext, cur)
    queue = (aee == bits64(far)) & (eff == bits64(max_eb))
    eject = active & (_flip(eff) <= _key(ejection))
    eligible = (_flip(aee) <= _key(finalized)) & (act == bits64(far))
    return queue, eject, eligible, active


@torch.inference_mode()
def registry_scan_plain(aee, act, ext, eff, *, cur, finalized, far, max_eb, ejection, cap,
                        spans=1, fill=True) -> Scan:
    """Plain K17 (see :func:`registry_scan`); it always fills."""
    n = aee.shape[0]
    n_local = n // spans
    *fams, active = registry_families_plain(aee, act, ext, eff, cur=cur, finalized=finalized,
                                            far=far, max_eb=max_eb, ejection=ejection)
    bufs, counts = [], []
    for mask in fams:
        spans_buf, spans_count = [], []
        for s in range(spans):
            li = torch.nonzero(mask[s * n_local:(s + 1) * n_local]).flatten()[:cap]
            fill = torch.full((cap - li.numel(),), n_local, dtype=torch.int64, device=aee.device)
            spans_buf.append(s * n_local + torch.cat([li, fill]))
            spans_count.append(int(mask[s * n_local:(s + 1) * n_local].sum()))
        bufs.append(torch.cat(spans_buf))
        counts.append(spans_count)
    return Scan(*bufs, torch.tensor(counts, dtype=torch.int64, device=aee.device),
                active.sum(dtype=torch.int64).reshape(1))


def registry_scan(aee, act, ext, eff, *, cur, finalized, far, max_eb, ejection, cap,
                  spans=1, fill=True) -> Scan:
    """K17.  ``aee``, ``act``, ``ext``, ``eff``: (V,) int64 holding uint64
    bits, V a multiple of ``spans``.  Families per lane: activation queue
    (``aee == far`` and ``eff == max_eb``), ejection (active at ``cur``
    and ``eff <= ejection``), dequeue-eligible (``aee <= finalized`` and
    ``act == far``).  Each comes back as ``cap`` slots per span of global
    indices, ascending, with the (3, S) true counts and the active count.
    ``fill``: the slots past a span's count hold ``s * n_local + n_local``
    (the JAX program's output); else they are left unwritten.  Bound:
    bytes (:func:`registry_scan_bytes`)."""
    dev = _build.same_device(aee, act, ext, eff)
    n = aee.shape[0]
    for t, name in ((aee, "aee"), (act, "act"), (ext, "ext"), (eff, "eff")):
        _build.check(t, name, torch.int64, (n,))
    if spans < 1 or n % spans or cap < 1:
        raise ValueError(f"registry_scan: V={n} spans={spans} cap={cap}")
    kw = dict(cur=cur, finalized=finalized, far=far, max_eb=max_eb, ejection=ejection)
    if dev.type == "cpu":
        return registry_scan_plain(aee, act, ext, eff, cap=cap, spans=spans, fill=fill, **kw)
    n_local = n // spans
    tiles = max(1, -(-n_local // SCAN_TILE))
    bufs = torch.empty((3, spans * cap), dtype=torch.int64, device=dev)
    counts = torch.empty((3, spans), dtype=torch.int64, device=dev)
    active = torch.empty(1, dtype=torch.int64, device=dev)
    _build.launch("registry_scan", aee, act, ext, eff, n_local, spans, cur % _U64,
                  finalized % _U64, far % _U64, max_eb % _U64, ejection % _U64, cap, tiles,
                  int(fill), bufs, counts, active, _scan_state(dev, 2 + 3 * spans * tiles))
    return Scan(bufs[0], bufs[1], bufs[2], counts, active)


_SCAN_STATE = {}


def _scan_state(dev, n: int) -> torch.Tensor:
    """K17's look-back flags and tally: one buffer per device and stream,
    zeroed once when made or grown and kept, since every launch leaves it
    zero (its last CTA to finish zeroes it)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _SCAN_STATE.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 2 + 3 * 512),), dtype=torch.int64, device=dev)
        _SCAN_STATE[key] = buf
    return buf


def scan_defined(scan) -> tuple:
    """The defined part of K17's outputs, as host values: each family's
    counted prefix per span (at most ``cap`` slots), concatenated in span
    order (int64 arrays); the (3, S) counts; the active count.  Two
    copies from the card: the counts, then the prefixes."""
    queue, eject, eligible, counts, active = scan
    spans = counts.shape[1]
    cap = queue.shape[0] // spans
    vals = _read(counts, active)
    count = np.array(vals[:-1], dtype=np.int64).reshape(3, spans)
    taken = np.minimum(count, cap)
    host = torch.cat([b[s * cap:s * cap + int(c)] for b, row in zip((queue, eject, eligible), taken)
                      for s, c in enumerate(row)]).cpu().numpy()
    ends = np.cumsum([0] + [int(r.sum()) for r in taken])
    return tuple(host[ends[f]:ends[f + 1]] for f in range(3)) + (count, vals[-1])


def registry_scan_slots(counts, cap: int, fill: bool) -> int:
    """Index slots K17 writes: S x cap per family with ``fill``, else each
    span's counted prefix (``counts``: the (3, S) true counts)."""
    counts = np.asarray(counts, dtype=np.int64)
    return counts.size * cap if fill else int(np.minimum(counts, cap).sum())


def registry_scan_bytes(n: int, spans: int, slots: int) -> int:
    """Four columns read (32 B per lane), ``slots`` index slots written
    (:func:`registry_scan_slots`), and the counts."""
    return 32 * n + 8 * slots + 8 * (3 * spans + 1)


def registry_scan_ops(n: int, slots: int) -> int:
    """Per lane the family tests (eight 64-bit compares) and per written
    slot a store."""
    return 8 * n + slots


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _read(*ts) -> list:
    """Small int64 results as python uint64 ints, in one copy."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    return [v % _U64 for v in flat.tolist()]


def _results(red: Reduced) -> tuple:
    """K15's sums and each max column's maximum over the spans, as python
    uint64 ints, in one copy."""
    vals = _read(*(t for t in (red.sums, red.maxes) if t is not None))
    k = 0 if red.sums is None else red.sums.numel()
    spans = 1 if red.maxes is None else red.maxes.shape[1]
    rest = vals[k:]
    return vals[:k], [max(rest[i:i + spans]) for i in range(0, len(rest), spans)]


def _registry(sa, dev, *keys) -> dict:
    return {k: sa.registry_card(k, dev) for k in keys}


def _dispatch(spec, state, fast) -> bool:
    """Run one sub-transition on the mesh engine.  True: it committed
    (the columnar body must not run); False: declined, nothing written."""
    if not mesh_state.enabled():
        _STATS["off"] += 1
        return False
    sa = state_arrays.of(state)
    n = len(sa.registry())
    if n == 0 or not mesh_state.engaged(n):
        _STATS["floor"] += 1
        return False
    ek = _ek()
    try:
        handled = fast(spec, state, sa, ek.engine_device())
    except ek._Fallback:
        _STATS["guard"] += 1
        return False
    if handled:
        _STATS["commits"] += 1
    return handled


def try_rewards_and_penalties(spec, state) -> bool:
    def fast(spec, state, sa, dev):
        if "altair" in _ek()._fork_lineage(spec):
            return _altair_rewards(spec, state, sa, dev)
        return _phase0_rewards(spec, state, sa, dev)
    return _dispatch(spec, state, fast)


def _altair_rewards(spec, state, sa, dev) -> bool:
    ek = _ek()
    n = len(sa.registry())
    reg = _registry(sa, dev, "eff", "act", "ext", "wd", "sl")
    part = sa.participation_card("previous", dev)
    scores = sa.column_card("inactivity_scores", dev)
    bal = sa.balances_card(dev)
    prev_epoch = int(spec.get_previous_epoch(state))
    cur_epoch = int(spec.get_current_epoch(state))
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    weights = tuple(int(w) for w in spec.PARTICIPATION_FLAG_WEIGHTS)
    red = epoch_reduce(reg, max_cols=(reg["eff"], scores, bal), sums=True, part=part,
                       n_flags=len(weights), masks=("eligible", "active"), prev=prev_epoch,
                       cur=cur_epoch, spans=mesh_state.n_shards())
    sums, (max_eff, max_score, max_bal) = _results(red)
    # the guard set of the JAX engine (a sum is exact below n x max_eff),
    # then the port's lane bounds
    ek._guard(n * max_eff)
    total_balance = max(increment, sums[0])
    ek._guard(total_balance)
    active_increments = total_balance // increment
    in_leak = bool(spec.is_in_inactivity_leak(state))
    wden = int(spec.WEIGHT_DENOMINATOR)
    ek._guard(active_increments * wden)
    brpi = increment * int(spec.BASE_REWARD_FACTOR) // math.isqrt(total_balance)
    ek._guard((max_eff // increment) * brpi)
    br_max = (max_eff // increment) * brpi
    part_inc, bal_bound = [], max_bal
    for w, s in zip(weights, sums[1:]):
        ui = max(increment, s) // increment
        ek._guard(br_max * w * ui)
        part_inc.append(ui)
        reward = 0 if in_leak else br_max * w * ui // (active_increments * wden)
        ek._guard(bal_bound + reward)
        bal_bound += reward
    ek._guard(max_eff * max_score, max_bal + (len(weights) + 1) * br_max)
    quotient = ek.inactivity_penalty_quotient(spec)
    s = ek.AltairScalars(increment, brpi, weights, tuple(part_inc), active_increments, wden,
                         in_leak, int(spec.config.INACTIVITY_SCORE_BIAS) * quotient)
    new = ek.altair_deltas(reg["eff"], bal, scores, part, red.eligible, red.active, s)
    sa.set_balances_card(new, bal_bound)
    return True


def _phase0_rewards(spec, state, sa, dev) -> bool:
    ek = _ek()
    cols = sa.registry()
    n = len(cols)
    # spec helpers first: their assertions must fire as in the loop path
    prev = spec.get_previous_epoch(state)
    src_atts = spec.get_matching_source_attestations(state, prev)
    tgt_atts = spec.get_matching_target_attestations(state, prev)
    head_atts = spec.get_matching_head_attestations(state, prev)
    src_set = spec.get_unslashed_attesting_indices(state, src_atts)
    tgt_set = spec.get_unslashed_attesting_indices(state, tgt_atts)
    head_set = spec.get_unslashed_attesting_indices(state, head_atts)
    prev_epoch, cur_epoch = int(prev), int(spec.get_current_epoch(state))
    reg = _registry(sa, dev, "eff", "act", "ext", "wd", "sl")
    bal = sa.balances_card(dev)
    # the attester masks come from python sets: they cross once, and K15
    # and K10 both read them on the card
    att_host = np.stack([ek._mask_from_indices(n, s) for s in (src_set, tgt_set, head_set)])
    att = state_arrays.upload(att_host, dev, "masks")
    red = epoch_reduce(reg, max_cols=(reg["eff"], bal), sums=True, rows=att,
                       masks=("eligible",), prev=prev_epoch, cur=cur_epoch,
                       spans=mesh_state.n_shards())
    sums, (max_eff, max_bal) = _results(red)
    ek._guard(n * max_eff)
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    total_balance = max(increment, sums[0])
    ek._guard(total_balance)
    total_increments = total_balance // increment
    in_leak = bool(spec.is_in_inactivity_leak(state))
    sqrt_total = int(spec.integer_squareroot(total_balance))
    brf, brpe = int(spec.BASE_REWARD_FACTOR), int(spec.BASE_REWARDS_PER_EPOCH)
    prq = int(spec.PROPOSER_REWARD_QUOTIENT)
    ek._guard(max_eff * brf)
    br_max = max_eff * brf // sqrt_total // brpe
    att_increments, rew_bound = [], 0
    for s in sums[1:]:
        ai = max(increment, s) // increment
        ek._guard(br_max * ai)
        att_increments.append(ai)
        rew_bound += br_max if in_leak else br_max * ai // total_increments

    # inclusion delays: one key per (attestation, attester), delay << 32 |
    # ordinal, whose least value is the spec's first attestation at the
    # least delay; K16 takes the minimum per lane on the card
    flat_idx, flat_key, proposers = [], [], []
    for ordinal, a in enumerate(src_atts):
        proposers.append(int(a.proposer_index))
        idxs = spec.get_attesting_indices(state, a.data, a.aggregation_bits)
        if not idxs:
            continue
        ii = np.fromiter(idxs, dtype=np.int64, count=len(idxs))
        flat_idx.append(ii)
        flat_key.append(np.full(ii.size, (int(a.inclusion_delay) << 32) | ordinal,
                                dtype=np.uint64))
    src_idx = np.nonzero(att_host[0])[0]
    incl_rewards = np.zeros(n, dtype=np.uint64)
    incl_max = 0
    if src_idx.size:
        best = incl_scan(state_arrays.upload(np.concatenate(flat_idx), dev, "incl_idx"),
                         state_arrays.upload(np.concatenate(flat_key), dev, "incl_keys"), n,
                         mesh_state.n_shards())
        key_src = state_arrays.download(best, "incl_keys")[src_idx]
        delay_src = key_src >> np.uint64(32)
        prop_src = np.array(proposers, dtype=np.int64)[
            (key_src & np.uint64(0xFFFFFFFF)).astype(np.int64)]
        base_src = ek._base_reward_host(cols["eff"][src_idx], brf, sqrt_total, brpe)
        proposer_src = base_src // np.uint64(prq)
        incl_rewards[src_idx] = (base_src - proposer_src) // delay_src
        # every attester's proposer cut could land on ONE proposer index
        ek._guard(br_max + src_idx.size * (br_max // prq))
        np.add.at(incl_rewards, prop_src, proposer_src)
        incl_max = int(incl_rewards[np.union1d(src_idx, prop_src)].max(initial=0))
    rew_bound += incl_max

    finality_delay = int(spec.get_finality_delay(state))
    ipq = int(spec.INACTIVITY_PENALTY_QUOTIENT)
    leak_delay = finality_delay if in_leak else 0
    pen_bound = 3 * br_max
    if in_leak:
        ek._guard(brpe * br_max + max_eff * finality_delay)
        pen_bound += brpe * br_max + max_eff * finality_delay // ipq
    ek._guard(3 * br_max + incl_max + max_bal,
              3 * br_max + brpe * br_max + max_eff * leak_delay)
    ek._guard(rew_bound, pen_bound, max_bal + rew_bound)
    scalars = ek.Phase0Scalars(brf, sqrt_total, brpe, tuple(att_increments), total_increments,
                               in_leak, prq, finality_delay, ipq)
    new = ek.phase0_deltas(reg["eff"], state_arrays.upload(incl_rewards, dev, "incl_rewards"),
                           bal, red.eligible, att, scalars)
    sa.set_balances_card(new, max_bal + rew_bound)
    return True


def try_inactivity_updates(spec, state) -> bool:
    def fast(spec, state, sa, dev):
        ek = _ek()
        reg = _registry(sa, dev, "act", "ext", "wd", "sl")
        scores = sa.column_card("inactivity_scores", dev)
        red = epoch_reduce(reg, max_cols=(scores,), masks=("eligible", "active"),
                           prev=int(spec.get_previous_epoch(state)),
                           spans=mesh_state.n_shards())
        _, (max_score,) = _results(red)
        bias = int(spec.config.INACTIVITY_SCORE_BIAS)
        ek._guard(max_score + bias)
        new = ek.inactivity_updates(
            scores, sa.participation_card("previous", dev), red.eligible, red.active, bias,
            int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE),
            bool(spec.is_in_inactivity_leak(state)))
        sa.set_column_card("inactivity_scores", new, max_score + bias)
        return True
    return _dispatch(spec, state, fast)


def try_slashings(spec, state, multiplier: int) -> bool:
    def fast(spec, state, sa, dev):
        ek = _ek()
        n = len(sa.registry())
        epoch = int(spec.get_current_epoch(state))
        target_epoch = epoch + int(spec.EPOCHS_PER_SLASHINGS_VECTOR) // 2
        ek._guard(target_epoch)
        reg = _registry(sa, dev, "eff", "act", "ext", "wd", "sl")
        red = epoch_reduce(reg, max_cols=(reg["eff"],), sums=True, masks=("target",),
                           cur=epoch, tgt=target_epoch, spans=mesh_state.n_shards())
        (total,), (max_eff,) = _results(red)
        ek._guard(n * max_eff)
        increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
        total_balance = max(increment, total)
        ek._guard(total_balance)
        slashed_sum = sum(int(s) for s in sequence_items(state.slashings))
        adjusted = min(slashed_sum * multiplier, total_balance)
        ek._guard((max_eff // increment) * adjusted)
        bound = sa.balances_bound()     # a decrease keeps the bound
        new = ek.slashings(reg["eff"], sa.balances_card(dev), red.target, increment, adjusted,
                           total_balance)
        sa.set_balances_card(new, bound)
        return True
    return _dispatch(spec, state, fast)


def try_effective_balance_updates(spec, state) -> bool:
    def fast(spec, state, sa, dev):
        ek = _ek()
        increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
        hysteresis_increment = increment // int(spec.HYSTERESIS_QUOTIENT)
        down = hysteresis_increment * int(spec.HYSTERESIS_DOWNWARD_MULTIPLIER)
        up = hysteresis_increment * int(spec.HYSTERESIS_UPWARD_MULTIPLIER)
        bal, eff_c = sa.balances_card(dev), sa.registry_card("eff", dev)
        red = epoch_reduce(max_cols=(bal, eff_c), spans=mesh_state.n_shards())
        _, (max_bal, max_eff) = _results(red)
        ek._guard(max_bal + down, max_eff + up)
        new_c = ek.effective_balance(bal, eff_c, increment, down, up,
                                     int(spec.MAX_EFFECTIVE_BALANCE))
        new_eff = state_arrays.download(new_c, "eff")
        # the commit diff is the SSZ write-back boundary, as in the
        # columnar engine
        changed = np.nonzero(sa.registry()["eff"] != new_eff)[0]
        if changed.size == 0:
            return True
        sa.registry_writable("eff")["eff"] = new_eff
        validators = sequence_items(state.validators)
        for i in changed.tolist():
            validators[i].effective_balance = int(new_eff[i])
        sa.mark_registry_committed(card={"eff": new_c})
        return True
    return _dispatch(spec, state, fast)


def try_registry_updates(spec, state) -> bool:
    def fast(spec, state, sa, dev):
        ek = _ek()
        cols = sa.registry()
        spans = mesh_state.n_shards()
        cap = SCAN_CAP or len(cols) // spans
        reg = _registry(sa, dev, "aee", "act", "ext", "eff")
        scan = registry_scan(reg["aee"], reg["act"], reg["ext"], reg["eff"],
                             cur=int(spec.get_current_epoch(state)),
                             finalized=int(state.finalized_checkpoint.epoch),
                             far=int(spec.FAR_FUTURE_EPOCH),
                             max_eb=int(spec.MAX_EFFECTIVE_BALANCE),
                             ejection=int(spec.config.EJECTION_BALANCE), cap=cap, spans=spans,
                             fill=False)
        queue_idx, eject_idx, eligible_idx, counts, active_count = scan_defined(scan)
        if int(counts.max(initial=0)) > cap:
            _STATS["overflow"] += 1
            return False
        ek._registry_apply_idx(spec, state, sa, cols, queue_idx, eject_idx, eligible_idx,
                               active_count)
        return True
    return _dispatch(spec, state, fast)
