"""Copy-on-write columnar ``StateArrays``, with a copy of each column on
the card.

Counterpart of ``consensus_specs_tpu/state/arrays.py`` without its
runtime switch (the store is always attached), its obs counters,
sanitizer, supervisor and fault sites, and its adoption of the
hash-forest's column stash.  Columns: the registry, the balances, and on
Altair states the inactivity scores and the two participation-flag
lists (the engine only reads the flags).

* **One extraction per state lineage.**  ``of(state)`` returns the
  store attached to the state.  Columns are extracted on first use and
  revalidated structurally: every SSZ sequence bumps a mutation
  generation (``_gen``) on any write through the sequence API, so a
  column is fresh iff its recorded ``(sequence, generation)`` still
  matches.
* **Copy-on-write forks.**  :func:`fork_state` (and every
  ``state.copy()`` of a state with a store) copies the SSZ state and
  binds the same column arrays to the copy; a fork that writes a column
  pays for that column only.
* **One commit per epoch transition.**  Inside :func:`commit_scope`
  (opened around ``process_epoch`` by ``forks/phase0.py``) balance and
  inactivity-score writes stay in the store and reach SSZ once, at scope
  exit, through the chunk-packed ``replace_basic_items(packed=)``.
  Registry writes commit eagerly: spec helpers read effective balances
  mid-epoch.

**Two places per column.**  The host copy is numpy uint64 (the registry
a structured ``VALIDATOR_DTYPE`` array): SSZ commits and the host numpy
passes read it.  The card copy is a torch tensor on the engine's device
holding the same bits as ``int64``: the epoch kernels read it.  Writing
either copy marks the other stale, and a column crosses between them
only when a reader needs it, through pinned memory (:func:`upload`,
:func:`download`).  Within one epoch transition on the card, balances
and inactivity scores go up once and come down once (at the scope's
commit), the effective balances go up once and come down once (after
their update, which commits eagerly), and the previous epoch's
participation flags go up once.  :func:`stats` counts every crossing by
column.  The device of a card copy is always the caller's (the epoch
engine's switch): the store never picks one.
"""
import weakref
from contextlib import contextmanager

import numpy as np
import torch

from .. import _build
from ..utils.ssz import forest, replace_basic_items, sequence_items

VALIDATOR_DTYPE = np.dtype([
    ("eff", "<u8"),    # effective_balance
    ("aee", "<u8"),    # activation_eligibility_epoch
    ("act", "<u8"),    # activation_epoch
    ("ext", "<u8"),    # exit_epoch
    ("wd", "<u8"),     # withdrawable_epoch
    ("sl", "?"),       # slashed
])

# SSZ Validator field name -> VALIDATOR_DTYPE key
REGISTRY_FIELDS = (
    ("effective_balance", "eff"), ("activation_eligibility_epoch", "aee"),
    ("activation_epoch", "act"), ("exit_epoch", "ext"),
    ("withdrawable_epoch", "wd"), ("slashed", "sl"))

_STATS = {}


def stats() -> dict:
    """Counts since the last reset: ``extracts``, ``commits``, ``forks``,
    ``cow_copies`` and ``h2d.<column>`` / ``d2h.<column>`` for every copy
    between the host and the engine's device (counted on the CPU device
    too, so the tests see the counts the card would)."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.clear()


def _count(key: str) -> None:
    _STATS[key] = _STATS.get(key, 0) + 1


# ---------------------------------------------------------------------------
# Host <-> card copies
# ---------------------------------------------------------------------------

def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None or t.device.index == dev.index)


def upload(a: np.ndarray, dev: torch.device, what: str) -> torch.Tensor:
    """A host column on ``dev``: uint64 as int64 bit patterns, bool as
    bool; through pinned memory on a CUDA device, without waiting for
    work queued on the card.  Counted as ``h2d.<what>``."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    _count(f"h2d.{what}")
    return _build.to_device(torch.from_numpy(a), dev)


def download(t: torch.Tensor, what: str) -> np.ndarray:
    """An int64 column from the card as host uint64 (the same bits),
    through pinned memory; waits for the card.  Counted as
    ``d2h.<what>``.  The result is never written in place."""
    _count(f"d2h.{what}")
    if t.device.type == "cpu":
        return t.numpy().view(np.uint64)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return out.numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# Column extraction / write-back primitives
# ---------------------------------------------------------------------------

def u64_column(seq) -> np.ndarray:
    """One uint64 column from a basic-element List/Vector."""
    items = sequence_items(seq)
    return np.fromiter(items, dtype=np.uint64, count=len(items))


def _write_u64_list(seq, elem_type, old, new) -> None:
    """Commit a uint64 column back into its SSZ list, equal bit for bit to
    the spec loop's per-index writes.  Few changes: targeted
    ``__setitem__`` (keeps the incremental tree).  Registry-wide changes:
    one wholesale item swap, the element objects built through a value
    table when values repeat (equal stakes earn equal rewards), and the
    leaf chunks packed straight from the column."""
    changed = np.nonzero(old != new)[0]
    if changed.size == 0:
        return
    if changed.size <= max(64, len(old) // 64):
        for i in changed.tolist():
            seq[i] = elem_type(int(new[i]))
        return
    vals, inv = np.unique(new, return_inverse=True)
    if vals.size * 4 <= new.size:
        pool = [elem_type(int(v)) for v in vals.tolist()]
        items = [pool[i] for i in inv.tolist()]
    else:
        # int.__new__ skips BasicValue's range check: the values come out
        # of a uint64 array, so they are in range by construction
        items = [int.__new__(elem_type, v) for v in new.tolist()]
    replace_basic_items(seq, items, packed=new.astype("<u8").tobytes())


def _gen_of(seq) -> int:
    return getattr(seq, "_gen", 0)


def _extract_registry(seq) -> np.ndarray:
    """The validator registry as one structured array: one ``np.fromiter``
    pass over the typed views."""
    items = sequence_items(seq)
    cols = np.fromiter(
        ((v.effective_balance, v.activation_eligibility_epoch,
          v.activation_epoch, v.exit_epoch, v.withdrawable_epoch,
          bool(v.slashed)) for v in items),
        dtype=VALIDATOR_DTYPE, count=len(items))
    _count("extracts")
    return cols


def _extract_u64(seq) -> np.ndarray:
    _count("extracts")
    return u64_column(seq)


def _extract_u8(seq) -> np.ndarray:
    items = sequence_items(seq)
    _count("extracts")
    return np.fromiter(items, dtype=np.uint8, count=len(items))


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

class _Cell:
    """One column (or column group) of one SSZ sequence.

    ``base`` is the committed host value: equal to the SSZ content while
    ``(seq identity, gen)`` still match, and never written in place, so
    forks share it.  ``data`` is the current host value (``data is
    base``: clean; another array: a pending write; ``None``: the card
    copy is newer).  ``card`` maps a column name to a tensor holding its
    current value on the engine's device; ``bound`` is a python int no
    smaller than any lane of a card-only value (the engine's overflow
    guards read it instead of the card)."""

    __slots__ = ("data", "base", "seq_ref", "gen", "card", "bound", "__weakref__")

    def __init__(self, data, seq):
        self.data = data
        self.base = data
        self.seq_ref = weakref.ref(seq)
        self.gen = _gen_of(seq)
        self.card = {}
        self.bound = None


# name -> (state field, extractor); the last three are Altair's
_COLUMNS = {
    "registry": ("validators", _extract_registry),
    "balances": ("balances", _extract_u64),
    "inactivity_scores": ("inactivity_scores", _extract_u64),
    "participation_previous": ("previous_epoch_participation", _extract_u8),
    "participation_current": ("current_epoch_participation", _extract_u8),
}

# uint64 columns whose writes may stay in the store across the
# sub-transitions of one commit_scope
_DEFERRABLE = ("balances", "inactivity_scores")

_ATTR = "_state_arrays"


class StateArrays:
    """Columnar view of one beacon state (see the module docstring)."""

    __slots__ = ("_state_ref", "_cells", "_deferred", "__weakref__")

    def __init__(self, state):
        self._state_ref = weakref.ref(state)
        self._cells = {}
        self._deferred = False

    # -- plumbing -----------------------------------------------------------

    def _state(self):
        state = self._state_ref()
        if state is None:
            raise RuntimeError("StateArrays outlived its state")
        return state

    def _seq(self, name):
        return object.__getattribute__(self._state(), _COLUMNS[name][0])

    def _cell(self, name) -> _Cell:
        """The cell for ``name``: structurally fresh or re-extracted."""
        seq = self._seq(name)
        cell = self._cells.get(name)
        if cell is not None and cell.seq_ref() is seq and cell.gen == _gen_of(seq):
            return cell
        if cell is not None and name in _DEFERRABLE and cell.data is not cell.base:
            # re-extracting would drop the pending engine write; the
            # registry is exempt: its write protocol (registry_writable,
            # matching SSZ writes, mark_registry_committed) passes
            # through a stale generation by design
            raise RuntimeError(f"state_arrays: {name} mutated through the SSZ "
                               "API while an engine write was pending")
        cell = _Cell(_COLUMNS[name][1](seq), seq)
        self._cells[name] = cell
        if name == "registry":
            _bind_registry(seq, cell)
        return cell

    def _card(self, cell, key, dev, host) -> torch.Tensor:
        t = cell.card.get(key)
        if t is None or not _on_device(t, dev):
            t = upload(host(), dev, key)
            cell.card[key] = t
        return t

    # -- registry (structured VALIDATOR_DTYPE array) ------------------------

    def registry(self) -> np.ndarray:
        """Read-only host registry columns (writes go through
        :meth:`registry_writable`)."""
        return self._cell("registry").data

    def registry_card(self, key: str, dev: torch.device) -> torch.Tensor:
        """Registry column ``key`` on ``dev`` (int64 bits; uploaded on
        first use)."""
        cell = self._cell("registry")
        return self._card(cell, key, dev, lambda: cell.data[key])

    def registry_writable(self, *fields) -> np.ndarray:
        """A private host registry array the engine may write in place:
        copied here, once, when it is still shared.  ``fields`` are the
        columns the caller will write; their card copies are dropped.
        The engine applies the same changes to the SSZ state and then
        calls :meth:`mark_registry_committed`."""
        cell = self._cell("registry")
        if cell.data is cell.base:
            cell.data = cell.base.copy()
            _count("cow_copies")
        for f in fields:
            cell.card.pop(f, None)
        return cell.data

    def drop_registry_card(self, *fields) -> None:
        """Drop the card copies of registry columns about to be written
        into the array :meth:`registry_writable` returned (between it and
        :meth:`mark_registry_committed` the cell is stale by design and
        is not revalidated)."""
        cell = self._cells["registry"]
        for f in fields:
            cell.card.pop(f, None)

    def mark_registry_committed(self, card=None) -> None:
        """Declare the written registry columns and the SSZ registry
        identical again.  ``card``: {column: tensor} card copies that
        equal the new host columns."""
        cell = self._cells.get("registry")
        if cell is None:
            return
        seq = self._seq("registry")
        if cell.seq_ref() is not seq:
            return
        cell.base = cell.data
        cell.gen = _gen_of(seq)
        if card:
            cell.card.update(card)

    # -- deferrable uint64 columns (balances, inactivity scores) ------------

    def column(self, name: str) -> np.ndarray:
        """Current host value of a deferrable column, pending writes
        included (read-only); brings a newer card copy down first."""
        cell = self._cell(name)
        if cell.data is None:
            cell.data = download(cell.card[name], name)
        return cell.data

    def column_card(self, name: str, dev: torch.device) -> torch.Tensor:
        """Current value of a deferrable column on ``dev`` (int64 bits)."""
        cell = self._cell(name)
        return self._card(cell, name, dev, lambda: self.column(name))

    def column_bound(self, name: str) -> int:
        """A python int no smaller than any lane of a deferrable column:
        the exact maximum when the host copy is current, else the bound
        recorded with the card write."""
        cell = self._cell(name)
        if cell.data is not None:
            return int(cell.data.max(initial=0))
        return cell.bound

    def set_column(self, name: str, new: np.ndarray) -> None:
        cell = self._cell(name)
        if new.dtype != np.uint64 or new.shape != cell.base.shape:
            raise ValueError(f"state_arrays.{name}: column shape/dtype mismatch "
                             f"({new.dtype}, {new.shape})")
        cell.data, cell.card, cell.bound = new, {}, None
        if not self._deferred:
            self.commit()

    def set_column_card(self, name: str, new: torch.Tensor, bound: int) -> None:
        """A write that stays on the card until a host reader or the
        commit needs it; ``bound`` >= every lane of ``new``."""
        cell = self._cell(name)
        if new.dtype != torch.int64 or tuple(new.shape) != cell.base.shape:
            raise ValueError(f"state_arrays.{name}: column shape/dtype mismatch "
                             f"({new.dtype}, {tuple(new.shape)})")
        cell.data, cell.card, cell.bound = None, {name: new}, bound
        if not self._deferred:
            self.commit()

    def balances(self) -> np.ndarray:
        return self.column("balances")

    def balances_card(self, dev: torch.device) -> torch.Tensor:
        return self.column_card("balances", dev)

    def balances_bound(self) -> int:
        return self.column_bound("balances")

    def set_balances(self, new: np.ndarray) -> None:
        self.set_column("balances", new)

    def set_balances_card(self, new: torch.Tensor, bound: int) -> None:
        self.set_column_card("balances", new, bound)

    # -- participation flags (Altair; read-only) ----------------------------

    def participation(self, which: str) -> np.ndarray:
        """The uint8 participation-flag column, ``which`` = ``"previous"``
        or ``"current"`` (read-only).  The cell follows the list object:
        ``process_participation_flag_updates`` assigns new lists, and the
        next read extracts them."""
        return self._cell(f"participation_{which}").data

    def participation_card(self, which: str, dev: torch.device) -> torch.Tensor:
        """The participation-flag column on ``dev`` (uint8; uploaded on
        first use)."""
        name = f"participation_{which}"
        cell = self._cell(name)
        return self._card(cell, name, dev, lambda: cell.data)

    # -- commit / discard ---------------------------------------------------

    def commit(self) -> None:
        """Write every pending deferrable column back to its SSZ list and
        re-stamp the cells as committed (the card copy stays valid)."""
        for name in _DEFERRABLE:
            cell = self._cells.get(name)
            if cell is None or cell.data is cell.base:
                continue
            seq = self._seq(name)
            if cell.seq_ref() is not seq or cell.gen != _gen_of(seq):
                raise RuntimeError(f"state_arrays: {name} mutated through the SSZ "
                                   "API while an engine write was pending")
            if cell.data is None:
                cell.data = download(cell.card[name], name)
            _write_u64_list(seq, type(seq).elem_type, cell.base, cell.data)
            cell.base = cell.data
            cell.gen = _gen_of(seq)
            cell.bound = None
            _count("commits")

    def commit_for_copy(self) -> None:
        """``Container.copy``'s commit before the field snapshot."""
        self.commit()

    def discard_pending(self) -> None:
        """Drop uncommitted engine writes (the enclosing transition
        failed; the SSZ state is authoritative)."""
        for name in _DEFERRABLE:
            cell = self._cells.get(name)
            if cell is not None and cell.data is not cell.base:
                cell.data, cell.card, cell.bound = cell.base, {}, None

    # -- fork ---------------------------------------------------------------

    def fork(self, new_state) -> "StateArrays":
        """Bind this store's columns, host and card, to ``new_state`` (an
        SSZ copy of the owner) without copying them.  Pending writes are
        committed first; a stale cell is dropped, never rebound."""
        self.commit()
        other = StateArrays(new_state)
        parent = self._state()
        for name, cell in self._cells.items():
            field = _COLUMNS[name][0]
            pseq = object.__getattribute__(parent, field)
            if cell.seq_ref() is not pseq or cell.gen != _gen_of(pseq):
                continue
            seq = object.__getattribute__(new_state, field)
            ncell = _Cell(cell.data, seq)
            ncell.card = dict(cell.card)
            other._cells[name] = ncell
            if name == "registry":
                _bind_registry(seq, ncell)
        object.__setattr__(new_state, _ATTR, other)
        _count("forks")
        return other


# ---------------------------------------------------------------------------
# Module-level surface
# ---------------------------------------------------------------------------

def of(state) -> StateArrays:
    """The state's attached store (created on first use)."""
    store = state.__dict__.get(_ATTR)
    if store is None or store._state_ref() is not state:
        store = StateArrays(state)
        object.__setattr__(state, _ATTR, store)
    return store


def flush(state) -> None:
    """Commit the pending writes of ``state``'s store, if any: every
    spec-loop decline calls this before the loop reads SSZ."""
    store = state.__dict__.get(_ATTR)
    if store is not None and store._state_ref() is state:
        store.commit()


@contextmanager
def commit_scope(state):
    """Defer the store's balance commits across the enclosed epoch
    transition: SSZ sees one chunk-packed commit at scope exit.
    Reentrant.  On an exception the pending writes are discarded
    (exception-as-invalidity: the caller abandons the state)."""
    store = of(state)
    if store._deferred:
        yield
        return
    store._deferred = True
    try:
        yield
    except BaseException:
        store._deferred = False
        store.discard_pending()
        raise
    store._deferred = False
    store.commit()


def fork_state(state):
    """An SSZ copy of ``state`` whose store shares this state's columns
    copy-on-write (``Container.copy`` forks an attached store; this
    attaches one first)."""
    from ..utils.ssz import copy as ssz_copy
    of(state)
    return ssz_copy(state)


# ---------------------------------------------------------------------------
# Column sharing with the hash-forest (utils/ssz/forest.py)
# ---------------------------------------------------------------------------

_REG_CELL_ATTR = "_sa_registry_cell"


def _bind_registry(seq, cell) -> None:
    """Backpointer for :func:`peek_registry`: the sequence knows its
    (weakly held) registry cell."""
    setattr(seq, _REG_CELL_ATTR, weakref.ref(cell))


def peek_registry(seq):
    """The committed registry columns bound to ``seq`` as ``{ssz field
    name: uint64 array}``, or None when the cell is gone, stale or
    belongs to another sequence.  Registered as the forest's column
    provider: a full build of the registry's element roots reads these
    instead of walking the typed views."""
    ref = getattr(seq, _REG_CELL_ATTR, None)
    cell = ref() if ref is not None else None
    if cell is None or cell.seq_ref() is not seq or cell.gen != _gen_of(seq):
        return None
    base = cell.base
    return {fname: base[key].astype(np.uint64) if key == "sl" else base[key]
            for fname, key in REGISTRY_FIELDS}


forest.set_column_provider(peek_registry)
