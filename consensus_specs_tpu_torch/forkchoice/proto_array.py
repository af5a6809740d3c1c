"""Incremental proto-array LMD-GHOST fork choice.

Counterpart of ``consensus_specs_tpu/forkchoice/proto_array.py``.  The
spec-shaped ``get_head`` (``forks/fork_choice.py``) recomputes
everything from scratch: every child at every tree level pays a
``get_weight`` that loops over all active validators and walks
``get_ancestor`` per vote, O(blocks x validators x depth) a head.  This
is protolambda's proto-array design instead (the flat-array,
delta-propagating form of the GHOST rule): the block tree as a flat node
array with per-node subtree weights; each recompute applies only the
vote deltas accrued since the last one and refreshes the best-child and
best-descendant links in one backward sweep, O(changed votes + nodes).

* one node array: parent index, slot, the block epoch and the realized
  and unrealized justification epochs, exact python-int subtree weights;
  each sweep derives viability, best-child and best-descendant links;
* one validator vote array: the applied vote's node and weight, int64
  lanes;
* vote weights come columnar from the justified checkpoint state's
  column store (``state/arrays.py`` ``of(state).registry()``), which a
  state copy shares copy-on-write, so a new justified checkpoint is one
  vectorized balance-delta pass;
* the proposer boost is a virtual vote applied and removed through the
  same delta path; an equivocation zeroes its validator's lane;
  finalization prunes the array to the finalized subtree.

The engine stays numpy on the host, as in the JAX package: it has no
device program to port.

Exactness contract: ``get_head``, ``get_weight`` and
``get_filtered_block_tree`` answer byte for byte what the spec loops
answer (``tests/test_torch_proto_array.py``).  Whatever the flat array
cannot represent (a root outside the pruned window, a weight column that
could overflow an int64 lane, blocks inserted behind the handlers' back)
raises :class:`_Fallback` inside the engine, and that call is answered
by the spec loop instead.

  use_proto() / use_spec() / use_auto()   the runtime switch for the
      reads; auto is the default, the engine on
  install_forkchoice_accel(cls)           wraps the fork-choice surface
      of ``cls``: the reads go to the engine, the write hooks feed it
  attach_store_accel(spec, store)         an engine for a store not
      built through the wrapped ``get_forkchoice_store``
  stats() / reset_stats()                 answers by engine and by spec
      loop, refreshes, balance passes, vote deltas, prunes, fallbacks

The JAX package's observability counters, tracing spans, supervisor
(breaker, deadlines, sentinel audits) and fault-injection sites are host
machinery this port does not carry.
"""
import functools

import numpy as np

from ..state import arrays as state_arrays
from ..utils.ssz import hash_tree_root

_ZERO_ROOT = b"\x00" * 32
# python-int magnitude bound for the int64 weight lanes: a single
# effective balance above this (or a registry summing above it) falls
# back to the spec loop instead of risking a wrapped lane.
_WEIGHT_GUARD = 1 << 60

# ---------------------------------------------------------------------------
# Runtime switch (as epoch_kernels' use_vectorized/use_loops/use_auto)
# ---------------------------------------------------------------------------

_on = True


def use_proto() -> None:
    """Answer the reads by the proto-array engine (guards can still fall
    back)."""
    global _on
    _on = True


def use_spec() -> None:
    """Answer the reads by the spec loops (the differential oracle)."""
    global _on
    _on = False


def use_auto() -> None:
    """Restore the default: the engine on."""
    use_proto()


def enabled() -> bool:
    return _on


# Answers by path and the engine's work.  The tests and chip_smoke.py
# read them, so a silent fallback cannot turn an engine-against-loop
# comparison into loop against loop.
_STAT_KEYS = ("proto_heads", "spec_heads", "proto_weights", "spec_weights",
              "proto_trees", "spec_trees", "refreshes", "vote_deltas",
              "balance_passes", "boost_deltas", "prunes", "pruned_nodes",
              "fallbacks")
_STATS = dict.fromkeys(_STAT_KEYS, 0)


def stats() -> dict:
    """Counts since the last reset: heads, weights and filtered trees
    answered by the engine (``proto_*``) and by the spec loops
    (``spec_*``); engine refreshes, balance passes, applied vote and
    boost deltas, prunes and pruned nodes; calls the engine declined
    (``fallbacks``)."""
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STAT_KEYS:
        _STATS[k] = 0


def _count(key: str, n: int = 1) -> None:
    _STATS[key] += n


class _Fallback(Exception):
    """A guard refused the array path for this call; the caller runs the
    spec loop instead (engine state is left consistent for retries)."""


def _ckpt_key(checkpoint):
    return (int(checkpoint.epoch), bytes(checkpoint.root))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class ProtoArrayEngine:
    """Flat-array fork choice for one ``Store``.

    Nodes are appended in ``on_block`` order, so a parent's index is
    always below its children's: the invariant both the delta
    up-propagation and the best-descendant sweep iterate on.
    """

    def __init__(self, spec, store):
        # -- node columns (index-aligned) -----------------------------------
        self._roots = []        # bytes32 per node
        self._index = {}        # root -> node index
        self._parent = []       # parent node index, -1 at the array base
        self._slot = []         # int block slot
        self._weight = []       # exact python-int subtree weight (boost included)
        cap = 64
        self._block_e = np.zeros(cap, dtype=np.int64)    # block epoch
        self._state_e = np.zeros(cap, dtype=np.int64)    # realized justification epoch
        self._unreal_e = np.zeros(cap, dtype=np.int64)   # unrealized justification epoch
        self._n = 0
        # -- validator vote lanes -------------------------------------------
        vcap = 1024
        self._vote_node = np.full(vcap, -1, dtype=np.int64)
        self._vote_weight = np.zeros(vcap, dtype=np.int64)
        self._equiv = np.zeros(vcap, dtype=bool)
        self._nv = vcap
        self._equiv_seen = set()
        self._dirty = set()     # validator indices with a possibly new vote
        # -- refresh bookkeeping --------------------------------------------
        self._bal_key = None    # justified-checkpoint key of _bal_eff
        self._bal_eff = None    # int64 per-validator weight column
        self._boost = None      # applied (node, amount) proposer boost
        self._fin_seen = None   # finalized-checkpoint key already pruned for
        self._anc_cache = None  # (fin_epoch, fin_root, n) -> per-node ancestor
        self._delta = None      # pending per-node weight deltas (int64)
        self._broken = False    # structural desync: disabled for good
        self._seen_blocks = 0   # unique roots ever appended (pruned ones too)
        for root in store.blocks:
            self._append_node(spec, store, bytes(root))

    # -- growth helpers -----------------------------------------------------

    def _grow_nodes(self, need: int) -> None:
        cap = self._block_e.size
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("_block_e", "_state_e", "_unreal_e"):
            old = getattr(self, name)
            arr = np.zeros(cap, dtype=np.int64)
            arr[:self._n] = old[:self._n]
            setattr(self, name, arr)

    def _grow_validators(self, need: int) -> None:
        if need <= self._nv:
            return
        cap = self._nv
        while cap < need:
            cap *= 2
        for name, fill in (("_vote_node", -1), ("_vote_weight", 0), ("_equiv", False)):
            old = getattr(self, name)
            arr = np.full(cap, fill, dtype=old.dtype)
            arr[:self._nv] = old
            setattr(self, name, arr)
        if self._bal_eff is not None:
            bal = np.zeros(cap, dtype=np.int64)
            bal[:self._bal_eff.size] = self._bal_eff
            self._bal_eff = bal
        self._nv = cap

    # -- event hooks (called by the install wrappers) -----------------------

    def _append_node(self, spec, store, root: bytes) -> None:
        if self._broken or root in self._index:
            return
        block = store.blocks[root]
        parent = self._index.get(bytes(block.parent_root), -1)
        if parent < 0 and self._n > 0:
            # a non-base block whose parent the array has never seen:
            # structural desync (impossible through on_block)
            self._broken = True
            return
        idx = self._n
        self._grow_nodes(idx + 1)
        self._roots.append(root)
        self._index[root] = idx
        self._parent.append(parent)
        self._slot.append(int(block.slot))
        self._weight.append(0)
        self._block_e[idx] = int(spec.compute_epoch_at_slot(block.slot))
        state = store.block_states.get(root)
        self._state_e[idx] = (0 if state is None
                              else int(state.current_justified_checkpoint.epoch))
        unreal = store.unrealized_justifications.get(root)
        self._unreal_e[idx] = 0 if unreal is None else int(unreal.epoch)
        self._n = idx + 1
        self._seen_blocks += 1
        self._anc_cache = None

    def note_block(self, spec, store, root: bytes) -> None:
        self._append_node(spec, store, bytes(root))

    def note_votes(self, indices) -> None:
        self._dirty.update(int(i) for i in indices)

    def note_equivocations(self, store) -> None:
        for i in store.equivocating_indices:
            ii = int(i)
            if ii in self._equiv_seen:
                continue
            self._equiv_seen.add(ii)
            self._grow_validators(ii + 1)
            self._equiv[ii] = True
            if self._bal_eff is not None and ii < self._bal_eff.size:
                self._bal_eff[ii] = 0
            self._dirty.add(ii)

    # -- refresh: prune + deltas + propagation ------------------------------

    def _get_delta(self) -> np.ndarray:
        if self._delta is None or self._delta.size < self._n:
            delta = np.zeros(self._n, dtype=np.int64)
            if self._delta is not None:
                delta[:self._delta.size] = self._delta
            self._delta = delta
        return self._delta

    def _prune(self, store) -> None:
        """Drop everything outside the finalized subtree and reindex."""
        froot = bytes(store.finalized_checkpoint.root)
        fidx = self._index.get(froot)
        if fidx is None:
            self._broken = True
            return
        if fidx == 0:
            return
        n = self._n
        keep = [False] * n
        keep[fidx] = True
        for i in range(fidx + 1, n):
            p = self._parent[i]
            keep[i] = p >= 0 and keep[p]
        remap = np.full(n, -1, dtype=np.int64)
        new_roots, new_parent, new_slot, new_weight = [], [], [], []
        for i in range(n):
            if not keep[i]:
                continue
            remap[i] = len(new_roots)
            new_roots.append(self._roots[i])
            p = self._parent[i]
            new_parent.append(int(remap[p]) if i != fidx else -1)
            new_slot.append(self._slot[i])
            new_weight.append(self._weight[i])
        kept = np.nonzero(remap >= 0)[0]
        m = kept.size
        for name in ("_block_e", "_state_e", "_unreal_e"):
            arr = getattr(self, name)
            compact = np.zeros(max(arr.size, 64), dtype=np.int64)
            compact[:m] = arr[kept]
            setattr(self, name, compact)
        self._roots = new_roots
        self._parent = new_parent
        self._slot = new_slot
        self._weight = new_weight
        self._index = {r: i for i, r in enumerate(new_roots)}
        self._n = m
        # votes (and the boost) on pruned nodes weighed only pruned nodes,
        # so they are dropped with no delta
        mask = self._vote_node >= 0
        self._vote_node[mask] = remap[self._vote_node[mask]]
        dropped = mask & (self._vote_node < 0)
        self._vote_weight[dropped] = 0
        if self._boost is not None:
            node, amount = self._boost
            node = int(remap[node])
            self._boost = (node, amount) if node >= 0 else None
        if self._delta is not None:
            padded = np.zeros(n, dtype=np.int64)
            k = min(self._delta.size, n)
            padded[:k] = self._delta[:k]
            self._delta = padded[kept]
        self._anc_cache = None
        _count("prunes")
        _count("pruned_nodes", n - m)

    def _balance_column(self, spec, state) -> np.ndarray:
        """Per-validator vote weight from the justified state: the
        effective balance where active and not slashed, else 0, exactly
        the set the spec's ``get_weight`` loop iterates.  The columns are
        the justified state's column store (``state/arrays.py``); a
        checkpoint state made by a state copy shares its parent's columns
        copy-on-write, so a new justified checkpoint usually extracts
        nothing."""
        cols = state_arrays.of(state).registry()
        epoch = int(spec.get_current_epoch(state))
        eff = cols["eff"]
        if eff.size and int(eff.max()) > _WEIGHT_GUARD:
            raise _Fallback()
        active = (cols["act"] <= np.uint64(epoch)) & (np.uint64(epoch) < cols["ext"])
        bal = np.where(active & ~cols["sl"], eff, 0).astype(np.int64)
        if float(bal.sum(dtype=np.float64)) > float(_WEIGHT_GUARD):
            raise _Fallback()
        return bal

    def _refresh(self, spec, store) -> None:
        """Bring the node weights up to date with the store: one columnar
        balance-delta pass (the justified checkpoint changed), one loop
        over the changed votes, one boost adjustment, one backward
        up-propagation."""
        _count("refreshes")
        # a caller that inserted into store.blocks directly (past the
        # wrapped on_block) would leave the array blind to those blocks;
        # spec stores never delete, so the unique roots ever seen must
        # equal the dict's size, else the spec loop answers
        if len(store.blocks) != self._seen_blocks:
            raise _Fallback()
        fk = _ckpt_key(store.finalized_checkpoint)
        if fk != self._fin_seen:
            self._prune(store)
            if self._broken:
                raise _Fallback()
            self._fin_seen = fk

        # the spec's get_weight opens with this lookup too, but its
        # get_head can still succeed without it (a filtered tree with no
        # children never weighs anything), so a missing justified
        # checkpoint state falls back instead of raising where the spec
        # would not
        jk = _ckpt_key(store.justified_checkpoint)
        try:
            justified_state = store.checkpoint_states[jk]
        except KeyError:
            raise _Fallback()
        if jk != self._bal_key:
            bal = self._balance_column(spec, justified_state)
            self._grow_validators(bal.size)
            bal_eff = np.zeros(self._nv, dtype=np.int64)
            bal_eff[:bal.size] = bal
            bal_eff[self._equiv] = 0
            mask = self._vote_node >= 0
            changed = mask & (self._vote_weight != bal_eff)
            idx = np.nonzero(changed)[0]
            if idx.size:
                delta = self._get_delta()
                np.add.at(delta, self._vote_node[idx], bal_eff[idx] - self._vote_weight[idx])
                self._vote_weight[idx] = bal_eff[idx]
            self._bal_eff = bal_eff
            self._bal_key = jk
            _count("balance_passes")

        if self._dirty:
            bal_eff = self._bal_eff
            index = self._index
            for i in self._dirty:
                if i >= self._nv:
                    self._grow_validators(i + 1)
                    bal_eff = self._bal_eff
                msg = store.latest_messages.get(i)
                node = -1 if msg is None else index.get(bytes(msg.root), -1)
                new_w = int(bal_eff[i]) if node >= 0 else 0
                old_n = int(self._vote_node[i])
                old_w = int(self._vote_weight[i])
                if node == old_n and new_w == old_w:
                    continue
                delta = self._get_delta()
                if old_n >= 0:
                    delta[old_n] -= old_w
                if node >= 0:
                    delta[node] += new_w
                self._vote_node[i] = node
                self._vote_weight[i] = new_w
                _count("vote_deltas")
            self._dirty.clear()

        # proposer boost: a virtual vote worth get_proposer_score, applied
        # and removed through the same delta path
        broot = bytes(store.proposer_boost_root)
        if broot == _ZERO_ROOT:
            desired = None
        else:
            node = self._index.get(broot)
            if node is None:
                raise _Fallback()
            desired = (node, int(spec.get_proposer_score(store)))
        if desired != self._boost:
            delta = self._get_delta()
            if self._boost is not None:
                delta[self._boost[0]] -= self._boost[1]
            if desired is not None:
                delta[desired[0]] += desired[1]
            self._boost = desired
            _count("boost_deltas")

        if self._delta is not None:
            # through _get_delta(): a held-over delta array (an earlier
            # refresh fell back after queuing deltas, then nodes were
            # appended) may be shorter than _n
            dl = self._get_delta()[:self._n].tolist()
            weight = self._weight
            parent = self._parent
            for i in range(self._n - 1, -1, -1):
                d = dl[i]
                if d:
                    weight[i] += d
                    p = parent[i]
                    if p >= 0:
                        dl[p] += d
            self._delta = None

    # -- viability + sweep --------------------------------------------------

    def _finalized_ancestors(self, spec, store) -> list:
        """Per node, the index of ``get_checkpoint_block(store, node,
        finalized_epoch)`` within the array, in one forward pass (parents
        precede children)."""
        fe = int(store.finalized_checkpoint.epoch)
        froot = bytes(store.finalized_checkpoint.root)
        key = (fe, froot, self._n)
        if self._anc_cache is not None and self._anc_cache[0] == key:
            return self._anc_cache[1]
        start = int(spec.compute_start_slot_at_epoch(fe))
        anc = [0] * self._n
        slot = self._slot
        parent = self._parent
        for i in range(self._n):
            p = parent[i]
            anc[i] = i if (slot[i] <= start or p < 0) else anc[p]
        self._anc_cache = (key, anc)
        return anc

    def _leaf_viable(self, spec, store) -> np.ndarray:
        """The spec's ``_leaf_viable`` over every node at once: the
        voting-source pull-up, the justification-epoch window and the
        finalized-checkpoint ancestry."""
        n = self._n
        cur_e = int(spec.get_current_store_epoch(store))
        genesis = int(spec.GENESIS_EPOCH)
        je = int(store.justified_checkpoint.epoch)
        fe = int(store.finalized_checkpoint.epoch)
        be = self._block_e[:n]
        vs = np.where(be < cur_e, self._unreal_e[:n], self._state_e[:n])
        correct_justified = (vs == je) | (vs + 2 >= cur_e) if je != genesis \
            else np.ones(n, dtype=bool)
        if fe == genesis:
            correct_finalized = np.ones(n, dtype=bool)
        else:
            froot = bytes(store.finalized_checkpoint.root)
            anc = self._finalized_ancestors(spec, store)
            roots = self._roots
            correct_finalized = np.fromiter((roots[anc[i]] == froot for i in range(n)),
                                            dtype=bool, count=n)
        return correct_justified & correct_finalized

    def _sweep(self, spec, store):
        """One backward pass: leaf viability aggregated (a subtree is kept
        iff some leaf in it is viable, the spec's ``filter_block_tree``)
        and the best-child and best-descendant links with the spec's
        ``(weight, root)`` tie-break."""
        n = self._n
        lv = self._leaf_viable(spec, store).tolist()
        viable = [False] * n
        child_or = [False] * n
        has_child = [False] * n
        best_child = [-1] * n
        best_key = [None] * n
        weight = self._weight
        roots = self._roots
        parent = self._parent
        for i in range(n - 1, -1, -1):
            v = child_or[i] if has_child[i] else lv[i]
            viable[i] = v
            p = parent[i]
            if p >= 0:
                has_child[p] = True
                if v:
                    child_or[p] = True
                    k = (weight[i], roots[i])
                    if best_key[p] is None or k > best_key[p]:
                        best_key[p] = k
                        best_child[p] = i
        best_desc = list(range(n))
        # children first (higher indices), so a parent's link is chased
        # through an already resolved child
        for i in range(n - 1, -1, -1):
            if best_child[i] >= 0:
                best_desc[i] = best_desc[best_child[i]]
        return viable, best_child, best_desc

    # -- spec-surface answers ----------------------------------------------

    def _refreshed(self, spec, store) -> bool:
        """``_refresh``; False (counted) when a guard declined."""
        if self._broken:
            return False
        try:
            self._refresh(spec, store)
        except _Fallback:
            _count("fallbacks")
            return False
        return True

    def head(self, spec, store):
        """Root of the canonical head, or None to fall back."""
        if not self._refreshed(spec, store):
            return None
        j = self._index.get(bytes(store.justified_checkpoint.root))
        if j is None:
            _count("fallbacks")
            return None
        _, _, best_desc = self._sweep(spec, store)
        return self._roots[best_desc[j]]

    def weight(self, spec, store, root: bytes):
        """Subtree weight of ``root`` (boost included), or None."""
        if not self._refreshed(spec, store):
            return None
        # looked up only after the refresh: a prune in it compacts the
        # arrays and remaps every index.  An unknown or pruned query root
        # says nothing of the engine's health: the spec loop answers it,
        # uncounted
        idx = self._index.get(bytes(root))
        return None if idx is None else self._weight[idx]

    def filtered_block_tree(self, spec, store):
        """The spec's ``get_filtered_block_tree`` dict, or None."""
        if not self._refreshed(spec, store):
            return None
        j = self._index.get(bytes(store.justified_checkpoint.root))
        if j is None:
            _count("fallbacks")
            return None
        viable, _, _ = self._sweep(spec, store)
        n = self._n
        parent = self._parent
        roots = self._roots
        in_tree = [False] * n
        in_tree[j] = True
        out = {}
        for i in range(j, n):
            if i != j:
                p = parent[i]
                in_tree[i] = p >= 0 and in_tree[p]
            if in_tree[i] and viable[i]:
                out[roots[i]] = store.blocks[roots[i]]
        return out


# ---------------------------------------------------------------------------
# Installation: wrap a spec class's fork-choice surface
# ---------------------------------------------------------------------------

def _engine(store):
    """The store's engine for the read dispatch, honoring the switch."""
    if not enabled():
        return None
    eng = getattr(store, "_fc_proto", None)
    if eng is not None and eng._broken:
        return None
    return eng


def attach_store_accel(spec, store) -> None:
    """Attach an engine to a store not built through the wrapped
    ``get_forkchoice_store`` (a restored store).  The nodes come from the
    blocks map, whose insertion order is the ``on_block`` order (so the
    engine's parent-before-child invariant holds), and the engine is
    seeded with every vote and equivocation, so the first head read
    answers as the original store would."""
    eng = store._fc_proto = ProtoArrayEngine(spec, store)
    eng.note_votes(list(store.latest_messages.keys()))
    eng.note_equivocations(store)


def install_forkchoice_accel(cls) -> None:
    """Wrap the fork-choice methods ``cls`` itself defines with the
    proto-array dispatch.  Inherited methods are wrapped on their own
    class; wrapping is idempotent.

    ``get_forkchoice_store`` attaches an engine to every store.  The
    write hooks (``on_block``, ``update_latest_messages``,
    ``on_attester_slashing``) feed it whatever the switch says, so that
    flipping ``use_spec()`` and ``use_proto()`` within a stream never
    desyncs it.  The reads (``get_head``, ``get_weight``,
    ``get_filtered_block_tree``) honor the switch."""

    def wrap(name, make):
        fn = cls.__dict__.get(name)
        if fn is None or getattr(fn, "_fc_accel_wrapper", False):
            return
        wrapper = functools.wraps(fn)(make(fn))
        wrapper._fc_accel_wrapper = True
        setattr(cls, name, wrapper)

    def make_get_forkchoice_store(orig):
        def get_forkchoice_store(self, anchor_state, anchor_block):
            store = orig(self, anchor_state, anchor_block)
            store._fc_proto = ProtoArrayEngine(self, store)
            return store
        return get_forkchoice_store

    def make_on_block(orig):
        def on_block(self, store, signed_block):
            orig(self, store, signed_block)
            # reached only when every on_block assertion passed
            eng = getattr(store, "_fc_proto", None)
            if eng is not None:
                eng.note_block(self, store, bytes(hash_tree_root(signed_block.message)))
        return on_block

    def make_update_latest_messages(orig):
        def update_latest_messages(self, store, attesting_indices, attestation):
            orig(self, store, attesting_indices, attestation)
            eng = getattr(store, "_fc_proto", None)
            if eng is not None:
                eng.note_votes(attesting_indices)
        return update_latest_messages

    def make_on_attester_slashing(orig):
        def on_attester_slashing(self, store, attester_slashing):
            orig(self, store, attester_slashing)
            eng = getattr(store, "_fc_proto", None)
            if eng is not None:
                eng.note_equivocations(store)
        return on_attester_slashing

    def make_get_head(orig):
        def get_head(self, store):
            eng = _engine(store)
            if eng is not None:
                head = eng.head(self, store)
                if head is not None:
                    _count("proto_heads")
                    return self.Root(head)
            _count("spec_heads")
            return orig(self, store)
        return get_head

    def make_get_weight(orig):
        def get_weight(self, store, root):
            eng = _engine(store)
            if eng is not None:
                w = eng.weight(self, store, root)
                if w is not None:
                    _count("proto_weights")
                    return self.Gwei(w)
            _count("spec_weights")
            return orig(self, store, root)
        return get_weight

    def make_get_filtered_block_tree(orig):
        def get_filtered_block_tree(self, store):
            eng = _engine(store)
            if eng is not None:
                tree = eng.filtered_block_tree(self, store)
                if tree is not None:
                    _count("proto_trees")
                    return tree
            _count("spec_trees")
            return orig(self, store)
        return get_filtered_block_tree

    wrap("get_forkchoice_store", make_get_forkchoice_store)
    wrap("on_block", make_on_block)
    wrap("update_latest_messages", make_update_latest_messages)
    wrap("on_attester_slashing", make_on_attester_slashing)
    wrap("get_head", make_get_head)
    wrap("get_weight", make_get_weight)
    wrap("get_filtered_block_tree", make_get_filtered_block_tree)
