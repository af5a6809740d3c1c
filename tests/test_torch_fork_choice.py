"""The PyTorch port's fork choice (``forks/fork_choice.py`` over
``forkchoice/proto_array.py``) against the JAX package's, minimal preset,
64 validators, exact (tolerance 0: bytes and integers).

One event stream per fork is built with the JAX ``test_infra``
(``block.py``, ``attestations.py``, ``slashings.py``) and carried to the
port by SSZ: ticks; two competing blocks at slot 1, the first timely and
boosted; "gossip" attestations for the second; a late block (after the
attesting interval, no boost) and a timely one on the other branch; an
attester slashing; then ``next_epoch_with_attestations`` epochs (the
JAX ``apply_next_epoch_with_attestations`` pattern: each block ticked
to, then its attestations and slashings as ``is_from_block``) until the
store justifies, finalizes and the engine prunes; invalid events among
them (a block from a future slot, a block at or before the finalized
slot, an unknown parent, a gossip attestation whose target lies in a
future epoch, a pair of equal attestations as a slashing).  Both stores
take every event; after each one they must agree on ``get_head``,
``get_weight`` of every block, the keys of ``get_filtered_block_tree``,
the justified, finalized and unrealized checkpoints, ``time``,
``proposer_boost_root``, ``block_timeliness``, ``equivocating_indices``,
``latest_messages``, ``unrealized_justifications``, the keys of
``block_states`` and ``checkpoint_states``, and ``get_proposer_head`` of
the head at the current slot and the next (its value, or the exception
type both raise).  An invalid event raises in both and leaves both
stores as they were, the engine's node count too.  The streams run on
phase0 and Altair with BLS off, and a short phase0 stream (a block, a
gossip attestation, a signed slashing, a block with another block's
signature) on both packages' python BLS.  The scenarios of
``tests/phase0/fork_choice/{test_on_block,test_head_weights,
test_ex_ante_reorg}.py`` run on both packages with their checks.
"""
import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.forkchoice import proto_array as jax_proto
from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import attestations as jax_att
from consensus_specs_tpu.test_infra import block as jax_block
from consensus_specs_tpu.test_infra import slashings as jax_slashings
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forkchoice import proto_array
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.utils import bls, ssz
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_torch_bellatrix import bls_on, carry

N_VALIDATORS = 64
ZERO = b"\x00" * 32


@pytest.fixture(scope="module")
def packages():
    """Both packages on python BLS with verification off unless a test
    turns it on; the JAX mesh engine off (ROADMAP rules)."""
    mesh_state.use_fallback()
    jax_backend = jax_bls.backend_name()
    jax_bls.use_py()
    bls.use_py()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    jek.use_vectorized()
    yield
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    getattr(jax_bls, f"use_{jax_backend}", jax_bls.use_py)()
    jek.use_auto()
    ek.use_auto()
    proto_array.use_auto()
    jax_proto.use_auto()
    mesh_state.use_auto()


def genesis(jspec):
    return create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                jspec.MAX_EFFECTIVE_BALANCE)


def slot_time(jspec, state, slot, seconds=0):
    return int(state.genesis_time) + int(slot) * int(jspec.config.SECONDS_PER_SLOT) + seconds


def signed_next(jspec, state, graffiti=None, attestations=()):
    """A block for the slot after ``state``'s, transitioned on ``state``."""
    block = jax_block.build_empty_block_for_next_slot(jspec, state)
    if graffiti is not None:
        block.body.graffiti = graffiti * 32
    for a in attestations:
        block.body.attestations.append(a)
    return jax_block.state_transition_and_sign_block(jspec, state, block)


def half(committee, first=True):
    members = sorted(committee)
    k = max(1, len(members) // 2)
    return set(members[:k] if first else members[k:])


# ---------------------------------------------------------------------------
# The event streams (JAX test_infra)
# ---------------------------------------------------------------------------

def build_stream(jspec):
    """(anchor state, anchor block, events) of the long stream; events
    are ``(kind, value, valid, is_from_block)`` with kinds ``tick``,
    ``block``, ``attestation`` and ``slashing``."""
    g = genesis(jspec)
    anchor = jspec.BeaconBlock(state_root=jax_ssz.hash_tree_root(g))
    ev = []

    def tick(state, slot, seconds=0):
        ev.append(("tick", slot_time(jspec, state, slot, seconds), True, False))

    # two competing blocks at slot 1: A (timely, boosted), then A2
    state_a, state_a2 = g.copy(), g.copy()
    block_a = signed_next(jspec, state_a)
    block_a2 = signed_next(jspec, state_a2, graffiti=b"\xaa")
    tick(g, 1)
    ev += [("block", block_a, True, False), ("block", block_a2, True, False)]
    # slot 2: gossip votes for A2 by half of slot 1's committee, the other
    # half for A
    tick(g, 2)
    ev.append(("attestation", jax_att.get_valid_attestation(
        jspec, state_a2, slot=1, filter_participant_set=half), True, False))
    ev.append(("attestation", jax_att.get_valid_attestation(
        jspec, state_a, slot=1, filter_participant_set=lambda c: half(c, False)),
        True, False))
    # a late block on A at slot 2 (after the attesting interval: no boost)
    state_c = state_a.copy()
    block_c = signed_next(jspec, state_c, graffiti=b"\xcc")
    tick(g, 2, int(jspec.config.SECONDS_PER_SLOT) // 3 + 1)
    ev.append(("block", block_c, True, False))
    # slot 3: a timely block on A2, and a slashing of slot 2's committee
    state_d = state_a2.copy()
    jax_block.next_slots(jspec, state_d, 1)
    block_d = signed_next(jspec, state_d, graffiti=b"\xdd")
    tick(g, 3)
    ev.append(("block", block_d, True, False))
    ev.append(("slashing", jax_slashings.get_valid_attester_slashing(
        jspec, state_c.copy(), slot=2), True, False))
    # invalid: a future slot, an unknown parent, a target from the future,
    # an unslashable pair
    future = state_d.copy()
    jax_block.next_slots(jspec, future, 2)
    ev.append(("block", signed_next(jspec, future), False, False))
    orphan = state_d.copy()
    jax_block.next_slots(jspec, orphan, 1)
    lost = jax_block.build_empty_block(jspec, orphan, orphan.slot + 1)
    lost.parent_root = b"\x42" * 32
    ev.append(("block", jax_block.sign_block(jspec, orphan, lost), False, False))
    ahead = state_d.copy()
    jax_block.next_slots(jspec, ahead, 2 * jspec.SLOTS_PER_EPOCH - int(ahead.slot))
    ev.append(("attestation", jax_att.get_valid_attestation(
        jspec, ahead, slot=ahead.slot), False, False))
    same = jspec.get_indexed_attestation(state_c, jax_att.get_valid_attestation(
        jspec, state_c, slot=2))
    ev.append(("slashing", jspec.AttesterSlashing(attestation_1=same, attestation_2=same),
               False, False))
    # the epochs: D's branch to the next epoch start, then attested epochs
    # until justification and finalization
    early = state_a.copy()
    state = state_d.copy()
    jax_block.next_slots(jspec, state, jspec.SLOTS_PER_EPOCH - int(state.slot))
    for fill_prev in (False, True, True, True):
        _, blocks, state = jax_att.next_epoch_with_attestations(jspec, state, True, fill_prev)
        for sb in blocks:
            tick(g, sb.message.slot)
            ev.append(("block", sb, True, False))
    # invalid: a block on the abandoned early branch, at or before the
    # finalized slot
    ev.append(("block", signed_next(jspec, early), False, False))
    # a gossip vote for the head at the last slot
    tick(g, state.slot + 1)
    ev.append(("attestation", jax_att.get_valid_attestation(
        jspec, state, slot=state.slot), True, False))
    return g, anchor, ev


def build_signed_stream(jspec):
    """The python-BLS leg: a block, a gossip attestation, a signed
    attester slashing, and a block whose proposer signature is another
    block's (refused)."""
    g = genesis(jspec)
    anchor = jspec.BeaconBlock(state_root=jax_ssz.hash_tree_root(g))
    state_a = g.copy()
    block_a = signed_next(jspec, state_a)
    forged_state = state_a.copy()
    forged = signed_next(jspec, forged_state, graffiti=b"\xee")
    forged.signature = block_a.signature
    ev = [("tick", slot_time(jspec, g, 1), True, False), ("block", block_a, True, False),
          ("tick", slot_time(jspec, g, 2), True, False),
          ("attestation", jax_att.get_valid_attestation(jspec, state_a, slot=1, signed=True),
           True, False),
          ("slashing", jax_slashings.get_valid_attester_slashing(
              jspec, state_a.copy(), slot=1, signed_1=True, signed_2=True), True, False),
          ("block", forged, False, False)]
    return g, anchor, ev


# ---------------------------------------------------------------------------
# Replay and comparison
# ---------------------------------------------------------------------------

def _ck(c):
    return (int(c.epoch), bytes(c.root))


def snapshot(spec, store) -> dict:
    """The store's fields in package-neutral form."""
    eng = getattr(store, "_fc_proto", None)
    return {
        "time": int(store.time), "genesis_time": int(store.genesis_time),
        "justified": _ck(store.justified_checkpoint),
        "finalized": _ck(store.finalized_checkpoint),
        "unrealized_justified": _ck(store.unrealized_justified_checkpoint),
        "unrealized_finalized": _ck(store.unrealized_finalized_checkpoint),
        "boost": bytes(store.proposer_boost_root),
        "equivocating": sorted(int(i) for i in store.equivocating_indices),
        "blocks": sorted(bytes(r) for r in store.blocks),
        "block_states": sorted(bytes(r) for r in store.block_states),
        "timeliness": {bytes(r): bool(v) for r, v in store.block_timeliness.items()},
        "checkpoint_states": sorted(store.checkpoint_states),
        "latest_messages": {int(i): (int(m.epoch), bytes(m.root))
                            for i, m in store.latest_messages.items()},
        "unrealized_justifications": {bytes(r): _ck(c)
                                      for r, c in store.unrealized_justifications.items()},
        "engine_nodes": None if eng is None else eng._n,
    }


def _outcome(fn):
    try:
        return bytes(fn())
    except Exception as exc:       # both packages must raise the same type
        return type(exc).__name__


def answers(spec, store) -> dict:
    """The read surface: head, every block's weight, the filtered tree's
    keys, the proposer head at the current and the next slot."""
    head = bytes(spec.get_head(store))
    slot = int(spec.get_current_slot(store))
    return {
        "head": head,
        "weights": {bytes(r): int(spec.get_weight(store, r)) for r in store.blocks},
        "tree": sorted(bytes(r) for r in spec.get_filtered_block_tree(store)),
        "proposer_head": [_outcome(lambda s=s: spec.get_proposer_head(store, head, s))
                          for s in (slot, slot + 1)],
        "proposer_score": int(spec.get_proposer_score(store)),
    }


def apply(spec, store, kind, value, from_block):
    if kind == "tick":
        spec.on_tick(store, value)
    elif kind == "block":
        spec.on_block(store, value)
        # an on_block step brings the block's attestations and slashings
        for a in value.message.body.attestations:
            spec.on_attestation(store, a, is_from_block=True)
        for s in value.message.body.attester_slashings:
            spec.on_attester_slashing(store, s)
    elif kind == "attestation":
        spec.on_attestation(store, value, is_from_block=from_block)
    else:
        spec.on_attester_slashing(store, value)


_TYPES = {"block": "SignedBeaconBlock", "attestation": "Attestation",
          "slashing": "AttesterSlashing"}


def replay(jspec, spec, g, anchor, events) -> dict:
    """Both stores through ``events``; every event's snapshot and answers
    compared.  Returns counts of what the stream exercised."""
    jstore = jspec.get_forkchoice_store(g.copy(), anchor)
    store = spec.get_forkchoice_store(carry(spec, g, "BeaconState"),
                                      carry(spec, anchor, "BeaconBlock"))
    assert snapshot(spec, store) == snapshot(jspec, jstore)
    seen = {"invalid": 0, "pruned": 0, "timely_false": 0, "proposer_head": 0}
    for kind, value, valid, from_block in events:
        pvalue = value if kind == "tick" else carry(spec, value, _TYPES[kind])
        before = (snapshot(jspec, jstore), snapshot(spec, store))
        if valid:
            apply(jspec, jstore, kind, value, from_block)
            apply(spec, store, kind, pvalue, from_block)
        else:
            with pytest.raises(AssertionError):
                apply(jspec, jstore, kind, value, from_block)
            with pytest.raises(AssertionError):
                apply(spec, store, kind, pvalue, from_block)
            assert (snapshot(jspec, jstore), snapshot(spec, store)) == before
            seen["invalid"] += 1
        got, want = snapshot(spec, store), snapshot(jspec, jstore)
        assert got == want, kind
        a, b = answers(spec, store), answers(jspec, jstore)
        assert a == b, kind
        seen["timely_false"] += sum(1 for v in got["timeliness"].values() if not v)
        seen["proposer_head"] += sum(isinstance(x, bytes) for x in a["proposer_head"])
    for r in store.block_states:
        assert ssz.hash_tree_root(store.block_states[r]) == \
            jax_ssz.hash_tree_root(jstore.block_states[r])
    seen["pruned"] = proto_array.stats()["pruned_nodes"]
    seen["store"] = store
    return seen


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_event_stream_bls_off(packages, fork):
    jspec, spec = jax_build_spec(fork, "minimal"), build_spec(fork, "minimal")
    g, anchor, events = build_stream(jspec)
    proto_array.reset_stats()
    seen = replay(jspec, spec, g, anchor, events)
    store = seen["store"]
    st = proto_array.stats()
    # the stream reached what it was built for
    assert int(store.justified_checkpoint.epoch) >= 2
    assert int(store.finalized_checkpoint.epoch) >= 1
    assert store.equivocating_indices
    assert seen["invalid"] == 5 and seen["timely_false"] and seen["proposer_head"]
    assert seen["pruned"] > 0 and st["prunes"] >= 1
    # the port's reads were the engine's
    assert st["spec_heads"] == 0 and st["proto_heads"] >= len(events)
    assert st["fallbacks"] == 0 and st["spec_trees"] == 0


def test_event_stream_python_bls(packages):
    """A short phase0 stream with real signatures on both packages'
    python BLS: every signature verified, a forged block refused."""
    jspec, spec = jax_build_spec("phase0", "minimal"), build_spec("phase0", "minimal")
    with bls_on():
        g, anchor, events = build_signed_stream(jspec)
        jax_bls.clear_verify_memo()
        bls.clear_verify_memo()
        seen = replay(jspec, spec, g, anchor, events)
    assert seen["invalid"] == 1
    assert seen["store"].equivocating_indices and seen["store"].latest_messages


# ---------------------------------------------------------------------------
# The reference scenarios (tests/phase0/fork_choice), on both packages
# ---------------------------------------------------------------------------

class Both:
    """The JAX and the port's spec and store side by side: each event
    goes to both; ``check()`` compares snapshots and answers."""

    def __init__(self, fork, state):
        self.j, self.p = jax_build_spec(fork, "minimal"), build_spec(fork, "minimal")
        anchor = self.j.BeaconBlock(state_root=jax_ssz.hash_tree_root(state))
        self.js = self.j.get_forkchoice_store(state.copy(), anchor)
        self.ps = self.p.get_forkchoice_store(carry(self.p, state, "BeaconState"),
                                              carry(self.p, anchor, "BeaconBlock"))
        self.genesis_time = int(state.genesis_time)

    def check(self):
        assert snapshot(self.p, self.ps) == snapshot(self.j, self.js)
        assert answers(self.p, self.ps) == answers(self.j, self.js)

    def tick(self, slot, interval=0):
        per = int(self.j.config.SECONDS_PER_SLOT) // self.j.INTERVALS_PER_SLOT
        t = self.genesis_time + int(slot) * int(self.j.config.SECONDS_PER_SLOT) + interval * per
        self.j.on_tick(self.js, t)
        self.p.on_tick(self.ps, t)
        self.check()

    def event(self, kind, value, valid=True, from_block=False):
        pvalue = carry(self.p, value, _TYPES[kind])
        if valid:
            apply(self.j, self.js, kind, value, from_block)
            apply(self.p, self.ps, kind, pvalue, from_block)
        else:
            before = (snapshot(self.j, self.js), snapshot(self.p, self.ps))
            for spec, store, v in ((self.j, self.js, value), (self.p, self.ps, pvalue)):
                with pytest.raises(AssertionError):
                    apply(spec, store, kind, v, from_block)
            assert (snapshot(self.j, self.js), snapshot(self.p, self.ps)) == before
        self.check()

    def weight(self, signed):
        root = jax_ssz.hash_tree_root(signed.message)
        w = int(self.p.get_weight(self.ps, root))
        assert w == int(self.j.get_weight(self.js, root))
        return w

    def head(self):
        return bytes(self.p.get_head(self.ps))


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_ex_ante_withheld_block_loses_to_boosted_proposal(packages, fork):
    """test_ex_ante_reorg: a withheld slot-2 block revealed at slot 3
    beside the honest, boosted proposal loses."""
    jspec = jax_build_spec(fork, "minimal")
    g = genesis(jspec)
    both = Both(fork, g)
    state_a = g.copy()
    a = signed_next(jspec, state_a)
    both.tick(1)
    both.event("block", a)
    state_b = state_a.copy()
    b = signed_next(jspec, state_b, graffiti=b"\xbb")
    att_b = jax_att.get_valid_attestation(jspec, state_b, slot=b.message.slot,
                                          filter_participant_set=lambda c: {min(c)})
    state_c = state_a.copy()
    jax_block.next_slots(jspec, state_c, 1)
    c = signed_next(jspec, state_c)
    both.tick(c.message.slot)
    both.event("block", b)
    assert bytes(both.ps.proposer_boost_root) == ZERO
    both.event("block", c)
    assert bytes(both.ps.proposer_boost_root) == jax_ssz.hash_tree_root(c.message)
    both.event("attestation", att_b)
    assert both.weight(c) > both.weight(b)
    assert both.head() == jax_ssz.hash_tree_root(c.message)


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_head_weights_follow_votes_and_boost(packages, fork):
    """test_head_weights: two branches; the votes decide once the boost
    is gone, and an equivocator's vote stops counting."""
    jspec = jax_build_spec(fork, "minimal")
    g = genesis(jspec)
    both = Both(fork, g)
    sa, sb = g.copy(), g.copy()
    a = signed_next(jspec, sa)
    b = signed_next(jspec, sb, graffiti=b"\x0b")
    both.tick(1)
    both.event("block", a)
    both.event("block", b)
    boost = int(both.p.get_proposer_score(both.ps))
    assert both.weight(a) == boost and both.weight(b) == 0
    both.tick(2)
    assert both.weight(a) == 0
    votes = jax_att.get_valid_attestation(jspec, sb, slot=1, signed=False)
    both.event("attestation", votes)
    assert both.head() == jax_ssz.hash_tree_root(b.message)
    wb = both.weight(b)
    assert wb > 0
    slashing = jax_slashings.get_valid_attester_slashing(jspec, sb.copy(), slot=1)
    both.event("slashing", slashing)
    assert both.weight(b) < wb


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_on_block_finalized_guards(packages, fork):
    """test_on_block: a block at or before the finalized slot, and one
    from a future slot, are refused with both stores unchanged; the store
    justifies and finalizes."""
    jspec = jax_build_spec(fork, "minimal")
    g = genesis(jspec)
    both = Both(fork, g)
    early = g.copy()
    state = g.copy()
    for fill_prev in (False, True, True, True):
        _, blocks, state = jax_att.next_epoch_with_attestations(jspec, state, True, fill_prev)
        for sb in blocks:
            both.tick(sb.message.slot)
            both.event("block", sb)
    assert int(both.ps.finalized_checkpoint.epoch) > 0
    stale = signed_next(jspec, early)
    both.event("block", stale, valid=False)
    ahead = state.copy()
    jax_block.next_slots(jspec, ahead, 3)
    both.event("block", signed_next(jspec, ahead), valid=False)
