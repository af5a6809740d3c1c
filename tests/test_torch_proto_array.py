"""The port's proto-array engine (``forkchoice/proto_array.py``) against
the port's own spec loops (``forks/fork_choice.py``), minimal preset, 64
validators, exact.

As ``tests/phase0/fork_choice/test_proto_array_differential.py`` does for
the JAX package: one port store is driven through an event stream (blocks,
attestations and slashings built by the JAX ``test_infra`` and carried by
SSZ), and after every event ``get_head``, ``get_weight`` of every block and
``get_filtered_block_tree`` are answered twice, under ``use_proto()`` and
under ``use_spec()``, and must be identical.  ``stats()`` must show that
the engine answered the first time and the loops the second, so that a
silent fallback cannot turn the comparison into loop against loop.
Covered: random branching trees with attestation streams, proposer boost
and equivocation, justification and pruning at finalization, a weight as
the first read after finalization, a store built under ``use_spec()``, a
held-over delta across node growth, blocks inserted behind the handlers'
back, a restored store through ``attach_store_accel``, and a forced
``_Fallback``: an effective balance above ``_WEIGHT_GUARD`` makes the
engine decline, and the answer is the spec loop's.
"""
import dataclasses
import random

import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import attestations as jax_att
from consensus_specs_tpu.test_infra import slashings as jax_slashings
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forkchoice import proto_array
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.state import arrays as state_arrays
from consensus_specs_tpu_torch.utils import bls
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_torch_bellatrix import carry
from tests.test_torch_fork_choice import genesis, signed_next


@pytest.fixture(scope="module")
def packages():
    mesh_state.use_fallback()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    yield
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    proto_array.use_auto()
    mesh_state.use_auto()


class StoreRun:
    """JAX states build the events; one port store takes them."""

    def __init__(self, fork="phase0", spec_reads=False):
        self.j, self.p = jax_build_spec(fork, "minimal"), build_spec(fork, "minimal")
        self.g = genesis(self.j)
        anchor = self.j.BeaconBlock(state_root=jax_ssz.hash_tree_root(self.g))
        self.anchor_root = bytes(jax_ssz.hash_tree_root(anchor))
        (proto_array.use_spec if spec_reads else proto_array.use_proto)()
        try:
            self.store = self.p.get_forkchoice_store(carry(self.p, self.g, "BeaconState"),
                                                     carry(self.p, anchor, "BeaconBlock"))
        finally:
            proto_array.use_auto()
        self.eng = self.store._fc_proto

    def tick_slot(self, slot, seconds=0):
        t = int(self.g.genesis_time) + int(slot) * int(self.j.config.SECONDS_PER_SLOT) + seconds
        if t > self.store.time:
            self.p.on_tick(self.store, t)

    def tick_next(self):
        self.tick_slot(int(self.p.get_current_slot(self.store)) + 1)

    def block(self, signed, tick=True):
        if tick:
            self.tick_slot(signed.message.slot)
        pb = carry(self.p, signed, "SignedBeaconBlock")
        self.p.on_block(self.store, pb)
        for a in pb.message.body.attestations:
            self.p.on_attestation(self.store, a, is_from_block=True)
        return bytes(jax_ssz.hash_tree_root(signed.message))

    def attestation(self, att):
        while int(self.p.get_current_slot(self.store)) <= int(att.data.slot):
            self.tick_next()
        self.p.on_attestation(self.store, carry(self.p, att, "Attestation"))

    def slashing(self, s):
        self.p.on_attester_slashing(self.store, carry(self.p, s, "AttesterSlashing"))

    def agree(self, check_weights=True):
        """Engine and loops answer alike; the engine answered (stats)."""
        spec, store = self.p, self.store
        assert self.eng is not None and not self.eng._broken

        def read():
            head = bytes(spec.get_head(store))
            tree = spec.get_filtered_block_tree(store)
            weights = ({r: int(spec.get_weight(store, r)) for r in store.blocks}
                       if check_weights else None)
            return head, tree, weights

        proto_array.use_proto()
        proto_array.reset_stats()
        try:
            head_p, tree_p, w_p = read()
        finally:
            proto_array.use_spec()
        st = proto_array.stats()
        assert st["proto_heads"] == 1 and st["spec_heads"] == 0
        assert st["proto_trees"] == 1 and st["spec_trees"] == 0
        assert st["fallbacks"] == 0
        if check_weights:
            # roots pruned out of the array go to the loop, and only those
            assert st["proto_weights"] == len(self.eng._index)
            assert st["spec_weights"] == len(store.blocks) - len(self.eng._index)
        proto_array.reset_stats()
        try:
            head_s, tree_s, w_s = read()
        finally:
            proto_array.use_auto()
        st = proto_array.stats()
        assert st["proto_heads"] == st["proto_trees"] == st["proto_weights"] == 0
        assert st["spec_heads"] >= 1
        assert head_p == head_s
        assert set(tree_p) == set(tree_s)
        assert all(tree_p[r] is tree_s[r] for r in tree_p)
        assert w_p == w_s
        return head_p


@pytest.mark.parametrize("seed", [11, 29])
@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_random_tree(packages, fork, seed):
    """Random branching trees and attestation streams."""
    rng = random.Random(seed)
    d = StoreRun(fork)
    branches = [d.g.copy()]
    for _ in range(14):
        action = rng.random()
        if action < 0.55 or len(d.store.blocks) < 3:
            i = rng.randrange(len(branches))
            state = branches[i]
            if rng.random() < 0.4 and len(branches) < 4:
                state = state.copy()
            else:
                branches.pop(i)
            d.block(signed_next(d.j, state, graffiti=bytes([rng.randrange(256)])))
            branches.append(state)
        elif action < 0.85:
            att_state = rng.choice(branches).copy()
            d.attestation(jax_att.get_valid_attestation(d.j, att_state, slot=att_state.slot,
                                                        index=0))
        else:
            d.tick_next()
        d.agree()


def test_boost_and_equivocation(packages):
    """The boost on and off; votes flip the head to the tie-break loser;
    slashing its voters flips it back."""
    d = StoreRun()
    sa, sb = d.g.copy(), d.g.copy()
    a = signed_next(d.j, sa)
    b = signed_next(d.j, sb, graffiti=b"\x42")
    ra = d.block(a)
    assert bytes(d.store.proposer_boost_root) == ra
    d.agree()
    rb = d.block(b)
    d.agree()
    d.tick_next()
    winner = d.agree()
    loser_state, loser = (sa, ra) if winner == rb else (sb, rb)
    att = jax_att.get_valid_attestation(d.j, loser_state)
    d.attestation(att)
    assert d.agree() == loser
    slashing = jax_slashings.get_valid_attester_slashing(d.j, loser_state, slot=att.data.slot)
    d.slashing(slashing)
    assert {int(i) for i in slashing.attestation_1.attesting_indices} \
        <= d.store.equivocating_indices
    assert d.agree() == winner


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_justification_and_pruning(packages, fork):
    """Attested epochs justify and finalize; finalization prunes the
    array to the finalized subtree, the loops keep every block."""
    d = StoreRun(fork)
    state = d.g.copy()
    for epoch in range(4):
        _, blocks, state = jax_att.next_epoch_with_attestations(d.j, state, True, epoch > 0)
        for sb in blocks:
            d.block(sb)
        d.agree(check_weights=epoch % 2 == 0)
    assert int(d.store.finalized_checkpoint.epoch) > 0
    assert len(d.eng._roots) < len(d.store.blocks)
    assert d.eng._parent[0] == -1
    assert d.eng._roots[0] == bytes(d.store.finalized_checkpoint.root)
    proto_array.reset_stats()
    d.agree()


def test_weight_first_read_after_finalization(packages):
    """``get_weight`` as the first engine read after finality: the prune
    in the refresh remaps every index before the lookup; a pruned root
    goes to the loop."""
    d = StoreRun()
    state = d.g.copy()
    proto_array.use_spec()
    try:
        for epoch in range(4):
            _, blocks, state = jax_att.next_epoch_with_attestations(d.j, state, True, epoch > 0)
            for sb in blocks:
                last = d.block(sb)
    finally:
        proto_array.use_auto()
    assert bytes(d.store.finalized_checkpoint.root) != d.anchor_root
    assert d.eng._fin_seen != proto_array._ckpt_key(d.store.finalized_checkpoint)
    proto_array.reset_stats()
    proto_array.use_proto()
    try:
        w_last = int(d.p.get_weight(d.store, last))
        w_anchor = int(d.p.get_weight(d.store, d.anchor_root))
    finally:
        proto_array.use_spec()
    try:
        assert w_last == int(d.p.get_weight(d.store, last))
        assert w_anchor == int(d.p.get_weight(d.store, d.anchor_root))
    finally:
        proto_array.use_auto()
    st = proto_array.stats()
    assert st["prunes"] == 1 and st["proto_weights"] == 1 and st["spec_weights"] == 3
    assert d.anchor_root not in d.eng._index and last in d.eng._index
    d.agree()


def test_engine_fed_while_spec_reads(packages):
    """A store built and driven under ``use_spec()`` still gets an
    engine, which the handlers feed: the loops answer every read, and the
    engine agrees with them once it is asked."""
    d = StoreRun(spec_reads=True)
    state = d.g.copy()
    proto_array.use_spec()
    try:
        block = signed_next(d.j, state)
        root = d.block(block)
        d.attestation(jax_att.get_valid_attestation(d.j, state, slot=block.message.slot))
        proto_array.reset_stats()
        assert bytes(d.p.get_head(d.store)) == root
    finally:
        proto_array.use_auto()
    st = proto_array.stats()
    assert st["proto_heads"] == 0 and st["spec_heads"] == 1 and st["refreshes"] == 0
    assert d.eng._n == len(d.store.blocks) == 2 and d.eng._dirty
    assert d.agree() == root


def test_heldover_delta_survives_node_growth(packages):
    """A delta array left pending at the old node count grows with the
    array instead of failing the next propagation."""
    d = StoreRun()
    state = d.g.copy()
    block = signed_next(d.j, state)
    d.block(block)
    d.attestation(jax_att.get_valid_attestation(d.j, state, slot=block.message.slot))
    d.agree()
    d.eng._get_delta()
    held = d.eng._delta.size
    d.p.on_tick(d.store, d.store.time + 2 * int(d.p.config.SECONDS_PER_SLOT))
    for _ in range(2):
        last = d.block(signed_next(d.j, state), tick=False)
    assert bytes(d.store.proposer_boost_root) == b"\x00" * 32
    assert d.eng._delta.size == held < d.eng._n
    assert d.agree() == last


def test_direct_insertion_falls_back(packages):
    """A block put into ``store.blocks`` by hand: the children index is
    rebuilt, the engine declines (counted) and the loop answers."""
    d = StoreRun()
    state = d.g.copy()
    d.block(signed_next(d.j, state))
    rogue = signed_next(d.j, state)
    root = bytes(jax_ssz.hash_tree_root(rogue.message))
    d.store.blocks[root] = carry(d.p, rogue.message, "BeaconBlock")
    d.store.block_states[root] = carry(d.p, state, "BeaconState")
    d.store.unrealized_justifications[root] = d.store.justified_checkpoint.copy()
    proto_array.reset_stats()
    proto_array.use_proto()
    try:
        head = bytes(d.p.get_head(d.store))
    finally:
        proto_array.use_auto()
    st = proto_array.stats()
    assert st["fallbacks"] > 0 and st["proto_heads"] == 0 and st["spec_heads"] == 1
    assert head == root


def test_attach_store_accel_restored_store(packages):
    """A store rebuilt from another's fields (as a restore would) has no
    engine until ``attach_store_accel``; then the engine, seeded with the
    blocks, the votes and the equivocations, answers the first reads as
    the original store's engine and the loops do."""
    d = StoreRun()
    sa, sb = d.g.copy(), d.g.copy()
    d.block(signed_next(d.j, sa))
    d.block(signed_next(d.j, sb, graffiti=b"\x05"))
    d.tick_next()
    att = jax_att.get_valid_attestation(d.j, sa, slot=1)
    d.attestation(att)
    d.slashing(jax_slashings.get_valid_attester_slashing(d.j, sb, slot=1))
    assert d.store.equivocating_indices and d.store.latest_messages
    head = d.agree()
    weights = {r: int(d.p.get_weight(d.store, r)) for r in d.store.blocks}
    original = d.store
    d.store = dataclasses.replace(original)
    assert getattr(d.store, "_fc_proto", None) is None
    proto_array.attach_store_accel(d.p, d.store)
    d.eng = d.store._fc_proto
    assert d.eng is not original._fc_proto and d.eng._n == len(d.store.blocks)
    assert d.agree() == head
    assert {r: int(d.p.get_weight(d.store, r)) for r in d.store.blocks} == weights


def test_weight_guard_forces_the_spec_loop(packages):
    """An effective balance above ``_WEIGHT_GUARD`` in the justified
    state: the engine raises ``_Fallback`` in its balance pass, every read
    is counted as a fallback and answered by the spec loop, with the
    loop's answer."""
    d = StoreRun()
    sa, sb = d.g.copy(), d.g.copy()
    ra = d.block(signed_next(d.j, sa))
    rb = d.block(signed_next(d.j, sb, graffiti=b"\x07"))
    d.tick_next()
    att = jax_att.get_valid_attestation(d.j, sb, slot=1)
    voter = min(int(i) for i in d.j.get_attesting_indices(sb, att.data, att.aggregation_bits))
    justified = d.store.checkpoint_states[proto_array._ckpt_key(d.store.justified_checkpoint)]
    justified.validators[voter].effective_balance = proto_array._WEIGHT_GUARD + 1
    assert int(state_arrays.of(justified).registry()["eff"].max()) > proto_array._WEIGHT_GUARD
    d.attestation(att)
    proto_array.reset_stats()
    proto_array.use_proto()
    try:
        head = bytes(d.p.get_head(d.store))
        weights = {r: int(d.p.get_weight(d.store, r)) for r in (ra, rb)}
    finally:
        proto_array.use_spec()
    st = proto_array.stats()
    assert st["proto_heads"] == st["proto_weights"] == 0
    assert st["fallbacks"] >= 3 and st["spec_heads"] == 1
    try:
        assert head == bytes(d.p.get_head(d.store)) == rb
        assert weights == {r: int(d.p.get_weight(d.store, r)) for r in (ra, rb)}
    finally:
        proto_array.use_auto()
    assert weights[rb] > proto_array._WEIGHT_GUARD
