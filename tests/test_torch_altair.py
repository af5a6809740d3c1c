"""The PyTorch port's Altair runtime against the JAX package's, minimal
preset, 64 validators.

Values are built by the JAX package (its ``test_infra``) and carried to
the port by SSZ; every comparison is exact (tolerance 0: bytes and
integers).  Held equal: the roots of ``BeaconState``, ``BeaconBlockBody``,
``SyncAggregate`` and ``SyncCommittee`` on seeded values;
``upgrade_to_altair`` of a phase0 state with pending attestations (its
``translate_participation`` writes the flags packed);
``get_next_sync_committee``; ``process_sync_aggregate`` with every bit,
a seeded subset, and no bit with the infinity signature;
``process_attestation``'s flags and proposer reward; one signed block
through ``state_transition`` on both packages' python BLS, and a block
with a wrong sync signature raising in both.  The port's first-occurrence
pubkey map equals ``list.index`` on a registry with repeated keys, and
the packed list construction equals the element-by-element one.
"""
from random import Random

import numpy as np
import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import attestations as jax_att
from consensus_specs_tpu.test_infra import block as jax_block
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.test_infra.sync_committee import (
    compute_aggregate_sync_committee_signature, compute_committee_indices)
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.utils import bls, ssz
from consensus_specs_tpu_torch.utils.ssz import (
    List, basic_sequence_from_column, replace_basic_items, uint8, uint64)
from tests._torch_port import one_torch_thread  # noqa: F401

N_VALIDATORS = 64


@pytest.fixture(scope="module")
def specs():
    """The JAX and port Altair specs; both packages on python BLS, with
    verification off unless a test turns it on."""
    mesh_state.use_fallback()
    jax_backend = jax_bls.backend_name()
    jax_bls.use_py()
    bls.use_py()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    jek.use_vectorized()
    ek.use_loops()
    yield jax_build_spec("altair", "minimal"), build_spec("altair", "minimal")
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    getattr(jax_bls, f"use_{jax_backend}", jax_bls.use_py)()
    jek.use_auto()
    ek.use_auto()
    mesh_state.use_auto()


class bls_on:
    """Signature checks on in both packages for the enclosed block."""

    def __enter__(self):
        jax_bls.bls_active = bls.bls_active = True

    def __exit__(self, *exc):
        jax_bls.bls_active = bls.bls_active = False


def carry(spec, jax_value, name):
    return ssz.deserialize(getattr(spec, name), jax_ssz.serialize(jax_value))


def root(value) -> bytes:
    return bytes(ssz.hash_tree_root(value))


def jroot(value) -> bytes:
    return bytes(jax_ssz.hash_tree_root(value))


@pytest.fixture(scope="module")
def genesis(specs):
    """A JAX Altair genesis with real sync-committee aggregates, advanced
    to slot 3."""
    jspec, _ = specs
    with bls_on():
        state = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                     jspec.MAX_EFFECTIVE_BALANCE)
    jspec.process_slots(state, 3)
    return state


def scattered(jspec, state, seed):
    """A copy with seeded participation flags and inactivity scores."""
    s = state.copy()
    rng = Random(seed)
    for i in range(len(s.validators)):
        s.previous_epoch_participation[i] = rng.randint(0, 7)
        s.current_epoch_participation[i] = rng.randint(0, 7)
        s.inactivity_scores[i] = rng.randint(0, 40)
    return s


def sync_aggregate(jspec, state, bits):
    """A JAX ``SyncAggregate`` of the current committee's members whose
    ``bits`` are set, signing the previous slot's block root."""
    committee = compute_committee_indices(state)
    participants = [v for v, b in zip(committee, bits) if b]
    with bls_on():
        sig = compute_aggregate_sync_committee_signature(
            jspec, state, state.slot - 1, participants,
            block_root=jspec.get_block_root_at_slot(state, state.slot - 1))
    return jspec.SyncAggregate(sync_committee_bits=bits, sync_committee_signature=sig)


@pytest.mark.parametrize("name", ["BeaconState", "BeaconBlockBody", "SyncAggregate",
                                  "SyncCommittee"])
def test_container_roots(specs, genesis, name):
    jspec, spec = specs
    if name == "BeaconState":
        value = scattered(jspec, genesis, 1)
    elif name == "SyncCommittee":
        value = genesis.current_sync_committee
    else:
        rng = Random(2)
        value = sync_aggregate(jspec, genesis, [rng.random() < 0.7
                                                for _ in range(jspec.SYNC_COMMITTEE_SIZE)])
        if name == "BeaconBlockBody":
            block = jax_block.build_empty_block_for_next_slot(jspec, genesis.copy())
            block.body.sync_aggregate = value
            block.body.graffiti = b"\x5a" * 32
            value = block.body
    got = carry(spec, value, name)
    assert root(got) == jroot(value)
    assert ssz.serialize(got) == jax_ssz.serialize(value)


def test_upgrade_to_altair(specs):
    """A phase0 state with pending attestations of both epochs (one
    previous-epoch attestation with a wrong head root), upgraded in both
    packages with real sync-committee aggregates."""
    jspec, spec = specs
    j0 = jax_build_spec("phase0", "minimal")
    p0 = build_spec("phase0", "minimal")
    pre = create_genesis_state(j0, [j0.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                               j0.MAX_EFFECTIVE_BALANCE)
    jax_block.next_epoch(j0, pre)
    _, _, pre = jax_att.next_epoch_with_attestations(j0, pre, True, False)
    _, _, pre = jax_att.next_epoch_with_attestations(j0, pre, True, True)
    pre.previous_epoch_attestations[0].data.beacon_block_root = b"\x33" * 32
    assert len(pre.previous_epoch_attestations) > 0
    with bls_on():
        want = jspec.upgrade_to_altair(pre.copy())
        got = spec.upgrade_to_altair(carry(p0, pre, "BeaconState"))
    assert root(got) == jroot(want)
    flags = list(got.previous_epoch_participation)
    assert flags == [int(f) for f in want.previous_epoch_participation]
    assert {3, 7} <= set(flags)             # the wrong head root earns no head flag
    assert bytes(got.fork.current_version) == bytes(spec.config.ALTAIR_FORK_VERSION)


def test_get_next_sync_committee(specs, genesis):
    jspec, spec = specs
    state = genesis.copy()
    jspec.process_slots(state, jspec.SLOTS_PER_EPOCH + 1)
    port = carry(spec, state, "BeaconState")
    assert spec.get_next_sync_committee_indices(port) == \
        [int(i) for i in jspec.get_next_sync_committee_indices(state)]
    with bls_on():
        want = jspec.get_next_sync_committee(state)
        got = spec.get_next_sync_committee(port)
    assert root(got) == jroot(want)


@pytest.mark.parametrize("case", ["all", "subset", "none"])
def test_process_sync_aggregate(specs, genesis, case):
    jspec, spec = specs
    size = jspec.SYNC_COMMITTEE_SIZE
    if case == "all":
        bits = [True] * size
    elif case == "subset":
        rng = Random(3)
        bits = [rng.random() < 0.6 for _ in range(size)]
    else:
        bits = [False] * size
    agg = sync_aggregate(jspec, genesis, bits)
    if case == "none":
        assert bytes(agg.sync_committee_signature) == bytes(spec.G2_POINT_AT_INFINITY)
    want = genesis.copy()
    state = carry(spec, genesis, "BeaconState")
    with bls_on():
        jspec.process_sync_aggregate(want, agg)
        spec.process_sync_aggregate(state, carry(spec, agg, "SyncAggregate"))
    assert root(state) == jroot(want)
    assert list(state.balances) != list(carry(spec, genesis, "BeaconState").balances)


def test_process_attestation_flags_and_proposer_reward(specs, genesis):
    jspec, spec = specs
    jstate = genesis.copy()
    jspec.process_slots(jstate, jspec.SLOTS_PER_EPOCH + 2)
    atts = [jax_att.get_valid_attestation(jspec, jstate, slot=jstate.slot - d, index=0)
            for d in (1, 2)]
    state = carry(spec, jstate, "BeaconState")
    proposer = int(jspec.get_beacon_proposer_index(jstate))
    before = int(jstate.balances[proposer])
    for att in atts:
        jspec.process_attestation(jstate, att)
        spec.process_attestation(state, carry(spec, att, "Attestation"))
    assert root(state) == jroot(jstate)
    assert list(state.current_epoch_participation) == \
        [int(f) for f in jstate.current_epoch_participation]
    assert int(state.balances[proposer]) == int(jstate.balances[proposer]) > before
    # the delay-1 attestation earned the head flag, the delay-2 one did not
    flags = set(int(f) for f in jstate.current_epoch_participation)
    assert 7 in flags and 3 in flags


def _signed_block(jspec, state, sync_bits, forge_sync=False):
    """A signed JAX block for the next slot with an attestation and a sync
    aggregate; returns (signed block, JAX post-state)."""
    post = state.copy()
    with bls_on():
        block = jax_block.build_empty_block_for_next_slot(jspec, post)
        block.body.attestations.append(jax_att.get_valid_attestation(
            jspec, post, slot=post.slot, index=0, signed=True))
    nxt = post.copy()
    jspec.process_slots(nxt, block.slot)
    agg = sync_aggregate(jspec, nxt, sync_bits)
    if forge_sync:
        agg.sync_committee_signature = block.body.attestations[0].signature
    block.body.sync_aggregate = agg
    jax_block.transition_unsigned_block(jspec, post, block)
    block.state_root = jax_ssz.hash_tree_root(post)
    with bls_on():
        signed = jax_block.sign_block(jspec, post, block, block.proposer_index)
    return signed, post


def test_signed_block_through_state_transition(specs, genesis):
    """One signed block on both packages' python BLS; a wrong sync
    signature raises in both."""
    jspec, spec = specs
    rng = Random(4)
    bits = [rng.random() < 0.8 for _ in range(jspec.SYNC_COMMITTEE_SIZE)]
    good, jpost = _signed_block(jspec, genesis, bits)
    state = carry(spec, genesis, "BeaconState")
    with bls_on():
        jstate = genesis.copy()
        jspec.state_transition(jstate, good)
        spec.state_transition(state, carry(spec, good, "SignedBeaconBlock"))
    assert root(state) == jroot(jstate) == jroot(jpost)

    bad, _ = _signed_block(jspec, genesis, bits, forge_sync=True)
    with bls_on():
        with pytest.raises(AssertionError):
            jspec.state_transition(genesis.copy(), bad)
        with pytest.raises(AssertionError):
            spec.state_transition(carry(spec, genesis, "BeaconState"),
                                  carry(spec, bad, "SignedBeaconBlock"))


def test_pubkey_map_is_list_index_with_repeated_keys(specs, genesis):
    """A registry whose keys repeat: the first-occurrence map gives what
    the spec's ``list.index`` gives, and ``process_sync_aggregate`` pays
    the same members as the JAX package's linear search."""
    jspec, spec = specs
    jstate = genesis.copy()
    for i in range(N_VALIDATORS // 2, N_VALIDATORS):
        jstate.validators[i].pubkey = jstate.validators[i % 7].pubkey
    # a committee drawn from the new registry (so every member's key is in
    # it, some more than once)
    jstate.current_sync_committee = jspec.get_next_sync_committee(jstate)
    state = carry(spec, jstate, "BeaconState")
    first = spec.registry_pubkey_indices(state)
    pubkeys = [bytes(v.pubkey) for v in state.validators]
    for pk in pubkeys + [bytes(p) for p in state.current_sync_committee.pubkeys]:
        assert first[pk] == pubkeys.index(pk)
    assert len(first) == len(set(pubkeys)) < N_VALIDATORS
    rng = Random(5)
    agg = jspec.SyncAggregate(
        sync_committee_bits=[rng.random() < 0.5 for _ in range(jspec.SYNC_COMMITTEE_SIZE)])
    jspec.process_sync_aggregate(jstate, agg)
    spec.process_sync_aggregate(state, carry(spec, agg, "SyncAggregate"))
    assert root(state) == jroot(jstate)


@pytest.mark.parametrize("elem", [uint8, uint64])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000])
def test_packed_list_equals_the_elementwise_list(elem, n):
    typ = List[elem, 2**40]
    col = np.random.default_rng(n).integers(0, 256, n).astype(np.uint64)
    want = typ([int(x) for x in col])
    got = basic_sequence_from_column(typ, col)
    assert root(got) == root(want) and ssz.serialize(got) == ssz.serialize(want)
    assert list(got) == list(want)
    # replace_basic_items with the packed bytes of a uint8 list, then a
    # per-index write on top of the packed tree
    seq = typ([0] * n)
    replace_basic_items(seq, [elem(int(x)) for x in col],
                        packed=col.astype(f"<u{elem.byte_length}").tobytes())
    assert root(seq) == root(want)
    if n:
        seq[n - 1] = 7
        want[n - 1] = 7
        assert root(seq) == root(want)


def test_columnar_decode_equals_the_jax_package(specs, genesis):
    """The port decodes lists of uint8-uint64 and of fixed-size
    containers column by column: a registry with every field edge
    (FAR_FUTURE_EPOCH, slashed, uint64 values above 2^63) and the Altair
    lists round-trip to the JAX package's bytes and roots; a boolean byte
    other than 0 or 1 is refused."""
    jspec, spec = specs
    jstate = scattered(jspec, genesis, 6)
    jstate.validators[5].slashed = True
    jstate.validators[6].exit_epoch = 2**64 - 1
    jstate.validators[7].effective_balance = 2**63 + 5
    jstate.balances[8] = 2**64 - 1
    jstate.inactivity_scores[9] = 2**63
    for name in ("validators", "balances", "inactivity_scores",
                 "previous_epoch_participation", "randao_mixes"):
        jvalue = getattr(jstate, name)
        got = ssz.deserialize(type(getattr(spec.BeaconState(), name)),
                              jax_ssz.serialize(jvalue))
        assert ssz.serialize(got) == jax_ssz.serialize(jvalue)
        assert root(got) == jroot(jvalue)
    state = carry(spec, jstate, "BeaconState")
    assert bool(state.validators[5].slashed) and int(state.balances[8]) == 2**64 - 1
    raw = bytearray(ssz.serialize(state.validators[5]))
    raw[80 + 8] = 2                                     # the slashed byte
    with pytest.raises(ValueError):
        ssz.deserialize(type(state.validators), bytes(raw))
