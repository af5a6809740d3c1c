"""The PyTorch port's Bellatrix runtime against the JAX package's, minimal
preset, 64 validators.

Values are built by the JAX package (its ``test_infra``:
``execution_payload.build_empty_execution_payload``, the block and
attestation helpers) and carried to the port by SSZ; every comparison
is exact (tolerance 0: bytes and integers).  Held equal: the preset
files both packages load; the roots of ``ExecutionPayload``,
``ExecutionPayloadHeader``, ``PowBlock``, ``BeaconBlockBody`` and
``BeaconState`` on seeded values; ``upgrade_to_bellatrix``; the merge
predicates on an empty and a non-empty header; ``process_execution_payload``
and its three rejections; the terminal PoW block checks;
``slash_validator``, ``process_slashings`` and the inactivity penalty
deltas of the spec loops; the optimistic-sync store; one signed block
through ``state_transition`` on both packages' python BLS, and a block
with a wrong ``prev_randao`` raising in both.
"""
from random import Random

import pytest

from consensus_specs_tpu.config import load_preset as jax_load_preset
from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import attestations as jax_att
from consensus_specs_tpu.test_infra import block as jax_block
from consensus_specs_tpu.test_infra.execution_payload import build_empty_execution_payload
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.test_infra.sync_committee import (
    compute_aggregate_sync_committee_signature, compute_committee_indices)
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.config import loader
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.utils import bls, ssz
from tests._torch_port import one_torch_thread  # noqa: F401

N_VALIDATORS = 64
FORK = "bellatrix"


@pytest.fixture(scope="module")
def specs():
    """The JAX and port Bellatrix specs; both packages on python BLS, with
    verification off unless a test turns it on; the spec loops."""
    mesh_state.use_fallback()
    jax_backend = jax_bls.backend_name()
    jax_bls.use_py()
    bls.use_py()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    jek.use_vectorized()
    ek.use_loops()
    yield jax_build_spec(FORK, "minimal"), build_spec(FORK, "minimal")
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
    """A JAX Bellatrix genesis after the merge (the harness's non-empty
    payload header) with real sync-committee aggregates, at slot 3."""
    jspec, _ = specs
    with bls_on():
        state = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                     jspec.MAX_EFFECTIVE_BALANCE)
    jspec.process_slots(state, 3)
    return state


def seeded_payload(jspec, state, seed):
    """A payload valid against ``state`` with seeded transactions, extra
    data, fee recipient and a base fee above 2^64."""
    rng = Random(seed)
    payload = build_empty_execution_payload(jspec, state)
    payload.fee_recipient = bytes(rng.randrange(256) for _ in range(20))
    payload.extra_data = bytes(rng.randrange(256) for _ in range(rng.randint(1, 32)))
    payload.base_fee_per_gas = 2**200 + rng.randrange(2**64)
    payload.gas_used = rng.randrange(2**30)
    for n in (1, 17, 300):
        payload.transactions.append(bytes(rng.randrange(256) for _ in range(n)))
    return payload


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
def test_presets_and_specs(specs, preset):
    """The port loads the preset files of the forks it carries: every key
    equals the JAX package's, the phase0 and Altair keys keep their
    values, and Bellatrix and Capella specs build."""
    port = loader.load_preset(preset)
    want = jax_load_preset(preset, forks=list(loader.FORKS))
    assert port == want
    old = jax_load_preset(preset, forks=["phase0", "altair"])
    assert {k: port[k] for k in old} == old
    altair = build_spec("altair", preset)
    for k, v in old.items():
        assert getattr(altair, k) == v
    for fork in ("bellatrix", "capella"):
        spec = build_spec(fork, preset)
        assert spec.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX == 2**24
        assert spec.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX == 3
        assert bytes(spec.config.BELLATRIX_FORK_VERSION) == \
            bytes(jax_build_spec(fork, preset).config.BELLATRIX_FORK_VERSION)


@pytest.mark.parametrize("name", ["ExecutionPayload", "ExecutionPayloadHeader", "PowBlock",
                                  "BeaconBlockBody", "BeaconState"])
def test_container_roots(specs, genesis, name):
    jspec, spec = specs
    payload = seeded_payload(jspec, genesis, 1)
    if name == "ExecutionPayload":
        value = payload
    elif name == "ExecutionPayloadHeader":
        value = jspec._payload_to_header(payload)
    elif name == "PowBlock":
        value = jspec.PowBlock(block_hash=b"\x11" * 32, parent_hash=b"\x22" * 32,
                               total_difficulty=2**255 + 12345)
    elif name == "BeaconBlockBody":
        block = jax_block.build_empty_block_for_next_slot(jspec, genesis.copy())
        block.body.execution_payload = payload
        block.body.graffiti = b"\x5a" * 32
        value = block.body
    else:
        value = genesis.copy()
        value.latest_execution_payload_header = jspec._payload_to_header(payload)
    got = carry(spec, value, name)
    assert root(got) == jroot(value)
    assert ssz.serialize(got) == jax_ssz.serialize(value)
    if name == "ExecutionPayloadHeader":
        assert root(spec._payload_to_header(carry(spec, payload, "ExecutionPayload"))) == \
            jroot(value)


def test_upgrade_to_bellatrix(specs):
    """An Altair state with scattered flags and scores, upgraded in both
    packages: the header starts empty, the fork moves on."""
    jspec, spec = specs
    ja = jax_build_spec("altair", "minimal")
    pa = build_spec("altair", "minimal")
    pre = create_genesis_state(ja, [ja.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                               ja.MAX_EFFECTIVE_BALANCE)
    ja.process_slots(pre, ja.SLOTS_PER_EPOCH + 3)
    rng = Random(2)
    for i in range(N_VALIDATORS):
        pre.previous_epoch_participation[i] = rng.randint(0, 7)
        pre.inactivity_scores[i] = rng.randint(0, 99)
    want = jspec.upgrade_to_bellatrix(pre.copy())
    got = spec.upgrade_to_bellatrix(carry(pa, pre, "BeaconState"))
    assert root(got) == jroot(want)
    assert bytes(got.fork.current_version) == bytes(spec.config.BELLATRIX_FORK_VERSION)
    assert bytes(got.fork.previous_version) == bytes(spec.config.ALTAIR_FORK_VERSION)
    assert not spec.is_merge_transition_complete(got)


@pytest.mark.parametrize("header", ["empty", "default"])
@pytest.mark.parametrize("payload", ["empty", "seeded"])
def test_merge_predicates(specs, genesis, header, payload):
    jspec, spec = specs
    jstate = genesis.copy()
    if header == "empty":
        jstate.latest_execution_payload_header = jspec.ExecutionPayloadHeader()
    body = jspec.BeaconBlockBody()
    if payload == "seeded":
        body.execution_payload = seeded_payload(jspec, genesis, 3)
    state, pbody = carry(spec, jstate, "BeaconState"), carry(spec, body, "BeaconBlockBody")
    for name in ("is_merge_transition_complete",):
        assert getattr(spec, name)(state) == bool(getattr(jspec, name)(jstate))
    for name in ("is_merge_transition_block", "is_execution_enabled"):
        assert getattr(spec, name)(state, pbody) == bool(getattr(jspec, name)(jstate, body))
    assert spec.is_merge_transition_complete(state) == (header == "default")
    assert spec.is_merge_transition_block(state, pbody) == \
        (header == "empty" and payload == "seeded")


@pytest.mark.parametrize("case", ["valid", "merge", "parent_hash", "prev_randao", "timestamp"])
def test_process_execution_payload(specs, genesis, case):
    """A valid payload caches the same header; a merge block's payload
    skips the parent check; a wrong parent hash, randao mix or timestamp
    raises in both."""
    jspec, spec = specs
    jstate = genesis.copy()
    if case == "merge":
        jstate.latest_execution_payload_header = jspec.ExecutionPayloadHeader()
    payload = seeded_payload(jspec, jstate, 4)
    if case == "merge":
        payload.parent_hash = b"\x77" * 32
    elif case == "parent_hash":
        payload.parent_hash = b"\x01" * 32
    elif case == "prev_randao":
        payload.prev_randao = b"\x02" * 32
    elif case == "timestamp":
        payload.timestamp = int(payload.timestamp) + 1
    body = jspec.BeaconBlockBody(execution_payload=payload)
    state = carry(spec, jstate, "BeaconState")
    pbody = carry(spec, body, "BeaconBlockBody")
    if case in ("valid", "merge"):
        jspec.process_execution_payload(jstate, body, jspec.EXECUTION_ENGINE)
        spec.process_execution_payload(state, pbody, spec.EXECUTION_ENGINE)
        assert root(state) == jroot(jstate)
        assert root(state.latest_execution_payload_header) == \
            root(spec._payload_to_header(pbody.execution_payload))
    else:
        with pytest.raises(AssertionError):
            jspec.process_execution_payload(jstate, body, jspec.EXECUTION_ENGINE)
        with pytest.raises(AssertionError):
            spec.process_execution_payload(state, pbody, spec.EXECUTION_ENGINE)


def test_terminal_pow_block_and_timestamps(specs, genesis):
    jspec, spec = specs
    ttd = int(spec.config.TERMINAL_TOTAL_DIFFICULTY)
    assert ttd == int(jspec.config.TERMINAL_TOTAL_DIFFICULTY)
    for block_td in (ttd - 1, ttd, ttd + 1):
        for parent_td in (ttd - 1, ttd, 0):
            jb, jp = (jspec.PowBlock(total_difficulty=t) for t in (block_td, parent_td))
            pb, pp = (spec.PowBlock(total_difficulty=t) for t in (block_td, parent_td))
            assert spec.is_valid_terminal_pow_block(pb, pp) == \
                bool(jspec.is_valid_terminal_pow_block(jb, jp))
    assert root(spec.get_pow_block(b"\x05" * 32)) == jroot(jspec.get_pow_block(b"\x05" * 32))
    state = carry(spec, genesis, "BeaconState")
    for slot in (0, 1, 3, 1000):
        assert int(spec.compute_timestamp_at_slot(state, slot)) == \
            int(jspec.compute_timestamp_at_slot(genesis, slot))
    # the stub's PoW blocks carry no difficulty: a merge block fails in both
    block = jspec.BeaconBlock(slot=4)
    block.body.execution_payload.parent_hash = b"\x09" * 32
    with pytest.raises(AssertionError):
        jspec.validate_merge_block(block)
    with pytest.raises(AssertionError):
        spec.validate_merge_block(carry(spec, block, "BeaconBlock"))


def test_slash_validator_and_spec_loops(specs, genesis):
    """Bellatrix's slashing quotient in ``slash_validator``, its multiplier
    in ``process_slashings`` and its inactivity quotient in the penalty
    deltas, on the spec loops of both packages."""
    jspec, spec = specs
    jstate = genesis.copy()
    rng = Random(5)
    for i in range(N_VALIDATORS):
        jstate.previous_epoch_participation[i] = rng.randint(0, 7)
        jstate.inactivity_scores[i] = rng.randint(0, 5000)
    state = carry(spec, jstate, "BeaconState")
    for index, whistleblower in ((5, None), (9, 11)):
        jspec.slash_validator(jstate, index, whistleblower)
        spec.slash_validator(state, index, whistleblower)
    assert root(state) == jroot(jstate)
    # the epoch at which the two slashed validators' penalties fall due,
    # with slashings at which multipliers 3 and 2 give different penalties
    due = int(jstate.validators[5].withdrawable_epoch) - jspec.EPOCHS_PER_SLASHINGS_VECTOR // 2
    jstate.slot = due * jspec.SLOTS_PER_EPOCH
    jstate.slashings[0] = 200 * jspec.EFFECTIVE_BALANCE_INCREMENT
    state = carry(spec, jstate, "BeaconState")
    j_deltas = jspec.get_inactivity_penalty_deltas(jstate)
    deltas = spec.get_inactivity_penalty_deltas(state)
    assert [[int(x) for x in d] for d in deltas] == [[int(x) for x in d] for d in j_deltas]
    assert any(deltas[1])
    before = int(state.balances[5])
    jspec.process_slashings(jstate)
    spec.process_slashings(state)
    assert root(state) == jroot(jstate)
    total = int(spec.get_total_active_balance(state))
    inc = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    eff = int(state.validators[5].effective_balance)
    penalty = eff // inc * min(200 * inc * 3, total) // total * inc
    assert penalty != eff // inc * min(200 * inc * 2, total) // total * inc
    assert before - int(state.balances[5]) == penalty


def test_optimistic_store(specs, genesis):
    """The optimistic-sync store of both packages on a chain of four
    blocks: imports, a VALID verdict up the chain, an INVALIDATED subtree
    dropped."""
    jspec, spec = specs
    jstate = genesis.copy()
    anchor = jspec.BeaconBlock(slot=jstate.slot, state_root=jax_ssz.hash_tree_root(jstate))
    chain = [anchor]
    for k in range(4):
        blk = jspec.BeaconBlock(slot=int(jstate.slot) + 1 + k,
                                parent_root=jax_ssz.hash_tree_root(chain[-1]))
        if k == 1:
            blk.body.execution_payload = seeded_payload(jspec, genesis, 6)
        chain.append(blk)
    port_chain = [carry(spec, b, "BeaconBlock") for b in chain]
    stores = (jspec.get_optimistic_store(jstate, anchor),
              spec.get_optimistic_store(carry(spec, jstate, "BeaconState"), port_chain[0]))

    def same():
        js, ps = stores
        assert {bytes(r) for r in js.optimistic_roots} == ps.optimistic_roots
        assert set(js.blocks) == set(ps.blocks)

    for jb, pb in zip(chain[1:], port_chain[1:]):
        assert spec.is_optimistic_candidate_block(stores[1], pb.slot, pb) == \
            bool(jspec.is_optimistic_candidate_block(stores[0], jb.slot, jb))
        jspec.import_optimistic_block(stores[0], jb)
        spec.import_optimistic_block(stores[1], pb)
        same()
    assert root(spec.latest_verified_ancestor(stores[1], port_chain[-1])) == \
        jroot(jspec.latest_verified_ancestor(stores[0], chain[-1]))
    for k, valid in ((2, True), (3, False)):
        jspec.on_payload_status(stores[0], jax_ssz.hash_tree_root(chain[k]), valid)
        spec.on_payload_status(stores[1], ssz.hash_tree_root(port_chain[k]), valid)
        same()
    assert len(stores[1].blocks) == 3 and not stores[1].optimistic_roots


def sync_aggregate(jspec, state, bits):
    committee = compute_committee_indices(state)
    participants = [v for v, b in zip(committee, bits) if b]
    with bls_on():
        sig = compute_aggregate_sync_committee_signature(
            jspec, state, state.slot - 1, participants,
            block_root=jspec.get_block_root_at_slot(state, state.slot - 1))
    return jspec.SyncAggregate(sync_committee_bits=bits, sync_committee_signature=sig)


def _signed_block(jspec, state, bad_randao=False):
    """A signed JAX block for the next slot with an attestation, a sync
    aggregate and a payload; returns (signed block, JAX post-state)."""
    post = state.copy()
    with bls_on():
        block = jax_block.build_empty_block_for_next_slot(jspec, post)
        block.body.attestations.append(jax_att.get_valid_attestation(
            jspec, post, slot=post.slot, index=0, signed=True))
    nxt = post.copy()
    jspec.process_slots(nxt, block.slot)
    rng = Random(7)
    block.body.sync_aggregate = sync_aggregate(
        jspec, nxt, [rng.random() < 0.8 for _ in range(jspec.SYNC_COMMITTEE_SIZE)])
    block.body.execution_payload.gas_used = 21000
    block.body.execution_payload.transactions.append(b"\x02" + b"\xab" * 99)
    if bad_randao:
        block.body.execution_payload.prev_randao = b"\x03" * 32
        block.state_root = b"\x00" * 32
    else:
        jax_block.transition_unsigned_block(jspec, post, block)
        block.state_root = jax_ssz.hash_tree_root(post)
    with bls_on():
        signed = jax_block.sign_block(jspec, state, block, block.proposer_index)
    return signed, post


def test_signed_block_through_state_transition(specs, genesis):
    """One signed block on both packages' python BLS; a payload with a
    wrong randao mix raises in both."""
    jspec, spec = specs
    good, jpost = _signed_block(jspec, genesis)
    state = carry(spec, genesis, "BeaconState")
    with bls_on():
        jstate = genesis.copy()
        jspec.state_transition(jstate, good)
        spec.state_transition(state, carry(spec, good, "SignedBeaconBlock"))
    assert root(state) == jroot(jstate) == jroot(jpost)
    assert root(state.latest_execution_payload_header) == \
        jroot(jspec._payload_to_header(good.message.body.execution_payload))

    bad, _ = _signed_block(jspec, genesis, bad_randao=True)
    with bls_on():
        with pytest.raises(AssertionError):
            jspec.state_transition(genesis.copy(), bad)
        with pytest.raises(AssertionError):
            spec.state_transition(carry(spec, genesis, "BeaconState"),
                                  carry(spec, bad, "SignedBeaconBlock"))
