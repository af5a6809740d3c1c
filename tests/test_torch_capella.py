"""The PyTorch port's Capella runtime against the JAX package's, minimal
preset, 64 validators.

Values are built by the JAX package (its ``test_infra`` and the
credential, withdrawal and address-change helpers of
``tests/capella/block_processing``) and carried to the port by SSZ;
every comparison is exact (tolerance 0: bytes and integers).  Held
equal: the roots of ``Withdrawal``, ``BLSToExecutionChange``,
``SignedBLSToExecutionChange``, ``HistoricalSummary``,
``ExecutionPayload``, ``ExecutionPayloadHeader``, ``BeaconBlockBody``
and ``BeaconState`` on seeded values; ``upgrade_to_capella``;
``get_expected_withdrawals`` and ``process_withdrawals`` with none, full,
partial, mixed, at the per-payload cap and a sweep that wraps, and a
payload that differs raising in both; ``process_bls_to_execution_change``
valid and with a wrong pubkey hash or credentials; the historical
summaries at and before their boundary epoch; one signed block with
withdrawals and BLS changes through ``state_transition`` on both
packages' python BLS, and a forged BLS-change signature raising in both
and named alone in the port's batch.  The port's column store carries a
Capella state: its columns equal the SSZ lists, and a copy-on-write fork
keeps the new fields and leaves the original's columns alone.
"""
from random import Random

import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import attestations as jax_att
from consensus_specs_tpu.test_infra import block as jax_block
from consensus_specs_tpu.test_infra.execution_payload import build_empty_execution_payload
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.utils import bls, ssz
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.capella.block_processing.test_process_bls_to_execution_change import (
    get_signed_address_change)
from tests.capella.block_processing.test_process_withdrawals import (
    prepare_expected_withdrawals, set_eth1_credentials)
from tests.test_torch_bellatrix import bls_on, carry, jroot, root, sync_aggregate

N_VALIDATORS = 64
FORK = "capella"


@pytest.fixture(scope="module")
def specs():
    """The JAX and port Capella specs; both packages on python BLS, with
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


@pytest.fixture(scope="module")
def genesis(specs):
    """A JAX Capella genesis (its validators' withdrawal keys are their
    own keys) with real sync-committee aggregates, at slot 3."""
    jspec, _ = specs
    with bls_on():
        state = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                     jspec.MAX_EFFECTIVE_BALANCE)
    jspec.process_slots(state, 3)
    return state


def seeded_values(jspec, genesis, seed):
    """{type name: a JAX value} with seeded fields."""
    rng = Random(seed)
    rb = lambda n: bytes(rng.randrange(256) for _ in range(n))  # noqa: E731
    withdrawal = jspec.Withdrawal(index=2**63 + rng.randrange(2**32),
                                  validator_index=rng.randrange(2**40), address=rb(20),
                                  amount=rng.randrange(2**64))
    change = jspec.BLSToExecutionChange(validator_index=rng.randrange(2**20),
                                        from_bls_pubkey=rb(48), to_execution_address=rb(20))
    payload = build_empty_execution_payload(jspec, genesis)
    payload.transactions.append(rb(77))
    payload.base_fee_per_gas = 2**130 + rng.randrange(2**64)
    for k in range(3):
        payload.withdrawals.append(jspec.Withdrawal(index=k, validator_index=k * 7,
                                                    address=rb(20), amount=rng.randrange(2**40)))
    body = jspec.BeaconBlockBody(execution_payload=payload, graffiti=rb(32))
    signed_change = jspec.SignedBLSToExecutionChange(message=change, signature=rb(96))
    for _ in range(3):
        body.bls_to_execution_changes.append(signed_change)
    state = genesis.copy()
    state.latest_execution_payload_header = jspec._payload_to_header(payload)
    state.next_withdrawal_index = rng.randrange(2**64)
    state.next_withdrawal_validator_index = rng.randrange(N_VALIDATORS)
    summary = jspec.HistoricalSummary(block_summary_root=rb(32), state_summary_root=rb(32))
    state.historical_summaries.append(summary)
    return {"Withdrawal": withdrawal, "BLSToExecutionChange": change,
            "SignedBLSToExecutionChange": signed_change, "HistoricalSummary": summary,
            "ExecutionPayload": payload,
            "ExecutionPayloadHeader": jspec._payload_to_header(payload),
            "BeaconBlockBody": body, "BeaconState": state}


@pytest.mark.parametrize("name", ["Withdrawal", "BLSToExecutionChange",
                                  "SignedBLSToExecutionChange", "HistoricalSummary",
                                  "ExecutionPayload", "ExecutionPayloadHeader",
                                  "BeaconBlockBody", "BeaconState"])
def test_container_roots(specs, genesis, name):
    jspec, spec = specs
    value = seeded_values(jspec, genesis, 1)[name]
    got = carry(spec, value, name)
    assert root(got) == jroot(value)
    assert ssz.serialize(got) == jax_ssz.serialize(value)


def test_upgrade_to_capella(specs):
    """A Bellatrix state after the merge, upgraded in both packages: the
    header gains an empty withdrawals root, the cursors start at 0."""
    jspec, spec = specs
    jb = jax_build_spec("bellatrix", "minimal")
    pb = build_spec("bellatrix", "minimal")
    pre = create_genesis_state(jb, [jb.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                               jb.MAX_EFFECTIVE_BALANCE)
    jb.process_slots(pre, jb.SLOTS_PER_EPOCH + 3)
    pre.latest_execution_payload_header.block_number = 12345
    pre.latest_execution_payload_header.extra_data = b"\x07" * 9
    want = jspec.upgrade_to_capella(pre.copy())
    got = spec.upgrade_to_capella(carry(pb, pre, "BeaconState"))
    assert root(got) == jroot(want)
    assert bytes(got.fork.current_version) == bytes(spec.config.CAPELLA_FORK_VERSION)
    assert int(got.latest_execution_payload_header.block_number) == 12345
    assert len(got.historical_summaries) == 0


def _withdrawal_state(jspec, genesis, case):
    """A copy of ``genesis`` prepared for one withdrawal case."""
    state = genesis.copy()
    if case == "full":
        prepare_expected_withdrawals(jspec, state, num_full=2)
    elif case == "partial":
        prepare_expected_withdrawals(jspec, state, num_partial=3)
    elif case in ("mixed", "mismatch"):
        prepare_expected_withdrawals(jspec, state, num_full=1, num_partial=2)
    elif case == "cap":
        prepare_expected_withdrawals(jspec, state, num_full=2, num_partial=5)
    elif case == "wrap":
        state.next_withdrawal_validator_index = N_VALIDATORS - 3
        for i in (N_VALIDATORS - 1, 1, 2):
            set_eth1_credentials(jspec, state, i)
            state.balances[i] = jspec.MAX_EFFECTIVE_BALANCE + 3 * 10**9 + i
        state.next_withdrawal_index = 2**40
    return state


@pytest.mark.parametrize("case", ["none", "full", "partial", "mixed", "cap", "wrap", "mismatch"])
def test_withdrawals(specs, genesis, case):
    jspec, spec = specs
    jstate = _withdrawal_state(jspec, genesis, case)
    state = carry(spec, jstate, "BeaconState")
    want = jspec.get_expected_withdrawals(jstate)
    got = spec.get_expected_withdrawals(state)
    assert [ssz.serialize(w) for w in got] == [jax_ssz.serialize(w) for w in want]
    count = {"none": 0, "full": 2, "partial": 3, "mixed": 3, "mismatch": 3, "cap": 4,
             "wrap": 3}[case]
    assert len(got) == count
    payload = build_empty_execution_payload(jspec, jstate)
    if case == "mismatch":
        payload.withdrawals[1].amount += 1
        with pytest.raises(AssertionError):
            jspec.process_withdrawals(jstate, payload)
        with pytest.raises(AssertionError):
            spec.process_withdrawals(state, carry(spec, payload, "ExecutionPayload"))
        return
    jspec.process_withdrawals(jstate, payload)
    spec.process_withdrawals(state, carry(spec, payload, "ExecutionPayload"))
    assert root(state) == jroot(jstate)
    assert int(state.next_withdrawal_index) == int(jstate.next_withdrawal_index)
    assert int(state.next_withdrawal_validator_index) == \
        int(jstate.next_withdrawal_validator_index)
    if case == "wrap":
        assert int(state.next_withdrawal_validator_index) == \
            (N_VALIDATORS - 3 + spec.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP) % N_VALIDATORS
    if case == "cap":
        assert int(state.next_withdrawal_validator_index) == int(got[-1].validator_index) + 1


@pytest.mark.parametrize("case", ["valid", "wrong_pubkey", "eth1_credentials"])
def test_process_bls_to_execution_change(specs, genesis, case):
    jspec, spec = specs
    jstate = genesis.copy()
    index = 7
    if case == "wrong_pubkey":
        from consensus_specs_tpu.test_infra.keys import pubkeys
        with bls_on():
            change = get_signed_address_change(jspec, jstate, index,
                                               withdrawal_pubkey=pubkeys[index + 1])
    else:
        with bls_on():
            change = get_signed_address_change(jspec, jstate, index,
                                               to_execution_address=b"\x5c" * 20)
    if case == "eth1_credentials":
        set_eth1_credentials(jspec, jstate, index)
    state = carry(spec, jstate, "BeaconState")
    pchange = carry(spec, change, "SignedBLSToExecutionChange")
    with bls_on():
        if case == "valid":
            jspec.process_bls_to_execution_change(jstate, change)
            spec.process_bls_to_execution_change(state, pchange)
            assert root(state) == jroot(jstate)
            assert bytes(state.validators[index].withdrawal_credentials) == \
                b"\x01" + b"\x00" * 11 + b"\x5c" * 20
        else:
            with pytest.raises(AssertionError):
                jspec.process_bls_to_execution_change(jstate, change)
            with pytest.raises(AssertionError):
                spec.process_bls_to_execution_change(state, pchange)


@pytest.mark.parametrize("boundary", [True, False])
def test_historical_summaries_update(specs, genesis, boundary):
    jspec, spec = specs
    jstate = genesis.copy()
    per = jspec.SLOTS_PER_HISTORICAL_ROOT // jspec.SLOTS_PER_EPOCH
    epoch = per - 1 if boundary else per - 2
    jstate.slot = epoch * jspec.SLOTS_PER_EPOCH + 5
    rng = Random(epoch)
    for i in range(jspec.SLOTS_PER_HISTORICAL_ROOT):
        jstate.block_roots[i] = bytes(rng.randrange(256) for _ in range(32))
    state = carry(spec, jstate, "BeaconState")
    jspec.process_historical_summaries_update(jstate)
    spec.process_historical_summaries_update(state)
    assert root(state) == jroot(jstate)
    assert len(state.historical_summaries) == int(boundary)
    with pytest.raises(AttributeError):
        spec.process_historical_roots_update(state)


def _signed_block(jspec, state, forge=None, state_root=None):
    """A signed JAX block for the next slot: three withdrawals, an
    attestation, a sync aggregate and two BLS-to-execution changes
    (``forge``: the index of the change whose signature is forged, the
    block carrying ``state_root``); returns (signed block, JAX pre-state,
    JAX post-state)."""
    post = state.copy()
    prepare_expected_withdrawals(jspec, post, num_full=1, num_partial=2)
    pre = post.copy()
    with bls_on():
        block = jax_block.build_empty_block_for_next_slot(jspec, post)
        block.body.attestations.append(jax_att.get_valid_attestation(
            jspec, post, slot=post.slot, index=0, signed=True))
        for k, index in enumerate((20, 33)):
            block.body.bls_to_execution_changes.append(get_signed_address_change(
                jspec, post, index, to_execution_address=bytes([k + 1]) * 20,
                bad_signature=forge == k))
    nxt = post.copy()
    jspec.process_slots(nxt, block.slot)
    rng = Random(8)
    block.body.sync_aggregate = sync_aggregate(
        jspec, nxt, [rng.random() < 0.8 for _ in range(jspec.SYNC_COMMITTEE_SIZE)])
    assert len(block.body.execution_payload.withdrawals) == 3
    if forge is None:
        jax_block.transition_unsigned_block(jspec, post, block)
        block.state_root = jax_ssz.hash_tree_root(post)
    else:
        block.state_root = state_root
    with bls_on():
        signed = jax_block.sign_block(jspec, pre, block, block.proposer_index)
    return signed, pre, post


def test_signed_block_through_state_transition(specs, genesis):
    """One signed block with withdrawals and BLS changes on both packages'
    python BLS; the same block with a forged BLS-change signature raises
    in both."""
    jspec, spec = specs
    good, pre, jpost = _signed_block(jspec, genesis)
    state = carry(spec, pre, "BeaconState")
    with bls_on():
        jstate = pre.copy()
        jspec.state_transition(jstate, good)
        spec.state_transition(state, carry(spec, good, "SignedBeaconBlock"))
    assert root(state) == jroot(jstate) == jroot(jpost)
    assert int(state.next_withdrawal_index) == 3
    assert [bytes(state.validators[i].withdrawal_credentials[:1]) for i in (20, 33)] == \
        [b"\x01", b"\x01"]

    bad, pre, _ = _signed_block(jspec, genesis, forge=1, state_root=good.message.state_root)
    bls.clear_verify_memo()             # every item of the block enters the batch
    with bls_on():
        with pytest.raises(AssertionError):
            jspec.state_transition(pre.copy(), bad)
        with bls.scoped_batch(bls.DeferredBatch()) as batch:
            with pytest.raises(AssertionError):
                spec.state_transition(carry(spec, pre, "BeaconState"),
                                      carry(spec, bad, "SignedBeaconBlock"))
    # items: the proposer signature, the randao reveal, the attestation,
    # the two changes, the sync aggregate
    assert [i for i, ok in enumerate(batch.last_results) if not ok] == [4]


def test_state_columns_carry_the_capella_state(specs, genesis):
    """The column store on a Capella state: the registry, balance, score
    and flag columns equal the SSZ lists; a copy-on-write fork keeps the
    new fields and the root, and a balance written in the fork leaves the
    original's column alone."""
    import numpy as np
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    jspec, spec = specs
    jstate = seeded_values(jspec, genesis, 9)["BeaconState"]
    rng = Random(9)
    for i in range(N_VALIDATORS):
        jstate.balances[i] = rng.randrange(2**40)
        jstate.inactivity_scores[i] = rng.randrange(2**20)
        jstate.previous_epoch_participation[i] = rng.randint(0, 7)
    state = carry(spec, jstate, "BeaconState")
    store = state_arrays.of(state)
    assert store.balances().tolist() == [int(b) for b in jstate.balances]
    assert store.column("inactivity_scores").tolist() == \
        [int(x) for x in jstate.inactivity_scores]
    assert store.participation("previous").tolist() == \
        [int(x) for x in jstate.previous_epoch_participation]
    reg = store.registry()
    assert reg["eff"].tolist() == [int(v.effective_balance) for v in jstate.validators]
    assert reg["wd"].tolist() == [int(v.withdrawable_epoch) for v in jstate.validators]
    fork = state_arrays.fork_state(state)
    assert root(fork) == root(state) == jroot(jstate)
    assert int(fork.next_withdrawal_index) == int(jstate.next_withdrawal_index)
    before = store.balances().copy()
    spec.decrease_balance(fork, 3, 5)
    assert int(fork.balances[3]) == int(jstate.balances[3]) - 5
    assert np.array_equal(state_arrays.of(state).balances(), before)
    assert root(state) == jroot(jstate)
