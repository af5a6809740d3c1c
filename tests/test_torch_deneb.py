"""The PyTorch port's Deneb runtime against the JAX package's, minimal
preset, 64 validators (the EIP-7045 inclusion window on mainnet's
32-slot epochs).

Values are built by the JAX package (its ``test_infra``, with
``execution_payload.get_sample_opaque_tx`` for blob transactions and
commitments) and carried to the port by SSZ; every comparison is exact
(tolerance 0: bytes and integers).  Held equal: the roots of
``ExecutionPayload``, ``ExecutionPayloadHeader``, ``BeaconBlockBody``,
``BlobSidecar``, ``BlobIdentifier`` and ``BeaconState`` on seeded values;
``upgrade_to_deneb``; ``kzg_commitment_to_versioned_hash``; the EIP-7045
flags and ``process_attestation`` at inclusion delays 1, 5, 32, 33 and
40 (33 and 40 rejected by both Capella specs, accepted by both Deneb
specs); ``process_execution_payload`` with 0, 1 and 6 commitments (7
raising in both) and the versioned hashes and parent root the engine
receives; EIP-7044's exit domain (the Capella domain passes, the Deneb
domain raises, in both); one signed block with blob commitments through
``state_transition`` on both packages' python BLS.
"""
import hashlib
from random import Random

import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import attestations as jax_att
from consensus_specs_tpu.test_infra import block as jax_block
from consensus_specs_tpu.test_infra.execution_payload import (
    build_empty_execution_payload, get_sample_opaque_tx)
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.test_infra.keys import privkeys
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.utils import bls, ssz
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_torch_bellatrix import bls_on, carry, jroot, root, sync_aggregate

N_VALIDATORS = 64
FORK = "deneb"
DELAYS = (1, 5, 32, 33, 40)


@pytest.fixture(scope="module")
def specs():
    """The JAX and port Deneb specs; both packages on python BLS, with
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
    """A JAX Deneb genesis with real sync-committee aggregates, at slot 3."""
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
    payload = build_empty_execution_payload(jspec, genesis)
    payload.transactions.append(rb(77))
    payload.base_fee_per_gas = 2**130 + rng.randrange(2**64)
    payload.blob_gas_used = rng.randrange(2**64)
    payload.excess_blob_gas = rng.randrange(2**64)
    payload.withdrawals.append(jspec.Withdrawal(index=5, validator_index=9, address=rb(20),
                                                amount=rng.randrange(2**40)))
    body = jspec.BeaconBlockBody(execution_payload=payload, graffiti=rb(32))
    for _ in range(4):
        body.blob_kzg_commitments.append(rb(48))
    header = jspec.BeaconBlockHeader(slot=rng.randrange(2**40), proposer_index=rng.randrange(64),
                                     parent_root=rb(32), state_root=rb(32), body_root=rb(32))
    sidecar = jspec.BlobSidecar(
        index=rng.randrange(6), blob=rb(jspec.BYTES_PER_BLOB), kzg_commitment=rb(48),
        kzg_proof=rb(48),
        signed_block_header=jspec.SignedBeaconBlockHeader(message=header, signature=rb(96)),
        kzg_commitment_inclusion_proof=[rb(32)
                                        for _ in range(jspec.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH)])
    state = genesis.copy()
    state.latest_execution_payload_header = jspec._payload_to_header(payload)
    state.next_withdrawal_index = rng.randrange(2**64)
    return {"ExecutionPayload": payload,
            "ExecutionPayloadHeader": jspec._payload_to_header(payload),
            "BeaconBlockBody": body, "BlobSidecar": sidecar,
            "BlobIdentifier": jspec.BlobIdentifier(block_root=rb(32), index=rng.randrange(6)),
            "BeaconState": state}


@pytest.mark.parametrize("name", ["ExecutionPayload", "ExecutionPayloadHeader",
                                  "BeaconBlockBody", "BlobSidecar", "BlobIdentifier",
                                  "BeaconState"])
def test_container_roots(specs, genesis, name):
    jspec, spec = specs
    value = seeded_values(jspec, genesis, 2)[name]
    got = carry(spec, value, name)
    assert root(got) == jroot(value)
    assert ssz.serialize(got) == jax_ssz.serialize(value)


def test_presets_and_spec(specs):
    """The Deneb preset keys and constants of both packages."""
    jspec, spec = specs
    for key in ("FIELD_ELEMENTS_PER_BLOB", "MAX_BLOB_COMMITMENTS_PER_BLOCK",
                "MAX_BLOBS_PER_BLOCK", "KZG_COMMITMENT_INCLUSION_PROOF_DEPTH",
                "MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT", "BYTES_PER_BLOB", "BLS_MODULUS"):
        assert int(getattr(spec, key)) == int(getattr(jspec, key))
    assert bytes(spec.config.DENEB_FORK_VERSION) == bytes(jspec.config.DENEB_FORK_VERSION)
    assert bytes(spec.G1_POINT_AT_INFINITY) == bytes(jspec.G1_POINT_AT_INFINITY)


def test_upgrade_to_deneb(specs):
    """A Capella state after the merge, upgraded in both packages: the
    header gains zero blob-gas fields and keeps its withdrawals root."""
    jspec, spec = specs
    jc = jax_build_spec("capella", "minimal")
    pc = build_spec("capella", "minimal")
    pre = create_genesis_state(jc, [jc.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                               jc.MAX_EFFECTIVE_BALANCE)
    jc.process_slots(pre, jc.SLOTS_PER_EPOCH + 3)
    pre.latest_execution_payload_header.block_number = 777
    pre.latest_execution_payload_header.withdrawals_root = b"\x3d" * 32
    pre.next_withdrawal_index = 19
    want = jspec.upgrade_to_deneb(pre.copy())
    got = spec.upgrade_to_deneb(carry(pc, pre, "BeaconState"))
    assert root(got) == jroot(want)
    assert bytes(got.fork.current_version) == bytes(spec.config.DENEB_FORK_VERSION)
    assert bytes(got.fork.previous_version) == bytes(spec.config.CAPELLA_FORK_VERSION)
    header = got.latest_execution_payload_header
    assert bytes(header.withdrawals_root) == b"\x3d" * 32
    assert int(header.blob_gas_used) == int(header.excess_blob_gas) == 0
    assert int(got.next_withdrawal_index) == 19


def test_kzg_commitment_to_versioned_hash(specs):
    jspec, spec = specs
    rng = Random(3)
    for _ in range(8):
        c = bytes(rng.randrange(256) for _ in range(48))
        got = bytes(spec.kzg_commitment_to_versioned_hash(c))
        assert got == bytes(jspec.kzg_commitment_to_versioned_hash(c))
        assert got[:1] == b"\x01" and got[1:] == hashlib.sha256(c).digest()[1:]


@pytest.fixture(scope="module")
def mainnet_epoch1(specs):
    """A JAX mainnet Capella genesis of 64 validators at slot 32, and its
    Deneb upgrade: {fork: JAX state}."""
    jc = jax_build_spec("capella", "mainnet")
    state = create_genesis_state(jc, [jc.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                 jc.MAX_EFFECTIVE_BALANCE)
    jc.process_slots(state, jc.SLOTS_PER_EPOCH)
    return {"capella": state, "deneb": jax_build_spec("deneb", "mainnet").upgrade_to_deneb(
        state.copy())}


@pytest.mark.parametrize("fork", ["capella", "deneb"])
@pytest.mark.parametrize("delay", DELAYS)
def test_eip7045_inclusion_window(mainnet_epoch1, fork, delay):
    """An attestation of slot 32 included ``delay`` slots later: the flags
    and the post-state equal in both packages; past 32 slots both Capella
    specs raise and both Deneb specs accept it with the target flag."""
    jspec, spec = jax_build_spec(fork, "mainnet"), build_spec(fork, "mainnet")
    jstate = mainnet_epoch1[fork].copy()
    attestation = jax_att.get_valid_attestation(jspec, jstate, slot=jstate.slot, index=0)
    jspec.process_slots(jstate, jstate.slot + delay)
    state = carry(spec, jstate, "BeaconState")
    patt = carry(spec, attestation, "Attestation")
    if fork == "capella" and delay > spec.SLOTS_PER_EPOCH:
        with pytest.raises(AssertionError):
            jspec.process_attestation(jstate, attestation)
        with pytest.raises(AssertionError):
            spec.process_attestation(state, patt)
        return
    flags = spec.get_attestation_participation_flag_indices(state, patt.data, delay)
    assert flags == jspec.get_attestation_participation_flag_indices(
        jstate, attestation.data, delay)
    assert 1 in flags           # the target flag, at every delay
    assert (0 in flags) == (delay <= 5) and (2 in flags) == (delay == 1)
    jspec.process_attestation(jstate, attestation)
    spec.process_attestation(state, patt)
    assert root(state) == jroot(jstate)


class RecordingEngine:
    """An engine that accepts every payload and keeps what it was sent."""

    def __init__(self):
        self.requests = []

    def verify_and_notify_new_payload(self, request) -> bool:
        self.requests.append(request)
        return True


@pytest.mark.parametrize("blobs", [0, 1, 6, 7])
def test_process_execution_payload(specs, genesis, blobs):
    jspec, spec = specs
    jstate = genesis.copy()
    jstate.latest_block_header.parent_root = b"\x6e" * 32
    payload = build_empty_execution_payload(jspec, jstate)
    payload.blob_gas_used = 131072 * blobs
    payload.excess_blob_gas = 3
    commitments = []
    if blobs:
        tx, _, commitments, _ = get_sample_opaque_tx(jspec, blob_count=blobs)
        payload.transactions.append(tx)
    body = jspec.BeaconBlockBody(execution_payload=payload, blob_kzg_commitments=commitments)
    state = carry(spec, jstate, "BeaconState")
    pbody = carry(spec, body, "BeaconBlockBody")
    jeng, peng = RecordingEngine(), RecordingEngine()
    if blobs > spec.MAX_BLOBS_PER_BLOCK:
        with pytest.raises(AssertionError):
            jspec.process_execution_payload(jstate, body, jeng)
        with pytest.raises(AssertionError):
            spec.process_execution_payload(state, pbody, peng)
        assert jeng.requests == peng.requests == []
        return
    jspec.process_execution_payload(jstate, body, jeng)
    spec.process_execution_payload(state, pbody, peng)
    assert root(state) == jroot(jstate)
    (jreq,), (preq,) = jeng.requests, peng.requests
    want = [bytes(h) for h in jreq.versioned_hashes]
    assert [bytes(h) for h in preq.versioned_hashes] == want
    assert want == [b"\x01" + hashlib.sha256(bytes(c)).digest()[1:] for c in commitments]
    assert bytes(preq.parent_beacon_block_root) == bytes(jreq.parent_beacon_block_root) \
        == b"\x6e" * 32
    assert root(preq.execution_payload) == jroot(payload)
    header = state.latest_execution_payload_header
    assert int(header.blob_gas_used) == 131072 * blobs and int(header.excess_blob_gas) == 3


@pytest.mark.parametrize("domain", ["capella", "deneb"])
def test_eip7044_exit_domain(specs, genesis, domain):
    """A voluntary exit signed under the Capella fork domain passes in
    both packages; one signed under the Deneb domain raises in both."""
    jspec, spec = specs
    jstate = genesis.copy()
    index = 5
    jstate.validators[index].activation_epoch = 0
    jstate.slot = jspec.SLOTS_PER_EPOCH * (jspec.config.SHARD_COMMITTEE_PERIOD + 1)
    message = jspec.VoluntaryExit(epoch=0, validator_index=index)
    if domain == "capella":
        d = jspec.compute_domain(jspec.DOMAIN_VOLUNTARY_EXIT, jspec.config.CAPELLA_FORK_VERSION,
                                 jstate.genesis_validators_root)
    else:
        d = jspec.get_domain(jstate, jspec.DOMAIN_VOLUNTARY_EXIT, 0)
    with bls_on():
        signed = jspec.SignedVoluntaryExit(
            message=message,
            signature=jax_bls.Sign(privkeys[index], jspec.compute_signing_root(message, d)))
    state = carry(spec, jstate, "BeaconState")
    psigned = carry(spec, signed, "SignedVoluntaryExit")
    bls.clear_verify_memo()
    with bls_on():
        if domain == "capella":
            jspec.process_voluntary_exit(jstate, signed)
            spec.process_voluntary_exit(state, psigned)
            assert root(state) == jroot(jstate)
            assert int(state.validators[index].exit_epoch) < int(spec.FAR_FUTURE_EPOCH)
        else:
            with pytest.raises(AssertionError):
                jspec.process_voluntary_exit(jstate, signed)
            with pytest.raises(AssertionError):
                spec.process_voluntary_exit(state, psigned)


def test_signed_block_with_blobs_through_state_transition(specs, genesis):
    """One signed block with three blob commitments (their blob
    transaction in the payload), an attestation and a sync aggregate on
    both packages' python BLS: equal post-states, one product pairing in
    the port's batch."""
    jspec, spec = specs
    post = genesis.copy()
    with bls_on():
        block = jax_block.build_empty_block_for_next_slot(jspec, post)
        block.body.attestations.append(jax_att.get_valid_attestation(
            jspec, post, slot=post.slot, index=0, signed=True))
    tx, _, commitments, _ = get_sample_opaque_tx(jspec, blob_count=3)
    block.body.blob_kzg_commitments = commitments
    block.body.execution_payload.transactions.append(tx)
    block.body.execution_payload.blob_gas_used = 3 * 131072
    nxt = post.copy()
    jspec.process_slots(nxt, block.slot)
    rng = Random(11)
    block.body.sync_aggregate = sync_aggregate(
        jspec, nxt, [rng.random() < 0.8 for _ in range(jspec.SYNC_COMMITTEE_SIZE)])
    pre = post.copy()
    jax_block.transition_unsigned_block(jspec, post, block)
    block.state_root = jax_ssz.hash_tree_root(post)
    with bls_on():
        signed = jax_block.sign_block(jspec, pre, block, block.proposer_index)
    state = carry(spec, pre, "BeaconState")
    bls.clear_verify_memo()
    with bls_on():
        jstate = pre.copy()
        jspec.state_transition(jstate, signed)
        with bls.scoped_batch(bls.DeferredBatch()) as batch:
            spec.state_transition(state, carry(spec, signed, "SignedBeaconBlock"))
    assert root(state) == jroot(jstate) == jroot(post)
    assert batch.pairings == 1 and batch.last_results == [True] * 4
    assert int(state.latest_execution_payload_header.blob_gas_used) == 3 * 131072
