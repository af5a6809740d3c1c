"""The PyTorch port's SSZ (``consensus_specs_tpu_torch/utils/ssz``) against
the JAX package's: serializations and ``hash_tree_root`` of the phase0
types are byte-identical (tolerance 0).  Values are made on the JAX side
(``debug/random_value.py``, seeded) and carried over by serialization.
A 4,096-validator state is hashed three ways: through the plain batched
hasher forced at threshold 1, through hashlib only, and incrementally
after a mutation of a validator and a balance."""
from random import Random

import numpy as np
import pytest

from consensus_specs_tpu.debug.random_value import RandomizationMode, get_random_ssz_object
from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import sha256
from consensus_specs_tpu_torch.utils import ssz
from consensus_specs_tpu_torch.utils.ssz import merkle
from tests._torch_port import one_torch_thread  # noqa: F401

TYPES = ("Fork", "ForkData", "Checkpoint", "Validator", "AttestationData",
         "IndexedAttestation", "PendingAttestation", "Eth1Data", "HistoricalBatch",
         "DepositMessage", "DepositData", "BeaconBlockHeader", "SigningData",
         "SignedBeaconBlockHeader", "ProposerSlashing", "AttesterSlashing",
         "Attestation", "Deposit", "VoluntaryExit", "SignedVoluntaryExit",
         "BeaconBlockBody", "BeaconBlock", "SignedBeaconBlock", "BeaconState",
         "Eth1Block", "AggregateAndProof", "SignedAggregateAndProof")
N_VALIDATORS = 4096


@pytest.fixture(scope="module", autouse=True)
def jax_mesh_off():
    """The JAX package's mesh merkle engine needs jax.experimental.enable_x64,
    which the installed JAX lacks: hash on its single-device path."""
    mesh_state.use_fallback()
    yield
    mesh_state.use_auto()


@pytest.fixture(scope="module")
def specs():
    return jax_build_spec("phase0", "minimal"), build_spec("phase0", "minimal")


def assert_same(jax_value, port_type):
    blob = jax_ssz.serialize(jax_value)
    port_value = ssz.deserialize(port_type, blob)
    assert ssz.serialize(port_value) == blob
    assert bytes(ssz.hash_tree_root(port_value)) == bytes(jax_ssz.hash_tree_root(jax_value))
    return port_value


@pytest.mark.parametrize("name", TYPES)
def test_phase0_types_match_the_jax_package(specs, name):
    jspec, spec = specs
    rng = Random(sum(map(ord, name)))
    for mode in (RandomizationMode.mode_random, RandomizationMode.mode_max_count,
                 RandomizationMode.mode_zero):
        value = get_random_ssz_object(rng, getattr(jspec, name), 64, 6, mode,
                                      chaos=mode is RandomizationMode.mode_random)
        assert_same(value, getattr(spec, name))


@pytest.fixture(scope="module")
def big_state(specs):
    """A seeded minimal-preset state with 4,096 validators, as the JAX
    package's value and its serialization."""
    jspec, _ = specs
    state = get_random_ssz_object(Random(41), jspec.BeaconState, 32, 4,
                                  RandomizationMode.mode_random)
    rng = np.random.default_rng(41)
    n = N_VALIDATORS
    rec = np.zeros((n, 121), dtype=np.uint8)
    rec[:, :80] = rng.integers(0, 256, (n, 80), dtype=np.uint8)       # pubkey, credentials
    rec[:, 80:88] = rng.integers(0, 33 * 10**9, n, dtype=np.uint64).view(np.uint8).reshape(n, 8)
    rec[:, 88] = rng.integers(0, 2, n, dtype=np.uint8)                # slashed
    rec[:, 89:] = rng.integers(0, 2**62, (n, 4), dtype=np.uint64).view(np.uint8).reshape(n, 32)
    state.validators = jax_ssz.deserialize(type(state.validators), rec.tobytes())
    balances = rng.integers(0, 2**63, n, dtype=np.uint64)
    state.balances = jax_ssz.deserialize(type(state.balances), balances.astype("<u8").tobytes())
    return state, jax_ssz.serialize(state)


@pytest.fixture
def restore_merkle():
    thresholds = merkle.batch_thresholds()
    yield
    merkle.set_batch_thresholds(*thresholds)
    merkle.set_batched_hasher(None)
    merkle.set_batched_hasher_np(None)


@pytest.mark.parametrize("way", ["batched", "hashlib", "incremental"])
def test_state_root_4096_validators(specs, big_state, restore_merkle, way):
    jspec, spec = specs
    jstate, blob = big_state
    state = ssz.deserialize(spec.BeaconState, blob)
    if way == "batched":
        sha256.install_merkle_hasher("cpu")
        merkle.set_batch_thresholds(1, 1)
    merkle.reset_stats()
    root = bytes(ssz.hash_tree_root(state))
    stats = merkle.stats()
    assert root == bytes(jax_ssz.hash_tree_root(jstate))
    if way == "batched":
        assert stats["pairs_hashlib"] == 0 and stats["pairs_batched"] > 8 * N_VALIDATORS
    else:
        assert stats["pairs_batched"] == 0 and stats["pairs_hashlib"] > 8 * N_VALIDATORS
    if way != "incremental":
        return
    # the dirty paths re-hash through the plain batched hasher
    sha256.install_merkle_hasher("cpu")
    merkle.set_batch_thresholds(1, 1)
    jstate = jstate.copy()
    for s in (state, jstate):
        s.validators[1234].effective_balance = 17 * 10**9
        s.validators[4095].slashed = not s.validators[4095].slashed
        s.balances[77] = 5
    merkle.reset_stats()
    root = bytes(ssz.hash_tree_root(state))
    stats = merkle.stats()
    assert root == bytes(jax_ssz.hash_tree_root(jstate))
    assert ssz.serialize(state) == jax_ssz.serialize(jstate)
    # a dirty path per tree level, not a rebuild
    assert 0 < stats["pairs_batched"] < 200 and stats["pairs_hashlib"] == 0


def test_merkleize_limits_and_mixins_match(specs):
    for count, limit in ((0, 1), (1, 1), (3, None), (5, 8), (17, 1 << 20)):
        chunks = [bytes([i + 1]) * 32 for i in range(count)]
        assert merkle.merkleize_chunks(chunks, limit) == \
            jax_ssz.merkleize_chunks(chunks, limit)
    assert merkle.mix_in_length(b"\x01" * 32, 7) == jax_ssz.mix_in_length(b"\x01" * 32, 7)
    with pytest.raises(ValueError):
        merkle.merkleize_chunks([b"\x00" * 32] * 3, 2)
