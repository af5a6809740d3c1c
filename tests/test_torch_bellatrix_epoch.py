"""The port's Bellatrix and Capella epoch processing against the JAX
package's: the epoch engine takes the inactivity penalty quotient and
the proportional slashing multiplier of the spec's fork lineage.

Minimal preset, 64 validators: the ``_altair_state`` cases of
``tests/test_epoch_vectorized.py`` (scattered registry edges, flags and
scores; an inactivity leak; zero participation) built by the JAX package
for Bellatrix and Capella and carried to the port by SSZ.  For
``process_epoch`` and each of its five engine sub-transitions, the
port's engine on the plain versions (``use_vectorized("cpu")``) and its
spec loops end at the JAX package's root (tolerance 0: bytes).

Mainnet preset, 64 validators, on the port's columnar engine
(``mesh_state.use_fallback()``) and its mesh engine (``use_mesh()``, whose
floors let a registry of any size engage): a slashing case whose
penalties differ between Bellatrix's multiplier 3 and Altair's 2, and a
leak case whose inactivity penalties differ between Bellatrix's quotient
2^24 and Altair's 3 * 2^24.  Each ends at the JAX package's root and at
the balances computed here from the Bellatrix constants.
"""
from random import Random

import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state as jax_mesh_state
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.ops import sha256
from consensus_specs_tpu_torch.parallel import mesh_epoch as me
from consensus_specs_tpu_torch.parallel import mesh_state
from consensus_specs_tpu_torch.utils import bls, ssz
from consensus_specs_tpu_torch.utils.ssz import merkle
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_epoch_vectorized import _altair_state
from tests.test_torch_altair_epoch import FNS, CASES, _jax_root, _port_run

FORKS = ("bellatrix", "capella")


@pytest.fixture(scope="module")
def engines():
    jax_mesh_state.use_fallback()
    mesh_state.use_fallback()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    saved = (merkle._batched_hasher, merkle._batched_hasher_np)
    yield
    merkle.set_batched_hasher(saved[0])
    merkle.set_batched_hasher_np(saved[1])
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    jek.use_auto()
    ek.use_auto()
    mesh_state.use_auto()
    jax_mesh_state.use_auto()


@pytest.fixture(scope="module")
def states(engines):
    """{(fork, case): (JAX spec, JAX state)}."""
    return {(fork, case): _altair_state(fork, **kw)
            for fork in FORKS for case, kw in CASES.items()}


@pytest.mark.parametrize("fn", FNS + ["process_epoch"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fork", FORKS)
def test_port_engine_matches_the_jax_engine_and_loops(states, fork, case, fn):
    spec = build_spec(fork, "minimal")
    jspec, state = states[(fork, case)]
    want = _jax_root(jspec, state, fn, vectorized=True)
    assert _jax_root(jspec, state, fn, vectorized=False) == want
    got, st = _port_run(spec, state, fn, vectorized=True)
    assert got == want
    assert st["vectorized"] > 0 and st["loop"] == 0 and st["guard"] == 0, st
    got, st = _port_run(spec, state, fn, vectorized=False)
    assert got == want
    assert st["vectorized"] == 0 and st["loop"] > 0


@pytest.mark.parametrize("fork", FORKS)
def test_engine_constants_follow_the_fork_lineage(fork):
    spec = build_spec(fork, "mainnet")
    assert ek.inactivity_penalty_quotient(spec) == 2**24
    assert ek.slashing_multiplier(spec) == 3
    altair, phase0 = build_spec("altair", "mainnet"), build_spec("phase0", "mainnet")
    assert ek.inactivity_penalty_quotient(altair) == 3 * 2**24
    assert ek.slashing_multiplier(altair) == 2 and ek.slashing_multiplier(phase0) == 1


def _mainnet_genesis(jspec):
    return create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * 64,
                                jspec.MAX_EFFECTIVE_BALANCE)


def _slashing_case(jspec):
    """A mainnet state at the epoch where three slashed validators'
    penalties fall due, with slashings of 300 ETH; returns (state, the
    slashed indices, their penalty under multiplier 3)."""
    state = _mainnet_genesis(jspec)
    inc = int(jspec.EFFECTIVE_BALANCE_INCREMENT)
    target = int(jspec.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    slashed = (3, 17, 40)
    for i in slashed:
        state.validators[i].slashed = True
        state.validators[i].withdrawable_epoch = target
    state.slashings[0] = 300 * inc
    total = int(jspec.get_total_active_balance(state))
    eff = int(jspec.MAX_EFFECTIVE_BALANCE)

    def penalty(multiplier):
        return eff // inc * min(300 * inc * multiplier, total) // total * inc

    assert penalty(3) != penalty(2)
    return state, slashed, penalty(3)


def _leak_case(jspec):
    """A mainnet state at epoch 6, finalized at 0 (leaking), with seeded
    flags (a third of the lanes without the target flag) and inactivity
    scores; returns (state, {index: penalty under quotient 2^24} of the
    lanes without the target flag)."""
    state = _mainnet_genesis(jspec)
    state.slot = 6 * jspec.SLOTS_PER_EPOCH
    rng = Random(29)
    penalties = {}
    bias = int(jspec.config.INACTIVITY_SCORE_BIAS)
    eff = int(jspec.MAX_EFFECTIVE_BALANCE)
    for i in range(64):
        flags = rng.choice((0b111, 0b111, 0b101))
        state.previous_epoch_participation[i] = flags
        state.inactivity_scores[i] = rng.randint(100, 5000)
        if not flags & 0b010:
            score = int(state.inactivity_scores[i])
            penalties[i] = eff * score // (bias * 2**24)
            assert penalties[i] != eff * score // (bias * 3 * 2**24)
    assert jspec.is_in_inactivity_leak(state) and penalties
    return state, penalties


@pytest.mark.parametrize("engine", ["columnar", "mesh"])
@pytest.mark.parametrize("fork", FORKS)
def test_mainnet_slashings_take_the_bellatrix_multiplier(engines, fork, engine):
    jspec = jax_build_spec(fork, "mainnet")
    spec = build_spec(fork, "mainnet")
    jstate, slashed, penalty = _slashing_case(jspec)
    want = jstate.copy()
    jek.use_loops()
    jspec.process_slashings(want)
    s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
    ek.use_vectorized("cpu")
    sha256.install_merkle_hasher("cpu")
    (mesh_state.use_mesh if engine == "mesh" else mesh_state.use_fallback)()
    try:
        ek.reset_stats()
        me.reset_stats()
        spec.process_slashings(s)
        assert ek.stats() == {"vectorized": 1, "loop": 0, "guard": 0}
        assert me.stats()["commits"] == (engine == "mesh")
        got = bytes(ssz.hash_tree_root(s))
    finally:
        mesh_state.use_fallback()
    assert got == bytes(jax_ssz.hash_tree_root(want))
    eff = int(jspec.MAX_EFFECTIVE_BALANCE)
    assert [int(s.balances[i]) for i in slashed] == [eff - penalty] * len(slashed)


@pytest.mark.parametrize("engine", ["columnar", "mesh"])
@pytest.mark.parametrize("fork", FORKS)
def test_mainnet_leak_takes_the_bellatrix_quotient(engines, fork, engine):
    jspec = jax_build_spec(fork, "mainnet")
    spec = build_spec(fork, "mainnet")
    jstate, penalties = _leak_case(jspec)
    want = jstate.copy()
    jek.use_loops()
    jspec.process_rewards_and_penalties(want)
    s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
    ek.use_vectorized("cpu")
    sha256.install_merkle_hasher("cpu")
    (mesh_state.use_mesh if engine == "mesh" else mesh_state.use_fallback)()
    try:
        ek.reset_stats()
        me.reset_stats()
        spec.process_rewards_and_penalties(s)
        assert ek.stats() == {"vectorized": 1, "loop": 0, "guard": 0}
        assert me.stats()["commits"] == (engine == "mesh")
        got = bytes(ssz.hash_tree_root(s))
    finally:
        mesh_state.use_fallback()
    assert got == bytes(jax_ssz.hash_tree_root(want))
    # in a leak no flag earns a reward: a lane without the target flag
    # loses the target penalty and its inactivity penalty
    base = int(jspec.get_base_reward(jstate, 0))
    target_penalty = base * int(jspec.TIMELY_TARGET_WEIGHT) // int(jspec.WEIGHT_DENOMINATOR)
    eff = int(jspec.MAX_EFFECTIVE_BALANCE)
    for i, p in penalties.items():
        assert int(s.balances[i]) == eff - target_penalty - p
