"""The port's phase0 epoch processing against the JAX package's, minimal
preset, 64 validators.

States are built by the JAX package's ``test_infra`` (as
``tests/test_epoch_vectorized.py`` builds them) and carried to the port
by SSZ, in three cases: attestations with the registry's edge shapes
scattered (slashed lanes at the slashings target and at the eligibility
boundary, exiting lanes, ejection candidates, hysteresis-straddling
balances, a nonzero ``state.slashings``), an inactivity-leak epoch, and
an epoch with no attestations.  For ``process_epoch`` and each of its
four vectorized sub-transitions (reached through
``run_epoch_processing_to``), the port's engine on the plain versions
(``use_vectorized("cpu")``) and the port's own loops end at post-state
roots identical to the JAX package's vectorized engine and its spec
loops (tolerance 0: bytes), and the port's counters show the engine
committed with no loop run.  A state between the port's 2^63 guard and
the JAX engine's 2^64 declines to the port's spec loop and still ends
at the same root, and a registry write through SSZ between two engine
reads of one epoch is seen by the second.
"""
from contextlib import nullcontext
from random import Random

import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra.attestations import next_epoch_with_attestations
from consensus_specs_tpu.test_infra.block import next_epoch
from consensus_specs_tpu.test_infra.epoch_processing import run_epoch_processing_to
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.test_infra.metrics import counting
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.state import arrays as state_arrays
from consensus_specs_tpu_torch.utils import bls, ssz
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_epoch_vectorized import _scatter_registry_edges

N_VALIDATORS = 64
FNS = ["process_rewards_and_penalties", "process_registry_updates",
       "process_slashings", "process_effective_balance_updates"]
CASES = ["attestations", "leak", "empty"]


@pytest.fixture(scope="module")
def specs():
    mesh_state.use_fallback()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    yield jax_build_spec("phase0", "minimal"), build_spec("phase0", "minimal")
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    jek.use_auto()
    ek.use_auto()
    mesh_state.use_auto()


def _jax_state(jspec, case):
    state = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                 jspec.MAX_EFFECTIVE_BALANCE)
    jek.use_loops()
    next_epoch(jspec, state)
    if case == "empty":
        next_epoch(jspec, state)
        next_epoch(jspec, state)
        seed = 17
    elif case == "leak":
        _, _, state = next_epoch_with_attestations(jspec, state, True, False)
        for _ in range(6):     # let finality lapse into a leak
            next_epoch(jspec, state)
        _, _, state = next_epoch_with_attestations(jspec, state, True, False)
        seed = 19
    else:
        _, _, state = next_epoch_with_attestations(jspec, state, True, False)
        _, _, state = next_epoch_with_attestations(jspec, state, True, True)
        seed = 11
    _scatter_registry_edges(jspec, state, Random(seed), preserve_active=True)
    assert jspec.is_in_inactivity_leak(state) == (case == "leak")
    return state


@pytest.fixture(scope="module")
def states(specs):
    jspec, _ = specs
    return {case: _jax_state(jspec, case) for case in CASES}


def _jax_root(jspec, state, fn, vectorized):
    s = state.copy()
    (jek.use_vectorized if vectorized else jek.use_loops)()
    with counting() as delta:
        if fn == "process_epoch":
            jspec.process_epoch(s)
        else:
            run_epoch_processing_to(jspec, s, fn)
            getattr(jspec, fn)(s)
    if vectorized:
        assert delta["epoch.transition{path=vectorized}"] > 0
        assert delta["epoch.fallbacks{reason=guard}"] == 0
    return bytes(jax_ssz.hash_tree_root(s))


def _port_run(spec, jax_state, fn, vectorized):
    s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jax_state))
    if vectorized:
        ek.use_vectorized("cpu")
    else:
        ek.use_loops()
    ek.reset_stats()
    if fn == "process_epoch":
        with state_arrays.commit_scope(s):
            spec.process_epoch(s)
    else:
        run_epoch_processing_to(spec, s, fn)
        getattr(spec, fn)(s)
    return bytes(ssz.hash_tree_root(s)), ek.stats()


@pytest.mark.parametrize("fn", FNS + ["process_epoch"])
@pytest.mark.parametrize("case", CASES)
def test_port_engine_matches_the_jax_engine_and_loops(specs, states, case, fn):
    jspec, spec = specs
    state = states[case]
    want = _jax_root(jspec, state, fn, vectorized=True)
    assert _jax_root(jspec, state, fn, vectorized=False) == want
    got, st = _port_run(spec, state, fn, vectorized=True)
    assert got == want
    assert st["vectorized"] > 0 and st["loop"] == 0 and st["guard"] == 0, st
    got, st = _port_run(spec, state, fn, vectorized=False)
    assert got == want
    assert st["vectorized"] == 0 and st["loop"] > 0


def test_epoch_copies_cross_once(specs, states):
    """One epoch through the engine: balances and effective balances go
    up once and come down once, and balances commit once."""
    _, spec = specs
    s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(states["attestations"]))
    ek.use_vectorized("cpu")
    run_epoch_processing_to(spec, s, "process_justification_and_finalization")
    state_arrays.reset_stats()
    ek.reset_stats()
    with state_arrays.commit_scope(s):
        spec.process_epoch(s)
    st = state_arrays.stats()
    assert ek.stats() == {"vectorized": 4, "loop": 0, "guard": 0}
    for key in ("h2d.balances", "d2h.balances", "h2d.eff", "d2h.eff", "commits"):
        assert st.get(key) == 1, (key, st)


def test_guard_declines_between_the_port_and_jax_limits(specs, states):
    """A balance of 2^63 passes the JAX guard (2^64) and trips the port's
    (2^63): the port's rewards decline to its spec loop, which ends at the
    JAX engine's root."""
    jspec, spec = specs
    jstate = states["attestations"].copy()
    jstate.balances[3] = 2**63
    s_jax = jstate.copy()
    jek.use_vectorized()
    with counting() as delta:
        jspec.process_rewards_and_penalties(s_jax)
    assert delta["epoch.fallbacks{reason=guard}"] == 0
    s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
    ek.use_vectorized("cpu")
    ek.reset_stats()
    spec.process_rewards_and_penalties(s)
    assert ek.stats() == {"vectorized": 0, "loop": 1, "guard": 1}
    assert bytes(ssz.hash_tree_root(s)) == bytes(jax_ssz.hash_tree_root(s_jax))


@pytest.mark.parametrize("in_scope", [False, True])
def test_registry_poisoning_mid_epoch(specs, states, in_scope):
    """A registry write through the SSZ API between two engine reads of
    one epoch, with warm columns (and, in a scope, balances pending on the
    engine's device): the second read sees the write."""
    jspec, spec = specs
    jstate = states["attestations"]
    s_loop = jstate.copy()
    jek.use_loops()
    jspec.process_rewards_and_penalties(s_loop)
    s_loop.validators[5].effective_balance = jspec.EFFECTIVE_BALANCE_INCREMENT
    jspec.process_effective_balance_updates(s_loop)

    s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
    ek.use_vectorized("cpu")
    state_arrays.reset_stats()
    with state_arrays.commit_scope(s) if in_scope else nullcontext():
        assert ek.try_process_rewards_and_penalties(spec, s)
        extracts = state_arrays.stats()["extracts"]
        s.validators[5].effective_balance = spec.EFFECTIVE_BALANCE_INCREMENT
        assert ek.try_process_effective_balance_updates(spec, s)
        assert state_arrays.stats()["extracts"] == extracts + 1   # registry re-read
    assert bytes(ssz.hash_tree_root(s)) == bytes(jax_ssz.hash_tree_root(s_loop))



@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1000])
def test_committee_shuffle_is_the_per_index_shuffle(specs, n):
    """The port's whole-array swap-or-not shuffle (the committees' one
    permutation per seed) equals the spec's per-index shuffle, in the
    port and in the JAX package."""
    jspec, spec = specs
    seed = bytes(range(n % 7, n % 7 + 32))
    perm = spec._shuffled_positions(n, seed).tolist()
    assert perm == [int(spec.compute_shuffled_index(i, n, seed)) for i in range(n)]
    assert perm == [int(jspec.compute_shuffled_index(i, n, seed)) for i in range(n)]
    assert sorted(perm) == list(range(n))


def test_attester_sets_equal_the_jax_sets(specs, states):
    jspec, spec = specs
    jstate = states["attestations"]
    state = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
    atts = state.previous_epoch_attestations
    assert len(atts) > 0
    want = jspec.get_unslashed_attesting_indices(jstate, jstate.previous_epoch_attestations)
    assert spec.get_unslashed_attesting_indices(state, atts) == want
    assert 0 < len(want) < N_VALIDATORS     # the scatter slashed some attesters


def test_inclusion_delay_ties_go_to_the_first_attestation(specs, states):
    """Every attester of one attestation appears again, later in the list,
    with the same inclusion delay and another proposer: the spec's min()
    keeps the first, so the first proposer earns the cut."""
    jspec, spec = specs
    jstate = states["attestations"].copy()
    first = jstate.previous_epoch_attestations[0].copy()
    first.proposer_index = (int(first.proposer_index) + 1) % N_VALIDATORS
    jstate.previous_epoch_attestations.append(first)
    s_loop = jstate.copy()
    jek.use_loops()
    jspec.process_rewards_and_penalties(s_loop)
    s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
    ek.use_vectorized("cpu")
    assert ek.try_process_rewards_and_penalties(spec, s)
    assert bytes(ssz.hash_tree_root(s)) == bytes(jax_ssz.hash_tree_root(s_loop))
