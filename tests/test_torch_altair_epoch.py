"""The port's Altair epoch processing against the JAX package's, minimal
preset, 64 validators.

States are ``tests/test_epoch_vectorized.py``'s ``_altair_state`` cases
(registry edges and participation flags and inactivity scores scattered;
an inactivity leak; zero participation), built by the JAX package and
carried to the port by SSZ.  For ``process_epoch`` and each of its five
engine sub-transitions (reached through ``run_epoch_processing_to``), the
port's engine on the plain versions (``use_vectorized("cpu")``: K14, K13,
K11, K12) and the port's spec loops end at the JAX package's root
(tolerance 0: bytes), and the counters show the engine committed.  A
state whose ``eff x score`` lies between the port's 2^63 guard and the
JAX engine's 2^64 declines to the port's loop at the same root; a clamp
in a middle pair gives the JAX balance; the copies cross once; the
participation cells follow the lists ``process_participation_flag_updates``
assigns; the participating sets equal the JAX package's; on the mainnet
preset the slashings take Altair's multiplier.
"""
import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state
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
from tests.test_epoch_vectorized import _altair_state

FNS = ["process_inactivity_updates", "process_rewards_and_penalties",
       "process_registry_updates", "process_slashings", "process_effective_balance_updates"]
CASES = {"scattered": {}, "leak": {"leak": True, "seed": 23},
         "zero": {"zero_participation": True, "seed": 13}}


@pytest.fixture(scope="module")
def specs():
    mesh_state.use_fallback()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    yield build_spec("altair", "minimal")
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    jek.use_auto()
    ek.use_auto()
    mesh_state.use_auto()


@pytest.fixture(scope="module")
def states(specs):
    """{case: (JAX spec, JAX state)}."""
    return {case: _altair_state("altair", **kw) for case, kw in CASES.items()}


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


def carry(spec, jax_state):
    return ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jax_state))


def _port_run(spec, jax_state, fn, vectorized):
    s = carry(spec, jax_state)
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
@pytest.mark.parametrize("case", list(CASES))
def test_port_engine_matches_the_jax_engine_and_loops(specs, states, case, fn):
    spec = specs
    jspec, state = states[case]
    want = _jax_root(jspec, state, fn, vectorized=True)
    assert _jax_root(jspec, state, fn, vectorized=False) == want
    got, st = _port_run(spec, state, fn, vectorized=True)
    assert got == want
    assert st["vectorized"] > 0 and st["loop"] == 0 and st["guard"] == 0, st
    got, st = _port_run(spec, state, fn, vectorized=False)
    assert got == want
    assert st["vectorized"] == 0 and st["loop"] > 0


def test_epoch_copies_cross_once(specs, states):
    """One Altair epoch through the engine: balances, effective balances
    and inactivity scores go up once and come down once, the previous
    flags go up once, and balances and scores commit once each."""
    spec = specs
    s = carry(spec, states["scattered"][1])
    ek.use_vectorized("cpu")
    run_epoch_processing_to(spec, s, "process_justification_and_finalization")
    state_arrays.reset_stats()
    ek.reset_stats()
    with state_arrays.commit_scope(s):
        spec.process_epoch(s)
    st = state_arrays.stats()
    assert ek.stats() == {"vectorized": 5, "loop": 0, "guard": 0}
    for key in ("h2d.balances", "d2h.balances", "h2d.eff", "d2h.eff", "h2d.inactivity_scores",
                "d2h.inactivity_scores", "h2d.participation_previous"):
        assert st.get(key) == 1, (key, st)
    assert st["commits"] == 2, st


def test_guard_declines_between_the_port_and_jax_limits(specs, states):
    """A score a months-long leak could reach: eff x score is above 2^63
    and below 2^64, so the JAX engine runs and the port's rewards decline
    to its spec loop, at the JAX engine's root."""
    spec = specs
    jspec, jstate = states["leak"]
    jstate = jstate.copy()
    i = next(i for i, v in enumerate(jstate.validators)
             if int(v.effective_balance) == int(jspec.MAX_EFFECTIVE_BALANCE) and not v.slashed)
    score = 2**63 // int(jspec.MAX_EFFECTIVE_BALANCE) + 1
    assert 2**63 <= score * int(jspec.MAX_EFFECTIVE_BALANCE) < 2**64
    jstate.inactivity_scores[i] = score
    jstate.previous_epoch_participation[i] = 0
    want = jstate.copy()
    jek.use_vectorized()
    with counting() as delta:
        jspec.process_rewards_and_penalties(want)
    assert delta["epoch.fallbacks{reason=guard}"] == 0
    s = carry(spec, jstate)
    ek.use_vectorized("cpu")
    ek.reset_stats()
    spec.process_rewards_and_penalties(s)
    assert ek.stats() == {"vectorized": 0, "loop": 1, "guard": 1}
    assert bytes(ssz.hash_tree_root(s)) == bytes(jax_ssz.hash_tree_root(want))
    assert int(s.balances[i]) == 0


def test_middle_pair_clamp_gives_the_jax_balance(specs, states):
    """A validator with one gwei, the source and head flags and no target
    flag: the target penalty clamps the balance to zero in the second
    pair, and the head reward of the third survives, as in the JAX
    package (one sum of the pairs, clamped once, would leave zero)."""
    spec = specs
    jspec, jstate = states["scattered"]
    jstate = jstate.copy()
    prev = jspec.get_previous_epoch(jstate)
    i = next(i for i, v in enumerate(jstate.validators)
             if not v.slashed and jspec.is_active_validator(v, prev))
    jstate.balances[i] = 1
    jstate.previous_epoch_participation[i] = 0b101
    jstate.inactivity_scores[i] = 0
    want = jstate.copy()
    jek.use_loops()
    jspec.process_rewards_and_penalties(want)
    s = carry(spec, jstate)
    ek.use_vectorized("cpu")
    ek.reset_stats()
    spec.process_rewards_and_penalties(s)
    assert ek.stats() == {"vectorized": 1, "loop": 0, "guard": 0}
    assert bytes(ssz.hash_tree_root(s)) == bytes(jax_ssz.hash_tree_root(want))
    assert int(s.balances[i]) == int(want.balances[i]) > 0


def test_participation_cells_follow_the_lists(specs, states):
    """``process_participation_flag_updates`` assigns new lists; the
    store's flag cells notice by the list's identity and re-extract, and
    a flag written through SSZ is seen by the next read."""
    spec = specs
    s = carry(spec, states["scattered"][1])
    store = state_arrays.of(s)
    prev, cur = store.participation("previous"), store.participation("current")
    assert store.participation("previous") is prev
    state_arrays.reset_stats()
    spec.process_participation_flag_updates(s)
    assert (store.participation("previous") == cur).all()
    assert not store.participation("current").any()
    assert state_arrays.stats()["extracts"] == 2
    s.previous_epoch_participation[3] = 6
    assert int(store.participation("previous")[3]) == 6


@pytest.mark.parametrize("case", list(CASES))
def test_participating_sets_equal_the_jax_sets(specs, states, case):
    spec = specs
    jspec, jstate = states[case]
    s = carry(spec, jstate)
    for epoch in (jspec.get_previous_epoch(jstate), jspec.get_current_epoch(jstate)):
        for flag in range(3):
            want = jspec.get_unslashed_participating_indices(jstate, flag, epoch)
            assert spec.get_unslashed_participating_indices(s, flag, epoch) == \
                {int(i) for i in want}


def test_slashings_take_the_altair_multiplier(specs):
    """On the mainnet preset, where Altair's slashing multiplier (2)
    differs from phase0's (1), with slashings large enough that it
    changes the penalty: the port's engine gives the JAX root, so it takes
    the multiplier of the spec's fork lineage."""
    jspec = jax_build_spec("altair", "mainnet")
    spec = build_spec("altair", "mainnet")
    assert int(jspec.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR) \
        != int(jspec.PROPORTIONAL_SLASHING_MULTIPLIER)
    jstate = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * 64,
                                  jspec.MAX_EFFECTIVE_BALANCE)
    inc = int(jspec.EFFECTIVE_BALANCE_INCREMENT)
    target_epoch = int(jspec.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    for i in (3, 17, 40):
        jstate.validators[i].slashed = True
        jstate.validators[i].withdrawable_epoch = target_epoch
    jstate.slashings[0] = 300 * inc
    total = int(jspec.get_total_active_balance(jstate))
    eff = int(jspec.MAX_EFFECTIVE_BALANCE)

    def penalty(multiplier):
        return eff // inc * min(300 * inc * multiplier, total) // total * inc

    assert penalty(2) != penalty(1)
    want = jstate.copy()
    jek.use_loops()
    jspec.process_slashings(want)
    assert int(want.balances[3]) == eff - penalty(2)
    s = carry(spec, jstate)
    ek.use_vectorized("cpu")
    ek.reset_stats()
    spec.process_slashings(s)
    assert ek.stats() == {"vectorized": 1, "loop": 0, "guard": 0}
    assert bytes(ssz.hash_tree_root(s)) == bytes(jax_ssz.hash_tree_root(want))
