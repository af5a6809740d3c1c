"""The port's state column store (``state/arrays.py``) and its SSZ hooks.

The extracted registry and balance columns equal the JAX package's
store's; a write through the SSZ API makes a column stale (the next read
re-extracts it); ``fork_state`` shares columns copy-on-write; a
``commit_scope`` commits once, and ``state.copy()`` inside one commits
before the snapshot; a card-side write comes down only when read; the
chunk-packed commit equals per-index writes.
"""
from random import Random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.state import arrays as jax_arrays
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.state import arrays as sa
from consensus_specs_tpu_torch.utils import ssz
from consensus_specs_tpu_torch.utils.ssz import (
    List, replace_basic_items, sequence_items, uint64)
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_epoch_vectorized import _scatter_registry_edges

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    """A JAX minimal-preset state with scattered registry edges, and the
    port's spec."""
    mesh_state.use_fallback()
    jspec = jax_build_spec("phase0", "minimal")
    state = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * 64,
                                 jspec.MAX_EFFECTIVE_BALANCE)
    state.slot = jspec.SLOTS_PER_EPOCH * 3
    _scatter_registry_edges(jspec, state, Random(5), preserve_active=True)
    state.validators[9].exit_epoch = 2**64 - 1
    yield state, build_spec("phase0", "minimal")
    mesh_state.use_auto()


def port_state(spec, jstate):
    return ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))


def test_columns_equal_the_jax_store(pair):
    jstate, spec = pair
    jax_arrays.use_arrays()
    try:
        jcopy = jstate.copy()
        jstore = jax_arrays.of(jcopy)
        want_reg, want_bal = jstore.registry(), jstore.balances()
    finally:
        jax_arrays.use_auto()
    state = port_state(spec, jstate)
    store = sa.of(state)
    reg = store.registry()
    assert reg.dtype.names == want_reg.dtype.names
    for name in reg.dtype.names:
        np.testing.assert_array_equal(reg[name], want_reg[name])
    np.testing.assert_array_equal(store.balances(), want_bal)
    assert (reg["ext"] == np.uint64(2**64 - 1)).any()


def test_ssz_write_makes_the_column_stale(pair):
    jstate, spec = pair
    state = port_state(spec, jstate)
    store = sa.of(state)
    sa.reset_stats()
    reg = store.registry()
    assert store.registry() is reg and sa.stats()["extracts"] == 1
    state.validators[3].effective_balance = 7
    assert store.registry() is not reg and int(store.registry()["eff"][3]) == 7
    state.balances[4] = 11
    assert int(store.balances()[4]) == 11
    assert sa.stats()["extracts"] == 3


def test_fork_state_is_copy_on_write(pair):
    jstate, spec = pair
    state = port_state(spec, jstate)
    store = sa.of(state)
    reg, bal = store.registry(), store.balances()
    eff_card = store.registry_card("eff", CPU)
    sa.reset_stats()
    child = sa.fork_state(state)
    cstore = sa.of(child)
    assert cstore is not store and sa.stats()["forks"] == 1
    assert cstore.registry() is reg and cstore.balances() is bal
    assert cstore.registry_card("eff", CPU) is eff_card
    cstore.registry_writable("eff")["eff"][0] = 1
    child.validators[0].effective_balance = 1
    cstore.mark_registry_committed()
    assert sa.stats()["cow_copies"] == 1
    assert int(store.registry()["eff"][0]) == int(jstate.validators[0].effective_balance)
    assert int(cstore.registry()["eff"][0]) == 1
    cstore.set_balances(bal + np.uint64(1))
    np.testing.assert_array_equal(store.balances(), bal)
    assert int(child.balances[2]) == int(bal[2]) + 1 and int(state.balances[2]) == int(bal[2])
    assert bytes(ssz.hash_tree_root(state)) == bytes(jax_ssz.hash_tree_root(jstate))


def test_one_commit_per_scope(pair):
    jstate, spec = pair
    state = port_state(spec, jstate)
    store = sa.of(state)
    bal = store.balances()
    sa.reset_stats()
    with sa.commit_scope(state):
        store.set_balances(bal + np.uint64(5))
        with sa.commit_scope(state):           # reentrant
            store.set_balances_card(store.balances_card(CPU) + 2, int(bal.max()) + 7)
        assert int(state.balances[0]) == int(bal[0]) and store.balances_bound() >= 0
        store.set_balances_card(store.balances_card(CPU) * 1, int(bal.max()) + 7)
    st = sa.stats()
    assert st["commits"] == 1 and st["h2d.balances"] == 1 and st["d2h.balances"] == 1, st
    assert [int(x) for x in state.balances] == [int(x) + 7 for x in bal]
    want = jstate.copy()
    for i in range(len(want.balances)):
        want.balances[i] += 7
    assert bytes(ssz.hash_tree_root(state)) == bytes(jax_ssz.hash_tree_root(want))


def test_copy_inside_a_scope_commits_first_and_errors_discard(pair):
    jstate, spec = pair
    state = port_state(spec, jstate)
    store = sa.of(state)
    bal = store.balances()
    with pytest.raises(ValueError):
        with sa.commit_scope(state):
            store.set_balances(bal + np.uint64(3))
            copy = state.copy()
            assert int(copy.balances[1]) == int(bal[1]) + 3
            store.set_balances(bal + np.uint64(9))
            raise ValueError("transition failed")
    # the write after the copy was discarded; the one before was committed
    assert int(state.balances[1]) == int(bal[1]) + 3
    np.testing.assert_array_equal(sa.of(state).balances(), bal + np.uint64(3))


def test_pending_write_and_a_direct_ssz_write_raise(pair):
    jstate, spec = pair
    state = port_state(spec, jstate)
    store = sa.of(state)
    with pytest.raises(RuntimeError, match="pending"):
        with sa.commit_scope(state):
            store.set_balances(store.balances() + np.uint64(1))
            state.balances[0] = 1
            store.balances()


def test_upload_download_keep_the_uint64_bits():
    a = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], dtype=np.uint64)
    card = sa.upload(a, CPU, "test")
    assert card.dtype == torch.int64 and int(card[4]) == -1
    np.testing.assert_array_equal(sa.download(card, "test"), a)
    assert sa.upload(np.array([True, False]), CPU, "mask").dtype == torch.bool


def test_write_back_wholesale_matches_targeted():
    """Both commit strategies (targeted writes; the wholesale swap with a
    value table or built directly) give the content and root of per-index
    writes."""
    BalanceList = List[uint64, 1 << 40]
    rng = Random(41)
    n = 512
    base = [rng.randrange(0, 2**40) for _ in range(n)]

    def reference(vals):
        ref = BalanceList(base)
        for i, v in enumerate(vals):
            ref[i] = uint64(v)
        return ssz.hash_tree_root(ref)

    few = list(base)
    few[3], few[200] = few[3] + 1, 0
    pooled = [b % 5 for b in base]
    distinct = [b + i + 1 for i, b in enumerate(base)]
    for vals in (few, pooled, distinct):
        seq = BalanceList(base)
        ssz.hash_tree_root(seq)
        sa._write_u64_list(seq, uint64, np.array(base, dtype=np.uint64),
                           np.array(vals, dtype=np.uint64))
        assert [int(x) for x in sequence_items(seq)] == vals
        assert ssz.hash_tree_root(seq) == reference(vals)


def test_replace_basic_items_validates_before_swapping():
    seq = List[uint64, 4]([1, 2])
    root, gen = ssz.hash_tree_root(seq), getattr(seq, "_gen", 0)
    with pytest.raises(ValueError):
        replace_basic_items(seq, [uint64(1)] * 5)
    with pytest.raises(ValueError):
        replace_basic_items(seq, [uint64(5), uint64(6)], packed=b"\x00" * 8)
    with pytest.raises(TypeError):
        replace_basic_items(List[List[uint64, 2], 2](), [])
    assert ssz.hash_tree_root(seq) == root and getattr(seq, "_gen", 0) == gen
    replace_basic_items(seq, [uint64(5), uint64(6)],
                        packed=np.array([5, 6], dtype="<u8").tobytes())
    assert ssz.hash_tree_root(seq) == ssz.hash_tree_root(List[uint64, 4]([5, 6]))
    assert seq._gen == gen + 1
    with pytest.raises(TypeError):
        sequence_items(uint64(3))


def test_forest_reads_the_committed_registry_columns(pair, monkeypatch):
    """A full build of the registry's element roots (300 validators: the
    columnar path) takes the store's committed columns
    (``peek_registry``) and gives the root of a typed-view walk; a write
    through SSZ retires them."""
    from consensus_specs_tpu_torch.utils.ssz import forest
    jstate, spec = pair
    state = port_state(spec, jstate)
    state.validators = [state.validators[i % 64] for i in range(300)]
    state.balances = [int(state.balances[i % 64]) for i in range(300)]
    want = bytes(ssz.hash_tree_root(ssz.deserialize(spec.BeaconState, ssz.serialize(state))))
    seq = state.validators
    assert sa.peek_registry(seq) is None
    reg = sa.of(state).registry()
    cols = sa.peek_registry(seq)
    np.testing.assert_array_equal(cols["effective_balance"], reg["eff"])
    assert cols["slashed"].dtype == np.uint64
    served = []
    monkeypatch.setattr(forest, "_column_provider",
                        lambda owner: served.append(owner) or sa.peek_registry(owner))
    seq._drop_tree()
    assert bytes(ssz.hash_tree_root(state)) == want
    assert served and served[0] is seq
    state.validators[0].slashed = True
    assert sa.peek_registry(seq) is None
