"""The Deneb activation churn cap (EIP-7514) on the port's epoch engines
against the JAX package.

Mainnet preset with ``MIN_PER_EPOCH_CHURN_LIMIT`` overridden to 16 in
both packages, so that on a registry of 64 validators the churn limit
(16) exceeds Deneb's cap ``MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT`` (8).
3, 8, 9 and 24 validators wait for activation at seeded lanes with
seeded eligibility epochs, beside lanes not yet eligible and lanes that
enter the queue this epoch.  ``process_registry_updates`` and a whole
``process_epoch`` on the port's columnar engine
(``mesh_state.use_fallback()``), its mesh engine (``use_mesh()``) and its
spec loops end at the JAX package's root and activate the JAX package's
validators (tolerance 0: bytes and indices): the first 8 by
(eligibility epoch, index) on Deneb, the first 16 on Capella.  The JAX
package's own registry test runs at churn 2, so alone it cannot show the
cap.
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

OVERRIDE = {"MIN_PER_EPOCH_CHURN_LIMIT": 16}
N_VALIDATORS = 64
FINALIZED = 3
QUEUED = (3, 8, 9, 24)
ENGINES = ("columnar", "mesh", "loops")


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
def genesis(engines):
    """{fork: a JAX mainnet genesis of 64 validators under the override}."""
    out = {}
    for fork in ("capella", "deneb"):
        jspec = jax_build_spec(fork, "mainnet", OVERRIDE)
        out[fork] = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                         jspec.MAX_EFFECTIVE_BALANCE)
    return out


def _queued_state(jspec, genesis, queued):
    """``genesis`` at the last slot of epoch 5, finalized at epoch 3,
    with ``queued`` validators eligible for activation (eligibility epochs
    0-3 at seeded lanes), two lanes eligible only after the finalized
    epoch and two entering the queue; returns (state, the eligible lanes
    in the order the spec dequeues them)."""
    state = genesis.copy()
    state.slot = 6 * jspec.SLOTS_PER_EPOCH - 1
    state.finalized_checkpoint = jspec.Checkpoint(epoch=FINALIZED, root=b"\x0f" * 32)
    rng = Random(queued)
    lanes = rng.sample(range(N_VALIDATORS), queued + 4)
    far = jspec.FAR_FUTURE_EPOCH
    order = []
    for k, i in enumerate(lanes):
        v = state.validators[i]
        v.activation_epoch = far
        if k < queued:
            v.activation_eligibility_epoch = rng.randint(0, FINALIZED)
            order.append((int(v.activation_eligibility_epoch), i))
        elif k < queued + 2:
            v.activation_eligibility_epoch = FINALIZED + 1
        else:
            v.activation_eligibility_epoch = far
    return state, [i for _, i in sorted(order)]


def _activated(state, before):
    return [i for i, v in enumerate(state.validators)
            if int(v.activation_epoch) != int(before.validators[i].activation_epoch)]


def _port(fork, jstate, engine, run):
    spec = build_spec(fork, "mainnet", OVERRIDE)
    state = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
    if engine == "loops":
        ek.use_loops()
    else:
        ek.use_vectorized("cpu")
        sha256.install_merkle_hasher("cpu")
    (mesh_state.use_mesh if engine == "mesh" else mesh_state.use_fallback)()
    try:
        ek.reset_stats()
        me.reset_stats()
        run(spec, state)
        st, mst = ek.stats(), me.stats()
    finally:
        mesh_state.use_fallback()
    if engine == "loops":
        assert st["vectorized"] == 0 and st["loop"] > 0, st
    else:
        assert st["vectorized"] > 0 and st["loop"] == 0 and st["guard"] == 0, st
        assert (mst["commits"] > 0) == (engine == "mesh"), mst
    return state


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fork", ["capella", "deneb"])
@pytest.mark.parametrize("queued", QUEUED)
def test_registry_updates_cap_activations(genesis, queued, fork, engine):
    jspec = jax_build_spec(fork, "mainnet", OVERRIDE)
    jstate, order = _queued_state(jspec, genesis[fork], queued)
    want = jstate.copy()
    jek.use_loops()
    jspec.process_registry_updates(want)
    churn = int(jspec.get_validator_churn_limit(jstate))
    assert churn == 16
    cap = 8 if fork == "deneb" else churn
    expected = sorted(order[:cap])
    assert _activated(want, jstate) == expected
    got = _port(fork, jstate, engine, lambda s, st: s.process_registry_updates(st))
    assert bytes(ssz.hash_tree_root(got)) == bytes(jax_ssz.hash_tree_root(want))
    assert _activated(got, jstate) == expected
    if fork == "deneb":
        assert int(build_spec("deneb", "mainnet", OVERRIDE)
                   .get_validator_activation_churn_limit(got)) == 8


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("queued", (9, 24))
def test_process_epoch_under_the_cap(genesis, queued, engine):
    """A whole ``process_slots`` across the epoch boundary on Deneb."""
    jspec = jax_build_spec("deneb", "mainnet", OVERRIDE)
    jstate, order = _queued_state(jspec, genesis["deneb"], queued)
    want = jstate.copy()
    jek.use_loops()
    jspec.process_slots(want, jstate.slot + 1)
    got = _port("deneb", jstate, engine, lambda s, st: s.process_slots(st, jstate.slot + 1))
    assert bytes(ssz.hash_tree_root(got)) == bytes(jax_ssz.hash_tree_root(want))
    assert _activated(got, jstate) == _activated(want, jstate) == sorted(order[:8])


def test_activation_churn_limit():
    spec = build_spec("deneb", "mainnet")
    assert int(spec.MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT) == 8
    assert "deneb" in ek._fork_lineage(spec) and "deneb" not in ek._fork_lineage(
        build_spec("capella", "mainnet"))
