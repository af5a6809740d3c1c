"""The port's SSZ fast paths for containers whose fields are all immutable
leaves (a ``Validator``): a copy is one dict update that keeps the cached
root, a list of them coerces across forks' classes of the same field
types the same way, and serializes field by field through numpy.

Held exact (tolerance 0: bytes and roots) against the per-element paths
and the JAX package's SSZ on the same values: the serialized bytes, the
roots after copies and upgrades, and the independence of a copy from its
source under mutation.
"""
import hashlib

import numpy as np
import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.utils import ssz
from consensus_specs_tpu_torch.utils.ssz import types as T
from tests._torch_port import one_torch_thread  # noqa: F401

N = 3000


@pytest.fixture(scope="module")
def registry():
    """A port Capella ``validators`` list of seeded records (edges: slashed,
    far epochs, 2^63 and up) and its bytes."""
    rng = np.random.default_rng(5)
    rec = np.zeros((N, 121), dtype=np.uint8)
    rec[:, :80] = rng.integers(0, 256, (N, 80), dtype=np.uint8)
    epochs = rng.integers(0, 2**63, (N, 5), dtype=np.uint64)
    epochs[::7] = 2**64 - 1
    epochs[3::11] = 2**63 + 5
    rec[:, 80:88] = epochs[:, :1].astype("<u8").view(np.uint8)
    rec[:, 88] = rng.integers(0, 2, N)
    rec[:, 89:121] = epochs[:, 1:].astype("<u8").view(np.uint8)
    spec = build_spec("capella", "mainnet")
    data = rec.tobytes()
    return spec, ssz.deserialize(type(spec.BeaconState().validators), data), data


def test_flat_classes(registry):
    spec, _, _ = registry
    assert T._flat(spec.Validator) and T._flat(spec.Checkpoint)
    assert not T._flat(spec.BeaconState) and not T._flat(spec.Attestation)
    assert not T._flat(dict) and not T._flat(ssz.uint64)


def test_columnar_serialize_equals_per_element_and_jax(registry):
    spec, seq, data = registry
    got = seq.serialize()
    assert got == data == b"".join(x.serialize() for x in seq._items)
    jspec = jax_build_spec("capella", "mainnet")
    jseq = jax_ssz.deserialize(type(jspec.BeaconState().validators), data)
    assert jax_ssz.serialize(jseq) == got
    assert bytes(ssz.hash_tree_root(seq)) == bytes(jax_ssz.hash_tree_root(jseq))


def test_copy_keeps_root_and_is_independent(registry):
    spec, seq, data = registry
    root = bytes(ssz.hash_tree_root(seq))
    v = seq[17]
    c = v.copy()
    assert bytes(ssz.hash_tree_root(c)) == bytes(ssz.hash_tree_root(v))
    assert "_owner" not in c.__dict__ and "_owner" in v.__dict__
    orig = int(v.effective_balance)
    c.effective_balance = 9
    assert int(v.effective_balance) == orig != 9
    assert bytes(ssz.hash_tree_root(seq)) == root
    assert bytes(ssz.hash_tree_root(c)) != bytes(ssz.hash_tree_root(v))
    copied = seq.copy()
    assert bytes(ssz.hash_tree_root(copied)) == root
    copied[5].exit_epoch = 3
    copied[6] = copied[7]
    assert bytes(ssz.hash_tree_root(seq)) == root
    fresh = ssz.deserialize(type(seq), copied.serialize())
    assert bytes(ssz.hash_tree_root(copied)) == bytes(ssz.hash_tree_root(fresh)) != root
    assert copied[5]._owner[0]() is copied and copied[5]._owner[1] == 5


def test_coerce_across_forks_keeps_roots(registry):
    """A Capella registry assigned into a Deneb state: the elements take
    the Deneb class with their roots; mutations reach the new state's
    root and not the old list's."""
    mesh_state.use_fallback()
    spec, seq, data = registry
    root = bytes(ssz.hash_tree_root(seq))
    deneb = build_spec("deneb", "mainnet")
    state = deneb.BeaconState()
    state.validators = seq
    assert type(state.validators[0]) is deneb.Validator
    assert bytes(ssz.hash_tree_root(state.validators)) == root
    before = bytes(ssz.hash_tree_root(state))
    state.validators[9].slashed = not bool(state.validators[9].slashed)
    assert bytes(ssz.hash_tree_root(state)) != before
    assert bytes(ssz.hash_tree_root(seq)) == root
    fresh = ssz.deserialize(type(state), ssz.serialize(state))
    assert bytes(ssz.hash_tree_root(fresh)) == bytes(ssz.hash_tree_root(state))
    mesh_state.use_auto()


def test_mixed_values_fall_back(registry):
    """A list given dicts or other containers coerces element by element."""
    spec, seq, _ = registry
    d = {"pubkey": hashlib.sha256(b"k").digest() + b"\x00" * 16, "effective_balance": 5}
    typ = type(seq)
    mixed = typ([seq[0], d])
    assert bytes(mixed[0].serialize()) == bytes(seq[0].serialize())
    assert int(mixed[1].effective_balance) == 5
    assert bytes(ssz.hash_tree_root(mixed)) == bytes(ssz.hash_tree_root(
        ssz.deserialize(typ, mixed.serialize())))
