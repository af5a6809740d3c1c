"""Batched ``process_attestation`` message preparation: one columnar
pass computes every attestation signing root of a block.

Counterpart of ``consensus_specs_tpu/ops/att_prep.py`` without its
telemetry counters and the serving pipeline's window prepare.  The
batched dispatches go through the port's ``merkle.hash_rows``, so at a
mainnet block's 128 attestations the checkpoint and data-root levels
run on kernel K5.

The per-attestation python cost of block verification is not the
pairing (the RLC flush already folds a whole block into one — see
``docs/bls-batching.md``) but the message preparation feeding it:
``is_valid_indexed_attestation`` merkleizes one ``AttestationData``
(two checkpoint subtrees + an 8-chunk container) and one
``SigningData`` per attestation, object by object.  This module batches
all of it: for the N attestations of a block it computes

* both checkpoint roots per attestation      — one ``(2N, 64)`` batch,
* all ``AttestationData`` roots              — three level reductions
  over an ``(N, 8, 32)`` chunk cube,
* all signing roots (``H(data_root‖domain)``) — one ``(N, 64)`` batch,

five batched hash dispatches total, and installs the results where the
spec bodies will find them: the exact container roots are poked into
the SSZ root memos (value-semantics copies inherit them, so the
``PendingAttestation`` path is also warm), and the signing roots go
into a per-block lookup consulted by an externally-installed
``is_valid_indexed_attestation`` wrapper (``install_att_prep``, applied
from outside so the spec method bodies stay spec-shaped).  Every prepared verification then feeds the
existing deferred-batch RLC flush unchanged.

The lookup key includes the fork version in force at the attestation's
target epoch and the genesis validators root, so a hit can never hand
back a signing root computed for a different chain or fork boundary; any
miss (attester slashings, a state of another fork) falls through to the
spec body.
"""
import functools

import numpy as np

from ..utils import bls
from ..utils.ssz import merkle

# one prepare's worth of {key: signing root bytes} (a block's
# attestations), replaced wholesale by the next prepare call
_table = {}
# identity of the attestation list the table was built from: fork
# overrides chain process_operations through super(), so the inner
# (wrapped) call would otherwise re-prepare the same block.  A STRONG
# reference: ``is`` identity is only meaningful while the list lives.
_prepared_srcs = []


# the exact AttestationData layout the chunk cube is built for (the
# legacy sharding lineage appends shard_transition_root — see the
# layout gate in prepare_block_attestations)
_PHASE0_DATA_FIELDS = ("slot", "index", "beacon_block_root",
                       "source", "target")


def _fork_version(state, epoch):
    return (state.fork.previous_version if epoch < state.fork.epoch
            else state.fork.current_version)


def _key(state, data):
    e = int(data.target.epoch)
    return (int(data.slot), int(data.index), bytes(data.beacon_block_root),
            int(data.source.epoch), bytes(data.source.root),
            e, bytes(data.target.root),
            bytes(_fork_version(state, e)),
            bytes(state.genesis_validators_root))


def _prepare(spec, state, datas):
    """The five batched hash dispatches over ``datas`` (any number of
    blocks' worth, concatenated): poke the container-root memos and
    return the {key: signing root} table — or None when the layout gate
    trips (the legacy sharding lineage appends shard_transition_root;
    the 5-field chunk cube below would compute, and memo-poke, wrong
    container roots for that layout)."""
    n = len(datas)
    if n == 0:
        return {}
    if tuple(type(datas[0])._fields) != _PHASE0_DATA_FIELDS:
        return None

    # checkpoint roots: rows [0:n] = sources, [n:2n] = targets
    ck = np.zeros((2 * n, 64), dtype=np.uint8)
    se = np.fromiter((int(d.source.epoch) for d in datas),
                     dtype="<u8", count=n)
    te = np.fromiter((int(d.target.epoch) for d in datas),
                     dtype="<u8", count=n)
    ck[:n, :8] = se.view(np.uint8).reshape(n, 8)
    ck[n:, :8] = te.view(np.uint8).reshape(n, 8)
    ck[:n, 32:] = np.frombuffer(
        b"".join(bytes(d.source.root) for d in datas),
        dtype=np.uint8).reshape(n, 32)
    ck[n:, 32:] = np.frombuffer(
        b"".join(bytes(d.target.root) for d in datas),
        dtype=np.uint8).reshape(n, 32)
    ckr = merkle.hash_rows(ck)

    # AttestationData roots: (slot, index, beacon_block_root, source,
    # target) padded to 8 chunks, reduced level-synchronously
    cube = np.zeros((n, 8, 32), dtype=np.uint8)
    slots = np.fromiter((int(d.slot) for d in datas), dtype="<u8", count=n)
    idxs = np.fromiter((int(d.index) for d in datas), dtype="<u8", count=n)
    cube[:, 0, :8] = slots.view(np.uint8).reshape(n, 8)
    cube[:, 1, :8] = idxs.view(np.uint8).reshape(n, 8)
    cube[:, 2, :] = np.frombuffer(
        b"".join(bytes(d.beacon_block_root) for d in datas),
        dtype=np.uint8).reshape(n, 32)
    cube[:, 3, :] = ckr[:n]
    cube[:, 4, :] = ckr[n:]
    lvl = cube
    while lvl.shape[1] > 1:
        half = lvl.shape[1] // 2
        lvl = merkle.hash_rows(lvl.reshape(n * half, 64)) \
            .reshape(n, half, 32)
    data_roots = lvl.reshape(n, 32)

    # domains (one get_domain per distinct target epoch) + signing roots
    domains = {}
    for e in {int(d.target.epoch) for d in datas}:
        domains[e] = bytes(spec.get_domain(
            state, spec.DOMAIN_BEACON_ATTESTER, e))
    sd = np.zeros((n, 64), dtype=np.uint8)
    sd[:, :32] = data_roots
    sd[:, 32:] = np.frombuffer(
        b"".join(domains[int(d.target.epoch)] for d in datas),
        dtype=np.uint8).reshape(n, 32)
    signing = merkle.hash_rows(sd)

    table = {}
    for i, d in enumerate(datas):
        # poke the exact roots into the SSZ memos: every later
        # hash_tree_root on these containers (or their value-semantics
        # copies — get_indexed_attestation, PendingAttestation) hits
        object.__setattr__(d, "_root_cache", data_roots[i].tobytes())
        object.__setattr__(d.source, "_root_cache", ckr[i].tobytes())
        object.__setattr__(d.target, "_root_cache", ckr[n + i].tobytes())
        table[_key(state, d)] = signing[i].tobytes()
    return table


def prepare_block_attestations(spec, state, attestations) -> None:
    """Batch-compute checkpoint/data/signing roots for every
    attestation in the block body, poke the container-root memos, and
    (re)fill the signing-root lookup.  Idempotent per list identity
    (nested ``super().process_operations`` chains prepare once); a
    stale skip can only cause lookup misses, never wrong hits - the
    lookup key re-derives the fork/genesis identity from the querying
    state."""
    global _table, _prepared_srcs
    for src in _prepared_srcs:
        if src is attestations:
            return
    _prepared_srcs = [attestations]
    table = _prepare(spec, state, [a.data for a in attestations])
    _table = table or {}


def lookup_signing_root(state, data):
    """The signing root prepared for this attestation data under this
    state's fork/genesis identity, or None."""
    return _table.get(_key(state, data))


def install_att_prep(cls) -> None:
    """Wrap ``cls``'s own ``process_operations`` (prepare the block's
    attestation messages in one columnar pass before the ops loops) and
    ``is_valid_indexed_attestation`` (serve the prepared signing root;
    fall through to the spec body on any miss).  Only methods defined
    on ``cls`` itself are wrapped; wrapping is idempotent.  Applied by
    ``forks.register_fork``."""
    fn = cls.__dict__.get("process_operations")
    if fn is not None and not getattr(fn, "_att_prep_wrapper", False):
        @functools.wraps(fn)
        def process_operations(self, state, body, _orig=fn):
            prepare_block_attestations(self, state, body.attestations)
            return _orig(self, state, body)
        process_operations._att_prep_wrapper = True
        setattr(cls, "process_operations", process_operations)

    fn = cls.__dict__.get("is_valid_indexed_attestation")
    if fn is not None and not getattr(fn, "_att_prep_wrapper", False):
        @functools.wraps(fn)
        def is_valid_indexed_attestation(self, state, indexed_attestation,
                                         _orig=fn):
            signing_root = lookup_signing_root(
                state, indexed_attestation.data)
            if signing_root is None:
                return _orig(self, state, indexed_attestation)
            # the spec body with the two merkleizations pre-resolved;
            # index checks stay bit-for-bit (beacon-chain.md:739)
            indices = list(indexed_attestation.attesting_indices)
            if len(indices) == 0 or not indices == sorted(set(indices)):
                return False
            pubkeys = [state.validators[i].pubkey for i in indices]
            return bls.FastAggregateVerify(
                pubkeys, signing_root, indexed_attestation.signature)
        is_valid_indexed_attestation._att_prep_wrapper = True
        setattr(cls, "is_valid_indexed_attestation",
                is_valid_indexed_attestation)
