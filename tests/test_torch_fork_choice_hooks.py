"""The fork hooks of the port's ``on_block`` against the JAX package's,
minimal preset, 64 validators, exact.

- **Bellatrix merge block** (``tests/bellatrix/fork_choice/
  test_on_merge_block.py``): a merge-transition block whose terminal PoW
  block reaches the terminal total difficulty and whose PoW parent does
  not is accepted; one under TTD, one whose parent is at or over TTD and
  one whose PoW parent is missing are refused, with both stores unchanged.
  Capella's hook is a no-op: on a pre-merge state and a merge block with
  no PoW block to be found it passes where Bellatrix's raises, and a
  Capella block goes through ``on_block`` in both packages.
- **Deneb blobs** (``tests/deneb/fork_choice/test_on_block_blob_data.py``)
  on the width-8 setup of ``tests/_torch_kzg.py``: a signed block with two
  blob commitments through ``on_block`` inside the caller's
  ``bls.scoped_batch``, on ``bls.use_torch("cpu")`` (the plain K1-K4):
  the block's two items and the blob batch flush as one product pairing
  (``pairings == 1``).  With the blob proofs swapped, ``on_block`` raises
  in both packages with both stores unchanged and
  ``last_pairing_results`` naming the blob check; with no blobs
  retrievable, likewise.
- **EIP-7594** on the width-64 setup (2 cells a blob): the sampled cells
  of a block's blob join its items in one product pairing through
  ``on_block``; a sampled cell with one element changed fails that
  pairing in the block's flush, and a withheld blob makes ``on_block``
  raise with no pairing, both in both packages with both stores
  unchanged.
"""
import numpy as np
import pytest

from consensus_specs_tpu.config import load_config as jax_load_config
from consensus_specs_tpu.config import load_preset as jax_load_preset
from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.forks import fork_registry as jax_fork_registry
from consensus_specs_tpu.ops import kzg as JK
from consensus_specs_tpu.ops import kzg_7594 as JK7
from consensus_specs_tpu.ops.bls12_381 import curve as JC
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import block as jax_block
from consensus_specs_tpu.test_infra.execution_payload import (
    build_state_with_incomplete_transition, compute_el_block_hash)
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.config import loader
from consensus_specs_tpu_torch.forks import build_spec, fork_registry
from consensus_specs_tpu_torch.ops.bls12_381 import curve as PC
from consensus_specs_tpu_torch.utils import bls, ssz
from tests._torch_kzg import Setup, blob, setup_points
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_torch_bellatrix import bls_on, carry
from tests.test_torch_fork_choice import genesis, snapshot

GAS_PER_BLOB = 2**17


@pytest.fixture(scope="module")
def packages():
    mesh_state.use_fallback()
    jax_backend = jax_bls.backend_name()
    jax_bls.use_py()
    bls.use_py()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    yield
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    getattr(jax_bls, f"use_{jax_backend}", jax_bls.use_py)()
    bls.use_py()
    mesh_state.use_auto()


def stores(jspec, spec, state):
    """Both packages' stores anchored at ``state`` (its header's block)."""
    anchor = jspec.BeaconBlock(slot=state.slot, state_root=jax_ssz.hash_tree_root(state))
    return (jspec.get_forkchoice_store(state.copy(), anchor),
            spec.get_forkchoice_store(carry(spec, state, "BeaconState"),
                                      carry(spec, anchor, "BeaconBlock")))


def tick_to(jspec, spec, jstore, store, slot):
    t = int(jstore.genesis_time) + int(slot) * int(jspec.config.SECONDS_PER_SLOT)
    jspec.on_tick(jstore, t)
    spec.on_tick(store, t)


def refused(jspec, spec, jstore, store, signed):
    """``on_block`` raises in both packages; both stores as they were."""
    before = (snapshot(jspec, jstore), snapshot(spec, store))
    with pytest.raises(AssertionError):
        jspec.on_block(jstore, signed)
    with pytest.raises(AssertionError):
        spec.on_block(store, carry(spec, signed, "SignedBeaconBlock"))
    assert (snapshot(jspec, jstore), snapshot(spec, store)) == before


def accepted(jspec, spec, jstore, store, signed):
    jspec.on_block(jstore, signed)
    spec.on_block(store, carry(spec, signed, "SignedBeaconBlock"))
    root = bytes(jax_ssz.hash_tree_root(signed.message))
    assert snapshot(spec, store) == snapshot(jspec, jstore)
    assert bytes(ssz.hash_tree_root(store.block_states[root])) == \
        bytes(jax_ssz.hash_tree_root(jstore.block_states[root]))
    assert bytes(spec.get_head(store)) == bytes(jspec.get_head(jstore)) == root


# ---------------------------------------------------------------------------
# Bellatrix: the merge block
# ---------------------------------------------------------------------------

def _merge_block(jspec):
    """A pre-merge state and a signed merge-transition block on it."""
    state = build_state_with_incomplete_transition(jspec, genesis(jspec))
    block = jax_block.build_empty_block_for_next_slot(jspec, state)
    payload = block.body.execution_payload
    payload.parent_hash = b"\xaa" * 32
    payload.block_hash = compute_el_block_hash(jspec, payload)
    return state, jax_block.state_transition_and_sign_block(jspec, state.copy(), block)


@pytest.mark.parametrize("case", ["valid", "below_ttd", "parent_at_ttd", "parent_over_ttd",
                                  "missing_parent"])
def test_merge_block(packages, monkeypatch, case):
    jspec, spec = jax_build_spec("bellatrix", "minimal"), build_spec("bellatrix", "minimal")
    state, signed = _merge_block(jspec)
    ttd = int(spec.config.TERMINAL_TOTAL_DIFFICULTY)
    td, parent_td = {"valid": (ttd, ttd - 1), "below_ttd": (ttd - 1, ttd - 2),
                     "parent_at_ttd": (ttd, ttd), "parent_over_ttd": (ttd, ttd + 1),
                     "missing_parent": (ttd, None)}[case]
    parent_hash = bytes(signed.message.body.execution_payload.parent_hash)
    for s in (jspec, spec):
        table = {parent_hash: s.PowBlock(block_hash=parent_hash, parent_hash=b"\xbb" * 32,
                                         total_difficulty=td)}
        if parent_td is not None:
            table[b"\xbb" * 32] = s.PowBlock(block_hash=b"\xbb" * 32, parent_hash=b"\x00" * 32,
                                             total_difficulty=parent_td)
        monkeypatch.setattr(s, "get_pow_block", lambda h, t=table: t.get(bytes(h)),
                            raising=False)
    jstore, store = stores(jspec, spec, state)
    tick_to(jspec, spec, jstore, store, signed.message.slot)
    assert spec.is_merge_transition_block(state_of(spec, store, signed),
                                          carry(spec, signed, "SignedBeaconBlock").message.body)
    if case == "valid":
        accepted(jspec, spec, jstore, store, signed)
    else:
        refused(jspec, spec, jstore, store, signed)


def state_of(spec, store, signed):
    return store.block_states[bytes(signed.message.parent_root)]


def test_capella_hook_is_a_no_op(packages, monkeypatch):
    """Capella overrides the merge hook with nothing to validate: on a
    pre-merge state and a merge block, with no PoW block to be found,
    Capella's hook passes in both packages where Bellatrix's raises; a
    Capella block goes through ``on_block`` in both."""
    for s in (jax_build_spec("bellatrix", "minimal"), build_spec("bellatrix", "minimal"),
              jax_build_spec("capella", "minimal"), build_spec("capella", "minimal")):
        monkeypatch.setattr(s, "get_pow_block", lambda h: None, raising=False)
    jb, pb = jax_build_spec("bellatrix", "minimal"), build_spec("bellatrix", "minimal")
    state, signed = _merge_block(jb)
    for s, st, blk in ((jb, state, signed.message),
                       (pb, carry(pb, state, "BeaconState"), carry(pb, signed.message,
                                                                   "BeaconBlock"))):
        with pytest.raises(AssertionError):
            s._on_block_merge_check(st, blk)
    jspec, spec = jax_build_spec("capella", "minimal"), build_spec("capella", "minimal")
    state = build_state_with_incomplete_transition(jspec, genesis(jspec))
    block = jax_block.build_empty_block_for_next_slot(jspec, state)
    block.body.execution_payload.parent_hash = b"\xaa" * 32
    assert jspec._on_block_merge_check(state, block) is None
    assert spec._on_block_merge_check(carry(spec, state, "BeaconState"),
                                      carry(spec, block, "BeaconBlock")) is None
    state = genesis(jspec)
    signed = jax_block.state_transition_and_sign_block(
        jspec, state.copy(), jax_block.build_empty_block_for_next_slot(jspec, state))
    jstore, store = stores(jspec, spec, state)
    tick_to(jspec, spec, jstore, store, signed.message.slot)
    accepted(jspec, spec, jstore, store, signed)


def test_every_fork_carries_fork_choice():
    """Every fork class has the handlers; the Bellatrix, Capella, Deneb
    and EIP-7594 hooks override the mixin's."""
    from consensus_specs_tpu_torch.forks.fork_choice import ForkChoiceMixin
    names = ("get_forkchoice_store", "on_tick", "on_block", "on_attestation",
             "on_attester_slashing", "get_head", "get_weight", "get_proposer_head")
    reg = fork_registry()
    for fork, cls in reg.items():
        assert issubclass(cls, ForkChoiceMixin) and all(hasattr(cls, n) for n in names), fork
    mixin = ForkChoiceMixin.__dict__
    for fork in ("bellatrix", "capella", "deneb", "eip7594"):
        cls = reg[fork]
        assert cls._on_block_merge_check is not mixin["_on_block_merge_check"], fork
    for fork in ("deneb", "eip7594"):
        cls = reg[fork]
        assert cls._on_block_data_availability_check is not \
            mixin["_on_block_data_availability_check"], fork
    for fork in ("phase0", "altair"):
        cls = reg[fork]
        assert cls._on_block_data_availability_check is mixin["_on_block_data_availability_check"]


# ---------------------------------------------------------------------------
# Deneb and EIP-7594: blobs
# ---------------------------------------------------------------------------

def small_spec(cls, preset, config, setup, width):
    """``cls`` at ``width`` field elements a blob, bound to ``setup``."""
    class Small(cls):
        @property
        def kzg_setup(self):
            return setup
    return Small(dict(preset, FIELD_ELEMENTS_PER_BLOB=width), config, preset_name="minimal")


def blob_specs(fork, width):
    points = setup_points(width, width + 1)
    j_setup, p_setup = Setup(points, JC.g2_from_compressed), Setup(points, PC.g2_from_compressed)
    jspec = small_spec(jax_fork_registry()[fork],
                       jax_load_preset("minimal", forks=list(loader.FORKS)),
                       jax_load_config("minimal"), j_setup, width)
    spec = small_spec(fork_registry()[fork], loader.load_preset("minimal"),
                      loader.load_config("minimal"), p_setup, width)
    return jspec, spec, j_setup


def blob_block(jspec, cs):
    """A genesis and a signed block for slot 1 carrying the commitments
    ``cs`` (their blob transaction and blob gas)."""
    state = genesis(jspec)
    post = state.copy()
    with bls_on():
        block = jax_block.build_empty_block_for_next_slot(jspec, post)
    block.body.blob_kzg_commitments = list(cs)
    hashes = [bytes(jspec.kzg_commitment_to_versioned_hash(c)) for c in cs]
    block.body.execution_payload.transactions.append(b"\x03" + b"".join(hashes))
    block.body.execution_payload.blob_gas_used = len(cs) * GAS_PER_BLOB
    jax_block.transition_unsigned_block(jspec, post, block)
    block.state_root = jax_ssz.hash_tree_root(post)
    with bls_on():
        signed = jax_block.sign_block(jspec, state, block, block.proposer_index)
    return state, signed


@pytest.fixture(scope="module")
def deneb_case(packages):
    jspec, spec, j_setup = blob_specs("deneb", 8)
    rng = np.random.default_rng(4844)
    blobs = [blob(rng, 8) for _ in range(2)]
    cs = [JK.blob_to_kzg_commitment(b, j_setup) for b in blobs]
    proofs = [JK.compute_blob_kzg_proof(b, c, j_setup) for b, c in zip(blobs, cs)]
    state, signed = blob_block(jspec, cs)
    return {"j": jspec, "p": spec, "blobs": blobs, "proofs": proofs, "state": state,
            "signed": signed}


@pytest.fixture
def stubs(monkeypatch):
    def put(specs, name, fn):
        for s in specs:
            monkeypatch.setattr(s, name, fn, raising=False)
    return put


def test_deneb_block_with_blobs_one_pairing(deneb_case, stubs):
    """On the plain K1-K4: the proposer signature, the randao reveal and
    the blob batch of ``on_block`` flush as one product pairing, and the
    stores agree."""
    jspec, spec = deneb_case["j"], deneb_case["p"]
    stubs((jspec, spec), "retrieve_blobs_and_proofs",
          lambda r: (deneb_case["blobs"], deneb_case["proofs"]))
    jstore, store = stores(jspec, spec, deneb_case["state"])
    tick_to(jspec, spec, jstore, store, 1)
    signed = deneb_case["signed"]
    bls.use_torch("cpu")
    try:
        with bls_on():
            jax_bls.clear_verify_memo()
            bls.clear_verify_memo()
            with jax_bls.scoped_batch(jax_bls.DeferredBatch()) as jbatch:
                jspec.on_block(jstore, signed)
            with bls.scoped_batch(bls.DeferredBatch()) as batch:
                spec.on_block(store, carry(spec, signed, "SignedBeaconBlock"))
    finally:
        bls.use_py()
    assert batch.pairings == 1
    assert batch.last_results == jbatch.last_results == [True, True]
    assert batch.last_pairing_results == jbatch.last_pairing_results == [True]
    root = bytes(jax_ssz.hash_tree_root(signed.message))
    assert snapshot(spec, store) == snapshot(jspec, jstore)
    assert bytes(ssz.hash_tree_root(store.block_states[root])) == bytes(signed.message.state_root)
    assert bytes(spec.get_head(store)) == root
    assert bytes(store.proposer_boost_root) == root


@pytest.mark.parametrize("case", ["swapped_proofs", "unavailable"])
def test_deneb_bad_blobs_refused(deneb_case, stubs, case):
    """A wrong blob proof fails the block's flush (every item passes, the
    blob check is named); blobs that cannot be retrieved fail the hook
    before any pairing.  Both stores stay as they were."""
    jspec, spec = deneb_case["j"], deneb_case["p"]
    proofs = deneb_case["proofs"][::-1]
    if case == "swapped_proofs":
        stubs((jspec, spec), "retrieve_blobs_and_proofs", lambda r: (deneb_case["blobs"], proofs))
    else:
        stubs((jspec, spec), "retrieve_blobs_and_proofs", lambda r: ([], []))
    jstore, store = stores(jspec, spec, deneb_case["state"])
    tick_to(jspec, spec, jstore, store, 1)
    jax_bls.clear_verify_memo()
    bls.clear_verify_memo()
    before = (snapshot(jspec, jstore), snapshot(spec, store))
    results = []
    for package, s, st, sb in ((jax_bls, jspec, jstore, deneb_case["signed"]),
                               (bls, spec, store, carry(spec, deneb_case["signed"],
                                                        "SignedBeaconBlock"))):
        with bls_on():
            with pytest.raises(AssertionError):
                with package.scoped_batch(package.DeferredBatch()) as batch:
                    s.on_block(st, sb)
        results.append((batch.last_results, batch.last_pairing_results))
    assert (snapshot(jspec, jstore), snapshot(spec, store)) == before
    assert store._fc_proto._n == 1
    if case == "swapped_proofs":
        assert results[0] == results[1] == ([True, True], [False])
    else:
        assert results[0] == results[1] == (None, None)
        assert batch.pairings == 0


@pytest.fixture(scope="module")
def eip7594_case(packages):
    jspec, spec, j_setup = blob_specs("eip7594", 64)
    rng = np.random.default_rng(7594)
    b = blob(rng, 64)
    c = JK.blob_to_kzg_commitment(b, j_setup)
    cells, proofs = JK7.compute_cells_and_proofs(b, j_setup)
    cells = [b"".join(int(x).to_bytes(32, "big") for x in cell) for cell in cells]
    state, signed = blob_block(jspec, [c])
    # the first element of cell 1, plus one modulo the field
    x = int.from_bytes(cells[1][:32], "big")
    altered = list(cells)
    altered[1] = ((x + 1) % JK.BLS_MODULUS).to_bytes(32, "big") + cells[1][32:]
    return {"j": jspec, "p": spec, "sampled": [([0, 1], cells, list(proofs))],
            "altered": [([0, 1], altered, list(proofs))], "withheld": [],
            "state": state, "signed": signed}


@pytest.mark.parametrize("case", ["sampled", "altered", "withheld"])
def test_eip7594_on_block_sampling(eip7594_case, stubs, case):
    """The sampled cells of the block's blob join the block's items in one
    product pairing; an altered cell fails that pairing in the block's
    flush (every item passes), and a withheld blob raises with no pairing,
    both stores unchanged."""
    jspec, spec = eip7594_case["j"], eip7594_case["p"]
    sampled = eip7594_case[case]
    stubs((jspec, spec), "retrieve_cells_and_proofs", lambda r: sampled)
    jstore, store = stores(jspec, spec, eip7594_case["state"])
    tick_to(jspec, spec, jstore, store, 1)
    signed = eip7594_case["signed"]
    before = (snapshot(jspec, jstore), snapshot(spec, store))
    batches = []
    for package, s, st, sb in ((jax_bls, jspec, jstore, signed),
                               (bls, spec, store, carry(spec, signed, "SignedBeaconBlock"))):
        package.clear_verify_memo()
        with bls_on(), package.scoped_batch(package.DeferredBatch()) as batch:
            if case == "sampled":
                s.on_block(st, sb)
            else:
                with pytest.raises(AssertionError):
                    s.on_block(st, sb)
        batches.append(batch)
    pb, jb = batches[1], batches[0]
    if case == "sampled":
        assert pb.pairings == 1
        assert pb.last_results == jb.last_results == [True, True]
        assert pb.last_pairing_results == jb.last_pairing_results == [True]
        assert snapshot(spec, store) == snapshot(jspec, jstore)
        assert bytes(spec.get_head(store)) == bytes(jax_ssz.hash_tree_root(signed.message))
        return
    assert (snapshot(jspec, jstore), snapshot(spec, store)) == before
    assert store._fc_proto._n == 1
    if case == "altered":
        # the one product pairing fails, then each item and check alone
        assert pb.pairings == 1 + 2 + 1
        assert pb.last_results == jb.last_results == [True, True]
        assert pb.last_pairing_results == jb.last_pairing_results == [False]
    else:
        assert pb.pairings == 0 and pb.items == jb.items == []
        assert pb.pairing_checks == jb.pairing_checks == []

