"""The PyTorch port's EIP-7594 runtime against the JAX package's on the
width-64 setup of ``tests/_torch_kzg.py`` (2 cells a blob): cells, cell
proofs, their checks, recovery, sidecars, the sampling
``is_data_available`` and its deferral into a block's product pairing.

Both packages' specs are built here at that width: a subclass on each
side whose ``kzg_setup`` is the small setup, with ``FIELD_ELEMENTS_PER_BLOB``
64 in the preset before the types are built (so ``Blob``, ``Cell`` and
``NUMBER_OF_COLUMNS`` follow).  Values are built by the JAX package and
carried across by SSZ; every comparison is exact (tolerance 0: bytes,
integers and verdicts).  With the port on python BLS and on
``bls.use_torch("cpu")`` (the plain K4, K7, K8 and K9):
``compute_cells_and_proofs``; ``verify_cell_proof`` and
``verify_cell_proof_batch`` true and false, the batch against the JAX
engine route and the JAX spec loop; ``recover_polynomial`` and
``recover_cells_and_kzg_proofs`` from each single kept cell;
``get_data_column_sidecars`` and ``verify_data_column_sidecar_kzg_proofs``
of a signed block.  On python BLS: ``is_data_available`` without a cell
stub (Deneb's full-blob path), with a cell stub taking precedence, a
withheld blob, a bad cell outside a scope, and inside a scope with a
signed block of three blob commitments through ``state_transition`` on
both packages (one product pairing, equal roots; one cell of blob 1
altered named alone by ``last_pairing_results``); ``derive_scalars``
over six ``das_cells`` checks, and over six with a ``kzg_batch`` check
among them, byte for byte.
"""
from random import Random

import numpy as np
import pytest

from consensus_specs_tpu.config import load_config as jax_load_config
from consensus_specs_tpu.config import load_preset as jax_load_preset
from consensus_specs_tpu.forks import fork_registry as jax_fork_registry
from consensus_specs_tpu.ops import bls_rlc as jax_rlc
from consensus_specs_tpu.ops import kzg as JK
from consensus_specs_tpu.ops import kzg_7594 as JK7
from consensus_specs_tpu.ops.bls12_381 import curve as JC
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import attestations as jax_att
from consensus_specs_tpu.test_infra import block as jax_block
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.config import loader
from consensus_specs_tpu_torch.forks.eip7594 import EIP7594Spec
from consensus_specs_tpu_torch.ops import bls_rlc
from consensus_specs_tpu_torch.ops.bls12_381 import curve as PC
from consensus_specs_tpu_torch.utils import bls
from tests._torch_kzg import R, Setup, blob, setup_points
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_torch_bellatrix import bls_on, carry, jroot, root, sync_aggregate

WIDTH = 64
BLOBS = 3
N_VALIDATORS = 64
GAS_PER_BLOB = 2**17


def small_spec(cls, preset, config, setup):
    """``cls`` at ``WIDTH`` field elements a blob, bound to ``setup``."""
    class Small(cls):
        @property
        def kzg_setup(self):
            return setup
    preset = dict(preset, FIELD_ELEMENTS_PER_BLOB=WIDTH)
    return Small(preset, config, preset_name="minimal")


def cell_bytes(cell) -> bytes:
    return b"".join(int(x).to_bytes(32, "big") for x in cell)


@pytest.fixture(scope="module")
def case():
    """Both specs at width 64, three blobs with their commitments, blob
    proofs, cells and cell proofs (JAX package); both packages on python
    BLS with verification off."""
    mesh_state.use_fallback()
    jax_backend = jax_bls.backend_name()
    jax_bls.use_py()
    bls.use_py()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    points = setup_points(WIDTH, WIDTH + 1)
    j_setup, p_setup = Setup(points, JC.g2_from_compressed), Setup(points, PC.g2_from_compressed)
    # through the registry, which imports every JAX fork: importing the fork
    # module alone would leave the JAX registry with six forks
    jspec = small_spec(jax_fork_registry()["eip7594"],
                       jax_load_preset("minimal", forks=list(loader.FORKS)),
                       jax_load_config("minimal"), j_setup)
    spec = small_spec(EIP7594Spec, loader.load_preset("minimal"), loader.load_config("minimal"),
                      p_setup)
    rng = np.random.default_rng(7594)
    blobs = [blob(rng, WIDTH) for _ in range(BLOBS)]
    cs = [JK.blob_to_kzg_commitment(b, j_setup) for b in blobs]
    blob_proofs = [JK.compute_blob_kzg_proof(b, c, j_setup) for b, c in zip(blobs, cs)]
    cells, proofs = zip(*(JK7.compute_cells_and_proofs(b, j_setup) for b in blobs))
    yield {"j": jspec, "p": spec, "blobs": blobs, "cs": cs, "blob_proofs": blob_proofs,
           "cells": list(cells), "proofs": list(proofs),
           "cell_bytes": [[cell_bytes(c) for c in cl] for cl in cells], "jax": {}}
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    getattr(jax_bls, f"use_{jax_backend}", jax_bls.use_py)()
    mesh_state.use_auto()


@pytest.fixture(params=["py", "torch"])
def backend(request):
    """The port on python BLS or on the plain kernels (``use_torch("cpu")``)."""
    if request.param == "torch":
        bls.use_torch("cpu")
    yield request.param
    bls.use_py()


def jax_once(case, key, fn):
    """The JAX package's answer ``fn()``, computed once for both port
    backends."""
    if key not in case["jax"]:
        case["jax"][key] = fn()
    return case["jax"][key]


def test_widths(case):
    jspec, spec = case["j"], case["p"]
    assert int(spec.NUMBER_OF_COLUMNS) == int(jspec.NUMBER_OF_COLUMNS) == 2
    assert int(spec.BYTES_PER_BLOB) == int(jspec.BYTES_PER_BLOB) == 32 * WIDTH
    assert int(spec.BYTES_PER_CELL) == int(jspec.BYTES_PER_CELL) == 32 * 64
    assert spec.kzg_setup.FIELD_ELEMENTS_PER_BLOB == WIDTH


def test_compute_cells_and_proofs(case, backend):
    jspec, spec = case["j"], case["p"]
    b = case["blobs"][0]
    got = spec.compute_cells_and_proofs(b)
    want = jax_once(case, "cells", lambda: jspec.compute_cells_and_proofs(b))
    assert got[0] == want[0] == case["cells"][0]
    assert [bytes(p) for p in got[1]] == [bytes(p) for p in want[1]] == case["proofs"][0]
    assert spec.compute_cells(b) == want[0]


def altered(cell: bytes) -> bytes:
    """``cell`` with its second element plus one."""
    x = int.from_bytes(cell[32:64], "big")
    return cell[:32] + ((x + 1) % R).to_bytes(32, "big") + cell[64:]


@pytest.mark.parametrize("valid", [True, False])
def test_verify_cell_proof(case, backend, valid):
    """At this width a cell's quotient is zero: every proof is the point
    at infinity, so a changed cell is what fails."""
    jspec, spec = case["j"], case["p"]
    cell = case["cell_bytes"][1][1]
    args = (case["cs"][1], 1, cell if valid else altered(cell), case["proofs"][1][1])
    want = jax_once(case, ("cell", valid), lambda: jspec.verify_cell_proof(*args))
    assert spec.verify_cell_proof(*args) is want is valid


def _batch(case, valid):
    """Every cell of blobs 0 and 1 as one batch over the three row
    commitments; invalid: the proof of blob 1's cell 0 replaced by a
    commitment (a point other than infinity)."""
    rows = [0, 0, 1, 1]
    cols = [0, 1, 0, 1]
    cells = [case["cell_bytes"][r][c] for r, c in zip(rows, cols)]
    proofs = [case["proofs"][r][c] for r, c in zip(rows, cols)]
    if not valid:
        proofs[2] = case["cs"][2]
    return list(case["cs"]), rows, cols, cells, proofs


@pytest.mark.parametrize("valid", [True, False])
def test_verify_cell_proof_batch(case, backend, valid):
    """The port's batch against the JAX engine route and the JAX spec
    loop; the port's spec loop too on python BLS."""
    jspec, spec = case["j"], case["p"]
    args = _batch(case, valid)
    jax_loop = jax_fork_registry()["eip7594"].__dict__["verify_cell_proof_batch"]._das_spec_body
    want = jax_once(case, ("batch", valid), lambda: (jspec.verify_cell_proof_batch(*args),
                                                     jax_loop(jspec, *args)))
    assert want == (valid, valid)
    assert spec.verify_cell_proof_batch(*args) is valid
    if backend == "py":
        assert spec.verify_cell_proof_batch_loop(*args) is valid


@pytest.mark.parametrize("kept", [0, 1])
def test_recovery(case, backend, kept):
    jspec, spec = case["j"], case["p"]
    for i in range(BLOBS):
        ids, cells = [kept], [case["cell_bytes"][i][kept]]
        data = spec.recover_polynomial(ids, cells)
        assert data == jax_once(case, ("recover", i, kept),
                                lambda: jspec.recover_polynomial(ids, cells))
        assert data == [x for cell in case["cells"][i] for x in cell]
    ids, cells = [kept], [case["cell_bytes"][0][kept]]
    got = spec.recover_cells_and_kzg_proofs(ids, cells)
    want = jax_once(case, ("recover_proofs", kept),
                    lambda: jspec.recover_cells_and_kzg_proofs(ids, cells))
    assert got[0] == want[0] == case["cells"][0]
    assert [bytes(p) for p in got[1]] == [bytes(p) for p in want[1]] == case["proofs"][0]
    with pytest.raises(AssertionError):
        spec.recover_polynomial([kept, kept], cells * 2)


@pytest.fixture(scope="module")
def block_case(case):
    """A JAX genesis at slot 3 and a signed block for slot 4 carrying the
    three blob commitments (their blob transaction and blob gas), an
    attestation and a sync aggregate; and the JAX post-state."""
    jspec = case["j"]
    with bls_on():
        state = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                     jspec.MAX_EFFECTIVE_BALANCE)
    jspec.process_slots(state, 3)
    post = state.copy()
    with bls_on():
        block = jax_block.build_empty_block_for_next_slot(jspec, post)
        block.body.attestations.append(jax_att.get_valid_attestation(
            jspec, post, slot=post.slot, index=0, signed=True))
    block.body.blob_kzg_commitments = list(case["cs"])
    hashes = [bytes(jspec.kzg_commitment_to_versioned_hash(c)) for c in case["cs"]]
    block.body.execution_payload.transactions.append(b"\x03" + b"".join(hashes))
    block.body.execution_payload.blob_gas_used = BLOBS * GAS_PER_BLOB
    nxt = post.copy()
    jspec.process_slots(nxt, block.slot)
    rng = Random(17)
    block.body.sync_aggregate = sync_aggregate(
        jspec, nxt, [rng.random() < 0.8 for _ in range(jspec.SYNC_COMMITTEE_SIZE)])
    jax_block.transition_unsigned_block(jspec, post, block)
    block.state_root = jax_ssz.hash_tree_root(post)
    with bls_on():
        signed = jax_block.sign_block(jspec, state, block, block.proposer_index)
    return {"pre": state, "signed": signed, "post": post}


def test_data_column_sidecars(case, block_case, backend):
    """The sidecars of a signed block equal; column 0 verifies, column 1
    with one proof replaced fails, in both packages."""
    jspec, spec = case["j"], case["p"]
    signed = block_case["signed"]
    cells_and_proofs = list(zip(case["cells"], case["proofs"]))
    want = jspec.get_data_column_sidecars(signed, cells_and_proofs)
    got = spec.get_data_column_sidecars(carry(spec, signed, "SignedBeaconBlock"),
                                        cells_and_proofs)
    assert [root(s) for s in got] == [jroot(s) for s in want] and len(got) == 2
    assert root(got[0].signed_block_header) == root(spec.signed_block_header(
        carry(spec, signed, "SignedBeaconBlock")))
    bad = want[1].copy()
    bad.kzg_proofs[2] = case["cs"][0]
    assert jax_once(case, "sidecars", lambda: (
        jspec.verify_data_column_sidecar_kzg_proofs(want[0]),
        jspec.verify_data_column_sidecar_kzg_proofs(bad))) == (True, False)
    assert spec.verify_data_column_sidecar_kzg_proofs(got[0]) is True
    assert spec.verify_data_column_sidecar_kzg_proofs(
        carry(spec, bad, "DataColumnSidecar")) is False


def _sampled(case, bad_blob=None):
    """The cell stub's answer: both cells of every blob with their proofs;
    one element of cell 0 of ``bad_blob`` changed."""
    out = []
    for i in range(BLOBS):
        cells = list(case["cell_bytes"][i])
        if i == bad_blob:
            cells[0] = altered(cells[0])
        out.append(([0, 1], cells, list(case["proofs"][i])))
    return out


@pytest.fixture
def stubs(case, monkeypatch):
    """Set a retrieval stub on both specs (removed after the test)."""
    def put(name, fn):
        for s in (case["j"], case["p"]):
            monkeypatch.setattr(s, name, fn, raising=False)
    return put


def test_is_data_available_full_blobs(case, stubs):
    """Without a cell stub: Deneb's full-blob check, in both packages."""
    jspec, spec = case["j"], case["p"]
    stubs("retrieve_blobs_and_proofs", lambda r: (case["blobs"], case["blob_proofs"]))
    assert spec.is_data_available(b"\x00" * 32, case["cs"]) is True
    assert jspec.is_data_available(b"\x00" * 32, case["cs"]) is True
    stubs("retrieve_blobs_and_proofs", lambda r: (case["blobs"], case["blob_proofs"][::-1]))
    assert spec.is_data_available(b"\x00" * 32, case["cs"]) is False
    assert jspec.is_data_available(b"\x00" * 32, case["cs"]) is False


def test_is_data_available_cells_take_precedence(case, stubs, monkeypatch):
    """The cell stub wins over a blob stub whose proofs are wrong; the spec
    loop is never called."""
    jspec, spec = case["j"], case["p"]

    def no_loop(*a):
        raise AssertionError("the spec loop was called")
    monkeypatch.setattr(spec, "verify_cell_proof_batch_loop", no_loop)
    stubs("retrieve_blobs_and_proofs", lambda r: (case["blobs"], case["blob_proofs"][::-1]))
    stubs("retrieve_cells_and_proofs", lambda r: _sampled(case))
    assert spec.is_data_available(b"\x00" * 32, case["cs"]) is True
    assert jspec.is_data_available(b"\x00" * 32, case["cs"]) is True


def test_is_data_available_withheld_and_bad_cell(case, stubs):
    """A withheld blob answers False without a pairing check, in a scope
    or not; outside a scope a bad cell answers False at once."""
    jspec, spec = case["j"], case["p"]
    stubs("retrieve_cells_and_proofs", lambda r: _sampled(case)[:BLOBS - 1])
    with bls.scoped_batch(bls.DeferredBatch()) as batch:
        assert spec.is_data_available(b"\x00" * 32, case["cs"]) is False
    with jax_bls.scoped_batch(jax_bls.DeferredBatch()) as jbatch:
        assert jspec.is_data_available(b"\x00" * 32, case["cs"]) is False
    assert batch.pairing_checks == jbatch.pairing_checks == []
    stubs("retrieve_cells_and_proofs", lambda r: _sampled(case, bad_blob=1))
    assert spec.is_data_available(b"\x00" * 32, case["cs"]) is False
    assert jspec.is_data_available(b"\x00" * 32, case["cs"]) is False


@pytest.mark.parametrize("valid", [True, False])
def test_is_data_available_joins_the_block(case, block_case, stubs, valid):
    """``is_data_available`` and ``state_transition`` in one scope on both
    packages: the three blobs' cell checks join the block's items in one
    product pairing, and the post-states are equal; with one cell of blob
    1 altered the transition raises in both, every item passes and
    ``last_pairing_results`` names the check of blob 1 alone."""
    jspec, spec = case["j"], case["p"]
    stubs("retrieve_cells_and_proofs", lambda r: _sampled(case, None if valid else 1))
    signed = block_case["signed"]
    block_root = jax_ssz.hash_tree_root(signed.message)
    results = []
    for package, s, state, sb in (
            (jax_bls, jspec, block_case["pre"].copy(), signed),
            (bls, spec, carry(spec, block_case["pre"], "BeaconState"),
             carry(spec, signed, "SignedBeaconBlock"))):
        package.clear_verify_memo()
        with bls_on():
            with package.scoped_batch(package.DeferredBatch()) as batch:
                assert s.is_data_available(block_root, sb.message.body.blob_kzg_commitments)
                assert [lb for _, lb in batch.pairing_checks] == ["das_cells"] * BLOBS
                if valid:
                    s.state_transition(state, sb)
                else:
                    with pytest.raises(AssertionError):
                        s.state_transition(state, sb)
        results.append((batch.last_results, batch.last_pairing_results, state))
    (jres, jchecks, jstate), (pres, pchecks, pstate) = results
    assert pres == jres == [True] * 4
    assert pchecks == jchecks == ([True] * BLOBS if valid else [True, False, True])
    if valid:
        assert root(pstate) == jroot(jstate) == jroot(block_case["post"])
        assert batch.pairings == 1
    else:
        assert batch.pairings == 1 + 4 + BLOBS


def _checks(package, spec, case, kzg_at=None):
    """The deferred checks of six cell batches (each blob's cell 0, then
    each blob's cell 1) queued in a scope of ``package``; at ``kzg_at`` the
    blob batch's ``kzg_batch`` check instead."""
    with package.scoped_batch(package.DeferredBatch()) as batch:
        for k in range(6):
            if k == kzg_at:
                spec.verify_blob_kzg_proof_batch(case["blobs"], case["cs"], case["blob_proofs"])
                continue
            i, c = k % BLOBS, k // BLOBS
            spec.verify_cell_proof_batch([case["cs"][i]], [0], [c], [case["cell_bytes"][i][c]],
                                         [case["proofs"][i][c]])
        checks = list(batch.pairing_checks)
        ok = batch.flush()
    return checks, ok, batch.last_pairing_results


@pytest.mark.parametrize("kzg_at", [None, 2])
def test_derive_scalars_six_checks(case, kzg_at):
    """The Fiat-Shamir transcript over six deferred checks (labels, pair
    counts, compressed points, in queue order) byte for byte, with no
    item and with two; the flushes agree."""
    jchecks, jok, jres = _checks(jax_bls, case["j"], case, kzg_at)
    pchecks, pok, pres = _checks(bls, case["p"], case, kzg_at)
    labels = ["das_cells"] * 6
    if kzg_at is not None:
        labels[kzg_at] = "kzg_batch"
    assert [lb for _, lb in pchecks] == [lb for _, lb in jchecks] == labels
    for (jp, _), (pp, _) in zip(jchecks, pchecks):
        assert [(p.to_compressed(), q.to_compressed()) for p, q in pp] == \
            [(p.to_compressed(), q.to_compressed()) for p, q in jp]
    items = block_items()
    for its in ([], items):
        ours = bls_rlc.derive_scalars(its, pchecks)
        assert ours == jax_rlc.derive_scalars(its, jchecks) and len(ours) == len(its) + 6
    assert (pok, pres) == (jok, jres) == (True, [True] * 6)


def block_items():
    """Two signed items (the oracle's)."""
    from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as PO
    out = []
    for n, tag in ((1, b"randao"), (2, b"attestation")):
        msg = tag.ljust(32, b"\x00")
        keys = (3, 5)[:n]
        out.append(([PO.SkToPk(k) for k in keys], msg,
                    PO.Aggregate([PO.Sign(k, msg) for k in keys])))
    return out
