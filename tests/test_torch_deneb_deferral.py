"""The port's deferral of raw pairing-product checks into a block's batch
(``utils/bls.defer_pairing_check``, ``ops/bls_rlc``, the ``extra_pairs``
of ``bls_torch.rlc_combined_check``) against the JAX package's, exact on
scalars and verdicts:

- ``derive_scalars(items, checks)`` byte for byte with 0, 1 and 2
  deferred checks, empty and non-empty labels and points at infinity;
- the combined verdict on ``"py"`` and on ``bls.use_torch("cpu")`` (the
  plain K1-K4) against JAX ``combined_check(..., "py")``, for valid and
  invalid checks, with and without items;
- on the width-8 setup of ``tests/_torch_kzg.py``: inside a scope one
  ``FastAggregateVerify`` and ``verify_blob_kzg_proof_batch`` flush as one
  product pairing; a wrong proof leaves ``last_results == [True]`` and
  ``last_pairing_results == [False]``, as in the JAX package; outside a
  scope the answer is False at once; a scope that holds only a deferred
  check flushes;
- the DAS cell batch's deferral (``das_cells``) on a width-64 setup;
- a CUDA tensor never takes a plain version on the ``extra_pairs`` route.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.das import kernels as JD
from consensus_specs_tpu.ops import bls_rlc as jax_rlc
from consensus_specs_tpu.ops import kzg as JK
from consensus_specs_tpu.ops import kzg_7594 as JK7
from consensus_specs_tpu.ops.bls12_381 import curve as JC
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.das import kernels as PD
from consensus_specs_tpu_torch.ops import bls_rlc, bls_torch
from consensus_specs_tpu_torch.ops import kzg as PK
from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as PO
from consensus_specs_tpu_torch.ops.bls12_381 import curve as PC
from consensus_specs_tpu_torch.ops.torch_bls import pairing
from consensus_specs_tpu_torch.utils import bls
from tests._torch_kzg import R, Setup, blob, setup_points
from tests._torch_port import one_torch_thread  # noqa: F401

SEED = 7514
KEYS = (3, 5, 11)


def _items(valid=True):
    """Two FastAggregateVerify triples signed by the oracle; the second
    over another message where ``valid`` is False."""
    pks = [PO.SkToPk(k) for k in KEYS]
    out = []
    for n, tag in ((1, b"randao"), (3, b"attestation")):
        msg = bytes(tag).ljust(32, b"\x00")
        sig = PO.Aggregate([PO.Sign(k, msg) for k in KEYS[:n]])
        out.append((pks[:n], msg, sig))
    if not valid:
        pk, msg, sig = out[1]
        out[1] = (pk, msg, PO.Aggregate([PO.Sign(k, b"other".ljust(32, b"\x00"))
                                          for k in KEYS]))
    return out


def _check(curve, a, b, valid=True, infinity=False):
    """(pairs, label) for e([a]G1, [b]G2) * e(-[ab (+1)]G1, G2) == 1 in the
    package of ``curve``; ``infinity`` adds a pair with the G1 point at
    infinity, which contributes 1."""
    g1, g2 = curve.G1_GENERATOR, curve.G2_GENERATOR
    c = a * b % R + (0 if valid else 1)
    pairs = [(g1.mult(a), g2.mult(b)), (-(g1.mult(c)), g2)]
    if infinity:
        pairs.append((curve.G1Point.inf(), g2.mult(a)))
    return pairs


def _checks(curve, n, label, valid=True):
    return [(_check(curve, 7 + k, 9 + 2 * k, valid or k == 0, infinity=k == 1), label)
            for k in range(n)]


@pytest.mark.parametrize("label", ["", "kzg_batch"])
@pytest.mark.parametrize("n_checks", [0, 1, 2])
def test_derive_scalars_byte_identical(n_checks, label):
    items = _items()
    ours = bls_rlc.derive_scalars(items, _checks(PC, n_checks, label))
    want = jax_rlc.derive_scalars(items, _checks(JC, n_checks, label))
    assert ours == want and len(ours) == len(items) + n_checks
    assert bls_rlc.derive_scalars(items[:1], _checks(PC, n_checks, label)) == \
        jax_rlc.derive_scalars(items[:1], _checks(JC, n_checks, label))
    if n_checks:
        assert bls_rlc.derive_scalars([], _checks(PC, n_checks, label)) == \
            jax_rlc.derive_scalars([], _checks(JC, n_checks, label))


@pytest.fixture(scope="module")
def port_torch():
    bls.use_torch("cpu")
    yield
    bls.use_py()


@pytest.mark.parametrize("case", ["valid", "bad_check", "bad_item", "checks_only",
                                  "bad_checks_only"])
def test_combined_verdict(port_torch, case):
    """The combined verdict of the port's python and plain-K1-K4 folds
    equals JAX ``combined_check(..., "py")``."""
    items = [] if case.startswith(("checks", "bad_checks")) else _items(case != "bad_item")[1:]
    valid = case not in ("bad_check", "bad_checks_only")
    want = jax_rlc.combined_check(items, _checks(JC, 2, "kzg_batch", valid), "py")
    assert want is (case in ("valid", "checks_only"))
    port_checks = _checks(PC, 2, "kzg_batch", valid)
    assert bls_rlc.combined_check(items, port_checks, "py") is want
    assert bls_rlc.combined_check(items, port_checks, "torch", "cpu") is want


@pytest.fixture(scope="module")
def kzg_case():
    """Width-8 blobs, commitments and proofs (JAX package), the two
    packages' setups and a signed item for the scope."""
    rng = np.random.default_rng(SEED)
    points = setup_points(8, 9)
    j_setup, p_setup = Setup(points, JC.g2_from_compressed), Setup(points, PC.g2_from_compressed)
    blobs = [blob(rng, 8) for _ in range(2)]
    cs = [JK.blob_to_kzg_commitment(b, j_setup) for b in blobs]
    proofs = [JK.compute_blob_kzg_proof(b, c, j_setup) for b, c in zip(blobs, cs)]
    pk = PO.SkToPk(KEYS[0])
    msg = b"block".ljust(32, b"\x00")
    return {"j": j_setup, "p": p_setup, "blobs": blobs, "cs": cs, "proofs": proofs,
            "item": ([pk], msg, PO.Sign(KEYS[0], msg))}


def _jax_scope(kzg_case, proofs, with_item=True):
    """The JAX package's verdicts for the same scope."""
    pks, msg, sig = kzg_case["item"]
    jax_bls.clear_verify_memo()
    with jax_bls.scoped_batch(jax_bls.DeferredBatch()) as batch:
        if with_item:
            assert jax_bls.FastAggregateVerify(pks, msg, sig)
        assert JK.verify_blob_kzg_proof_batch(kzg_case["blobs"], kzg_case["cs"], proofs,
                                              kzg_case["j"]) is True
        assert [lb for _, lb in batch.pairing_checks] == ["kzg_batch"]
        ok = batch.flush()
    return ok, batch.last_results, batch.last_pairing_results


@pytest.mark.parametrize("valid", [True, False])
def test_blob_batch_joins_the_block_flush(port_torch, kzg_case, valid):
    proofs = kzg_case["proofs"] if valid else kzg_case["proofs"][::-1]
    pks, msg, sig = kzg_case["item"]
    bls.clear_verify_memo()
    with bls.scoped_batch(bls.DeferredBatch()) as batch:
        assert bls.FastAggregateVerify(pks, msg, sig) is True
        assert PK.verify_blob_kzg_proof_batch(kzg_case["blobs"], kzg_case["cs"], proofs,
                                              kzg_case["p"]) is True
        assert [lb for _, lb in batch.pairing_checks] == ["kzg_batch"]
        ok = batch.flush()
    assert (ok, batch.last_results, batch.last_pairing_results) == \
        _jax_scope(kzg_case, proofs) == (valid, [True], [valid])
    # one product pairing, or that and the bisect's item and check
    assert batch.pairings == (1 if valid else 3)
    if not valid:
        with pytest.raises(AssertionError, match=r"items \[\], deferred checks \[0\]"):
            with bls.scoped_batch(bls.DeferredBatch()) as again:
                PK.verify_blob_kzg_proof_batch(kzg_case["blobs"], kzg_case["cs"], proofs,
                                               kzg_case["p"])
                again.assert_valid()


@pytest.mark.parametrize("valid", [True, False])
def test_blob_batch_outside_a_scope_and_checks_alone(port_torch, kzg_case, valid):
    """No scope: the eager verdict.  A scope holding only the deferred
    check flushes to the same verdict, as in the JAX package."""
    proofs = kzg_case["proofs"] if valid else kzg_case["proofs"][::-1]
    assert not bls.batch_scope_active()
    assert bls.defer_pairing_check([], "none") is False
    assert PK.verify_blob_kzg_proof_batch(kzg_case["blobs"], kzg_case["cs"], proofs,
                                          kzg_case["p"]) is valid
    with bls.scoped_batch(bls.DeferredBatch()) as batch:
        PK.verify_blob_kzg_proof_batch(kzg_case["blobs"], kzg_case["cs"], proofs,
                                       kzg_case["p"])
        ok = batch.flush()
    assert (ok, batch.last_results, batch.last_pairing_results) == \
        _jax_scope(kzg_case, proofs, with_item=False) == (valid, [], [valid])
    assert batch.pairings == (1 if valid else 2)


@pytest.fixture(scope="module")
def cells_case():
    """A width-64 blob's commitment, cells and cell proofs (JAX package)."""
    rng = np.random.default_rng(SEED + 1)
    points = setup_points(64, 65)
    j_setup, p_setup = Setup(points, JC.g2_from_compressed), Setup(points, PC.g2_from_compressed)
    b = blob(rng, 64)
    commitment = JK.blob_to_kzg_commitment(b, j_setup)
    cells, proofs = JK7.compute_cells_and_proofs(b, j_setup)
    cells = [b"".join(int(x).to_bytes(32, "big") for x in c) for c in cells]
    return j_setup, p_setup, commitment, cells, proofs


@pytest.mark.parametrize("valid", [True, False])
def test_das_cells_deferral(cells_case, valid):
    j_setup, p_setup, commitment, cells, proofs = cells_case
    if not valid:
        cells = [cells[0], cells[1][:-1] + bytes([cells[1][-1] ^ 1])]
    args = ([commitment], [0, 0], [0, 1], cells[:2], proofs[:2])
    results = []
    for package, setup in ((jax_bls, j_setup), (bls, p_setup)):
        verify = (JD if package is jax_bls else PD).verify_cell_proof_batch
        with package.scoped_batch(package.DeferredBatch()) as batch:
            assert verify(*args, setup) is True
            assert [lb for _, lb in batch.pairing_checks] == ["das_cells"]
            results.append((batch.flush(), batch.last_results, batch.last_pairing_results))
    assert results[0] == results[1] == (valid, [], [valid])


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """On the ``extra_pairs`` route a CUDA tensor launches K4 or raises:
    here the build fails (no nvcc), and no plain version runs."""
    def no_plain(*a, **kw):
        raise AssertionError("plain version used for CUDA tensors")
    monkeypatch.setattr(pairing, "pairing_check_plain", no_plain)
    monkeypatch.setattr(pairing, "pairing_check_gt_plain", no_plain)
    monkeypatch.setattr(_build, "same_device", lambda *t: torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError)) as exc:
        bls_torch.rlc_combined_check([], [], [], [], "cpu", extra_pairs=_check(PC, 3, 4))
    assert "plain version used" not in str(exc.value)
