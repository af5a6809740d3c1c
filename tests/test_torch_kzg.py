"""The port's Deneb KZG library (``ops/kzg.py``) against the JAX package's
(``consensus_specs_tpu/ops/kzg.py``), exact at canonical boundaries:
compressed commitments and proofs, field elements as bytes, verdicts.

The library runs whole on a width-8 setup built from a known tau
(``tests/_torch_kzg.py``: test-only, insecure), under both of the port's
backends: ``bls.use_torch("cpu")``, where every MSM runs on the plain
K7/K8 and every pairing on the plain K4, and ``bls.use_py()``, the
oracle.  The JAX package runs on its default backend.  The real
4096-point setup is checked for parsing only: a full-width MSM on the
plain versions would take minutes on a CPU."""
import os

import numpy as np
import pytest

from consensus_specs_tpu.ops import kzg as JK
from consensus_specs_tpu.ops.bls12_381.curve import g2_from_compressed as j_g2
from consensus_specs_tpu_torch.ops import bls_torch, msm
from consensus_specs_tpu_torch.ops import kzg as PK
from consensus_specs_tpu_torch.ops.bls12_381.curve import g2_from_compressed as p_g2
from consensus_specs_tpu_torch.utils import bls
from tests._torch_kzg import R, Setup, blob, setup_points
from tests._torch_port import REPO, one_torch_thread  # noqa: F401

WIDTH = 8
SEED = 4844
# the plain K4 takes ~3 s per pairing on a CPU: the torch backend runs
# every entry point but the blob-level single verify, which is
# ``verify_kzg_proof_impl`` again; the oracle backend's pure-python MSMs
# and pairings cost ~1 s each, so it runs the entry points that reach
# each of them once
KEYS = ("commitments", "kzg_proof", "kzg_proof_in_domain", "blob_proofs",
        "verify_kzg_proof", "batch_valid", "batch_bad", "batch_empty")
PY_KEYS = ("commitments", "kzg_proof", "verify_kzg_proof", "verify_blob_kzg_proof",
           "batch_empty")


def _run(K, setup, blobs, z, keys=KEYS, log=None):
    """The Deneb entry points named by ``keys`` on ``blobs`` -> {key:
    canonical result}; ``log`` (a list) gets each key before its call."""
    cs = [K.blob_to_kzg_commitment(b, setup) for b in blobs]
    proof, y = K.compute_kzg_proof(blobs[0], z, setup)
    bad_y = ((int.from_bytes(y, "big") + 1) % R).to_bytes(32, "big")
    w = K.compute_roots_of_unity(WIDTH)[3].to_bytes(32, "big")
    proofs = []
    calls = {
        "commitments": lambda: cs,
        "kzg_proof": lambda: (proof, y),
        "kzg_proof_in_domain": lambda: K.compute_kzg_proof(blobs[1], w, setup),
        "blob_proofs": lambda: proofs,
        "verify_kzg_proof": lambda: (K.verify_kzg_proof(cs[0], z, y, proof, setup),
                                     K.verify_kzg_proof(cs[0], z, bad_y, proof, setup)),
        "verify_blob_kzg_proof": lambda: K.verify_blob_kzg_proof(blobs[0], cs[0], proofs[0],
                                                                 setup),
        "batch_valid": lambda: K.verify_blob_kzg_proof_batch(blobs, cs, proofs, setup),
        "batch_bad": lambda: K.verify_blob_kzg_proof_batch(blobs, cs, [proofs[1], proofs[1]],
                                                           setup),
        "batch_empty": lambda: K.verify_blob_kzg_proof_batch([], [], [], setup),
    }
    if {"blob_proofs", "verify_blob_kzg_proof", "batch_valid", "batch_bad"} & set(keys):
        proofs += [K.compute_blob_kzg_proof(b, c, setup) for b, c in zip(blobs, cs)]
    out = {}
    for k in keys:
        if log is not None:
            log.append(k)
        out[k] = calls[k]()
    return out


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(SEED)
    blobs = [blob(rng, WIDTH) for _ in range(2)]
    z = (int.from_bytes(rng.bytes(32), "big") % R).to_bytes(32, "big")
    points = setup_points(WIDTH, WIDTH + 1)
    return blobs, z, Setup(points, j_g2), Setup(points, p_g2)


@pytest.fixture(scope="module")
def results(case):
    """Every side's results, and ``log``: the torch run's keys, each
    followed by the K8 (``msm_core``) and K4 (``pairing_check``) wrapper
    calls it made."""
    blobs, z, j_setup, p_setup = case
    out = {"jax": _run(JK, j_setup, blobs, z, KEYS + ("verify_blob_kzg_proof",)),
           "log": []}
    originals = [(msm, "msm_core"), (bls_torch, "pairing_check")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in originals]

    def logged(name, fn):
        def wrapped(*a, **kw):
            out["log"].append(name)
            return fn(*a, **kw)
        return wrapped
    try:
        for mod, name, fn in originals:
            setattr(mod, name, logged(name, fn))
        bls.use_torch("cpu")
        out["torch-cpu"] = _run(PK, p_setup, blobs, z, log=out["log"])
        bls.use_py()
        out["torch_log_len"] = len(out["log"])
        out["py"] = _run(PK, p_setup, blobs, z, PY_KEYS)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
        bls.use_py()
    return out


@pytest.mark.parametrize("backend,key", [("torch-cpu", k) for k in KEYS]
                         + [("py", k) for k in PY_KEYS])
def test_deneb_library_matches_jax(results, backend, key):
    assert results[backend][key] == results["jax"][key]


def test_deneb_library_verdicts(results):
    """The JAX side's verdicts are the expected ones, so the equalities
    above compare true and false answers alike."""
    r = results["jax"]
    assert r["verify_kzg_proof"] == (True, False)
    assert r["verify_blob_kzg_proof"] is True
    assert (r["batch_valid"], r["batch_bad"], r["batch_empty"]) == (True, False, True)
    assert len(set(r["commitments"])) == 2 and JK.G1_POINT_AT_INFINITY not in r["commitments"]


@pytest.mark.parametrize("entry", ["commitment", "verify_kzg_proof", "batch"])
def test_element_at_least_r_raises_in_both(case, entry):
    blobs, z, j_setup, p_setup = case
    bad = blobs[0][:-32] + R.to_bytes(32, "big")
    r_bytes = R.to_bytes(32, "big")
    c = JK.G1_GENERATOR.to_compressed()     # a valid point in the subgroup
    for K, setup in ((JK, j_setup), (PK, p_setup)):
        call = {"commitment": lambda: K.blob_to_kzg_commitment(bad, setup),
                "verify_kzg_proof": lambda: K.verify_kzg_proof(c, r_bytes, z, c, setup),
                "batch": lambda: K.verify_blob_kzg_proof_batch([bad], [c], [c], setup)}[entry]
        with pytest.raises(AssertionError):
            call()


def test_batch_verify_runs_msms_and_one_pairing_on_the_kernels(results):
    """Under the torch backend every MSM of ``verify_blob_kzg_proof_batch``
    goes through K8's wrapper and its pairing is ONE K4 group; the
    oracle backend calls neither."""
    log = results["log"]
    start = log.index("batch_valid")
    calls = log[start + 1:log.index("batch_bad")]
    # 2 combines (C - [y]G1) + 3 lincombs; one pairing group
    assert calls == ["msm_core"] * 5 + ["pairing_check"]
    assert log.count("pairing_check") == 5
    assert len(log) == results["torch_log_len"]


def test_trusted_setup_copy_is_the_jax_packages():
    """One copy in the port serves both presets: byte-identical to both of
    the JAX package's files, parsed to the same points."""
    with open(PK.SETUP_FILE, "rb") as f:
        ours = f.read()
    for preset in ("mainnet", "minimal"):
        with open(os.path.join(REPO, "consensus_specs_tpu", "presets", preset,
                               "trusted_setup_4096.json"), "rb") as f:
            assert f.read() == ours
    j, p = JK.TrustedSetup("mainnet"), PK.TrustedSetup("minimal")
    assert p.FIELD_ELEMENTS_PER_BLOB == j.FIELD_ELEMENTS_PER_BLOB == 4096
    for name in ("KZG_SETUP_G1_MONOMIAL", "KZG_SETUP_G1_LAGRANGE",
                 "KZG_SETUP_G2_MONOMIAL", "g1_lagrange_brp"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.g2_tau.to_compressed() == j.g2_tau.to_compressed()
    with pytest.raises(ValueError):
        PK.TrustedSetup("holesky")
