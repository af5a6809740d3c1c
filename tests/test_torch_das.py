"""The port's PeerDAS path against the JAX package's, exact on ints,
bytes and verdicts:

- ``kzg_7594.compute_cells`` and ``das.kernels.recover_cells_batch`` at
  the real width (4096 field elements, extended to 8192 in 128 cells):
  two blobs missing the same half of their columns (one group, a batched
  FFT of 2 rows) and a third missing a different half (a group of its
  own).  The port runs under ``bls.use_torch("cpu")``, so every FFT phase
  goes through the plain K9; there is no MSM on this path.  Compared with
  the JAX package's ``recover_cells_batch`` and its spec loop
  ``kzg_7594.recover_polynomial``.
- ``das.kernels.verify_cell_proof_batch``, true and false, on a width-64
  setup from a known tau (``tests/_torch_kzg.py``; 2 cells per blob),
  the port on the plain K7/K8/K4."""
import numpy as np
import pytest

from consensus_specs_tpu.das import kernels as JD
from consensus_specs_tpu.ops import kzg as JK
from consensus_specs_tpu.ops import kzg_7594 as JK7
from consensus_specs_tpu.ops.bls12_381.curve import g2_from_compressed as j_g2
from consensus_specs_tpu_torch.das import kernels as PD
from consensus_specs_tpu_torch.ops import fr_fft
from consensus_specs_tpu_torch.ops import kzg as PK
from consensus_specs_tpu_torch.ops import kzg_7594 as PK7
from consensus_specs_tpu_torch.ops.bls12_381.curve import g2_from_compressed as p_g2
from consensus_specs_tpu_torch.utils import bls
from tests._torch_kzg import Setup, blob, setup_points
from tests._torch_port import one_torch_thread  # noqa: F401

SEED = 128
CELLS = 128


def _cell_bytes(cell) -> bytes:
    return b"".join(int(x).to_bytes(32, "big") for x in cell)


@pytest.fixture(scope="module")
def full():
    rng = np.random.default_rng(SEED)
    j_setup, p_setup = JK.trusted_setup("mainnet"), PK.trusted_setup("mainnet")
    blobs = [blob(rng, 4096) for _ in range(3)]
    j_cells = [JK7.compute_cells(b, j_setup) for b in blobs]
    p_cells = [PK7.compute_cells(b, p_setup) for b in blobs]
    keep_a = sorted(rng.choice(CELLS, CELLS // 2, replace=False).tolist())
    keep_b = sorted(set(range(CELLS)) - set(keep_a))
    keeps = [keep_a, keep_a, keep_b]
    requests = [(keep, [_cell_bytes(cells[c]) for c in keep])
                for keep, cells in zip(keeps, j_cells)]
    stages = []
    butterfly = fr_fft.fr_butterfly
    try:
        bls.use_torch("cpu")
        fr_fft.fr_butterfly = lambda vals, tw, half: stages.append(tuple(vals.shape)) \
            or butterfly(vals, tw, half)
        ours = PD.recover_cells_batch(requests, p_setup)
    finally:
        fr_fft.fr_butterfly = butterfly
        bls.use_py()
    return {"j_cells": j_cells, "p_cells": p_cells, "requests": requests, "ours": ours,
            "stages": stages, "jax": JD.recover_cells_batch(requests, j_setup),
            "spec": [JK7.recover_polynomial(ids, cb, j_setup) for ids, cb in requests]}


@pytest.mark.parametrize("i", range(3))
def test_compute_cells_matches_jax(full, i):
    assert full["p_cells"][i] == full["j_cells"][i]
    assert len(full["p_cells"][i]) == CELLS and all(len(c) == 64 for c in full["p_cells"][i])


@pytest.mark.parametrize("i", range(3))
def test_recover_cells_batch_matches_jax_and_spec_loop(full, i):
    want = [x for cell in full["j_cells"][i] for x in cell]
    assert full["ours"][i] == full["jax"][i] == full["spec"][i] == want


def test_recovery_ran_batched_fft_stages(full):
    """Two groups, 4 batched FFTs each, 13 stages per FFT of 8192 points:
    the group of two blobs as (2, 8192) rows, the other as (1, 8192)."""
    stages = full["stages"]
    assert len(stages) == 2 * 4 * 13
    assert sorted(set(stages)) == [(1, 8192, 8), (2, 8192, 8)]


def test_recover_rejects_too_few_cells(full):
    ids, cells = full["requests"][0]
    with pytest.raises(AssertionError):
        PD.recover_cells_batch([(ids[:-1], cells[:-1])], PK.trusted_setup("mainnet"))


@pytest.fixture(scope="module")
def small():
    """A width-64 blob (2 cells), its commitment, cells and cell proofs,
    made by the JAX package."""
    rng = np.random.default_rng(SEED + 1)
    points = setup_points(64, 65)
    j_setup, p_setup = Setup(points, j_g2), Setup(points, p_g2)
    b = blob(rng, 64)
    commitment = JK.blob_to_kzg_commitment(b, j_setup)
    cells, proofs = JK7.compute_cells_and_proofs(b, j_setup)
    return j_setup, p_setup, commitment, [_cell_bytes(c) for c in cells], proofs


@pytest.mark.parametrize("valid", [True, False])
def test_verify_cell_proof_batch_matches_jax(small, valid):
    j_setup, p_setup, commitment, cells, proofs = small
    if not valid:
        cells = [cells[0], cells[1][:-1] + bytes([cells[1][-1] ^ 1])]
    args = ([commitment], [0, 0], [0, 1], cells, proofs)
    want = JD.verify_cell_proof_batch(*args, j_setup)
    try:
        bls.use_torch("cpu")
        got = PD.verify_cell_proof_batch(*args, p_setup)
    finally:
        bls.use_py()
    assert got is want is valid
