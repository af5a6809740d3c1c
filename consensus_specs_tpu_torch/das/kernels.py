"""Batched DAS crypto: one pairing per cell-proof batch, columnar
multi-blob erasure recovery.

Counterpart of ``consensus_specs_tpu/das/kernels.py``.  The EIP-7594
runtime (``forks/eip7594.py``) calls it: its ``verify_cell_proof_batch``
is :func:`verify_cell_proof_batch`, its ``recover_polynomial`` one
request of :func:`recover_cells_batch`.

Verification - the per-cell check ``e(pi_k, [tau^L - s_k]_2) ==
e(C_k - [I_k(tau)]_1, [1]_2)`` (``L = FIELD_ELEMENTS_PER_CELL``,
``s_k`` the cell coset's L-th power) rearranges to
``e(pi_k, [tau^L]_2) == e(C_k - I_k + s_k*pi_k, [1]_2)``; a random
linear combination with deterministic Fiat-Shamir scalars folds every
cell of the batch into ONE product pairing check of two pairs:

    e(sum l_k pi_k, [tau^L]_2) * e(-(RLC - RLI + RLP), [1]_2) == 1

* ``RLC`` folds cells sharing a row commitment into one weighted term;
* ``RLI`` is the aggregated interpolation commitment: cells sharing a
  column share a coset, so their evaluations aggregate BEFORE the one
  shifted IFFT per distinct column;
* ``RLP`` re-weights the proofs by ``l_k * s_k``.

Under the torch backend the three MSMs and the proof fold run on K7/K8
and the pairing is one K4 group (``ops/kzg.py``).  Inside a block's
batch scope the two pairs are deferred into its one product pairing
(``bls.defer_pairing_check``, label ``das_cells``) and the call answers
True; outside a scope the pairing is evaluated at once.

Recovery - blobs missing the SAME cell set (the withheld-column shape:
every blob of a block loses identical columns) share the vanishing
polynomial, both of its full-domain FFTs AND one Montgomery batch
inversion of the shifted-domain denominators; each blob then pays 4
FFTs.  Under the torch backend the 4 FFT phases of a group run as
batched FFTs on K9 (``ops/fr_fft.py``), on the backend's device;
under the py backend they run on the host ``fft_field``.

The JAX package's supervisor deadline checks, observability counters
and ``das/engine.py`` (fault sites, breaker, audits) are not carried.
"""
from ..ops import fr_fft
from ..ops import kzg as K
from ..ops import kzg_7594 as K7
from ..ops.bls12_381.curve import G2_GENERATOR, g2_from_compressed
from ..utils import bls as _bls
from ..utils.hash_function import hash as _hash

BLS_MODULUS = K.BLS_MODULUS
CELL = K7.FIELD_ELEMENTS_PER_CELL
_DOMAIN_SEP = K7.RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN


# ---------------------------------------------------------------------------
# Per-setup domain tables (content-keyed)
# ---------------------------------------------------------------------------

_TABLES = {}


class _Tables:
    __slots__ = ("n_cells", "ext", "roots_ext", "roots_cell", "shifts",
                 "s_pows", "hinv_pows", "tau_ell_g2")

    def __init__(self, setup):
        self.ext = 2 * setup.FIELD_ELEMENTS_PER_BLOB
        self.n_cells = self.ext // CELL
        self.roots_ext = list(K.compute_roots_of_unity(self.ext))
        self.roots_cell = list(K.compute_roots_of_unity(CELL))
        # cell coset k = h_k * H_CELL with h_k = w_ext^rev(k); its L-th
        # power s_k is constant over the coset
        self.shifts = [self.roots_ext[K.reverse_bits(k, self.n_cells)]
                       for k in range(self.n_cells)]
        self.s_pows = [pow(h, CELL, BLS_MODULUS) for h in self.shifts]
        # h_k^{-i} tables for the per-column coset IFFT unshift
        self.hinv_pows = [None] * self.n_cells
        self.tau_ell_g2 = g2_from_compressed(
            setup.KZG_SETUP_G2_MONOMIAL[CELL])

    def hinv(self, k):
        pows = self.hinv_pows[k]
        if pows is None:
            hinv = pow(self.shifts[k], BLS_MODULUS - 2, BLS_MODULUS)
            pows = [1] * CELL
            for i in range(1, CELL):
                pows[i] = pows[i - 1] * hinv % BLS_MODULUS
            self.hinv_pows[k] = pows
        return pows


def _setup_key(setup):
    """Content key of a setup: a :class:`_Tables` derives exclusively
    from the blob width and the degree-L G2 monomial, so these two
    fields are the table identity (an ``id(setup)`` key could alias a
    collected setup's tables to a new one: speclint D1004)."""
    return (int(setup.FIELD_ELEMENTS_PER_BLOB),
            bytes(setup.KZG_SETUP_G2_MONOMIAL[CELL]))


def tables(setup) -> _Tables:
    key = _setup_key(setup)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES.setdefault(key, _Tables(setup))
    return t


def _cell_fields(cell_bytes):
    """Flat cell bytes -> validated field elements (the spec's
    ``bytes_to_cell`` checks: exact length, canonical elements)."""
    cell_bytes = bytes(cell_bytes)
    assert len(cell_bytes) == 32 * CELL
    out = []
    for i in range(CELL):
        element = int.from_bytes(cell_bytes[32 * i:32 * (i + 1)], "big")
        assert element < BLS_MODULUS
        out.append(element)
    return out


# ---------------------------------------------------------------------------
# Batched cell-proof verification
# ---------------------------------------------------------------------------

def batch_challenge(row_commitments, row_ids, column_ids, cells, proofs):
    """Deterministic Fiat-Shamir scalars for the RLC fold: one SHA-256
    transcript over every batch input, powers of the digest."""
    data = _DOMAIN_SEP
    data += int.to_bytes(CELL, 8, "big")
    data += int.to_bytes(len(row_commitments), 8, "big")
    data += int.to_bytes(len(cells), 8, "big")
    for commitment in row_commitments:
        data += bytes(commitment)
    for r, c, cell, proof in zip(row_ids, column_ids, cells, proofs):
        data += int.to_bytes(int(r), 8, "big")
        data += int.to_bytes(int(c), 8, "big")
        data += bytes(cell)
        data += bytes(proof)
    r = int.from_bytes(_hash(data), "big") % BLS_MODULUS
    return K.compute_powers(r, len(cells))


def verify_cell_proof_batch(row_commitments_bytes, row_ids, column_ids,
                            cells_bytes, proofs_bytes, setup) -> bool:
    """Whole-batch fold: 3 small MSMs, the proof fold and ONE product
    pairing check.  Input validation order and verdicts match the spec
    loop exactly."""
    assert len(cells_bytes) == len(proofs_bytes) == len(row_ids) \
        == len(column_ids)
    t = tables(setup)
    # the spec loop's validation pass, same exceptions in the same order
    commitments = [K.bytes_to_kzg_commitment(row_commitments_bytes[int(r)])
                   for r in row_ids]
    for c in column_ids:
        assert int(c) < t.n_cells
    cells = [_cell_fields(cb) for cb in cells_bytes]
    proofs = [K.bytes_to_kzg_proof(pb) for pb in proofs_bytes]
    if not cells:
        return True

    lambdas = batch_challenge(
        [bytes(c) for c in row_commitments_bytes], row_ids, column_ids,
        [bytes(cb) for cb in cells_bytes], proofs)

    # RLC: fold same-commitment cells into one weighted term
    weights = {}
    for lam, commitment in zip(lambdas, commitments):
        weights[commitment] = (weights.get(commitment, 0) + lam) \
            % BLS_MODULUS
    rlc = K.g1_lincomb(list(weights.keys()), list(weights.values()))

    # RLI: aggregate evaluations per distinct column, ONE shifted IFFT
    # per column, coefficients summed (interpolation is linear)
    agg_evals = {}
    for lam, col, cell in zip(lambdas, column_ids, cells):
        col = int(col)
        acc = agg_evals.get(col)
        if acc is None:
            agg_evals[col] = [lam * y % BLS_MODULUS for y in cell]
        else:
            agg_evals[col] = [(a + lam * y) % BLS_MODULUS
                              for a, y in zip(acc, cell)]
    agg_interp = [0] * CELL
    for col, evals in agg_evals.items():
        q = K7.fft_field(K.bit_reversal_permutation(evals), t.roots_cell,
                         inv=True)
        hinv = t.hinv(col)
        for i in range(CELL):
            agg_interp[i] = (agg_interp[i] + q[i] * hinv[i]) % BLS_MODULUS
    rli = K.g1_lincomb(setup.KZG_SETUP_G1_MONOMIAL[:CELL], agg_interp,
                       cache_key="monomial")

    # RLP + the proof fold
    proof_lincomb = K.g1_lincomb(proofs, lambdas)
    rlp = K.g1_lincomb(
        proofs, [lam * t.s_pows[int(col)] % BLS_MODULUS
                 for lam, col in zip(lambdas, column_ids)])

    rhs = K._g1_of(rlc) + (-K._g1_of(rli)) + K._g1_of(rlp)
    pairs = [
        (K._g1_of(proof_lincomb), t.tau_ell_g2),
        (-rhs, G2_GENERATOR),
    ]
    if _bls.defer_pairing_check(pairs, label="das_cells"):
        return True
    return K._pairing_check(pairs)


# ---------------------------------------------------------------------------
# Columnar multi-blob recovery
# ---------------------------------------------------------------------------

def _fft_rows(rows, roots_ext, inv):
    """One batched FFT of a group's rows: K9 on the torch backend's
    device, the host ``fft_field`` under the py backend."""
    if _bls.backend_name() == "torch":
        return fr_fft.fft_batch(rows, roots_ext, inv=inv,
                                device=_bls.backend_device())
    return [K7.fft_field(row, roots_ext, inv=inv) for row in rows]


def recover_cells_batch(requests, setup):
    """Batched erasure recovery: ``requests`` is a list of
    ``(cell_ids, cells_bytes)`` pairs (one blob each); returns each
    blob's full extended evaluations, byte-identical to the spec
    loop's per-blob ``recover_polynomial``.

    Blobs are grouped by missing-cell set; each group shares the
    vanishing polynomial, its two full-domain FFTs and one batch
    inversion of the shifted-domain denominators.  Validation asserts
    (duplicate ids, insufficient count, received-cell round-trip)
    mirror the spec loop exactly."""
    t = tables(setup)
    n = t.ext
    p = BLS_MODULUS
    roots_ext = t.roots_ext
    shift_factor = K.PRIMITIVE_ROOT_OF_UNITY
    shift_inv = pow(shift_factor, p - 2, p)

    parsed = []
    groups = {}
    for i, (cell_ids, cells_bytes) in enumerate(requests):
        ids = [int(c) for c in cell_ids]
        assert len(ids) == len(cells_bytes)
        assert len(set(ids)) == len(ids)
        assert all(c < t.n_cells for c in ids)
        assert 2 * len(ids) >= t.n_cells
        cells = [_cell_fields(cb) for cb in cells_bytes]
        received = set(ids)
        missing = tuple(cid for cid in range(t.n_cells)
                        if cid not in received)
        parsed.append((ids, cells))
        groups.setdefault(missing, []).append(i)

    results = [None] * len(requests)
    for missing, idxs in groups.items():
        zero_poly_coeff, zero_poly_eval, _ = \
            K7.construct_vanishing_polynomial(list(missing), setup)
        shifted_zero_poly = K7.shift_polynomialcoeff(zero_poly_coeff,
                                                     shift_factor)
        eval_shifted_zero_poly = K7.fft_field(shifted_zero_poly, roots_ext)
        # ONE batch inversion for the whole group (the spec loop pays a
        # modular inversion per evaluation point per blob)
        inv_denoms = K._batch_inverse(eval_shifted_zero_poly)

        # phase 1: (E * Z) per blob, batched IFFT
        rows = []
        for i in idxs:
            ids, cells = parsed[i]
            ext_eval_rbo = [0] * n
            for cid, cell in zip(ids, cells):
                start = cid * CELL
                ext_eval_rbo[start:start + CELL] = cell
            ext_eval = K.bit_reversal_permutation(ext_eval_rbo)
            rows.append([a * b % p
                         for a, b in zip(zero_poly_eval, ext_eval)])
        rows = _fft_rows(rows, roots_ext, True)
        # phase 2: shift onto the 7-coset, batched FFT
        rows = [K7.shift_polynomialcoeff(row, shift_factor)
                for row in rows]
        rows = _fft_rows(rows, roots_ext, False)
        # phase 3: divide out Z on the shifted domain (shared inverses),
        # batched IFFT
        rows = [[a * d % p for a, d in zip(row, inv_denoms)]
                for row in rows]
        rows = _fft_rows(rows, roots_ext, True)
        # phase 4: unshift, batched FFT, bit-reverse back
        rows = [K7.shift_polynomialcoeff(row, shift_inv) for row in rows]
        rows = _fft_rows(rows, roots_ext, False)
        for i, row in zip(idxs, rows):
            reconstructed = K.bit_reversal_permutation(row)
            ids, cells = parsed[i]
            for cid, cell in zip(ids, cells):
                start = cid * CELL
                assert reconstructed[start:start + CELL] == cell
            results[i] = reconstructed
    return results
