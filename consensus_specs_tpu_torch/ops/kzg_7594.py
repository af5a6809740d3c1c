"""EIP-7594 (PeerDAS) polynomial sampling: FFT, cells, KZG multiproofs,
erasure recovery.

Counterpart of ``consensus_specs_tpu/ops/kzg_7594.py``.  Behavioral
parity with
``specs/_features/eip7594/polynomial-commitments-sampling.md`` (cited per
function).  This is the reference's "long-context" axis: a blob is
Reed-Solomon-extended x2 and split into ``CELLS_PER_BLOB`` cells held by
different nodes; any half recovers the original via FFT + vanishing
polynomials.

The field FFT is implemented iteratively (radix-2, in-place butterflies)
rather than by the spec's recursion - identical outputs, and the
butterfly schedule is the one kernel K9 (``ops/fr_fft.py``) runs on the
card for the DAS engine's batched recovery.  This host ``fft_field``
stays the spec path (``compute_cells`` uses it, as in the JAX package).
MSMs go through ``kzg.g1_lincomb`` (K7/K8 under the torch backend);
``g2_lincomb`` stays on the oracle.

The EIP-7594 runtime (``forks/eip7594.py``) is its caller: its cell
proofs and their single checks, its polynomial ring and its spec loop
(``verify_cell_proof_batch_loop``) delegate here.
"""
from typing import Sequence, Tuple

from .bls12_381.curve import G2_GENERATOR, G2Point, g2_from_compressed, msm
from . import kzg as K

BLS_MODULUS = K.BLS_MODULUS

# Preset (polynomial-commitments-sampling.md:76-86)
FIELD_ELEMENTS_PER_CELL = 64
RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN = b"RCKZGCBATCH__V1_"


def _ext_width(setup) -> int:
    return 2 * setup.FIELD_ELEMENTS_PER_BLOB


def cells_per_blob(setup) -> int:
    return _ext_width(setup) // FIELD_ELEMENTS_PER_CELL


def bytes_to_cell(cell_bytes) -> list:
    """md:92 — one cell's worth of Bytes32 -> field elements
    (validated).  Accepts the flat-bytes spec encoding (the markdown
    surface and the corpus format) or the library's legacy list of
    32-byte chunks."""
    if isinstance(cell_bytes, (bytes, bytearray)):
        # exact-length gate, same as the spec body and the engine: a
        # short flat cell would otherwise shrink the extended-domain
        # slice assignment in recovery and fail far from the cause
        assert len(cell_bytes) == 32 * FIELD_ELEMENTS_PER_CELL
        return [K.bytes_to_bls_field(cell_bytes[32 * i:32 * (i + 1)])
                for i in range(FIELD_ELEMENTS_PER_CELL)]
    return [K.bytes_to_bls_field(b) for b in cell_bytes]


def g2_lincomb(points: Sequence[bytes], scalars: Sequence[int]) -> bytes:
    """md:104 - small G2 MSM (vanishing-polynomial commitment) by the
    oracle's group-generic Pippenger (``curve.msm``)."""
    assert len(points) == len(scalars)
    if not points:
        return G2Point.inf().to_compressed()
    return msm([g2_from_compressed(bytes(x)) for x in points],
               [int(a) % BLS_MODULUS for a in scalars]).to_compressed()


# ---------------------------------------------------------------------------
# FFT (md:118-152)
# ---------------------------------------------------------------------------

def _fft_field(vals, roots_of_unity):
    """Iterative radix-2 DIT FFT; output identical to the spec's
    recursion (md:120)."""
    n = len(vals)
    if n == 1:
        return list(vals)
    out = [int(vals[K.reverse_bits(i, n)]) for i in range(n)]
    # roots_of_unity[i] = w^i over the full domain; stage m uses strides
    m = 2
    while m <= n:
        stride = n // m
        half = m // 2
        for start in range(0, n, m):
            for j in range(half):
                w = roots_of_unity[j * stride]
                a = out[start + j]
                b = out[start + j + half] * w % BLS_MODULUS
                out[start + j] = (a + b) % BLS_MODULUS
                out[start + j + half] = (a - b) % BLS_MODULUS
        m *= 2
    return out


def fft_field(vals, roots_of_unity, inv: bool = False):
    """md:137 — forward / inverse FFT over the given root domain."""
    if inv:
        invlen = pow(len(vals), BLS_MODULUS - 2, BLS_MODULUS)
        inv_roots = list(roots_of_unity[0:1]) + list(roots_of_unity[:0:-1])
        return [x * invlen % BLS_MODULUS
                for x in _fft_field(vals, inv_roots)]
    return _fft_field(vals, roots_of_unity)


# ---------------------------------------------------------------------------
# Coefficient-form polynomials (md:154-293)
# ---------------------------------------------------------------------------

def polynomial_eval_to_coeff(polynomial, setup) -> list:
    """md:156 — evaluation form (brp domain) -> coefficient form."""
    width = setup.FIELD_ELEMENTS_PER_BLOB
    roots = list(K.compute_roots_of_unity(width))
    return fft_field(K.bit_reversal_permutation(list(polynomial)), roots,
                     inv=True)


def add_polynomialcoeff(a, b):
    a, b = (a, b) if len(a) >= len(b) else (b, a)
    return [(a[i] + (b[i] if i < len(b) else 0)) % BLS_MODULUS
            for i in range(len(a))]


def neg_polynomialcoeff(a):
    return [(BLS_MODULUS - x) % BLS_MODULUS for x in a]


def multiply_polynomialcoeff(a, b):
    r = [0] * (len(a) + len(b) - 1)
    for power, coef in enumerate(a):
        c = int(coef)
        if c == 0:
            continue
        for j, x in enumerate(b):
            r[power + j] = (r[power + j] + c * int(x)) % BLS_MODULUS
    return r


def divide_polynomialcoeff(a, b):
    """md:205 — long division."""
    a = [int(x) for x in a]
    o = []
    apos = len(a) - 1
    bpos = len(b) - 1
    diff = apos - bpos
    while diff >= 0:
        quot = K.div(a[apos], b[bpos])
        o.insert(0, quot)
        for i in range(bpos, -1, -1):
            a[diff + i] = (a[diff + i] - int(b[i]) * quot) % BLS_MODULUS
        apos -= 1
        diff -= 1
    return [x % BLS_MODULUS for x in o]


def shift_polynomialcoeff(polynomial_coeff, factor):
    """md:227 — g(x) = f(factor * x)... via successive inverse powers."""
    factor_power = 1
    inv_factor = pow(int(factor), BLS_MODULUS - 2, BLS_MODULUS)
    o = []
    for p in polynomial_coeff:
        o.append(int(p) * factor_power % BLS_MODULUS)
        factor_power = factor_power * inv_factor % BLS_MODULUS
    return o


def interpolate_polynomialcoeff(xs, ys):
    """md:244 — Lagrange interpolation in coefficient form."""
    assert len(xs) == len(ys)
    r = [0]
    for i in range(len(xs)):
        summand = [int(ys[i])]
        for j in range(len(ys)):
            if j != i:
                weight_adjustment = K.bls_modular_inverse(
                    (int(xs[i]) - int(xs[j])) % BLS_MODULUS)
                summand = multiply_polynomialcoeff(
                    summand,
                    [(-weight_adjustment * int(xs[j])) % BLS_MODULUS,
                     weight_adjustment])
        r = add_polynomialcoeff(r, summand)
    return r


def vanishing_polynomialcoeff(xs):
    p = [1]
    for x in xs:
        p = multiply_polynomialcoeff(p, [(-int(x)) % BLS_MODULUS, 1])
    return p


def evaluate_polynomialcoeff(polynomial_coeff, z) -> int:
    y = 0
    for coef in reversed(polynomial_coeff):
        y = (y * int(z) + int(coef)) % BLS_MODULUS
    return y


# ---------------------------------------------------------------------------
# KZG multiproofs (md:295-346)
# ---------------------------------------------------------------------------

def compute_kzg_proof_multi_impl(polynomial_coeff, zs,
                                 setup) -> Tuple[bytes, list]:
    """md:299"""
    ys = [evaluate_polynomialcoeff(polynomial_coeff, z) for z in zs]
    interpolation_polynomial = interpolate_polynomialcoeff(zs, ys)
    polynomial_shifted = add_polynomialcoeff(
        polynomial_coeff, neg_polynomialcoeff(interpolation_polynomial))
    denominator_poly = vanishing_polynomialcoeff(zs)
    quotient_polynomial = divide_polynomialcoeff(polynomial_shifted,
                                                 denominator_poly)
    return K.g1_lincomb(
        setup.KZG_SETUP_G1_MONOMIAL[:len(quotient_polynomial)],
        quotient_polynomial, cache_key="monomial"), ys


def verify_kzg_proof_multi_impl(commitment, zs, ys, proof, setup) -> bool:
    """md:323 - e(proof, [Z(tau)]G2) == e(C - [I(tau)]G1, G2)."""
    assert len(zs) == len(ys)
    zero_poly = g2_lincomb(setup.KZG_SETUP_G2_MONOMIAL[:len(zs) + 1],
                           vanishing_polynomialcoeff(zs))
    interpolated_poly = K.g1_lincomb(
        setup.KZG_SETUP_G1_MONOMIAL[:len(zs)],
        interpolate_polynomialcoeff(zs, ys), cache_key="monomial")
    return K._pairing_check([
        (K._g1_of(proof), g2_from_compressed(zero_poly)),
        (K._g1_of(commitment) + (-K._g1_of(interpolated_poly)),
         -G2_GENERATOR),
    ])


# ---------------------------------------------------------------------------
# Cells (md:348-476)
# ---------------------------------------------------------------------------

def coset_for_cell(cell_id: int, setup) -> list:
    """md:350"""
    assert cell_id < cells_per_blob(setup)
    roots_brp = K.bit_reversal_permutation(
        list(K.compute_roots_of_unity(_ext_width(setup))))
    return roots_brp[FIELD_ELEMENTS_PER_CELL * cell_id:
                     FIELD_ELEMENTS_PER_CELL * (cell_id + 1)]


def compute_cells_and_proofs(blob: bytes, setup):
    """md:368 — all cells + per-cell multiproofs (O(n^2) spec algorithm)."""
    polynomial = K.blob_to_polynomial(bytes(blob),
                                      setup.FIELD_ELEMENTS_PER_BLOB)
    polynomial_coeff = polynomial_eval_to_coeff(polynomial, setup)
    cells, proofs = [], []
    for i in range(cells_per_blob(setup)):
        coset = coset_for_cell(i, setup)
        proof, ys = compute_kzg_proof_multi_impl(polynomial_coeff, coset,
                                                 setup)
        cells.append(ys)
        proofs.append(proof)
    return cells, proofs


def compute_cells(blob: bytes, setup):
    """md:396 — extended evaluations split into cells (no proofs)."""
    width = setup.FIELD_ELEMENTS_PER_BLOB
    polynomial = K.blob_to_polynomial(bytes(blob), width)
    polynomial_coeff = polynomial_eval_to_coeff(polynomial, setup)
    extended_data = fft_field(
        polynomial_coeff + [0] * width,
        list(K.compute_roots_of_unity(_ext_width(setup))))
    extended_data_rbo = K.bit_reversal_permutation(extended_data)
    return [extended_data_rbo[i * FIELD_ELEMENTS_PER_CELL:
                              (i + 1) * FIELD_ELEMENTS_PER_CELL]
            for i in range(cells_per_blob(setup))]


def verify_cell_proof(commitment_bytes, cell_id, cell_bytes, proof_bytes,
                      setup) -> bool:
    """md:417"""
    coset = coset_for_cell(cell_id, setup)
    return verify_kzg_proof_multi_impl(
        K.bytes_to_kzg_commitment(commitment_bytes), coset,
        bytes_to_cell(cell_bytes), K.bytes_to_kzg_proof(proof_bytes), setup)


def verify_cell_proof_batch(row_commitments_bytes, row_ids, column_ids,
                            cells_bytes, proofs_bytes, setup) -> bool:
    """md:438 — per-cell verification over the (row, column) matrix."""
    assert len(cells_bytes) == len(proofs_bytes) == len(row_ids) \
        == len(column_ids)
    commitments = [K.bytes_to_kzg_commitment(row_commitments_bytes[r])
                   for r in row_ids]
    cells = [bytes_to_cell(cb) for cb in cells_bytes]
    proofs = [K.bytes_to_kzg_proof(pb) for pb in proofs_bytes]
    return all(
        verify_kzg_proof_multi_impl(commitment,
                                    coset_for_cell(column_id, setup),
                                    cell, proof, setup)
        for commitment, column_id, cell, proof
        in zip(commitments, column_ids, cells, proofs))


# ---------------------------------------------------------------------------
# Reconstruction (md:478-640)
# ---------------------------------------------------------------------------

def construct_vanishing_polynomial(missing_cell_ids, setup):
    """md:478"""
    n_cells = cells_per_blob(setup)
    roots_of_unity_reduced = list(K.compute_roots_of_unity(n_cells))
    short_zero_poly = vanishing_polynomialcoeff([
        roots_of_unity_reduced[K.reverse_bits(mid, n_cells)]
        for mid in missing_cell_ids])
    zero_poly_coeff = [0] * _ext_width(setup)
    for i, coeff in enumerate(short_zero_poly):
        zero_poly_coeff[i * FIELD_ELEMENTS_PER_CELL] = coeff
    zero_poly_eval = fft_field(
        zero_poly_coeff, list(K.compute_roots_of_unity(_ext_width(setup))))
    zero_poly_eval_brp = K.bit_reversal_permutation(zero_poly_eval)
    for cell_id in range(n_cells):
        start = cell_id * FIELD_ELEMENTS_PER_CELL
        end = (cell_id + 1) * FIELD_ELEMENTS_PER_CELL
        if cell_id in missing_cell_ids:
            assert all(a == 0 for a in zero_poly_eval_brp[start:end])
        else:
            assert all(a != 0 for a in zero_poly_eval_brp[start:end])
    return zero_poly_coeff, zero_poly_eval, zero_poly_eval_brp


def recover_shifted_data(cell_ids, cells, zero_poly_eval, zero_poly_coeff,
                         roots_of_unity_extended, setup):
    """md:519"""
    shift_factor = K.PRIMITIVE_ROOT_OF_UNITY
    shift_inv = K.div(1, shift_factor)

    extended_evaluation_rbo = [0] * _ext_width(setup)
    for cell_id, cell in zip(cell_ids, cells):
        start = cell_id * FIELD_ELEMENTS_PER_CELL
        extended_evaluation_rbo[start:start + FIELD_ELEMENTS_PER_CELL] = cell
    extended_evaluation = K.bit_reversal_permutation(extended_evaluation_rbo)

    extended_evaluation_times_zero = [
        int(a) * int(b) % BLS_MODULUS
        for a, b in zip(zero_poly_eval, extended_evaluation)]
    extended_evaluations_fft = fft_field(extended_evaluation_times_zero,
                                         roots_of_unity_extended, inv=True)
    shifted_extended_evaluation = shift_polynomialcoeff(
        extended_evaluations_fft, shift_factor)
    shifted_zero_poly = shift_polynomialcoeff(zero_poly_coeff, shift_factor)
    eval_shifted_extended_evaluation = fft_field(
        shifted_extended_evaluation, roots_of_unity_extended)
    eval_shifted_zero_poly = fft_field(shifted_zero_poly,
                                       roots_of_unity_extended)
    return (eval_shifted_extended_evaluation, eval_shifted_zero_poly,
            shift_inv)


def recover_original_data(eval_shifted_extended_evaluation,
                          eval_shifted_zero_poly, shift_inv,
                          roots_of_unity_extended):
    """md:560"""
    eval_shifted_reconstructed_poly = [
        K.div(a, b) for a, b in zip(eval_shifted_extended_evaluation,
                                    eval_shifted_zero_poly)]
    shifted_reconstructed_poly = fft_field(eval_shifted_reconstructed_poly,
                                           roots_of_unity_extended, inv=True)
    reconstructed_poly = shift_polynomialcoeff(shifted_reconstructed_poly,
                                               shift_inv)
    return K.bit_reversal_permutation(
        fft_field(reconstructed_poly, roots_of_unity_extended))


def recover_polynomial(cell_ids, cells_bytes, setup):
    """md:586 — recover all evaluations from >=50% of the cells."""
    assert len(cell_ids) == len(cells_bytes)
    n_cells = cells_per_blob(setup)
    # integer form of the spec's >=50% bound (speclint D1002: no float
    # on a consensus path); equivalent for every integer n_cells
    assert n_cells <= 2 * len(cell_ids) and len(cell_ids) <= n_cells
    assert len(cell_ids) == len(set(cell_ids))

    roots_of_unity_extended = list(
        K.compute_roots_of_unity(_ext_width(setup)))
    cells = [bytes_to_cell(cb) for cb in cells_bytes]
    missing_cell_ids = [cid for cid in range(n_cells)
                        if cid not in cell_ids]
    zero_poly_coeff, zero_poly_eval, _ = construct_vanishing_polynomial(
        missing_cell_ids, setup)
    (eval_shifted_extended_evaluation, eval_shifted_zero_poly,
     shift_inv) = recover_shifted_data(
        cell_ids, cells, zero_poly_eval, zero_poly_coeff,
        roots_of_unity_extended, setup)
    reconstructed_data = recover_original_data(
        eval_shifted_extended_evaluation, eval_shifted_zero_poly, shift_inv,
        roots_of_unity_extended)
    for cell_id, cell in zip(cell_ids, cells):
        start = cell_id * FIELD_ELEMENTS_PER_CELL
        assert reconstructed_data[start:start + FIELD_ELEMENTS_PER_CELL] \
            == cell
    return reconstructed_data
