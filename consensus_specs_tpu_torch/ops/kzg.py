"""Deneb KZG polynomial-commitment library.

Counterpart of ``consensus_specs_tpu/ops/kzg.py``, with behavioral parity
with ``specs/deneb/polynomial-commitments.md`` (cited per function):
commitments and proofs over the 4096-element Lagrange trusted setup.

The KZG layer follows the BLS backend switch (``utils/bls.py``), as the
JAX package's does:

- under ``bls.use_torch()`` every ``g1_lincomb`` and ``_g1_combine`` runs
  on the card through K7/K8 (``ops/msm.py``), whatever its size, and every
  pairing check is one K4 group (``bls_torch.pairing_check_pairs``);
  ``bls.use_torch("cpu")`` runs the same path on the plain versions;
- under ``bls.use_py()`` they run on the oracle (``_pippenger_msm``,
  ``multi_pairing_check``).

What differs from the JAX package: it hands MSMs under 256 points and
every pairing to a native C library, which the port does not have; the
fixed-basis window cache is keyed by the basis's content, not by
``id(setup)``; and ``_g2_combine`` (only the single-proof
``verify_kzg_proof_impl`` uses it) stays on the oracle.

Inside a block's batch scope (``utils/bls.batched_verification``, or
``scoped_batch`` around ``is_data_available`` and ``state_transition``
as Deneb's ``on_block`` composes them), ``verify_kzg_proof_batch``
defers its final two pairs into the block's batch
(``bls.defer_pairing_check``, label ``kzg_batch``) and answers True: the
block's one product pairing folds them in, and a failing flush names the
check alone.  Outside a scope the pairing is evaluated at once.
"""
import hashlib
import json
from functools import lru_cache
from pathlib import Path
from typing import Sequence, Tuple

from ..utils import bls as _bls
from ..utils.hash_function import hash
from . import bls_torch
from . import msm as _msm
from .bls12_381.curve import (
    G1Point, G2Point, G1_GENERATOR, G2_GENERATOR, g1_from_compressed,
    g2_from_compressed)
from .bls12_381.fields import R_ORDER
from .bls12_381.pairing import multi_pairing_check

# Constants (polynomial-commitments.md:70-100)
BLS_MODULUS = R_ORDER
BYTES_PER_FIELD_ELEMENT = 32
KZG_ENDIANNESS = "big"
PRIMITIVE_ROOT_OF_UNITY = 7
G1_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 47
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"


# ---------------------------------------------------------------------------
# Bit-reversal permutation (polynomial-commitments.md:105-144)
# ---------------------------------------------------------------------------

def is_power_of_two(value: int) -> bool:
    return value > 0 and (value & (value - 1)) == 0


def reverse_bits(n: int, order: int) -> int:
    assert is_power_of_two(order)
    return int(format(n, f"0{order.bit_length() - 1}b")[::-1], 2)


def bit_reversal_permutation(sequence):
    return [sequence[reverse_bits(i, len(sequence))]
            for i in range(len(sequence))]


# ---------------------------------------------------------------------------
# Field helpers (polynomial-commitments.md:146-305)
# ---------------------------------------------------------------------------

def hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(hash(data), KZG_ENDIANNESS) % BLS_MODULUS


def bytes_to_bls_field(b: bytes) -> int:
    """Rejects values >= the BLS modulus (md:160)."""
    field_element = int.from_bytes(b, KZG_ENDIANNESS)
    assert field_element < BLS_MODULUS
    return field_element


def bls_field_to_bytes(x: int) -> bytes:
    return int(x).to_bytes(BYTES_PER_FIELD_ELEMENT, KZG_ENDIANNESS)


def bls_modular_inverse(x: int) -> int:
    assert x % BLS_MODULUS != 0
    return pow(x, -1, BLS_MODULUS)


def div(x: int, y: int) -> int:
    return x * bls_modular_inverse(y) % BLS_MODULUS


def compute_powers(x: int, n: int) -> list:
    current_power = 1
    powers = []
    for _ in range(n):
        powers.append(current_power)
        current_power = current_power * x % BLS_MODULUS
    return powers


@lru_cache(maxsize=8)
def compute_roots_of_unity(order: int) -> tuple:
    assert (BLS_MODULUS - 1) % order == 0
    root_of_unity = pow(PRIMITIVE_ROOT_OF_UNITY,
                        (BLS_MODULUS - 1) // order, BLS_MODULUS)
    return tuple(compute_powers(root_of_unity, order))


@lru_cache(maxsize=8)
def _roots_of_unity_brp(order: int) -> tuple:
    """Bit-reversed roots of unity, cached (the hot-path domain)."""
    return tuple(bit_reversal_permutation(list(compute_roots_of_unity(order))))


@lru_cache(maxsize=8)
def _roots_brp_index(order: int) -> dict:
    """root value -> brp index, for O(1) in-domain membership checks."""
    return {w: i for i, w in enumerate(_roots_of_unity_brp(order))}


def _batch_inverse(values) -> list:
    """Montgomery batch inversion: one pow, 3n mults (all values != 0)."""
    prefix = []
    acc = 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % BLS_MODULUS
    inv = bls_modular_inverse(acc)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * inv % BLS_MODULUS
        inv = inv * values[i] % BLS_MODULUS
    return out


# ---------------------------------------------------------------------------
# G1 helpers
# ---------------------------------------------------------------------------

class _BoundedCache(dict):
    """Decompression cache bounded so adversary-chosen one-off commitment
    and proof encodings cannot grow memory without limit; the fixed
    trusted-setup basis (8192 points) always fits."""

    MAX = 1 << 14

    def put(self, key, value):
        if len(self) >= self.MAX:
            self.clear()
        self[key] = value


_g1_cache = _BoundedCache()


def _to_g1(b48: bytes) -> G1Point:
    pt = _g1_cache.get(b48)
    if pt is None:
        pt = g1_from_compressed(b48)
        _g1_cache.put(b48, pt)
    return pt


def validate_kzg_g1(b: bytes) -> None:
    """md:174 - KeyValidate semantics except infinity is allowed."""
    if bytes(b) == G1_POINT_AT_INFINITY:
        return
    pt = g1_from_compressed(bytes(b))  # raises on non-canonical/off-curve
    assert not pt.infinity
    assert pt.in_subgroup()


def bytes_to_kzg_commitment(b: bytes) -> bytes:
    validate_kzg_g1(b)
    return bytes(b)


def bytes_to_kzg_proof(b: bytes) -> bytes:
    validate_kzg_g1(b)
    return bytes(b)


def _on_card() -> bool:
    return _bls.backend_name() == "torch"


def _basis_key(tag: str, points) -> tuple:
    """Content key of a fixed basis for the card's window cache: an
    address key (``id(setup)``) could alias a collected setup's table
    to a new one (speclint D1004)."""
    digest = hashlib.sha256(b"".join(bytes(p) for p in points)).digest()
    return (tag, len(points), digest)


def g1_lincomb(points: Sequence[bytes], scalars: Sequence[int],
               cache_key=None) -> bytes:
    """MSM (md:265).  Pippenger bucket method on the oracle; the torch
    backend sends every size to K7/K8 (``ops/msm.py``).

    ``cache_key``: optional tag of a fixed basis (the trusted setup); on
    the card its window expansion is kept, keyed by the tag and the
    basis's content."""
    assert len(points) == len(scalars)
    pts = [_to_g1(bytes(p)) for p in points]
    scalars = [int(s) % BLS_MODULUS for s in scalars]
    if _on_card():
        key = _basis_key(cache_key, points) if cache_key is not None else None
        return _msm.g1_msm(pts, scalars, cache_key=key,
                           device=_bls.backend_device()).to_compressed()
    return _pippenger_msm(pts, scalars).to_compressed()


def _pippenger_msm(pts, scalars, window: int = 8) -> G1Point:
    """Windowed bucket accumulation, MSB window first."""
    if not pts:
        return G1Point.inf()
    n_windows = (255 + window - 1) // window
    result = G1Point.inf()
    mask = (1 << window) - 1
    for w in range(n_windows - 1, -1, -1):
        if not result.infinity:
            for _ in range(window):
                result = result.double()
        buckets = [None] * (mask + 1)
        for pt, s in zip(pts, scalars):
            digit = (s >> (w * window)) & mask
            if digit == 0 or pt.infinity:
                continue
            buckets[digit] = pt if buckets[digit] is None else buckets[digit] + pt
        running = G1Point.inf()
        window_sum = G1Point.inf()
        for digit in range(mask, 0, -1):
            if buckets[digit] is not None:
                running = running + buckets[digit]
            window_sum = window_sum + running
        result = result + window_sum
    return result


# ---------------------------------------------------------------------------
# Trusted setup (reference: setup.py:112-143 injects these constants from
# presets/<preset>/trusted_setups/trusted_setup_4096.json)
# ---------------------------------------------------------------------------

SETUP_FILE = Path(__file__).resolve().parents[1] / "presets" / "trusted_setup_4096.json"


class TrustedSetup:
    def __init__(self, preset_name: str):
        # both presets carry the same ceremony output: one copy serves both
        if preset_name not in ("mainnet", "minimal"):
            raise ValueError(f"no trusted setup for preset {preset_name!r}")
        with open(SETUP_FILE) as f:
            data = json.load(f)
        self.KZG_SETUP_G1_MONOMIAL = [
            bytes.fromhex(p[2:]) for p in data["g1_monomial"]]
        self.KZG_SETUP_G1_LAGRANGE = [
            bytes.fromhex(p[2:]) for p in data["g1_lagrange"]]
        self.KZG_SETUP_G2_MONOMIAL = [
            bytes.fromhex(p[2:]) for p in data["g2_monomial"]]
        self.FIELD_ELEMENTS_PER_BLOB = len(self.KZG_SETUP_G1_LAGRANGE)
        # hot path: the bit-reversed Lagrange basis (md:347)
        self.g1_lagrange_brp = bit_reversal_permutation(
            self.KZG_SETUP_G1_LAGRANGE)
        self._g2_tau = None

    @property
    def g2_tau(self):
        """[tau]G2 = KZG_SETUP_G2_MONOMIAL[1], decompressed lazily."""
        if self._g2_tau is None:
            self._g2_tau = g2_from_compressed(self.KZG_SETUP_G2_MONOMIAL[1])
        return self._g2_tau


@lru_cache(maxsize=4)
def trusted_setup(preset_name: str) -> TrustedSetup:
    return TrustedSetup(preset_name)


# ---------------------------------------------------------------------------
# Blob <-> polynomial
# ---------------------------------------------------------------------------

def blob_to_polynomial(blob: bytes, width: int) -> list:
    """md:209"""
    assert len(blob) == BYTES_PER_FIELD_ELEMENT * width
    return [bytes_to_bls_field(
        blob[i * BYTES_PER_FIELD_ELEMENT:(i + 1) * BYTES_PER_FIELD_ELEMENT])
        for i in range(width)]


def compute_challenge(blob: bytes, commitment: bytes, width: int) -> int:
    """md:223 - Fiat-Shamir over domain | degree | blob | commitment."""
    degree_poly = int.to_bytes(width, 16, KZG_ENDIANNESS)
    data = FIAT_SHAMIR_PROTOCOL_DOMAIN + degree_poly + bytes(blob) \
        + bytes(commitment)
    return hash_to_bls_field(data)


def evaluate_polynomial_in_evaluation_form(polynomial, z: int,
                                           width: int) -> int:
    """Barycentric evaluation (md:308); batch-inverted denominators."""
    assert len(polynomial) == width
    inverse_width = bls_modular_inverse(width)
    roots_brp = _roots_of_unity_brp(width)
    z = int(z) % BLS_MODULUS
    in_domain = _roots_brp_index(width).get(z)
    if in_domain is not None:
        return int(polynomial[in_domain])
    denoms = [(z - w) % BLS_MODULUS for w in roots_brp]
    inv_denoms = _batch_inverse(denoms)
    result = 0
    for p, w, inv_d in zip(polynomial, roots_brp, inv_denoms):
        result += int(p) * w % BLS_MODULUS * inv_d
    result = (result % BLS_MODULUS) * (pow(z, width, BLS_MODULUS) - 1) \
        * inverse_width
    return result % BLS_MODULUS


# ---------------------------------------------------------------------------
# KZG core (md:340-640); ``setup`` = TrustedSetup for the active preset
# ---------------------------------------------------------------------------

def blob_to_kzg_commitment(blob: bytes, setup: TrustedSetup) -> bytes:
    """md:344"""
    width = setup.FIELD_ELEMENTS_PER_BLOB
    assert len(blob) == BYTES_PER_FIELD_ELEMENT * width
    return g1_lincomb(setup.g1_lagrange_brp, blob_to_polynomial(blob, width),
                      cache_key="lagrange-brp")


def verify_kzg_proof(commitment_bytes: bytes, z_bytes: bytes, y_bytes: bytes,
                     proof_bytes: bytes, setup: TrustedSetup) -> bool:
    """md:355"""
    assert len(commitment_bytes) == 48
    assert len(z_bytes) == BYTES_PER_FIELD_ELEMENT
    assert len(y_bytes) == BYTES_PER_FIELD_ELEMENT
    assert len(proof_bytes) == 48
    return verify_kzg_proof_impl(bytes_to_kzg_commitment(commitment_bytes),
                                 bytes_to_bls_field(z_bytes),
                                 bytes_to_bls_field(y_bytes),
                                 bytes_to_kzg_proof(proof_bytes), setup)


def _g1_of(b48: bytes) -> G1Point:
    if bytes(b48) == G1_POINT_AT_INFINITY:
        return G1Point.inf()
    return _to_g1(bytes(b48))


def _pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1: one K4 group under the torch backend, the
    oracle's ``multi_pairing_check`` otherwise."""
    if _on_card():
        return bls_torch.pairing_check_pairs(pairs, device=_bls.backend_device())
    return multi_pairing_check(pairs)


def _g1_combine(point_scalar_pairs) -> G1Point:
    """sum([k]P) over a few points: K7/K8 under the torch backend."""
    if _on_card():
        return _msm.g1_msm([p for p, _ in point_scalar_pairs],
                           [int(k) % BLS_MODULUS for _, k in point_scalar_pairs],
                           device=_bls.backend_device())
    acc = G1Point.inf()
    for p, k in point_scalar_pairs:
        acc = acc + p.mult(int(k))
    return acc


def _g2_combine(point_scalar_pairs) -> G2Point:
    """sum([k]Q) over a few G2 points, on the oracle (K2 takes 128-bit
    scalars; these are 255-bit)."""
    acc = G2Point.inf()
    for q, k in point_scalar_pairs:
        acc = acc + q.mult(int(k))
    return acc


def verify_kzg_proof_impl(commitment: bytes, z: int, y: int, proof: bytes,
                          setup: TrustedSetup) -> bool:
    """md:379 - e(P - y, -G2) * e(proof, [tau - z]G2) == 1."""
    X_minus_z = _g2_combine([(setup.g2_tau, 1),
                             (G2_GENERATOR, (BLS_MODULUS - z) % BLS_MODULUS)])
    P_minus_y = _g1_combine([(_g1_of(commitment), 1),
                             (G1_GENERATOR, (BLS_MODULUS - y) % BLS_MODULUS)])
    return _pairing_check([
        (P_minus_y, -G2_GENERATOR),
        (_g1_of(proof), X_minus_z),
    ])


def verify_kzg_proof_batch(commitments, zs, ys, proofs,
                           setup: TrustedSetup) -> bool:
    """md:404 - random linear combination -> 2 MSMs + 1 pairing check,
    deferred into the block's batch inside a scope, else evaluated at
    once."""
    assert len(commitments) == len(zs) == len(ys) == len(proofs)
    width = setup.FIELD_ELEMENTS_PER_BLOB

    degree_poly = int.to_bytes(width, 8, KZG_ENDIANNESS)
    num_commitments = int.to_bytes(len(commitments), 8, KZG_ENDIANNESS)
    data = RANDOM_CHALLENGE_KZG_BATCH_DOMAIN + degree_poly + num_commitments
    for commitment, z, y, proof in zip(commitments, zs, ys, proofs):
        data += bytes(commitment) + bls_field_to_bytes(z) \
            + bls_field_to_bytes(y) + bytes(proof)
    r = hash_to_bls_field(data)
    r_powers = compute_powers(r, len(commitments))

    proof_lincomb = g1_lincomb(proofs, r_powers)
    proof_z_lincomb = g1_lincomb(
        proofs, [int(z) * r_power % BLS_MODULUS
                 for z, r_power in zip(zs, r_powers)])
    C_minus_ys = [
        _g1_combine([(_g1_of(commitment), 1),
                     (G1_GENERATOR, (BLS_MODULUS - int(y)) % BLS_MODULUS)])
        .to_compressed()
        for commitment, y in zip(commitments, ys)]
    C_minus_y_lincomb = g1_lincomb(C_minus_ys, r_powers)

    pairs = [
        (_g1_of(proof_lincomb), -setup.g2_tau),
        (_g1_of(C_minus_y_lincomb) + _g1_of(proof_z_lincomb), G2_GENERATOR),
    ]
    # assert-style inside a batch scope: the block's flush folds the pairs
    if _bls.defer_pairing_check(pairs, label="kzg_batch"):
        return True
    return _pairing_check(pairs)


def compute_kzg_proof(blob: bytes, z_bytes: bytes,
                      setup: TrustedSetup) -> Tuple[bytes, bytes]:
    """md:448"""
    width = setup.FIELD_ELEMENTS_PER_BLOB
    assert len(blob) == BYTES_PER_FIELD_ELEMENT * width
    assert len(z_bytes) == BYTES_PER_FIELD_ELEMENT
    polynomial = blob_to_polynomial(blob, width)
    proof, y = compute_kzg_proof_impl(polynomial, bytes_to_bls_field(z_bytes),
                                      setup)
    return proof, bls_field_to_bytes(y)


def compute_quotient_eval_within_domain(z: int, polynomial, y: int,
                                        setup: TrustedSetup) -> int:
    """md:464 - q(x_m) when z is a root of unity."""
    width = setup.FIELD_ELEMENTS_PER_BLOB
    roots_brp = _roots_of_unity_brp(width)
    result = 0
    for i, omega_i in enumerate(roots_brp):
        if omega_i == z:
            continue
        f_i = (BLS_MODULUS + int(polynomial[i]) - int(y)) % BLS_MODULUS
        numerator = f_i * omega_i % BLS_MODULUS
        denominator = z * ((BLS_MODULUS + z - omega_i) % BLS_MODULUS) \
            % BLS_MODULUS
        result += div(numerator, denominator)
    return result % BLS_MODULUS


def compute_kzg_proof_impl(polynomial, z: int,
                           setup: TrustedSetup) -> Tuple[bytes, int]:
    """md:492 - quotient polynomial in evaluation form."""
    width = setup.FIELD_ELEMENTS_PER_BLOB
    roots_brp = _roots_of_unity_brp(width)

    y = evaluate_polynomial_in_evaluation_form(polynomial, z, width)
    polynomial_shifted = [(int(p) - y) % BLS_MODULUS for p in polynomial]
    denominator_poly = [(x - z) % BLS_MODULUS for x in roots_brp]

    quotient_polynomial = [0] * width
    # batch-invert the non-zero denominators (behavioral parity with md:510)
    nz = [i for i, d in enumerate(denominator_poly) if d != 0]
    inv_map = dict(zip(nz, _batch_inverse([denominator_poly[i] for i in nz])))
    for i, (a, b) in enumerate(zip(polynomial_shifted, denominator_poly)):
        if b == 0:
            quotient_polynomial[i] = compute_quotient_eval_within_domain(
                roots_brp[i], polynomial, y, setup)
        else:
            quotient_polynomial[i] = a * inv_map[i] % BLS_MODULUS

    return g1_lincomb(setup.g1_lagrange_brp, quotient_polynomial,
                      cache_key="lagrange-brp"), y


def compute_blob_kzg_proof(blob: bytes, commitment_bytes: bytes,
                           setup: TrustedSetup) -> bytes:
    """md:522"""
    width = setup.FIELD_ELEMENTS_PER_BLOB
    assert len(blob) == BYTES_PER_FIELD_ELEMENT * width
    assert len(commitment_bytes) == 48
    commitment = bytes_to_kzg_commitment(commitment_bytes)
    polynomial = blob_to_polynomial(blob, width)
    evaluation_challenge = compute_challenge(blob, commitment, width)
    proof, _ = compute_kzg_proof_impl(polynomial, evaluation_challenge, setup)
    return proof


def verify_blob_kzg_proof(blob: bytes, commitment_bytes: bytes,
                          proof_bytes: bytes, setup: TrustedSetup) -> bool:
    """md:543"""
    width = setup.FIELD_ELEMENTS_PER_BLOB
    assert len(blob) == BYTES_PER_FIELD_ELEMENT * width
    assert len(commitment_bytes) == 48
    assert len(proof_bytes) == 48
    commitment = bytes_to_kzg_commitment(commitment_bytes)
    polynomial = blob_to_polynomial(blob, width)
    evaluation_challenge = compute_challenge(blob, commitment, width)
    y = evaluate_polynomial_in_evaluation_form(
        polynomial, evaluation_challenge, width)
    proof = bytes_to_kzg_proof(proof_bytes)
    return verify_kzg_proof_impl(commitment, evaluation_challenge, y, proof,
                                 setup)


def verify_blob_kzg_proof_batch(blobs, commitments_bytes, proofs_bytes,
                                setup: TrustedSetup) -> bool:
    """md:571"""
    assert len(blobs) == len(commitments_bytes) == len(proofs_bytes)
    width = setup.FIELD_ELEMENTS_PER_BLOB
    commitments, evaluation_challenges, ys, proofs = [], [], [], []
    for blob, commitment_bytes, proof_bytes in zip(
            blobs, commitments_bytes, proofs_bytes):
        assert len(blob) == BYTES_PER_FIELD_ELEMENT * width
        assert len(commitment_bytes) == 48
        assert len(proof_bytes) == 48
        commitment = bytes_to_kzg_commitment(commitment_bytes)
        commitments.append(commitment)
        polynomial = blob_to_polynomial(blob, width)
        evaluation_challenge = compute_challenge(blob, commitment, width)
        evaluation_challenges.append(evaluation_challenge)
        ys.append(evaluate_polynomial_in_evaluation_form(
            polynomial, evaluation_challenge, width))
        proofs.append(bytes_to_kzg_proof(proof_bytes))
    return verify_kzg_proof_batch(commitments, evaluation_challenges, ys,
                                  proofs, setup)
