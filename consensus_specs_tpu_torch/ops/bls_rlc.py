"""Random-linear-combination (RLC) whole-batch BLS verification.

Counterpart of ``consensus_specs_tpu/ops/bls_rlc.py``: the one-pairing-
per-block engine behind ``utils/bls.DeferredBatch.flush``.  Each queued
check i says e(agg_pk_i, H(m_i)) * e(-G1, sig_i) == 1; with independent
nonzero 128-bit scalars r_i the single folded product

    prod_i e([r_i] agg_pk_i, H(m_i)) * e(-G1, sum_i [r_i] sig_i)
          * prod_k prod_j e([r_k] P_kj, Q_kj) == 1

holds for an all-valid batch and, for a batch holding any invalid item,
with probability <= 2^-128 over the scalars.  The trailing factor folds
the deferred raw pairing-product checks (the blob-KZG batch, the DAS
cell batch), each with a scalar of its own.  Their few G1 points are
scaled on the host by the oracle's ``mult`` (``_scale_g1_host``), as the
JAX package does: appending them to K1 as one-key rows would need a
second K1 launch, since K1 refuses a row whose key is the point at
infinity and a deferred point may be one.

Scalars are derived Fiat-Shamir style from a SHA-256 transcript of the
queued tuples, byte-for-byte as the JAX package derives them (same
domain tag, same transcript, same 128-bit draws), so the two packages
fold a batch identically.  A ``None`` verdict means an item is
structurally invalid (bad encoding, out-of-subgroup point, empty pubkey
list); the caller then bisects through the per-lane path.
"""
import hashlib

from .bls12_381 import ciphersuite as _oracle
from .bls12_381.curve import G1_GENERATOR, G1Point, msm
from .bls12_381.fields import R_ORDER
from .bls12_381.hash_to_curve import hash_to_g2
from .bls12_381.pairing import multi_pairing_check

SCALAR_BITS = 128
_DOMAIN = b"CS_TPU_BLS_RLC_V1"


def _u64(n: int) -> bytes:
    return int(n).to_bytes(8, "little")


def derive_scalars(items, extra_checks=()) -> list:
    """Per-check 128-bit nonzero coefficients seeded from a hash of the
    whole queue, byte for byte as the JAX package's ``derive_scalars``:
    ``len(items) + len(extra_checks)`` scalars, items first.  Every byte
    of every queued tuple, and each deferred check's label, pair count and
    compressed points, feed the seed."""
    h = hashlib.sha256(_DOMAIN)
    h.update(_u64(len(items)))
    for pubkeys, message, signature in items:
        h.update(_u64(len(pubkeys)))
        for pk in pubkeys:
            h.update(bytes(pk))
        h.update(_u64(len(message)))
        h.update(bytes(message))
        h.update(bytes(signature))
    h.update(_u64(len(extra_checks)))
    for pairs, label in extra_checks:
        lb = label.encode() if isinstance(label, str) else bytes(label)
        h.update(_u64(len(lb)))
        h.update(lb)
        h.update(_u64(len(pairs)))
        for p, q in pairs:
            h.update(p.to_compressed())
            h.update(q.to_compressed())
    seed = h.digest()
    out = []
    for i in range(len(items) + len(extra_checks)):
        r = int.from_bytes(
            hashlib.sha256(seed + _u64(i)).digest()[:SCALAR_BITS // 8], "little")
        out.append(r if r else 1)
    return out


def _scale_g1_host(p: G1Point, r: int) -> G1Point:
    """[r]P for the deferred checks' few G1 points (``bls_rlc.py:146`` of
    the JAX package): a point at infinity or r = 0 mod the group order
    gives the point at infinity."""
    if p.infinity or r % R_ORDER == 0:
        return G1Point.inf()
    return p.mult(r)


def _scaled_pairs(extra_checks, scalars) -> list:
    return [(_scale_g1_host(p, r), q)
            for (pairs, _), r in zip(extra_checks, scalars) for p, q in pairs]


def _check_py(items, extra_checks, scalars, device=None):
    """The python oracle's fold (``device`` is unused)."""
    n = len(items)
    pairs, sig_pts = [], []
    for (pubkeys, message, signature), r in zip(items, scalars):
        if not pubkeys:
            return None
        agg = G1Point.inf()
        for pk in pubkeys:
            pt = _oracle._decode_pubkey(bytes(pk))
            if pt is None:
                return None
            agg = agg + pt
        try:
            sig_pts.append(_oracle._decode_sig(bytes(signature)))
        except (ValueError, AssertionError):
            return None
        pairs.append((agg.mult(r), hash_to_g2(bytes(message))))
    if sig_pts:
        pairs.append((-G1_GENERATOR, msm(sig_pts, scalars[:n])))
    pairs += _scaled_pairs(extra_checks, scalars[n:])
    if not pairs:
        return True
    return multi_pairing_check(pairs)


def _check_torch(items, extra_checks, scalars, device=None):
    from . import bls_torch
    n = len(items)
    pk_rows, msgs, sig_pts = [], [], []
    for pubkeys, message, signature in items:
        if not pubkeys:
            return None
        rows = [bls_torch._packed_g1(pk) for pk in pubkeys]
        if any(r is None for r in rows):
            return None
        spt = bls_torch._decompress_g2(signature)
        if spt is None:
            return None
        pk_rows.append(rows)
        msgs.append(bytes(message))
        sig_pts.append(spt)
    extra_pairs = _scaled_pairs(extra_checks, scalars[n:])
    if not pk_rows and not extra_pairs:
        return True
    return bls_torch.rlc_combined_check(pk_rows, msgs, sig_pts, scalars[:n], device,
                                        extra_pairs=extra_pairs)


_COMBINERS = {"py": _check_py, "torch": _check_torch}


def combined_check(items, extra_checks, backend_name: str, device=None):
    """Fold the queue (``items``: (pubkeys, message, signature) byte
    triples; ``extra_checks``: (pairs, label) deferred raw pairing-product
    checks over oracle points) into one product pairing and evaluate it:
    True/False, or None when an item is structurally invalid."""
    scalars = derive_scalars(items, extra_checks)
    return _COMBINERS[backend_name](items, extra_checks, scalars, device)
