"""PyTorch/CUDA BLS backend - the ``bls.use_torch()`` implementation.

Counterpart of ``consensus_specs_tpu/ops/bls_jax.py``.  Hot verification
paths run on the card through the four kernels of ``ops/torch_bls``:

- K1 ``g1_aggregate_scale``: per-item pubkey aggregation (and the RLC
  scale);
- K2 ``g2_scale_sum``: the RLC signature combination;
- K3 ``hash_to_g2``: the field-to-curve map;
- K4 ``pairing_check``: grouped product pairings.

The JAX package's fused programs (``_program_multi_pair_verify``,
``_program_agg_verify_fused``) compute the same verdicts as its staged
path; here they are the compositions K1 -> K3 -> K4 and K3 -> K4.

Cold paths (``Sign``, ``SkToPk``, ``Aggregate``, ``AggregatePKs``,
``KeyValidate``) and decompression with its subgroup checks stay on the
host in the python oracle, with the decoded registry cached, as the JAX
package leaves them; ``AggregatePKs`` sums the cached points, so a sync
committee's 512 registry keys are not decompressed again.  Every entry point takes ``device``: None means
the card (and raises without one); ``"cpu"`` runs the plain versions.
"""
from collections import OrderedDict

import numpy as np
import torch

from .. import _build
from .bls12_381 import ciphersuite as _oracle
from .bls12_381.curve import G1_GENERATOR, g1_from_compressed, g2_from_compressed
from .torch_bls.convert import pack_g1, pack_g2
from .torch_bls.htc import hash_to_field_host, hash_to_g2
from .torch_bls.pairing import pairing_check
from .torch_bls.points import g1_aggregate_scale, g2_scale_sum

Sign = _oracle.Sign
SkToPk = _oracle.SkToPk
Aggregate = _oracle.Aggregate
KeyValidate = _oracle.KeyValidate


# ---------------------------------------------------------------------------
# Host-side decompression caches (bls_jax.py:61-128): registry pubkeys
# repeat across blocks, so decompression and the subgroup check are paid
# once per key; each entry also keeps the packed words the device reads.
# ---------------------------------------------------------------------------

class _LRU(OrderedDict):
    def __init__(self, maxsize):
        super().__init__()
        self.maxsize = maxsize

    def put(self, key, value):
        self[key] = value
        self.move_to_end(key)
        if len(self) > self.maxsize:
            self.popitem(last=False)


_g1_cache = _LRU(1 << 21)
_g2_cache = _LRU(1 << 14)


def _g1_entry(data: bytes):
    """bytes48 -> [G1Point|None, packed words|None] with KeyValidate
    semantics: non-canonical, off-curve, out-of-subgroup and the identity
    give None."""
    key = bytes(data)
    if key not in _g1_cache:
        try:
            pt = g1_from_compressed(key)
            ok = (not pt.infinity) and pt.in_subgroup()
            _g1_cache.put(key, [pt if ok else None, None])
        except (ValueError, AssertionError):
            _g1_cache.put(key, [None, None])
    return _g1_cache[key]


def _packed_g1(data: bytes):
    """bytes48 -> (24,) int32 words (affine x || y, Montgomery) or None."""
    entry = _g1_entry(data)
    if entry[0] is None:
        return None
    if entry[1] is None:
        entry[1] = pack_g1([entry[0]])[0].numpy().reshape(24)
    return entry[1]


def AggregatePKs(pubkeys) -> bytes:
    """The oracle's ``AggregatePKs`` (KeyValidate each key, sum), reading
    the decompression cache."""
    if len(pubkeys) == 0:
        raise ValueError("cannot aggregate empty pubkey list")
    acc = None
    for pk in pubkeys:
        p = _g1_entry(pk)[0]
        if p is None:
            raise ValueError("invalid pubkey in aggregation")
        acc = p if acc is None else acc + p
    return acc.to_compressed()


def _decompress_g2(data: bytes):
    """bytes96 -> subgroup-checked G2Point (infinity allowed: the pairing
    treats it as a degenerate pair) or None."""
    key = bytes(data)
    if key not in _g2_cache:
        try:
            pt = g2_from_compressed(key)
            _g2_cache.put(key, pt if pt.in_subgroup() else None)
        except (ValueError, AssertionError):
            _g2_cache.put(key, None)
    return _g2_cache[key]


# ---------------------------------------------------------------------------
# packing.  Host-to-card copies go through pinned memory without waiting
# for the card, so packing the next kernel's inputs overlaps the kernels
# already queued.  Row counts and group offsets stay on the host: the
# wrappers validate them there.
# ---------------------------------------------------------------------------

_NEG_G1 = pack_g1([-G1_GENERATOR])[0]


_to = _build.to_device


def _stack_pk_rows(rows, dev):
    """Per item, a list of (24,) word rows -> (B, N, 2, 12) words on
    ``dev``, padded with zeros past each row's count, and the (B,) counts
    on the host."""
    n = max(1, max(len(r) for r in rows))
    arr = np.zeros((len(rows), n, 24), dtype=np.int32)
    for b, r in enumerate(rows):
        if r:
            arr[b, :len(r)] = np.stack(r)
    counts = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    return _to(torch.from_numpy(arr.reshape(len(rows), n, 2, 12)), dev), counts


def _pack_g2(points, dev):
    """Oracle G2Points -> (B, 2, 2, 12) affine words + (B,) infinity on ``dev``."""
    words, inf = pack_g2(points)
    return _to(words, dev), _to(inf, dev)


def _scalar_words(scalars, dev):
    raw = b"".join(int(s).to_bytes(16, "little") for s in scalars)
    w = np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(np.int32)
    return _to(torch.from_numpy(w.reshape(len(scalars), 4).copy()), dev)


def _neg_g1(n, dev):
    return _to(_NEG_G1, dev).expand(n, 2, 12)


# ---------------------------------------------------------------------------
# batch entry points
# ---------------------------------------------------------------------------

def verify_aggregates_batch(items, device=None) -> list:
    """items: [(pubkeys: list[bytes48], message: bytes, signature: bytes96)]
    -> per-item FastAggregateVerify verdicts, the whole batch as one
    K1 -> K3 -> K4 pass (two pairs per item: (agg_pk, H(m)), (-G1, sig))."""
    dev = _build.device(device)
    results = [False] * len(items)
    rows = []
    for idx, (pubkeys, msg, sig) in enumerate(items):
        pts = [_packed_g1(pk) for pk in pubkeys]
        spt = _decompress_g2(sig)
        if len(pubkeys) == 0 or any(p is None for p in pts) or spt is None:
            continue
        rows.append((idx, pts, bytes(msg), spt))
    if not rows:
        return results
    B = len(rows)
    pk, counts = _stack_pk_rows([r[1] for r in rows], dev)
    agg, agg_inf = g1_aggregate_scale(pk, counts)
    hm, hm_inf = hash_to_g2(_to(hash_to_field_host([r[2] for r in rows]), dev))
    sig, sig_inf = _pack_g2([r[3] for r in rows], dev)
    p = torch.stack([agg, _neg_g1(B, dev)], dim=1).reshape(2 * B, 2, 12)
    q = torch.stack([hm, sig], dim=1).reshape(2 * B, 2, 2, 12)
    degen = torch.stack([agg_inf | hm_inf, sig_inf], dim=1).reshape(2 * B)
    offsets = torch.arange(0, 2 * B + 1, 2, dtype=torch.int32)
    out = pairing_check(p, q, degen, offsets).cpu().tolist()
    for (idx, _, _, _), ok in zip(rows, out):
        results[idx] = bool(ok)
    return results


def aggregate_verify_batch(items, device=None) -> list:
    """items: [(pubkeys, messages, signature)] -> per-item AggregateVerify
    verdicts; item i is the group of pairs (pk_j, H(m_j))... (-G1, sig),
    all messages through one K3 call and all groups through one K4."""
    dev = _build.device(device)
    results = [False] * len(items)
    rows = []
    for idx, (pubkeys, messages, sig) in enumerate(items):
        pts = [_packed_g1(pk) for pk in pubkeys]
        spt = _decompress_g2(sig)
        if (len(pubkeys) == 0 or len(pubkeys) != len(messages)
                or any(p is None for p in pts) or spt is None):
            continue
        rows.append((idx, pts, [bytes(m) for m in messages], spt))
    if not rows:
        return results
    msgs = [m for r in rows for m in r[2]]
    hm, hm_inf = hash_to_g2(_to(hash_to_field_host(msgs), dev))
    sig, sig_inf = _pack_g2([r[3] for r in rows], dev)
    p_parts, q_parts, d_parts, offsets = [], [], [], [0]
    start = 0
    for b, (_, pts, messages, _) in enumerate(rows):
        k = len(messages)
        p_parts += [_to(torch.from_numpy(np.stack(pts).reshape(k, 2, 12)), dev),
                    _neg_g1(1, dev)]
        q_parts += [hm[start:start + k], sig[b:b + 1]]
        d_parts += [hm_inf[start:start + k], sig_inf[b:b + 1]]
        start += k
        offsets.append(offsets[-1] + k + 1)
    out = pairing_check(torch.cat(p_parts), torch.cat(q_parts), torch.cat(d_parts),
                        torch.tensor(offsets, dtype=torch.int32))
    for (idx, _, _, _), ok in zip(rows, out.cpu().tolist()):
        results[idx] = bool(ok)
    return results


def rlc_combined_check(pk_rows, msgs, sig_pts, scalars, device=None, extra_pairs=()) -> bool:
    """ONE product pairing for a whole flushed batch (bls_jax.py:521):

        prod_i e([r_i] agg_pk_i, H(m_i)) * e(-G1, sum_i [r_i] sig_i)
              * prod_j e(P_j, Q_j) == 1

    ``pk_rows``: per item, the packed pubkey word rows (already
    KeyValidate-checked); ``msgs``: message bytes; ``sig_pts``: subgroup-
    checked oracle G2Points; ``scalars``: the 128-bit coefficients;
    ``extra_pairs``: oracle (G1Point, G2Point) pairs appended to the
    product (the deferred raw pairing checks, already scaled), each with
    its degenerate flag where a point is at infinity (bls_jax.py:587).
    Device work: K1 (aggregate + scale), K2 (signature MSM), K3, and one
    K4 group of n + 1 + len(extra_pairs) pairs; with no items, the one
    K4 group of the extra pairs alone."""
    n = len(pk_rows)
    if not (n == len(msgs) == len(sig_pts) and len(scalars) >= n):
        raise ValueError("rlc_combined_check: ragged inputs")
    if n == 0 and not extra_pairs:
        return True
    dev = _build.device(device)
    p_parts, q_parts, d_parts = [], [], []
    if n:
        sc = _scalar_words(scalars[:n], dev)
        pk, counts = _stack_pk_rows(pk_rows, dev)
        aggp, agg_inf = g1_aggregate_scale(pk, counts, sc)
        sig, sig_inf = _pack_g2(sig_pts, dev)
        s_aff, s_inf = g2_scale_sum(sig, sig_inf, sc)
        hm, hm_inf = hash_to_g2(_to(hash_to_field_host(msgs), dev))
        p_parts += [aggp, _neg_g1(1, dev)]
        q_parts += [hm, s_aff[None]]
        d_parts += [agg_inf | hm_inf, s_inf.reshape(1)]
    if extra_pairs:
        ep, ep_inf = pack_g1([a for a, _ in extra_pairs])
        eq, eq_inf = pack_g2([b for _, b in extra_pairs])
        p_parts.append(_to(ep, dev))
        q_parts.append(_to(eq, dev))
        d_parts.append(_to(ep_inf | eq_inf, dev))
    p, q, degen = torch.cat(p_parts), torch.cat(q_parts), torch.cat(d_parts)
    offsets = torch.tensor([0, p.shape[0]], dtype=torch.int32)
    return bool(pairing_check(p, q, degen, offsets).cpu()[0])


def pairing_check_pairs(pairs, device=None) -> bool:
    """Oracle (G1Point, G2Point) pairs -> prod_i e(P_i, Q_i) == 1 as ONE
    K4 group; a pair with a point at infinity contributes 1.  The KZG
    library's pairing checks (``ops/kzg.py``) come through here."""
    if not pairs:
        return True
    dev = _build.device(device)
    p, p_inf = pack_g1([a for a, _ in pairs])
    q, q_inf = pack_g2([b for _, b in pairs])
    offsets = torch.tensor([0, len(pairs)], dtype=torch.int32)
    return bool(pairing_check(_to(p, dev), _to(q, dev), _to(p_inf | q_inf, dev),
                              offsets).cpu()[0])


def FastAggregateVerify(pubkeys, message: bytes, signature: bytes, device=None) -> bool:
    return verify_aggregates_batch([(pubkeys, message, signature)], device)[0]


def Verify(pubkey: bytes, message: bytes, signature: bytes, device=None) -> bool:
    return verify_aggregates_batch([([pubkey], message, signature)], device)[0]


def AggregateVerify(pubkeys, messages, signature: bytes, device=None) -> bool:
    return aggregate_verify_batch([(pubkeys, messages, signature)], device)[0]
