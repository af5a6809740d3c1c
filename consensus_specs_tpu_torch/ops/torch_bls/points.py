"""G1/G2 point arithmetic: kernels K1 and K2 with their plain versions.

Counterpart of ``consensus_specs_tpu/ops/jax_bls/points.py``; the CUDA
side is ``csrc/points.cu`` over ``csrc/points.cuh``.

Points are homogeneous projective (X : Y : Z) with the Renes-Costello-
Batina complete formulas for a = 0 (addition: Algorithm 7, doubling:
Algorithm 9), the same formulas as the JAX package.  Complete formulas
matter here: an aggregate may hold the same key twice and a lane may be
the identity, exactly where incomplete Jacobian formulas go wrong.

Kernel boundaries are affine and canonical (see the package docstring):
G1 ``(..., 2, 12)`` int32 words, G2 ``(..., 2, 2, 12)``, plus a bool
infinity flag; an infinite point is written as x = y = 0.

K1 ``g1_aggregate_scale`` replaces ``bls_jax.py:196`` ``_j_tree_sum``
(``points.py:256`` ``g1_tree_sum_batched``), ``bls_jax.py:491``
``_j_g1_scale`` (``points.py:244,140``) and the normalization
``points.py:335`` ``_j_g1_norm_post`` with its ``limbs.py:308`` inverse.
K2 ``g2_scale_sum`` replaces ``bls_jax.py:498`` ``_j_g2_scale_sum``
(``points.py:248,286``), ``points.py:353`` ``_j_g2_norm_post`` and
``tower.py:154,160`` ``_j_f2_norm``/``_j_f2_inv_post``.
"""
import torch

from ..bls12_381.fields import Fq2 as _OFq2
from ... import _build
from . import limbs as L
from . import tower as T

SCALAR_WORDS = 4          # 128-bit RLC scalars as 4 little-endian words
K1_TEAMS = 40             # csrc/points.cu: 8 warps of five teams of six
K1_WIN = 4                # K1's sliding windows over its scalars (K1_WIN)

# Fq products per G1 point operation (for the kernels' bounds), a = 0:
# RCB complete addition 12, mixed addition (one affine input) 11,
# doubling 8 (the products by 3b = 12 are additions); a G2 operation
# takes as many Fq2 products (3b = 12 (1 + i) is additions too).
G1_ADD, G1_MADD, G1_DBL = 12, 11, 8
G2_ADD, G2_MADD, G2_DBL = (k * T.F2_MUL for k in (G1_ADD, G1_MADD, G1_DBL))


class _G1:
    """Field ops for G1 coordinates: Fq, (..., 24); a point (..., 3, 24)."""
    add, sub, mul = staticmethod(L.add_mod), staticmethod(L.sub_mod), \
        staticmethod(L.mont_mul)
    cdim = -2

    @staticmethod
    def b3(like):
        return L.fq_const(12, like)

    @staticmethod
    def is_zero(x):
        return L.is_zero(x)

    @staticmethod
    def inv(x):
        return L.inv_mod(x)

    @staticmethod
    def one(like):
        return L.one_like(like)


class _G2:
    """Field ops for G2 coordinates: Fq2, (..., 2, 24); a point (..., 3, 2, 24)."""
    add, sub, mul = staticmethod(L.add_mod), staticmethod(L.sub_mod), \
        staticmethod(T.f2_mul)
    cdim = -3

    @staticmethod
    def b3(like):
        return T.f2_const(_OFq2(12, 12), like)

    @staticmethod
    def is_zero(x):
        return T.f2_is_zero(x)

    @staticmethod
    def inv(x):
        return T.f2_inv(x)

    @staticmethod
    def one(like):
        return T.f2_one_like(like)


def complete_add(F, p, q):
    """RCB 2015 Algorithm 7 (complete addition, a = 0), multiplies and
    adds grouped into batched waves."""
    x1, y1, z1 = p.unbind(F.cdim)
    x2, y2, z2 = q.unbind(F.cdim)
    b3 = F.b3(x1)
    s = L.many(F.add, [(x1, y1), (y1, z1), (x1, z1), (x2, y2), (y2, z2), (x2, z2)])
    t0, t1, t2, m1, m2, m3 = L.many(F.mul, [
        (x1, x2), (y1, y2), (z1, z2), (s[0], s[3]), (s[1], s[4]), (s[2], s[5])])
    w = L.many(F.add, [(t0, t1), (t1, t2), (t0, t2), (t0, t0)])
    t3, t4, yp = L.many(F.sub, [(m1, w[0]), (m2, w[1]), (m3, w[2])])
    x3 = F.add(w[3], t0)                                # 3 x1x2
    t2b, y3 = L.many(F.mul, [(b3, t2), (b3, yp)])
    z3 = F.add(t1, t2b)                                 # y1y2 + 3b z1z2
    t1b = F.sub(t1, t2b)                                # y1y2 - 3b z1z2
    p1, p2, p3, p4, p5, p6 = L.many(F.mul, [
        (t3, t1b), (t4, y3), (t1b, z3), (y3, x3), (z3, t4), (x3, t3)])
    fin = L.many(F.add, [(p3, p4), (p5, p6)])
    return torch.stack([F.sub(p1, p2), fin[0], fin[1]], dim=F.cdim)


def complete_dbl(F, p):
    """RCB 2015 Algorithm 9 (exception-free doubling, a = 0)."""
    X, Y, Z = p.unbind(F.cdim)
    b3 = F.b3(X)
    t0, t1, xy, zz = L.many(F.mul, [(Y, Y), (Y, Z), (X, Y), (Z, Z)])
    w1 = F.add(t0, t0)
    w2 = F.add(w1, w1)
    t2 = F.mul(b3, zz)                                  # 3b Z^2
    z3, y3, t2x2 = L.many(F.add, [(w2, w2), (t0, t2), (t2, t2)])
    t0 = F.sub(t0, F.add(t2x2, t2))                     # Y^2 - 9b Z^2
    m1, m2, m3, m4 = L.many(F.mul, [(t2, z3), (t1, z3), (t0, y3), (t0, xy)])
    fin = L.many(F.add, [(m4, m4), (m1, m3)])
    return torch.stack([fin[0], fin[1], m2], dim=F.cdim)


def identity_like(F, x):
    """Projective identity (0 : 1 : 0) shaped like coordinate ``x``."""
    z = torch.zeros_like(x)
    return torch.stack([z, F.one(x), z], dim=F.cdim)


def from_affine(F, aff, inf):
    """Affine (..., 2, ...) + flag -> projective, identity where ``inf``."""
    x, y = aff.unbind(F.cdim)
    one = F.one(x)
    pt = torch.stack([x, y, one], dim=F.cdim)
    return _select(F, inf, identity_like(F, x), pt)


def _select(F, cond, a, b):
    cond = cond.reshape(cond.shape + (1,) * (-F.cdim))
    return torch.where(cond, a, b)


def scalar_mul(F, p, bits):
    """[k]P per lane: MSB-first double-and-add over ``bits`` (..., n) bool."""
    acc = identity_like(F, p.unbind(F.cdim)[0])
    for i in range(bits.shape[-1]):
        acc = complete_dbl(F, acc)
        acc = _select(F, bits[..., i], complete_add(F, acc, p), acc)
    return acc


def tree_sum(F, pts, axis):
    """Sum over ``axis`` by halving (padded with identities to 2^k)."""
    pts = pts.movedim(axis, 0)
    while pts.shape[0] > 1:
        if pts.shape[0] % 2:
            pad = identity_like(F, pts[:1].unbind(F.cdim)[0])
            pts = torch.cat([pts, pad])
        h = pts.shape[0] // 2
        pts = complete_add(F, pts[:h], pts[h:])
    return pts[0]


def normalize(F, p):
    """Projective -> (affine, infinity flag); infinity becomes x = y = 0."""
    X, Y, Z = p.unbind(F.cdim)
    inf = F.is_zero(Z)
    aff = F.mul(torch.stack([X, Y]), F.inv(Z)).movedim(0, F.cdim)
    return _select(F, inf, torch.zeros_like(aff), aff), inf


def scalar_ints(scalars: torch.Tensor) -> list:
    """(B, 4) int32 little-endian words -> the B scalars as python ints."""
    w = scalars.to(torch.int64).cpu() & 0xFFFFFFFF
    return [sum(int(v) << (32 * i) for i, v in enumerate(row)) for row in w.tolist()]


def _ladder_fq_products(k: int, dbl: int, madd: int) -> int:
    """[k]P for an affine P: bit_length - 1 doublings, one mixed addition
    per further set bit."""
    return 0 if k == 0 else (k.bit_length() - 1) * dbl + (bin(k).count("1") - 1) * madd


def scalar_bits(scalars: torch.Tensor, n_bits: int = 32 * SCALAR_WORDS):
    """(..., 4) int32 little-endian words -> (..., n_bits) bool, MSB first."""
    w = scalars.to(torch.int64) & 0xFFFFFFFF
    k = torch.arange(n_bits - 1, -1, -1, device=w.device)
    return ((w[..., k // 32] >> (k % 32)) & 1).bool()


# ---------------------------------------------------------------------------
# K1: per-row pubkey aggregate, optional 128-bit scale, normalize
# ---------------------------------------------------------------------------

@torch.inference_mode()
def g1_aggregate_scale_plain(pk, counts, scalars=None):
    """Plain PyTorch version of K1 (any device; ``counts`` on any device)."""
    B, N = pk.shape[:2]
    aff = L.unpack(pk)                                   # (B, N, 2, 24)
    counts = counts.to(pk.device).long()
    live = torch.arange(N, device=pk.device)[None, :] < counts[:, None]
    pts = from_affine(_G1, aff, ~live)
    total = tree_sum(_G1, pts, 1) if N else identity_like(
        _G1, torch.zeros((B, L.NLIMB), dtype=torch.int64, device=pk.device))
    if scalars is not None:
        total = scalar_mul(_G1, total, scalar_bits(scalars))
    out, inf = normalize(_G1, total)
    return L.pack(out), inf


def g1_aggregate_scale_fq_products(pk, counts, scalars=None) -> int:
    """Fq products K1's function needs on these inputs: per row, count - 1
    mixed additions of its affine keys, then the scale of the sum (whose
    base is projective: full additions) by the cheaper of binary
    double-and-add and K1's sliding windows, then an inversion (no
    products, see ``tower.F2_INV``) and two products to make it affine."""
    n = sum(max(int(k) - 1, 0) for k in counts.tolist()) * G1_MADD
    for k in (scalar_ints(scalars) if scalars is not None else ()):
        n += _scale_fq_products(k, K1_WIN, G1_DBL, G1_ADD, G1_ADD)
    return n + len(counts) * 2


def g1_aggregate_scale_chain(counts, scalars=None) -> int:
    """K1's chain floor on these inputs, in dependent Fq product waves (two
    a team step): the longest row's team sum (team t adds keys t + 40 j,
    ceil(count / 40) - 1 additions after its first key), the tree's six
    levels over the 40 partials, the scale (the table of odd multiples:
    2S and seven additions; then the windows' doublings and additions),
    and one wave to make it affine (the binary-Euclid inversion has no
    products)."""
    from . import team_programs as TP
    tree = (K1_TEAMS - 1).bit_length()
    ks = scalar_ints(scalars) if scalars is not None else [0] * len(counts)
    steps = 0
    for c, k in zip(counts.tolist(), ks):
        scale = 0
        if k:
            _, mid, tail = TP.sliding_windows(k, K1_WIN)
            scale = (1 << (K1_WIN - 1)) + sum(sq + 1 for sq, _ in mid) + tail
        steps = max(steps, max(-(-int(c) // K1_TEAMS) - 1, 0) + tree + scale)
    return steps * TP.STEP_PRODUCT_WAVES + 1


def g1_aggregate_scale(pk, counts, scalars=None):
    """K1.  ``pk``: (B, N, 2, 12) int32 affine pubkeys (Montgomery words),
    row b live up to ``counts[b]``; ``counts``: (B,) int32 ON THE HOST
    (row lengths are host metadata: they are validated there and copied
    to ``pk``'s device, so no launch waits on a read-back); ``scalars``:
    optional (B, 4) int32 128-bit multipliers.  Returns the per-row
    affine [scalar] * sum (B, 2, 12) int32 and its infinity flag (B,)
    bool.

    CUDA: one block of 40 teams of six threads a row (``csrc/team.cuh``
    team_add, team_dbl: two waves of Fq products a step).  Team t sums
    keys t, t + 40, ..., a tree of team additions joins the partials, team
    0 scales the sum by 4-bit sliding windows over its odd multiples and
    makes it affine with one binary-Euclid inversion.  Bound: the chain of
    dependent products (``g1_aggregate_scale_chain``), not the card's
    multiply-add rate (``g1_aggregate_scale_fq_products``); the keys are
    read once (96 bytes each)."""
    dev = _build.same_device(pk, scalars)
    B, N = pk.shape[0], pk.shape[1]
    _build.check(pk, "pk", torch.int32, (B, N, 2, 12))
    _build.check(counts, "counts", torch.int32, (B,))
    _build.check_host(counts, "counts")
    if scalars is not None:
        _build.check(scalars, "scalars", torch.int32, (B, SCALAR_WORDS))
    if B and not (0 <= int(counts.min()) and int(counts.max()) <= N):
        raise ValueError(f"counts must lie in [0, {N}]")
    if dev.type == "cpu":
        return g1_aggregate_scale_plain(pk, counts, scalars)
    out = torch.empty((B, 2, 12), dtype=torch.int32, device=dev)
    inf = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _build.launch("g1_aggregate_scale", pk, _build.to_card(counts, dev), scalars,
                      out, inf, B, N)
    return out, inf


# ---------------------------------------------------------------------------
# K2: sum_i [r_i] sig_i over G2, normalized
# ---------------------------------------------------------------------------

@torch.inference_mode()
def g2_scale_sum_plain(sig, sig_inf, scalars):
    """Plain PyTorch version of K2 (any device)."""
    pts = from_affine(_G2, L.unpack(sig), sig_inf)       # (B, 3, 2, 24)
    scaled = scalar_mul(_G2, pts, scalar_bits(scalars))
    out, inf = normalize(_G2, tree_sum(_G2, scaled, 0))
    return L.pack(out), inf


def _scale_fq_products(k: int, win: int, dbl: int, add: int, ladder_add: int) -> int:
    """[k]P by the cheaper of binary double-and-add (``ladder_add`` a set
    bit) and the kernels' ``win``-bit sliding windows (2P and the odd
    multiples' table, then a doubling per bit after the first window and
    an addition per further window)."""
    from . import team_programs as TP
    if k == 0:
        return 0
    _, mid, tail = TP.sliding_windows(k, win)
    table = dbl + ((1 << (win - 1)) - 1) * add
    windows = table + sum(sq * dbl + add for sq, _ in mid) + tail * dbl
    return min(windows, _ladder_fq_products(k, dbl, ladder_add))


def _g2_lane_fq_products(k: int) -> int:
    """[k]P for an affine P (binary: mixed additions) as K2 computes it."""
    from . import team_programs as TP
    return _scale_fq_products(k, TP.K2_WIN, G2_DBL, G2_ADD, G2_MADD)


def g2_scale_sum_fq_products(sig, sig_inf, scalars) -> int:
    """Fq products K2's function needs on these inputs: each finite lane's
    [r]P over its affine signature (``_g2_lane_fq_products``), full
    additions joining the lanes, an Fq2 inversion and two Fq2 products to
    make the sum affine."""
    live = [k for k, inf in zip(scalar_ints(scalars), sig_inf.tolist()) if not inf]
    n = sum(_g2_lane_fq_products(k) for k in live)
    return n + max(len(live) - 1, 0) * G2_ADD + T.F2_INV + 2 * T.F2_MUL


def g2_scale_sum_chain(sig_inf, scalars) -> int:
    """K2's chain floor on these inputs: the dependent Fq product latencies
    of its design, the longest lane's steps (its table of odd multiples,
    then its 4-bit sliding windows; two product waves a step), the tree's
    ceil(log2 B) additions and the normalization (its binary-Euclid
    inversion has no products)."""
    from . import team_programs as TP
    table = 1 << (TP.K2_WIN - 1)              # 2P, then 3P .. 15P
    steps = [table + sum(sq + 1 for sq, _ in mid) + tail
             for _, mid, tail in (TP.sliding_windows(k, TP.K2_WIN)
                                  for k, inf in zip(scalar_ints(scalars), sig_inf.tolist())
                                  if k and not inf)]
    tree = (len(scalars) - 1).bit_length()
    return (max(steps, default=0) + tree) * TP.STEP_PRODUCT_WAVES + \
        TP.product_levels("g2_norm") + TP.product_levels("g2_affine")


def g2_scale_sum(sig, sig_inf, scalars):
    """K2.  ``sig``: (B, 2, 2, 12) int32 affine G2 points, ``sig_inf``
    (B,) bool, ``scalars`` (B, 4) int32.  Returns the affine
    sum_i [r_i] sig_i as (2, 2, 12) int32 and its infinity flag (bool,
    shape ()).

    CUDA: one launch, one warp per lane.  The warp runs its lane's 4-bit
    sliding windows over a table of odd multiples as laid-out team steps
    (a G2 doubling or addition is two waves of Fq products), then the
    lanes' partials are summed by a tree of team additions in which each
    pair's second finisher adds (an arrival counter per pair), and the
    last block normalizes with one binary-Euclid inversion.  Bound: the
    chain of dependent products (``g2_scale_sum_chain``), not the card's
    multiply-add rate (``g2_scale_sum_fq_products``)."""
    dev = _build.same_device(sig, sig_inf, scalars)
    B = sig.shape[0]
    _build.check(sig, "sig", torch.int32, (B, 2, 2, 12))
    _build.check(sig_inf, "sig_inf", torch.bool, (B,))
    _build.check(scalars, "scalars", torch.int32, (B, SCALAR_WORDS))
    if B == 0:
        raise ValueError("g2_scale_sum: empty batch")
    if dev.type == "cpu":
        return g2_scale_sum_plain(sig, sig_inf, scalars)
    partial = torch.empty((B, 3, 2, 12), dtype=torch.int32, device=dev)
    arrived = torch.zeros((B,), dtype=torch.int32, device=dev)
    out = torch.empty((2, 2, 12), dtype=torch.int32, device=dev)
    inf = torch.empty((), dtype=torch.bool, device=dev)
    _build.launch("g2_scale_sum", sig, sig_inf, scalars, partial, arrived, out, inf, B)
    return out, inf
