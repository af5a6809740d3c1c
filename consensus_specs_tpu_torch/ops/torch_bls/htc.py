"""Hash-to-G2 (RFC 9380 SSWU route): kernel K3 with its plain version.

Counterpart of ``consensus_specs_tpu/ops/jax_bls/htc.py``; the CUDA side
is ``csrc/htc.cu``.  ``expand_message_xmd``/``hash_to_field`` stay on the
host (a few SHA-256 calls per message), as the JAX package's
``hash_to_field_host`` keeps them; the field-to-curve map runs on the
device: simplified SWU on the 3-isogenous curve, the RFC 9380 E.3
isogeny, Q0 + Q1, and Budroni-Pintore cofactor clearing through the
x-chain ([x]R - P + psi(R) + psi^2([2]P) with R = [x]P - P).

K3 ``hash_to_g2`` replaces ``htc.py:150,158,173,181`` ``_j_sswu_*``,
``:196,202`` ``_j_iso_*``, ``:225,231,237,242,248`` (affine add, double
runs, cofactor combine), ``tower.py:173,184,193`` ``_j_sqrt_*`` and the
``limbs.py:308`` ladders it dispatches (Legendre, sqrt, inverse).
"""
import torch

from ..bls12_381 import hash_to_curve as _oracle
from ..bls12_381.fields import X_PARAM
from ... import _build
from . import limbs as L
from . import tower as T
from . import points as PT

_ABS_X_BITS = [int(c) for c in bin(-X_PARAM)[3:]]   # after the leading 1


def _c(x, like):
    return T.f2_const(x, like)


def sswu(u):
    """Simplified SWU: u (..., 2, 24) -> affine (x, y) on E'."""
    A, B, Z = (_c(_oracle.A_PRIME, u), _c(_oracle.B_PRIME, u),
               _c(_oracle.Z_SSWU, u))
    zu2 = T.f2_mul(Z, T.f2_sqr(u))
    tv = T.f2_add(T.f2_sqr(zu2), zu2)
    x1_main = T.f2_mul(_c(-_oracle.B_PRIME * _oracle.A_PRIME.inv(), u),
                       T.f2_add(T.f2_one_like(u), T.f2_inv(tv)))
    b_over_za = _oracle.B_PRIME * (_oracle.Z_SSWU * _oracle.A_PRIME).inv()
    x1 = T.f2_select(T.f2_is_zero(tv), _c(b_over_za, u).expand_as(u), x1_main)
    x2 = T.f2_mul(zu2, x1)
    xs = torch.stack([x1, x2])
    gx = T.f2_add(T.f2_mul(T.f2_add(T.f2_sqr(xs), A), xs), B)   # x^3 + Ax + B
    sq1 = T.f2_is_square(gx[0])
    x = T.f2_select(sq1, x1, x2)
    y = T.f2_sqrt(T.f2_select(sq1, gx[0], gx[1]))
    flip = T.f2_sgn0(u) != T.f2_sgn0(y)
    return x, T.f2_select(flip, T.f2_neg(y), y)


def iso_map(x, y):
    """3-isogeny E' -> E2 (RFC 9380 E.3), the four Horner chains run as one
    stacked chain; one shared inversion of x_den * y_den."""
    tabs = [_oracle.ISO_XNUM, _oracle.ISO_XDEN, _oracle.ISO_YNUM,
            _oracle.ISO_YDEN]
    deg = max(len(t) for t in tabs)
    zero = _oracle.Fq2(0, 0)
    coef = torch.stack([torch.stack([_c(t[k] if k < len(t) else zero, x)
                                     for t in tabs]) for k in range(deg)])
    shape = (4,) + x.shape
    acc = coef[deg - 1].reshape((4,) + (1,) * (x.dim() - 2) + (2, L.NLIMB))
    acc = acc.expand(shape)
    for k in range(deg - 2, -1, -1):
        acc = T.f2_add(T.f2_mul(acc, x),
                       coef[k].reshape(acc.shape[:1] + (1,) * (x.dim() - 2)
                                       + (2, L.NLIMB)))
    x_num, x_den, y_num, y_den = acc.unbind(0)
    inv = T.f2_inv(T.f2_mul(x_den, y_den))
    m = T.f2_mul(torch.stack([x_num, y_num]),
                 T.f2_mul(inv, torch.stack([y_den, x_den])))
    return m[0], T.f2_mul(y, m[1])


def psi(p):
    """Untwist-Frobenius-twist endomorphism on projective G2 points."""
    X, Y, Z = p.unbind(-3)
    xy = T.f2_mul(T.f2_conj(torch.stack([X, Y])),
                  torch.stack([_c(_oracle._PSI_CX, X), _c(_oracle._PSI_CY, X)])
                  .reshape((2,) + (1,) * (X.dim() - 2) + (2, L.NLIMB)))
    return torch.stack([xy[0], xy[1], T.f2_conj(Z)], dim=-3)


def _neg(p):
    X, Y, Z = p.unbind(-3)
    return torch.stack([X, T.f2_neg(Y), Z], dim=-3)


def _mul_abs_x(p):
    acc = p
    for bit in _ABS_X_BITS:
        acc = PT.complete_dbl(PT._G2, acc)
        if bit:
            acc = PT.complete_add(PT._G2, acc, p)
    return acc


def clear_cofactor(p):
    G = PT._G2
    r = _neg(PT.complete_add(G, _mul_abs_x(p), p))            # [x]P - P
    s = PT.complete_add(G, _neg(_mul_abs_x(r)), _neg(p))      # [x]R - P
    t = PT.complete_add(G, psi(r), psi(psi(PT.complete_dbl(G, p))))
    return PT.complete_add(G, s, t)


@torch.inference_mode()
def hash_to_g2_plain(u):
    """Plain PyTorch version of K3 (any device)."""
    uu = L.unpack(u)                                   # (B, 2, 2, 24)
    x, y = iso_map(*sswu(uu))
    aff = torch.stack([x, y], dim=-3)                  # (B, 2 halves, 2, 2, 24)
    pts = PT.from_affine(PT._G2, aff, torch.zeros(aff.shape[:2], dtype=torch.bool,
                                                  device=u.device))
    q = PT.complete_add(PT._G2, pts[:, 0], pts[:, 1])
    out, inf = PT.normalize(PT._G2, clear_cofactor(q))
    return L.pack(out), inf


def hash_to_g2_fq_products(u) -> int:
    """Fq products K3's function needs for the B messages of ``u``: per
    message, two SSWU maps (inversion, the square roots of the complex
    method, whose first root also decides the square test, so no
    Legendre symbol) and 3-isogenies, Q0 + Q1, the cofactor chain (two
    [|x|] ladders, five additions, a doubling, three psi maps) and the
    affine result."""
    from . import team_programs as TP
    ones = bin(-X_PARAM).count("1") - 1
    root = TP.LADDER_MULS + 1                 # c = a^((p - 3) / 4), then a c
    sswu_ = (2 + 3 + 2 + T.F2_INV + 3 + 5 + 2 + 5 + 2 * root + 2)
    iso = 11 * T.F2_MUL + T.F2_MUL + T.F2_INV + 5 * T.F2_MUL
    mul_x = len(_ABS_X_BITS) * PT.G2_DBL + ones * PT.G2_ADD
    cof = 2 * mul_x + 5 * PT.G2_ADD + PT.G2_DBL + 3 * 2 * T.F2_MUL
    per_msg = 2 * (sswu_ + iso) + PT.G2_ADD + cof + T.F2_INV + 2 * T.F2_MUL
    return u.shape[0] * per_msg


def hash_to_g2_chain() -> int:
    """K3's chain floor: the dependent Fq product latencies of one message
    in its design (any B).  A map (both maps run side by side): the front
    and the candidates' numerators as team programs, two square-root
    ladders (each with its products by the root and the square test), the
    affine point and the isogeny; then the steps of Q0 + Q1, the two
    [|x|] chains and R (two product waves each), the chain's end and the
    normalization.  The binary-Euclid inversions have no products."""
    from . import team_programs as TP
    lv = TP.product_levels
    ladders = 2 * (TP.LADDER_MULS + 2)
    maps = lv("h2c_front") + lv("h2c_gx") + ladders + lv("h2c_xy") + lv("h2c_iso")
    steps = 2 + 2 * (len(_ABS_X_BITS) + bin(-X_PARAM).count("1") - 1)
    return (maps + steps * TP.STEP_PRODUCT_WAVES + lv("h2c_tail") + lv("g2_norm")
            + lv("g2_affine"))


def hash_to_g2(u):
    """K3.  ``u``: (B, 2, 2, 12) int32, the two hash_to_field Fq2 outputs
    (u0, u1) per message.  Returns affine G2 points (B, 2, 2, 12) int32
    and infinity flags (B,) bool.

    CUDA: a block of three warps per message.  Warps 0 and 1 run the maps
    of u0 and u1 side by side as team programs, x1 kept as a fraction
    N / D; each map's square test is its first square-root ladder, and
    both candidates of each ladder run at once on two lanes (two ladders
    a map); warp 2 inverts N(D) meanwhile (binary extended Euclid).  Warp
    0 then runs Q0 + Q1 and the cofactor chain as laid-out team steps and
    ends with one inversion.  Bound: the chain (``hash_to_g2_chain``), not
    the card's multiply-add rate (``hash_to_g2_fq_products``): at a
    block's 131 messages the card runs 131 blocks."""
    dev = _build.same_device(u)
    B = u.shape[0]
    _build.check(u, "u", torch.int32, (B, 2, 2, 12))
    if dev.type == "cpu":
        return hash_to_g2_plain(u)
    out = torch.empty((B, 2, 2, 12), dtype=torch.int32, device=dev)
    inf = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _build.launch("hash_to_g2", u, out, inf, B)
    return out, inf


def hash_to_field_host(msgs, dst=_oracle.DST_G2) -> torch.Tensor:
    """Host: messages -> (B, 2, 2, 12) int32 words of (u0, u1) on the CPU."""
    vals = []
    for m in msgs:
        for u in _oracle.hash_to_field_fq2(bytes(m), 2, dst):
            vals += [u.a.n, u.b.n]
    return torch.from_numpy(L.words_from_ints(vals).reshape(len(msgs), 2, 2, 12).copy())
