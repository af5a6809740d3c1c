"""Optimal ate product pairing check: kernel K4 with its plain version.

Counterpart of ``consensus_specs_tpu/ops/jax_bls/pairing.py``; the CUDA
side is ``csrc/pairing.cu``.  Same math as the JAX package: a Miller
loop over the bits of |x| with Jacobian doubling / mixed addition on the
M-twist and lines scaled by Fq2 factors (they die in the final
exponentiation), the result conjugated because x < 0; the product of a
group's Miller values; the easy part f^((p^6-1)(p^2+1)); the hard part
through 3(p^4-p^2+1)/r = (x-1)^2 (x+p)(x^2+p^2-1) + 3 (gcd(3, r) = 1, so
the check may use 3h); the is-one test.  Degenerate pairs contribute 1.

K4 ``pairing_check`` replaces ``pairing.py:276,282,293,300``
``_j_miller_*``, ``:307`` ``_j_f12_mul``, ``:316,334`` the easy part,
``:349,355,360,366,374`` the hard part, ``:486-491`` the product tree
and the entry programs ``:452`` ``staged_product_pairing_check``,
``:496`` ``staged_pairing_check`` and ``:242`` ``pairing_check``.  Its
Fq12 steps run as team programs (``team_programs.py``).
"""
import torch

from ..bls12_381.fields import P, R_ORDER, X_PARAM
from ... import _build
from . import limbs as L
from . import tower as T

_ABS_X = -X_PARAM
assert 3 * ((P ** 4 - P ** 2 + 1) // R_ORDER) == \
    (X_PARAM - 1) ** 2 * (X_PARAM + P) * (X_PARAM ** 2 + P ** 2 - 1) + 3
MILLER_BITS = [int(c) for c in bin(_ABS_X)[3:]]        # after the leading 1


def _line(c0, c3, c5):
    """Sparse line c0 + c3 w^3 + c5 w^5 as a full Fq12: ((c0,0,0),(0,c3,c5))."""
    z = torch.zeros_like(c0)
    return torch.stack([torch.stack([c0, z, z], dim=-3),
                        torch.stack([z, c3, c5], dim=-3)], dim=-4)


def _xi_fq(d, s):
    """xi * d (Fq2) scaled by the Fq element s."""
    return T.f2_mul_fq(T.f2_mul_xi(d), s)


def dbl_step(r, px, py):
    """Jacobian doubling of R on the twist + its tangent line at P:
    c0 = 2YZ^3 xi py, c3 = 3X^3 - 2Y^2, c5 = -3X^2 Z^2 px."""
    X, Y, Z = r
    A, B, Z2 = L.many(T.f2_mul, [(X, X), (Y, Y), (Z, Z)])
    E = T.f2_add(T.f2_add(A, A), A)
    C, U, F, EX, EZ2, YZ = L.many(T.f2_mul, [
        (B, B), (T.f2_add(X, B), T.f2_add(X, B)), (E, E), (E, X), (E, Z2), (Y, Z)])
    t = T.f2_sub(U, T.f2_add(A, C))
    D = T.f2_add(t, t)
    X3 = T.f2_sub(F, T.f2_add(D, D))
    C2 = T.f2_add(C, C)
    C8 = T.f2_add(T.f2_add(C2, C2), T.f2_add(C2, C2))
    EDX, YZc = L.many(T.f2_mul, [(E, T.f2_sub(D, X3)), (YZ, Z2)])
    c0 = _xi_fq(T.f2_add(YZc, YZc), py)
    c5 = T.f2_neg(T.f2_mul_fq(EZ2, px))
    c3 = T.f2_sub(EX, T.f2_add(B, B))
    return (X3, T.f2_sub(EDX, C8), T.f2_add(YZ, YZ)), _line(c0, c3, c5)


def add_step(r, qx, qy, px, py):
    """Mixed addition R + Q (Q affine) + the chord line through them:
    with n = S2 - Y1 and d = Z1 H, c0 = d xi py, c3 = n qx - d qy,
    c5 = -n px."""
    X1, Y1, Z1 = r
    Z1Z1 = T.f2_mul(Z1, Z1)
    U2, Z1c = L.many(T.f2_mul, [(qx, Z1Z1), (Z1, Z1Z1)])
    H = T.f2_sub(U2, X1)
    S2, HH, Z1H = L.many(T.f2_mul, [(qy, Z1c), (H, H), (Z1, H)])
    I = T.f2_add(T.f2_add(HH, HH), T.f2_add(HH, HH))
    n = T.f2_sub(S2, Y1)
    rr = T.f2_add(n, n)
    J, V, RR2, NQX, DQY = L.many(T.f2_mul, [
        (H, I), (X1, I), (rr, rr), (n, qx), (Z1H, qy)])
    X3 = T.f2_sub(T.f2_sub(RR2, J), T.f2_add(V, V))
    RVX, Y1J = L.many(T.f2_mul, [(rr, T.f2_sub(V, X3)), (Y1, J)])
    c0 = _xi_fq(Z1H, py)
    c5 = T.f2_neg(T.f2_mul_fq(n, px))
    Y3 = T.f2_sub(RVX, T.f2_add(Y1J, Y1J))
    return (X3, Y3, T.f2_add(Z1H, Z1H)), _line(c0, T.f2_sub(NQX, DQY), c5)


def miller_loop(px, py, qx, qy, degenerate):
    """f_{|x|,Q}(P), conjugated for x < 0; 1 where ``degenerate``."""
    r = (qx, qy, T.f2_one_like(qx))
    f = None
    for bit in MILLER_BITS:
        f = None if f is None else T.f12_sqr(f)
        r, line = dbl_step(r, px, py)
        f = line if f is None else T.f12_mul(f, line)
        if bit:
            r, line = add_step(r, qx, qy, px, py)
            f = T.f12_mul(f, line)
    f = T.f12_conj(f)
    return T.f12_select(degenerate, T.f12_one_like(f), f)


def _pow_x(f):
    """f^|x| for a cyclotomic f: Granger-Scott squarings."""
    acc = f
    for bit in MILLER_BITS:
        acc = T.f12_cyclotomic_sqr(acc)
        if bit:
            acc = T.f12_mul(acc, f)
    return acc


def final_exp(f):
    """f^(3 (p^12 - 1) / r), the easy part and the 3h chain: the GT value
    that ``final_exp_is_one`` tests (the cube of the pairing's final
    exponentiation)."""
    g = T.f12_mul(T.f12_conj(f), T.f12_inv(f))
    g = T.f12_mul(T.f12_frobenius(T.f12_frobenius(g)), g)
    t1 = T.f12_conj(T.f12_mul(_pow_x(g), g))                   # g^(x-1)
    t2 = T.f12_conj(T.f12_mul(_pow_x(t1), t1))                 # t1^(x-1)
    t3 = T.f12_mul(T.f12_conj(_pow_x(t2)), T.f12_frobenius(t2))  # t2^(x+p)
    xx = T.f12_conj(_pow_x(T.f12_conj(_pow_x(t3))))            # t3^(x^2)
    t4 = T.f12_mul(T.f12_mul(xx, T.f12_frobenius(T.f12_frobenius(t3))),
                   T.f12_conj(t3))
    return T.f12_mul(t4, T.f12_mul(T.f12_cyclotomic_sqr(g), g))


def final_exp_is_one(f):
    """True iff f^((p^12-1)/r) == 1, via the 3h decomposition."""
    return T.f12_is_one(final_exp(f))


def group_product(f, offsets):
    """Product of f[offsets[g]:offsets[g+1]] per group (1 for an empty one)."""
    G = offsets.shape[0] - 1
    off = offsets.to(f.device).long()
    sizes = off[1:] - off[:-1]
    acc = T.f12_one_like(f[:1].expand((G,) + f.shape[1:]))
    longest = int((offsets[1:] - offsets[:-1]).max()) if G else 0
    for k in range(longest):
        idx = (off[:-1] + k).clamp(max=max(f.shape[0] - 1, 0))
        acc = T.f12_select(k < sizes, T.f12_mul(acc, f[idx]), acc)
    return acc


@torch.inference_mode()
def pairing_check_gt_plain(p, q, degenerate, offsets):
    """Plain PyTorch version of :func:`pairing_check_gt` (any device)."""
    G = offsets.shape[0] - 1
    if p.shape[0] == 0:
        gt = T.f12_one_like(torch.zeros((G, 2, 3, 2, L.NLIMB), dtype=torch.int64,
                                        device=p.device))
    else:
        pp, qq = L.unpack(p), L.unpack(q)               # (n,2,24), (n,2,2,24)
        f = miller_loop(pp[:, 0], pp[:, 1], qq[:, 0], qq[:, 1], degenerate)
        gt = final_exp(group_product(f, offsets))
    return T.f12_is_one(gt), L.pack(gt).reshape(G, 12, 12)


def pairing_check_plain(p, q, degenerate, offsets):
    """Plain PyTorch version of K4 (any device; ``offsets`` on any device)."""
    return pairing_check_gt_plain(p, q, degenerate, offsets)[0]


# Fq products of one Miller step (for the kernel's bound): the doubling
# step takes 6 Fq2 squares, 5 Fq2 products and 2 Fq2-by-Fq products
# (the line's P coordinates); the addition step 3 squares, 10 products
# and 2 Fq2-by-Fq products.
DBL_STEP = 6 * T.F2_SQR + 5 * T.F2_MUL + 2 * 2
ADD_STEP = 3 * T.F2_SQR + 10 * T.F2_MUL + 2 * 2


def _pow_x_fq_products() -> int:
    return len(MILLER_BITS) * T.CYC_SQR + sum(MILLER_BITS) * T.F12_MUL


FINAL_EXP = (T.F12_INV + 2 * T.F12_MUL + 5 * T.FROB + 5 * _pow_x_fq_products()
             + 8 * T.F12_MUL + T.CYC_SQR)


def pairing_check_fq_products(p, q, degenerate, offsets) -> int:
    """Fq products K4's function needs on these inputs.  Per group with a
    live (non-degenerate) pair: one shared Miller accumulator (a square
    per bit after the first), each live pair's doubling and addition
    steps with their sparse line products, and one final exponentiation;
    a group of degenerate pairs needs nothing."""
    live = (~degenerate).to(torch.int64).cpu()
    off = offsets.tolist()
    n = 0
    for g in range(len(off) - 1):
        k = int(live[off[g]:off[g + 1]].sum())
        if k == 0:
            continue
        steps = (len(MILLER_BITS) * DBL_STEP + (len(MILLER_BITS) - 1) * T.F12_SPARSE_MUL
                 + sum(MILLER_BITS) * (ADD_STEP + T.F12_SPARSE_MUL))
        n += (len(MILLER_BITS) - 1) * T.F12_SQR + k * steps + FINAL_EXP
    return n


def fold_levels(offsets) -> int:
    """Levels of K4's product tree: ceil(log2) of the largest group."""
    sizes = offsets[1:] - offsets[:-1]
    largest = int(sizes.max()) if sizes.numel() else 0
    return max(largest - 1, 0).bit_length()


def pairing_check(p, q, degenerate, offsets):
    """K4.  Flat pairs: ``p`` (n, 2, 12) int32 affine G1, ``q`` (n, 2, 2,
    12) int32 affine G2, ``degenerate`` (n,) bool (the pair contributes
    1), and ``offsets`` (G+1,) int32 ON THE HOST: group g owns pairs
    offsets[g]:offsets[g+1] (validated on the host and copied to the
    pairs' device, so no launch waits on a read-back).  Returns (G,)
    bool: prod e(P_i, Q_i) == 1 per group.

    CUDA (``csrc/pairing.cu``): every Fq12 step is a team program run by
    a block of ``team_programs.TEAM`` threads.  One team per pair runs
    its Miller loop into an (n, 12, 12) scratch; ``fold_levels(offsets)``
    launches multiply the values in a log-depth tree per group; one team
    per group runs the final exponentiation (one Fq inversion, by the
    binary extended Euclid).  Bound: integer multiply-adds
    (``pairing_check_fq_products``); a group's check is a chain of ~700
    Fq12 steps, so latency holds it: each step's products run at once."""
    return _pairing_check(p, q, degenerate, offsets, False)


def pairing_check_gt(p, q, degenerate, offsets):
    """K4 with each group's GT value: (verdicts (G,) bool, (G, 12, 12)
    int32 words of f^(3 (p^12 - 1) / r) for the product f of the group's
    Miller values, the value ``pairing_check`` tests for one).  One launch
    of the same kernel, which also writes the values; for holding K4
    byte for byte."""
    return _pairing_check(p, q, degenerate, offsets, True)


def _pairing_check(p, q, degenerate, offsets, with_gt):
    dev = _build.same_device(p, q, degenerate)
    n = p.shape[0]
    _build.check(p, "p", torch.int32, (n, 2, 12))
    _build.check(q, "q", torch.int32, (n, 2, 2, 12))
    _build.check(degenerate, "degenerate", torch.bool, (n,))
    _build.check(offsets, "offsets", torch.int32, (None,))
    _build.check_host(offsets, "offsets")
    G = offsets.shape[0] - 1
    if G < 0:
        raise ValueError("offsets must hold at least one entry")
    if (int(offsets[0]) != 0 or int(offsets[-1]) != n
            or bool((offsets[1:] < offsets[:-1]).any())):
        raise ValueError("offsets must rise from 0 to the number of pairs")
    if dev.type == "cpu":
        out = pairing_check_gt_plain(p, q, degenerate, offsets)
        return out if with_gt else out[0]
    out = torch.empty((G,), dtype=torch.bool, device=dev)
    gt = torch.empty((G, 12, 12), dtype=torch.int32, device=dev) if with_gt else None
    scratch = torch.empty((max(n, 1), 12, 12), dtype=torch.int32, device=dev)
    if G:
        _build.launch("pairing_check", p, q, degenerate, _build.to_card(offsets, dev),
                      scratch, out, gt, n, G, fold_levels(offsets))
    return (out, gt) if with_gt else out
