"""Extension towers Fq2/Fq6/Fq12, plain PyTorch version.

Counterpart of ``consensus_specs_tpu/ops/jax_bls/tower.py``; on the card
the tower's products are team programs (``team_programs.py``, run by
``csrc/pairing_team.cuh`` and ``csrc/g2_team.cuh``).  Same tower as the oracle
(``ops/bls12_381/fields.py``): Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-xi)
with xi = 1+u, Fq12 = Fq6[w]/(w^2-v).

An element is one tensor with its tower axes before the limb axis
(internal form, see ``limbs``): Fq2 ``(..., 2, 24)`` as (re, im), Fq6
``(..., 3, 2, 24)``, Fq12 ``(..., 2, 3, 2, 24)`` as (d0, d1) - the JAX
pytree order.  Products are computed as ONE wide Fq multiply over all
their coefficient products (schoolbook over the tower axes, gathered
with broadcasting), because the plain version's cost is the number of
tensor calls, not their width.
"""
import torch

from ..bls12_381.fields import (
    Fq2 as _OFq2, FROB_V1 as _OFROB_V1, FROB_V2 as _OFROB_V2,
    FROB_W as _OFROB_W, P)
from . import limbs as L


# Fq products per tower operation (for the kernels' bounds): Karatsuba
# Fq2 (3; a square 2); Fq6 by six Fq2 products; Fq12 by three Fq6
# products (a square two); a product by a sparse line c0 + c3 w^3 +
# c5 w^5 takes 13 Fq2 products; Granger-Scott cyclotomic squaring nine
# Fq2 squares; a Frobenius map five Fq2 products by constants; an
# inversion its norm's products (the Fq inversion none: the binary
# extended Euclid of ``csrc/fq_inv.cuh`` makes it with additions and
# shifts).
F2_MUL, F2_SQR = 3, 2
F2_INV = 2 * 2
F6_MUL = 6 * F2_MUL
F12_MUL, F12_SQR, F12_SPARSE_MUL = 3 * F6_MUL, 2 * F6_MUL, 13 * F2_MUL
CYC_SQR = 9 * F2_SQR
FROB = 5 * F2_MUL
F12_INV = 4 * F6_MUL + 3 * F2_SQR + 9 * F2_MUL + F2_INV


def f2_const(x: _OFq2, like: torch.Tensor) -> torch.Tensor:
    """Oracle Fq2 -> (2, 24) Montgomery constant on ``like``'s device."""
    return torch.stack([L.fq_const(x.a.n, like), L.fq_const(x.b.n, like)])


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

def f2_one_like(x):
    one = torch.zeros_like(x)
    one[..., 0, :] = L.fq_const(1, x)
    return one


def f2_add(x, y):
    return L.add_mod(x, y)


def f2_sub(x, y):
    return L.sub_mod(x, y)


def f2_neg(x):
    return L.neg_mod(x)


def f2_conj(x):
    return torch.stack([x[..., 0, :], L.neg_mod(x[..., 1, :])], dim=-2)


def f2_mul(x, y):
    """Karatsuba: (a+bu)(c+d u) = (ac - bd) + ((a+b)(c+d) - ac - bd) u."""
    x, y = torch.broadcast_tensors(x, y)
    s = L.add_mod(torch.stack([x[..., 0, :], y[..., 0, :]]),
                  torch.stack([x[..., 1, :], y[..., 1, :]]))
    m = L.mont_mul(torch.stack([x[..., 0, :], x[..., 1, :], s[0]]),
                   torch.stack([y[..., 0, :], y[..., 1, :], s[1]]))
    d = L.sub_mod(torch.stack([m[0], m[2]]), torch.stack([m[1], m[0]]))
    return torch.stack([d[0], L.sub_mod(d[1], m[1])], dim=-2)


def f2_sqr(x):
    return f2_mul(x, x)


def f2_mul_fq(x, s):
    """Multiply by an Fq element ``s`` of shape (..., 24)."""
    return L.mont_mul(x, s.unsqueeze(-2))


def f2_mul_xi(x):
    """xi (a + bu) = (a - b) + (a + b) u."""
    a, b = x[..., 0, :], x[..., 1, :]
    return torch.stack([L.sub_mod(a, b), L.add_mod(a, b)], dim=-2)


def f2_norm(x):
    """a^2 + b^2: the Fq norm every inverse/sqrt/Legendre reduces to."""
    sq = L.mont_sqr(x)
    return L.add_mod(sq[..., 0, :], sq[..., 1, :])


def f2_inv(x):
    ninv = L.inv_mod(f2_norm(x))
    m = L.mont_mul(x, ninv.unsqueeze(-2))
    return torch.stack([m[..., 0, :], L.neg_mod(m[..., 1, :])], dim=-2)


def f2_is_zero(x):
    return L.is_zero(x).all(dim=-1)


def f2_select(cond, x, y):
    return torch.where(cond[..., None, None], x, y)


def f2_is_square(x):
    """Euler criterion through the norm: a+bu is a square iff a^2+b^2 is."""
    return L.legendre_is_qr(f2_norm(x))


def f2_sqrt(x):
    """Square root in Fq2 (complex method, p = 3 mod 4), branchless; the
    caller knows x is a square.  Mirrors the oracle (``fields.py``)."""
    a, b = x[..., 0, :], x[..., 1, :]
    alpha = L.sqrt_candidate(f2_norm(x))
    inv2 = L.fq_const(pow(2, -1, P), a)
    deltas = L.mont_mul(L.add_mod(torch.stack([a, a]),
                                  torch.stack([alpha, L.neg_mod(alpha)])),
                        inv2)
    # one ladder for the four candidates: both deltas, a and -a (b == 0)
    roots = L.sqrt_candidate(torch.cat([deltas, a[None], L.neg_mod(a)[None]]))
    x1, x2, ra, rb = roots.unbind(0)
    sq = L.mont_sqr(torch.stack([x1, ra]))
    xr = L.select(L.eq(sq[0], deltas[0]), x1, x2)
    yr = L.mont_mul(b, L.inv_mod(L.add_mod(xr, xr)))
    a_qr = L.eq(sq[1], a)
    zero = torch.zeros_like(a)
    b0_re = L.select(a_qr, ra, zero)
    b0_im = L.select(a_qr, zero, rb)
    bz = L.is_zero(b)
    return torch.stack([L.select(bz, b0_re, xr), L.select(bz, b0_im, yr)],
                       dim=-2)


def f2_sgn0(x):
    """RFC 9380 sgn0 for Fq2: parity of re, or of im when re == 0."""
    par = L.parity(x)
    re_zero = L.is_zero(x[..., 0, :])
    return torch.where(re_zero, par[..., 1], par[..., 0])


# ---------------------------------------------------------------------------
# sums over an axis and polynomial products with a xi-fold
# ---------------------------------------------------------------------------

def _sum_axis(x, dim):
    """Modular sum over ``dim`` (pairwise halving, one add per level)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        h = x.shape[0] // 2
        x = L.add_mod(x[:h], x[h:])
    return x[0]


def _poly_mul_fold(x, y):
    """(..., n, 2, 24) x (..., n, 2, 24) Fq2 coefficient vectors over an
    indeterminate t with t^n = xi -> their product mod (t^n - xi).

    All n^2 coefficient products go through one Fq2 multiply; the
    antidiagonals are gathered with a skew (pad each row with n zero
    coefficients, flatten, re-split at width 2n - 1)."""
    x, y = torch.broadcast_tensors(x, y)
    n = x.shape[-3]
    lead = x.shape[:-3]
    prod = f2_mul(x.unsqueeze(-3), y.unsqueeze(-4))       # (..., n, n, 2, 24)
    prod = torch.cat([prod, torch.zeros_like(prod)], dim=-3)
    flat = prod.reshape(lead + (2 * n * n, 2, L.NLIMB))[..., :n * (2 * n - 1), :, :]
    cols = _sum_axis(flat.reshape(lead + (n, 2 * n - 1, 2, L.NLIMB)), -4)
    low, high = cols[..., :n, :, :], cols[..., n:, :, :]
    high = torch.cat([high, torch.zeros_like(high[..., :1, :, :])], dim=-3)
    return L.add_mod(low, f2_mul_xi(high))


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------

def f6_mul(x, y):
    return _poly_mul_fold(x, y)


def f6_mul_by_v(x):
    return torch.stack([f2_mul_xi(x[..., 2, :, :]), x[..., 0, :, :],
                        x[..., 1, :, :]], dim=-3)


def f6_inv(x):
    a0, a1, a2 = x.unbind(-3)
    m = f2_mul(torch.stack([a0, a1, a2, a1, a0, a0]),
               torch.stack([a0, a1, a2, a2, a1, a2]))
    sq0, sq1, sq2, m12, m01, m02 = m.unbind(0)
    t = f2_sub(torch.stack([sq0, f2_mul_xi(sq2), sq1]),
               torch.stack([f2_mul_xi(m12), m01, m02]))
    d = f2_mul(torch.stack([a0, a2, a1]), t)
    det = f2_add(d[0], f2_add(f2_mul_xi(d[1]), f2_mul_xi(d[2])))
    return f2_mul(t, f2_inv(det)).movedim(0, -3)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v) = Fq2[w]/(w^6 - xi)
# ---------------------------------------------------------------------------

def _to_w(x):
    """(..., 2, 3, 2, 24) -> (..., 6, 2, 24) coefficients of w^0..w^5:
    d_h.c_i multiplies v^i w^h = w^(2i+h)."""
    return x.transpose(-4, -3).reshape(x.shape[:-4] + (6, 2, L.NLIMB))


def _from_w(x):
    return x.reshape(x.shape[:-3] + (3, 2, 2, L.NLIMB)).transpose(-4, -3)


def f12_one_like(x):
    one = torch.zeros_like(x)
    one[..., 0, 0, 0, :] = L.fq_const(1, x)
    return one


def f12_mul(x, y):
    return _from_w(_poly_mul_fold(_to_w(x), _to_w(y)))


def f12_sqr(x):
    return f12_mul(x, x)


def f12_conj(x):
    return torch.stack([x[..., 0, :, :, :], L.neg_mod(x[..., 1, :, :, :])],
                       dim=-4)


def f12_inv(x):
    a, b = x[..., 0, :, :, :], x[..., 1, :, :, :]
    sq = f6_mul(torch.stack([a, b]), torch.stack([a, b]))
    t = f6_inv(L.sub_mod(sq[0], f6_mul_by_v(sq[1])))
    m = f6_mul(torch.stack([a, b]), t)
    return torch.stack([m[0], L.neg_mod(m[1])], dim=-4)


def _frob_coeffs(like):
    """gamma_k with frobenius(sum c_k w^k) = sum conj(c_k) gamma_k w^k:
    gamma_(2i+h) = FROB_V_i * FROB_W^h."""
    v = [_OFq2(1, 0), _OFROB_V1, _OFROB_V2]
    out = []
    for i in range(3):
        for h in range(2):
            out.append(f2_const(v[i] * _OFROB_W if h else v[i], like))
    return torch.stack(out)


def f12_frobenius(x):
    return _from_w(f2_mul(f2_conj(_to_w(x)), _frob_coeffs(x)))


def f12_cyclotomic_sqr(x):
    """Granger-Scott squaring for cyclotomic-subgroup elements (anything
    past the final exponentiation's easy part): 9 Fq2 squarings.  Same
    formula as the JAX package's ``tower.f12_cyclotomic_sqr``:
    coordinates (x0..x5) = (d0.c0, d0.c1, d0.c2, d1.c0, d1.c1, d1.c2),
    Fq4 pairs (x0, x4), (x3, x2), (x1, x5)."""
    (x0, x1, x2), (x3, x4, x5) = [t.unbind(-3) for t in x.unbind(-4)]
    A = torch.stack([x0, x3, x1])            # first of each Fq4 pair
    B = torch.stack([x4, x2, x5])            # second
    sq = f2_mul(torch.stack([A, B, f2_add(A, B)]),
                torch.stack([A, B, f2_add(A, B)]))
    sA, sB, sAB = sq.unbind(0)
    t_even = f2_add(sA, f2_mul_xi(sB))        # t0, t2, t4
    t_odd = f2_sub(sAB, f2_add(sA, sB))       # t1, t3, t5
    t0, t2, t4 = t_even.unbind(0)
    t1, t3, t5 = t_odd.unbind(0)
    xt5 = f2_mul_xi(t5)
    d = torch.cat([f2_sub(torch.stack([t0, t2, t4]), torch.stack([x0, x1, x2])),
                   f2_add(torch.stack([xt5, t1, t3]), torch.stack([x3, x4, x5]))])
    z = f2_add(f2_add(d, d), torch.stack([t0, t2, t4, xt5, t1, t3]))
    return torch.stack([z[0:3].movedim(0, -3), z[3:6].movedim(0, -3)], dim=-4)


def f12_is_one(x):
    return L.eq(x, f12_one_like(x)).flatten(-3).all(dim=-1)


def f12_select(cond, x, y):
    return torch.where(cond[..., None, None, None, None], x, y)


# ---------------------------------------------------------------------------
# host-side conversion for tests: oracle <-> internal tensors
# ---------------------------------------------------------------------------

def f12_const(x, like):
    """Oracle Fq12 -> (2, 3, 2, 24) constant."""
    return torch.stack([torch.stack([f2_const(c, like) for c in (d.c0, d.c1, d.c2)])
                        for d in (x.c0, x.c1)])


def f12_to_oracle(x):
    from ..bls12_381.fields import Fq6, Fq12
    vals = L.ints_from_words(L.pack(x))
    f2s = [_OFq2(vals[i], vals[i + 1]) for i in range(0, 12, 2)]
    return Fq12(Fq6(*f2s[0:3]), Fq6(*f2s[3:6]))
