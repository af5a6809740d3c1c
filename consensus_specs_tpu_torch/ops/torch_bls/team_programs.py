"""Team programs: K4's Fq12 steps (:data:`PROGRAMS`, for a team of
:data:`TEAM` threads) and K2's and K3's G2 and hash-to-curve steps
(:data:`G2_PROGRAMS`, for a team of one warp) as straight-line Fq
programs; K2's and K3's G2 doubling and addition, whose programs are
two waves of products, laid out as fixed waves (:data:`G2_STEPS`); K3's
square-root ladder (:func:`ladder`).

A program is traced once from formulas over Fq nodes (products and signed
sums), the same formulas as ``tower.py`` / ``pairing.py`` and the JAX
package's ``tower.py`` / ``pairing.py`` (Karatsuba Fq2/Fq6/Fq12 products,
the complex Fq12 square, Granger-Scott's cyclotomic square, the sparse
line product of ``_mul_by_line``, the Jacobian Miller steps), and cut
into *levels*.  Inside a level no op reads what another op of the level
writes, and no thread runs more than one product, so a team runs a level
as one wave: op ``i`` on thread ``i mod TEAM``, then a barrier.  An
Fq12 product (54 Fq products) becomes one wave of products and a few
waves of additions instead of 54 dependent products in one thread; a
Miller doubling, its line and ``f^2 * line`` together take four waves of
products.  Every value is the canonical residue the one-thread code
computes, so outputs are byte-identical whatever the order of the sums.

``header()`` writes the programs, the steps and the ladder as tables
for ``csrc/pairing.cu``, ``csrc/points.cu`` and ``csrc/htc.cu``
(``pairing_programs.cuh``, generated by ``_build.py``); ``run`` executes
the same tables on python ints, level by level and thread by thread as
the kernel does, and checks the level rules as it goes (the CPU tests
hold the programs against the plain version and the JAX package this
way).

Slots: an op names ``virtual`` slots.  Slots below :data:`TMP0` are
bound: argument ``b`` of a program (its inputs in order, then its
outputs) is ``BIND * b + i``, and the constants are argument
:data:`CONST_BIND`; the rest are the team's temporaries.  Outputs are
written where they are computed, so a kernel binds no output to the
memory of an input (it alternates between two buffers).
"""
from collections import defaultdict

from ..bls12_381 import hash_to_curve as H
from ..bls12_381.fields import P, Fq2 as _OFq2, FROB_V1, FROB_V2, FROB_W
from .limbs import R_INV, mont

TEAM = 64                 # threads of a K4 team (one block)
BIND = 16                 # virtual slots per bound argument
N_BIND = 8
CONST_BIND = N_BIND - 1
TMP0 = BIND * N_BIND      # first temporary slot
NONE = 0xFFFF
MUL, LIN, NOP = 0, 1, 2
MUL_TERMS = 16            # terms of a product's operand summed by its thread
LIN_TERMS = 48            # terms of a sum (fewer than 64: six bits)
MAX_COEF = 127            # |coefficient| of a term (eight signed bits)
WEIGHT = 1 << 10          # sum of |coefficients| of a sum: the kernel adds WEIGHT p
LIN_PER_THREAD = 4        # sums a thread without a product takes in a product level

# constants: zero and the Frobenius gammas 1..5 (Montgomery form)
_GAMMAS = []
for _i in range(3):
    for _h in range(2):
        _v = [_OFq2(1, 0), FROB_V1, FROB_V2][_i]
        _GAMMAS.append(_v * FROB_W if _h else _v)
CONSTS = [0] + [mont(c) for g in _GAMMAS[1:] for c in (g.a.n, g.b.n)]
ZERO_SLOT = BIND * CONST_BIND


def _gamma(B, k: int):
    """gamma_k (1 <= k <= 5) as an Fq2 of constant nodes."""
    base = ZERO_SLOT + 1 + 2 * (k - 1)
    return B.leaf("c", base), B.leaf("c", base + 1)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _fits(coefs) -> bool:
    """A sum's coefficients as the kernel takes them: each in a signed
    byte, their absolute sum below WEIGHT."""
    coefs = list(coefs)
    return all(abs(c) <= MAX_COEF for c in coefs) and sum(abs(c) for c in coefs) < WEIGHT


class Builder:
    """Fq nodes of one program, as ids into ``nodes``: ("in", slot), ("c",
    slot), ("mul", x_terms, y_terms) or ("lin", terms), terms being
    ((id, coefficient), ...) sorted by id, a coefficient a small non-zero
    integer.  Nodes are interned, so an expression built twice is one
    node; a sum absorbs the sums it adds while its terms stay few."""

    def __init__(self):
        self.nodes, self._ids = [], {}
        self.zero = self.leaf("c", ZERO_SLOT)

    def _intern(self, node) -> int:
        if node not in self._ids:
            self._ids[node] = len(self.nodes)
            self.nodes.append(node)
        return self._ids[node]

    def leaf(self, kind: str, slot: int) -> int:
        return self._intern((kind, slot))

    @staticmethod
    def _collect(pairs):
        acc = defaultdict(int)
        for n, c in pairs:
            acc[n] += c
        return {n: c for n, c in acc.items() if c}

    def _expand(self, terms, limit):
        acc = self._collect((n, c) for n, c in terms if n != self.zero)
        changed = True
        while changed:                               # absorb inner sums that fit
            changed = False
            for n in sorted(acc, key=lambda m: -m):
                d = self.nodes[n]
                if d[0] != "lin" or n not in acc:
                    continue
                trial = dict(acc)
                c = trial.pop(n)
                for m, k in d[1]:
                    trial[m] = trial.get(m, 0) + c * k
                trial = {m: k for m, k in trial.items() if k}
                if len(trial) <= limit and _fits(trial.values()):
                    acc, changed = trial, True
        return tuple(sorted(acc.items()))

    def lin(self, *terms) -> int:
        t = self._expand(terms, LIN_TERMS)
        if not t:
            return self.zero
        if len(t) > LIN_TERMS or not _fits(c for _, c in t):
            raise ValueError("a sum outside the term limits")
        if len(t) == 1 and t[0][1] == 1:
            return t[0][0]
        return self._intern(("lin", t))

    def _operand(self, terms):
        t = self._expand(terms, MUL_TERMS)
        if len(t) > MUL_TERMS or not _fits(c for _, c in t):
            return ((self.lin(*t), 1),)
        return t or ((self.zero, 1),)

    def copy(self, x) -> int:
        """x in a temporary of its own (an output that is an input)."""
        return self._intern(("lin", ((x, 1),)))

    def add(self, x, y):
        return self.lin((x, 1), (y, 1))

    def sub(self, x, y):
        return self.lin((x, 1), (y, -1))

    def neg(self, x):
        return self.lin((x, -1))

    def mul(self, x, y, xs=(), ys=()) -> int:
        """(x + xs)(y + ys) for extra signed terms xs, ys."""
        a = self._operand(((x, 1),) + tuple(xs))
        b = self._operand(((y, 1),) + tuple(ys))
        return self._intern(("mul",) + tuple(sorted((a, b))))


# ---------------------------------------------------------------- Fq2/6/12

def f2_add(B, x, y):
    return (B.add(x[0], y[0]), B.add(x[1], y[1]))


def f2_sub(B, x, y):
    return (B.sub(x[0], y[0]), B.sub(x[1], y[1]))


def f2_neg(B, x):
    return (B.neg(x[0]), B.neg(x[1]))


def f2_conj(B, x):
    return (x[0], B.neg(x[1]))


def f2_dbl(B, x):
    return f2_add(B, x, x)


def f2_mul_xi(B, x):
    """xi (a + b u) = (a - b) + (a + b) u."""
    return (B.sub(x[0], x[1]), B.add(x[0], x[1]))


def f2_mul(B, x, y):
    """Karatsuba: ac - bd, (a + b)(c + d) - ac - bd."""
    ac, bd = B.mul(x[0], y[0]), B.mul(x[1], y[1])
    cr = B.mul(x[0], y[0], [(x[1], 1)], [(y[1], 1)])
    return (B.sub(ac, bd), B.lin((cr, 1), (ac, -1), (bd, -1)))


def f2_sqr(B, x):
    """(a + b)(a - b), 2 a b."""
    re = B.mul(x[0], x[0], [(x[1], 1)], [(x[1], -1)])
    ab = B.mul(x[0], x[1])
    return (re, B.add(ab, ab))


def f2_mul_fq(B, x, s):
    return (B.mul(x[0], s), B.mul(x[1], s))


def f6_add(B, x, y):
    return tuple(f2_add(B, a, b) for a, b in zip(x, y))


def f6_sub(B, x, y):
    return tuple(f2_sub(B, a, b) for a, b in zip(x, y))


def f6_neg(B, x):
    return tuple(f2_neg(B, a) for a in x)


def f6_mul_by_v(B, x):
    return (f2_mul_xi(B, x[2]), x[0], x[1])


def f6_mul(B, x, y):
    """Karatsuba over Fq2 (``tower.py`` f6_mul): 6 Fq2 products."""
    t0, t1, t2 = f2_mul(B, x[0], y[0]), f2_mul(B, x[1], y[1]), f2_mul(B, x[2], y[2])
    m = f2_mul(B, f2_add(B, x[1], x[2]), f2_add(B, y[1], y[2]))
    c0 = f2_add(B, t0, f2_mul_xi(B, f2_sub(B, f2_sub(B, m, t1), t2)))
    m = f2_mul(B, f2_add(B, x[0], x[1]), f2_add(B, y[0], y[1]))
    c1 = f2_add(B, f2_sub(B, f2_sub(B, m, t0), t1), f2_mul_xi(B, t2))
    m = f2_mul(B, f2_add(B, x[0], x[2]), f2_add(B, y[0], y[2]))
    c2 = f2_add(B, f2_sub(B, f2_sub(B, m, t0), t2), t1)
    return (c0, c1, c2)


def f12_mul(B, x, y):
    """(a + b w)(c + d w) = (ac + v bd) + ((a + b)(c + d) - ac - bd) w."""
    t0, t1 = f6_mul(B, x[0], y[0]), f6_mul(B, x[1], y[1])
    s = f6_mul(B, f6_add(B, x[0], x[1]), f6_add(B, y[0], y[1]))
    return (f6_add(B, t0, f6_mul_by_v(B, t1)), f6_sub(B, f6_sub(B, s, t0), t1))


def f12_sqr(B, x):
    """Complex squaring (``tower.py`` f12_sqr): 2 Fq6 products."""
    a, b = x
    ab = f6_mul(B, a, b)
    s = f6_mul(B, f6_add(B, a, b), f6_add(B, a, f6_mul_by_v(B, b)))
    c0 = f6_sub(B, f6_sub(B, s, ab), f6_mul_by_v(B, ab))
    return (c0, f6_add(B, ab, ab))


def f12_conj(B, x):
    return (x[0], f6_neg(B, x[1]))


def f12_frobenius(B, x):
    """conj of every coefficient of w^k, times gamma_k."""
    def g(c, k):
        return f2_mul(B, f2_conj(B, c), _gamma(B, k))
    (a0, a1, a2), (b0, b1, b2) = x
    return ((f2_conj(B, a0), g(a1, 2), g(a2, 4)), (g(b0, 1), g(b1, 3), g(b2, 5)))


def f12_cyc_sqr(B, x):
    """Granger-Scott squaring of a cyclotomic element (``tower.py``
    f12_cyclotomic_sqr): 9 Fq2 squares."""
    (x0, x1, x2), (x3, x4, x5) = x
    A, Bv = (x0, x3, x1), (x4, x2, x5)
    te, to = [], []
    for k in range(3):
        sa, sb = f2_sqr(B, A[k]), f2_sqr(B, Bv[k])
        s = f2_sqr(B, f2_add(B, A[k], Bv[k]))
        to.append(f2_sub(B, f2_sub(B, s, sa), sb))          # t1, t3, t5
        te.append(f2_add(B, sa, f2_mul_xi(B, sb)))          # t0, t2, t4
    tz = (te[0], te[1], te[2], f2_mul_xi(B, to[2]), to[0], to[1])
    xz = (x0, x1, x2, x3, x4, x5)
    z = []
    for k in range(6):
        d = f2_sub(B, tz[k], xz[k]) if k < 3 else f2_add(B, tz[k], xz[k])
        z.append(f2_add(B, f2_dbl(B, d), tz[k]))
    return (tuple(z[:3]), tuple(z[3:]))


def mul_by_line(B, f, c0, c3, c5):
    """f (c0 + c3 w^3 + c5 w^5), the JAX package's ``_mul_by_line``: 16
    Fq2 products, a full Fq12 product's 18 less the line's zeros."""
    a, b = f

    def by_l1(x):
        t11, t22 = f2_mul(B, x[1], c3), f2_mul(B, x[2], c5)
        s = f2_mul(B, f2_add(B, x[1], x[2]), f2_add(B, c3, c5))
        r0 = f2_mul_xi(B, f2_sub(B, f2_sub(B, s, t11), t22))
        r1 = f2_add(B, f2_mul(B, x[0], c3), f2_mul_xi(B, t22))
        r2 = f2_add(B, f2_mul(B, x[0], c5), t11)
        return (r0, r1, r2)
    al0 = tuple(f2_mul(B, ai, c0) for ai in a)
    bl0 = tuple(f2_mul(B, bi, c0) for bi in b)
    al1, bl1 = by_l1(a), by_l1(b)
    return (f6_add(B, al0, f6_mul_by_v(B, bl1)), f6_add(B, al1, bl0))


def dbl_step(B, r, px, py):
    """R <- 2R (Jacobian, twist) and its tangent line at P, as
    ``pairing.py`` dbl_step: c0 = 2YZ^3 xi py (here xi 2 (YZ (Z^2 py))),
    c3 = 3X^3 - 2Y^2, c5 = -3X^2 Z^2 px."""
    X, Y, Z = r
    A, Bq, Z2 = f2_sqr(B, X), f2_sqr(B, Y), f2_sqr(B, Z)
    E = f2_add(B, f2_add(B, A, A), A)
    C, U, F = f2_sqr(B, Bq), f2_sqr(B, f2_add(B, X, Bq)), f2_sqr(B, E)
    EX, EZ2, YZ = f2_mul(B, E, X), f2_mul(B, E, Z2), f2_mul(B, Y, Z)
    D = f2_dbl(B, f2_sub(B, U, f2_add(B, A, C)))
    X3 = f2_sub(B, F, f2_dbl(B, D))
    C8 = f2_dbl(B, f2_dbl(B, f2_dbl(B, C)))
    EDX = f2_mul(B, E, f2_sub(B, D, X3))
    c0 = f2_mul_xi(B, f2_dbl(B, f2_mul(B, YZ, f2_mul_fq(B, Z2, py))))
    c5 = f2_neg(B, f2_mul_fq(B, EZ2, px))
    c3 = f2_sub(B, EX, f2_dbl(B, Bq))
    return (X3, f2_sub(B, EDX, C8), f2_dbl(B, YZ)), (c0, c3, c5)


def add_step(B, r, qx, qy, px, py):
    """R <- R + Q (Q affine) and the chord line, as ``pairing.py``
    add_step: with n = S2 - Y1 and d = Z1 H, c0 = d xi py, c3 = n qx -
    d qy, c5 = -n px."""
    X1, Y1, Z1 = r
    Z1Z1 = f2_sqr(B, Z1)
    U2, Z1c = f2_mul(B, qx, Z1Z1), f2_mul(B, Z1, Z1Z1)
    H = f2_sub(B, U2, X1)
    S2, HH, Z1H = f2_mul(B, qy, Z1c), f2_sqr(B, H), f2_mul(B, Z1, H)
    I = f2_dbl(B, f2_dbl(B, HH))
    n = f2_sub(B, S2, Y1)
    rr = f2_dbl(B, n)
    J, V, RR2 = f2_mul(B, H, I), f2_mul(B, X1, I), f2_sqr(B, rr)
    NQX, DQY = f2_mul(B, n, qx), f2_mul(B, Z1H, qy)
    X3 = f2_sub(B, f2_sub(B, RR2, J), f2_dbl(B, V))
    RVX, Y1J = f2_mul(B, rr, f2_sub(B, V, X3)), f2_mul(B, Y1, J)
    c0 = f2_mul_fq(B, f2_mul_xi(B, Z1H), py)
    c5 = f2_neg(B, f2_mul_fq(B, n, px))
    Y3 = f2_sub(B, RVX, f2_dbl(B, Y1J))
    return (X3, Y3, f2_dbl(B, Z1H)), (c0, f2_sub(B, NQX, DQY), c5)


# ---------------------------------------------------------------- programs
# Each body takes the builder and its inputs as flat Fq node lists and
# returns its outputs as flat lists.  Flat Fq12 order: (c0, c1) x (c0,
# c1, c2) x (a, b), as the plain version's axes.

def _f12(v):
    return tuple(tuple((v[6 * h + 2 * i], v[6 * h + 2 * i + 1]) for i in range(3))
                 for h in range(2))


def _flat(x):
    return [x] if isinstance(x, int) else [n for part in x for n in _flat(part)]


def _f2s(v):
    return tuple((v[2 * i], v[2 * i + 1]) for i in range(len(v) // 2))


def _dbl_body(B, f, r, p):
    r2, line = dbl_step(B, _f2s(r), p[0], p[1])
    return _flat(mul_by_line(B, f12_sqr(B, _f12(f)), *line)), _flat(r2)


def _add_body(B, f, r, p, q):
    qx, qy = _f2s(q)
    r2, line = add_step(B, _f2s(r), qx, qy, p[0], p[1])
    return _flat(mul_by_line(B, _f12(f), *line)), _flat(r2)


def _easy_a_body(B, f):
    """f12_inv's front: d6 = a0^2 - v a1^2, f6_inv's t0..t2 and its Fq2
    determinant det, and det's norm (inverted in Fq between the two
    halves)."""
    a0, a1 = _f12(f)
    x = f6_sub(B, f6_mul(B, a0, a0), f6_mul_by_v(B, f6_mul(B, a1, a1)))
    t0 = f2_sub(B, f2_sqr(B, x[0]), f2_mul_xi(B, f2_mul(B, x[1], x[2])))
    t1 = f2_sub(B, f2_mul_xi(B, f2_sqr(B, x[2])), f2_mul(B, x[0], x[1]))
    t2 = f2_sub(B, f2_sqr(B, x[1]), f2_mul(B, x[0], x[2]))
    det = f2_add(B, f2_mul(B, x[0], t0),
                 f2_mul_xi(B, f2_add(B, f2_mul(B, x[2], t1), f2_mul(B, x[1], t2))))
    norm = B.add(B.mul(det[0], det[0]), B.mul(det[1], det[1]))
    return (_flat((t0, t1, t2, det)) + [norm],)


def _easy_b_body(B, f, t):
    """The easy part g = f^((p^6 - 1)(p^2 + 1)) from f, the front's
    values and the norm's inverse t[9]."""
    t0, t1, t2, det = _f2s(t[:8])
    ninv = t[9]
    dinv = (B.mul(det[0], ninv), B.neg(B.mul(det[1], ninv)))
    inv6 = (f2_mul(B, t0, dinv), f2_mul(B, t1, dinv), f2_mul(B, t2, dinv))
    x = _f12(f)
    inv12 = (f6_mul(B, x[0], inv6), f6_neg(B, f6_mul(B, x[1], inv6)))
    g = f12_mul(B, f12_conj(B, x), inv12)
    return (_flat(f12_mul(B, f12_frobenius(B, f12_frobenius(B, g)), g)),)


def _mul_body(B, x, y):
    return (_flat(f12_mul(B, _f12(x), _f12(y))),)


def _cyc_body(B, x):
    return (_flat(f12_cyc_sqr(B, _f12(x))),)


def _conj_body(B, x):
    c0, c1 = f12_conj(B, _f12(x))
    return (_flat(tuple(tuple((B.copy(a), B.copy(b)) for a, b in c0)) + (c1,)),)


def _mulconj_body(B, x, y):
    return (_flat(f12_conj(B, f12_mul(B, _f12(x), _f12(y)))),)


def _t3_body(B, a, t2):
    """t2^(x + p) = conj(t2^|x|) frobenius(t2)."""
    x = _f12(t2)
    return (_flat(f12_mul(B, f12_conj(B, _f12(a)), f12_frobenius(B, x))),)


def _t4_body(B, xx, t3):
    """t3^(x^2 + p^2 - 1) = xx frobenius^2(t3) conj(t3)."""
    x = _f12(t3)
    return (_flat(f12_mul(B, f12_mul(B, _f12(xx), f12_frobenius(B, f12_frobenius(B, x))),
                          f12_conj(B, x))),)


def _final_body(B, t4, g):
    """t4 g^3 (g^2 by the cyclotomic square): the 3h exponent's value."""
    x = _f12(g)
    return (_flat(f12_mul(B, _f12(t4), f12_mul(B, f12_cyc_sqr(B, x), x))),)


# name: (body, input sizes, output sizes); the order is the kernel's
PROGRAMS = {
    "dbl": (_dbl_body, (12, 6, 2), (12, 6)),
    "add": (_add_body, (12, 6, 2, 4), (12, 6)),
    "conj": (_conj_body, (12,), (12,)),
    "mul": (_mul_body, (12, 12), (12,)),
    "easy_a": (_easy_a_body, (12,), (9,)),
    "easy_b": (_easy_b_body, (12, 10), (12,)),
    "cyc": (_cyc_body, (12,), (12,)),
    "mulconj": (_mulconj_body, (12, 12), (12,)),
    "t3": (_t3_body, (12, 12), (12,)),
    "t4": (_t4_body, (12, 12), (12,)),
    "final": (_final_body, (12, 12), (12,)),
}


# ---------------------------------------------------------------------------
# K2's and K3's programs: G2 steps and the hash-to-curve map, for a team of
# one warp
# ---------------------------------------------------------------------------
# A point is flat (X.a, X.b, Y.a, Y.b, Z.a, Z.b), homogeneous projective,
# with the Renes-Costello-Batina formulas of ``points.py`` (products by
# 3b = 12 (1 + u) as sums: 12 (a - b) + 12 (a + b) u).  The constant
# argument holds :data:`G2_CONSTS`; the isogeny's coefficients come as two
# bound arguments (:data:`ISO_COEFS`).

G2_TEAM = 32


def _g2_consts():
    """zero, A', B', Z, Z A', the raw 1 (a product by it leaves the
    canonical value), psi's cx and cy, and the norms of cx and cy (psi^2
    scales X and Y by them)."""
    za = H.Z_SSWU * H.A_PRIME
    vals = [0]
    for c in (H.A_PRIME, H.B_PRIME, H.Z_SSWU, za):
        vals += [mont(c.a.n), mont(c.b.n)]
    vals.append(1)
    for c in (H._PSI_CX, H._PSI_CY):
        vals += [mont(c.a.n), mont(c.b.n)]
    for c in (H._PSI_CX, H._PSI_CY):
        vals.append(mont((c.a.n * c.a.n + c.b.n * c.b.n) % P))
    assert len(vals) == BIND
    return vals


G2_CONSTS = _g2_consts()
_K_A, _K_B, _K_Z, _K_ZA, _K_RAW1, _K_CX, _K_CY, _K_NCX, _K_NCY = 1, 3, 5, 7, 9, 10, 12, 14, 15


def _k2(B, i):
    """The Fq2 constant at G2_CONSTS[i:i + 2]."""
    return B.leaf("c", ZERO_SLOT + i), B.leaf("c", ZERO_SLOT + i + 1)


def _k1(B, i):
    """The Fq constant G2_CONSTS[i]."""
    return B.leaf("c", ZERO_SLOT + i)


def _iso_tables():
    return [H.ISO_XNUM, H.ISO_XDEN, H.ISO_YNUM, H.ISO_YDEN]


# the isogeny's coefficients, flat (x_num, x_den, y_num, y_den; a, b each)
ISO_COEFS = [mont(c.a.n if h == 0 else c.b.n) for t in _iso_tables() for c in t for h in (0, 1)]


def _b3(B, x):
    """12 (1 + u) x."""
    return (B.lin((x[0], 12), (x[1], -12)), B.lin((x[0], 12), (x[1], 12)))


def _pt(v):
    return (v[0], v[1]), (v[2], v[3]), (v[4], v[5])


def g2_add(B, p, q):
    """RCB Algorithm 7 over Fq2 (``points.complete_add``)."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    t0, t1, t2 = f2_mul(B, x1, x2), f2_mul(B, y1, y2), f2_mul(B, z1, z2)
    m1 = f2_mul(B, f2_add(B, x1, y1), f2_add(B, x2, y2))
    m2 = f2_mul(B, f2_add(B, y1, z1), f2_add(B, y2, z2))
    m3 = f2_mul(B, f2_add(B, x1, z1), f2_add(B, x2, z2))
    t3 = f2_sub(B, m1, f2_add(B, t0, t1))
    t4 = f2_sub(B, m2, f2_add(B, t1, t2))
    y3 = _b3(B, f2_sub(B, m3, f2_add(B, t0, t2)))
    x3 = f2_add(B, f2_dbl(B, t0), t0)
    t2b = _b3(B, t2)
    z3, t1b = f2_add(B, t1, t2b), f2_sub(B, t1, t2b)
    return (f2_sub(B, f2_mul(B, t3, t1b), f2_mul(B, t4, y3)),
            f2_add(B, f2_mul(B, t1b, z3), f2_mul(B, y3, x3)),
            f2_add(B, f2_mul(B, z3, t4), f2_mul(B, x3, t3)))


def g2_dbl(B, p):
    """RCB Algorithm 9 over Fq2 (``points.complete_dbl``)."""
    X, Y, Z = p
    t0, t1, xy, zz = f2_sqr(B, Y), f2_mul(B, Y, Z), f2_mul(B, X, Y), f2_sqr(B, Z)
    z3 = f2_dbl(B, f2_dbl(B, f2_dbl(B, t0)))
    t2 = _b3(B, zz)
    y3 = f2_add(B, t0, t2)
    w = f2_sub(B, t0, f2_add(B, f2_dbl(B, t2), t2))
    return (f2_dbl(B, f2_mul(B, w, xy)), f2_add(B, f2_mul(B, t2, z3), f2_mul(B, w, y3)),
            f2_mul(B, t1, z3))


def g2_neg(B, p):
    return (p[0], f2_neg(B, p[1]), p[2])


def psi(B, p):
    """conj every coordinate; X by cx, Y by cy."""
    X, Y, Z = p
    return (f2_mul(B, f2_conj(B, X), _k2(B, _K_CX)), f2_mul(B, f2_conj(B, Y), _k2(B, _K_CY)),
            f2_conj(B, Z))


def psi2(B, p):
    """psi(psi(P)) = (N(cx) X, N(cy) Y, Z)."""
    X, Y, Z = p
    return (f2_mul_fq(B, X, _k1(B, _K_NCX)), f2_mul_fq(B, Y, _k1(B, _K_NCY)), Z)


def _g2_norm_body(B, p):
    """N(Z) = Z.a^2 + Z.b^2 (the Fq value an affine conversion inverts)."""
    return ([B.add(B.mul(p[4], p[4]), B.mul(p[5], p[5]))],)


def _g2_affine_body(B, p, ninv):
    """(X / Z, Y / Z) from N(Z)^-1: 1 / Z = conj(Z) N(Z)^-1."""
    X, Y, Z = _pt(p)
    zi = f2_mul_fq(B, f2_conj(B, Z), ninv[0])
    return (_flat((f2_mul(B, X, zi), f2_mul(B, Y, zi))),)


def _canon(B, x):
    """The canonical (non-Montgomery) value: a product by the raw 1."""
    return tuple(B.mul(c, _k1(B, _K_RAW1)) for c in x)


def _h2c_front_body(B, u):
    """SSWU's front on u: zu2 = Z u^2, tv = zu2^2 + zu2, the regular
    x1 = N / D with N = -B (tv + 1), D = A tv, and u's canonical value
    (for sgn0)."""
    u = (u[0], u[1])
    zu2 = f2_mul(B, _k2(B, _K_Z), f2_sqr(B, u))
    tv = f2_add(B, f2_sqr(B, zu2), zu2)
    Bk = _k2(B, _K_B)
    N = f2_neg(B, f2_add(B, f2_mul(B, Bk, tv), Bk))
    D = f2_mul(B, _k2(B, _K_A), tv)
    return (_flat((zu2, tv, N, D, _canon(B, u))),)


def _gx_num(B, N, D2, D3):
    """x^3 + A x + B at x = N / D, times D^3: N (N^2 + A D^2) + B D^3."""
    inner = f2_add(B, f2_sqr(B, N), f2_mul(B, _k2(B, _K_A), D2))
    return f2_add(B, f2_mul(B, N, inner), f2_mul(B, _k2(B, _K_B), D3))


def _h2c_gx_body(B, n, d, zu2):
    """Both candidates over one denominator D: x1 = N / D and x2 = Z u^2 x1
    = N2 / D.  g(x_i) = U_i / D^3 is a square exactly when W_i = U_i D is,
    and y = sqrt(W_i) / D^2.  Outputs W1, W2, their norms (the square test
    and the root's first ladder read them), N(D) and N2."""
    N, D, z = (n[0], n[1]), (d[0], d[1]), (zu2[0], zu2[1])
    N2 = f2_mul(B, z, N)
    D2 = f2_sqr(B, D)
    D3 = f2_mul(B, D2, D)
    W = [f2_mul(B, _gx_num(B, x, D2, D3), D) for x in (N, N2)]
    norms = [B.add(B.mul(w[0], w[0]), B.mul(w[1], w[1])) for w in W]
    nD = B.add(B.mul(D[0], D[0]), B.mul(D[1], D[1]))
    return (_flat((W[0], W[1])) + norms + [nD] + _flat(N2),)


def _h2c_xy_body(B, s, n, d, ninv):
    """The affine point of the chosen candidate: x = N / D and
    y = s / D^2 (s the root of W), 1 / D = conj(D) N(D)^-1; with y's
    canonical value (for sgn0)."""
    s, N, D = (s[0], s[1]), (n[0], n[1]), (d[0], d[1])
    di = f2_mul_fq(B, f2_conj(B, D), ninv[0])
    y = f2_mul(B, s, f2_sqr(B, di))
    return (_flat((f2_mul(B, N, di), y, _canon(B, y))),)


def _h2c_iso_body(B, x, y, ka, kb):
    """The 3-isogeny E' -> E2 (RFC 9380 E.3) to a projective point:
    (x_num y_den : y y_num x_den : x_den y_den).  Horner chains; a monic
    polynomial starts from x + c_(n-2)."""
    k = list(ka) + list(kb)
    x, y = (x[0], x[1]), (y[0], y[1])
    polys, pos = [], 0
    for tab in _iso_tables():
        cs = [(k[pos + 2 * i], k[pos + 2 * i + 1]) for i in range(len(tab))]
        pos += 2 * len(tab)
        top = tab[-1]
        lead = x if (top.a.n, top.b.n) == (1, 0) else f2_mul(B, cs[-1], x)
        acc = f2_add(B, lead, cs[-2])
        for c in reversed(cs[:-2]):
            acc = f2_add(B, f2_mul(B, acc, x), c)
        polys.append(acc)
    xn, xd, yn, yd = polys
    return (_flat((f2_mul(B, xn, yd), f2_mul(B, f2_mul(B, y, xd), yn), f2_mul(B, xd, yd))),)


def _h2c_tail_body(B, t, r, q):
    """The cofactor chain's end from t = [|x|]R, R = [x]Q - Q and Q:
    ([x]R - Q) + (psi(R) + psi^2([2]Q)), as the plain version groups it."""
    t, r, q = _pt(t), _pt(r), _pt(q)
    s = g2_add(B, g2_neg(B, t), g2_neg(B, q))
    u = g2_add(B, psi(B, r), psi2(B, g2_dbl(B, q)))
    return (_flat(g2_add(B, s, u)),)


# ---------------------------------------------------------------------------
# K2's and K3's G2 doubling and addition as laid-out waves
# ---------------------------------------------------------------------------
# The hot steps (a lane's 128-bit double-and-add, the cofactor chain) run
# as fixed four-level steps for a warp (``csrc/g2_team.cuh`` g2_step)
# rather than through the program interpreter: wave 1 (one Fq product a
# lane; its operands signed sums of the inputs' coordinates), the operands
# of wave 2 (signed sums of wave 1's products, one a lane), wave 2
# (products of two of them), the outputs (signed sums of wave 2's
# products).  The tables are read off each step's team program (the
# formulas ``g2_dbl``, ``g2_add`` above, scheduled for G2_TEAM), which must
# be exactly those three levels.

STEP_PRODUCT_WAVES = 2    # dependent product latencies of a step
STEP_FQ = 54              # a step's scratch slots (csrc/g2_team.cuh G2_STEP_FQ)

# name: the step's formulas over (P, Q), written as the tables G2S_<NAME>_*
G2_STEPS = {
    "dbl": lambda B, p, q: g2_dbl(B, p),
    "add": lambda B, p, q: g2_add(B, p, q),
    "add_neg": lambda B, p, q: g2_neg(B, g2_add(B, p, q)),
}
_STEPS = {}


def g2_step(name: str) -> dict:
    """A step's tables: ``wave1`` (pairs of operand forms over the input
    slots, P's 0-5 and Q's 6-11), ``mids`` (forms over wave 1's
    products), ``wave2`` (pairs of indices into ``mids``) and ``out``
    (forms over wave 2's products); a form is ((index, coefficient), ...)."""
    if name in _STEPS:
        return _STEPS[name]
    body = G2_STEPS[name]
    prog = Program("g2_" + name, lambda B, p, q: (_flat(body(B, _pt(p), _pt(q))),),
                   (6, 6), (6,), G2_TEAM, G2_CONSTS)
    assert [{op[0] for op in lv} for lv in prog.levels] == [{MUL}, {MUL}, {LIN}], \
        f"{name}: not two waves of products and the outputs' sums"
    w1, w2, outs = prog.levels
    at_in = {BIND * b + i: 6 * b + i for b in (0, 1) for i in range(6)}
    at_w1 = {op[1]: i for i, op in enumerate(w1)}
    at_w2 = {op[1]: i for i, op in enumerate(w2)}
    form = lambda g, at: tuple((at[s], c) for s, c in g)
    mids = []
    for op in w2:
        mids += [f for f in (form(g, at_w1) for g in op[2]) if f not in mids]
    st = {"wave1": [tuple(form(g, at_in) for g in op[2]) for op in w1], "mids": mids,
          "wave2": [tuple(mids.index(form(g, at_w1)) for g in op[2]) for op in w2],
          "out": [form(op[2][0], at_w2) for op in sorted(outs, key=lambda op: op[1])]}
    assert len(mids) <= G2_TEAM and len(w1) + len(mids) + len(w2) <= STEP_FQ
    _STEPS[name] = st
    return st


# name: (body, input sizes, output sizes); team G2_TEAM, constants G2_CONSTS
G2_PROGRAMS = {
    "g2_norm": (_g2_norm_body, (6,), (1,)),
    "g2_affine": (_g2_affine_body, (6, 1), (4,)),
    "h2c_front": (_h2c_front_body, (2,), (10,)),
    "h2c_gx": (_h2c_gx_body, (2, 2, 2), (9,)),
    "h2c_xy": (_h2c_xy_body, (2, 2, 2, 1), (6,)),
    "h2c_iso": (_h2c_iso_body, (2, 2, 16, 14), (6,)),
    "h2c_tail": (_h2c_tail_body, (6, 6, 6), (6,)),
}


# ---------------------------------------------------------------------------
# K3's ladder: a^((p - 3) / 4) by 4-bit sliding windows
# ---------------------------------------------------------------------------
# One thread's chain of squarings (ROADMAP D.2 would split a product).  c =
# a^((p - 3) / 4) gives both a's square root candidate a c (a square when
# (a c)^2 = a) and, for a non-zero square, its inverse c: 1 / (a c) = c.

LADDER_EXP = (P - 3) // 4
LADDER_W = 4
K2_WIN = 4                # K2's sliding windows over its scalars (csrc/points.cu)


def sliding_windows(e: int, w: int):
    """MSB-first sliding windows of w bits over e > 0, as the kernels walk
    them (K3's ladder, K2's scalars): (the first window's odd digit,
    [(squarings or doublings, odd digit), ...], trailing squarings)."""
    bits, i, steps, sq = bin(e)[2:], 0, [], 0
    while i < len(bits):
        if bits[i] == "0":
            sq, i = sq + 1, i + 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        steps.append((sq + j - i, int(bits[i:j], 2)))
        sq, i = 0, j
    return steps[0][1], steps[1:], sq


LADDER_FIRST, LADDER_STEPS, LADDER_TAIL = sliding_windows(LADDER_EXP, LADDER_W)
# products of one ladder: a^2 and the odd powers a^3 .. a^(2^w - 1), then
# the squarings and the window products
LADDER_MULS = (1 << (LADDER_W - 1)) + sum(s + 1 for s, _ in LADDER_STEPS) + LADDER_TAIL


def ladder(a: int) -> int:
    """The kernel's ladder on a Montgomery-form int, product by product."""
    mm = lambda x, y: x * y * R_INV % P
    a2 = mm(a, a)
    tab = [a]
    for _ in range((1 << (LADDER_W - 1)) - 1):
        tab.append(mm(tab[-1], a2))
    acc = tab[LADDER_FIRST >> 1]
    for sq, d in LADDER_STEPS:
        for _ in range(sq):
            acc = mm(acc, acc)
        acc = mm(acc, tab[d >> 1])
    for _ in range(LADDER_TAIL):
        acc = mm(acc, acc)
    return acc


# ---------------------------------------------------------------------------
# scheduling
# ---------------------------------------------------------------------------

def _operands(desc):
    if desc[0] == "mul":
        return [n for n, _ in desc[1]] + [n for n, _ in desc[2]]
    if desc[0] == "lin":
        return [n for n, _ in desc[1]]
    return []


class Program:
    """A scheduled program: ``levels`` is a list of op lists, an op being
    (kind, out slot, groups) with groups (((slot, coefficient), ...), ...):
    one for a sum, two for a product.  NOPs pad a level so that op
    ``i`` runs on thread ``i % team``; ``consts`` are the values of the
    constant argument."""

    def __init__(self, name, body, ins, outs, team=TEAM, consts=CONSTS):
        assert len(ins) + len(outs) <= CONST_BIND
        self.name, self.ins, self.outs = name, ins, outs
        self.team, self.consts = team, consts
        B = Builder()
        args = [[B.leaf("in", BIND * b + i) for i in range(n)] for b, n in enumerate(ins)]
        results = body(B, *args)
        assert [len(r) for r in results] == list(outs), (name, [len(r) for r in results])
        self._schedule(B.nodes, results)

    def _schedule(self, nodes, results):
        desc = nodes
        users, seen, order = defaultdict(list), set(), []
        for s in (n for r in results for n in r):
            stack = [(s, False)]
            while stack:
                m, finished = stack.pop()
                if finished:
                    order.append(m)
                    continue
                if m in seen:
                    continue
                seen.add(m)
                stack.append((m, True))
                for o in _operands(desc[m]):
                    users[o].append(m)
                    if o not in seen:
                        stack.append((o, False))
        is_op = lambda n: desc[n][0] in ("mul", "lin")
        ops = [n for n in order if is_op(n)]
        height = {}
        for n in reversed(order):
            if is_op(n):
                cost = 1.0 if desc[n][0] == "mul" else 0.02 * len(desc[n][1])
                height[n] = cost + max((height[u] for u in users[n]), default=0.0)
        done = {n for n in order if not is_op(n)}
        pending = sorted(ops, key=lambda n: -height[n])
        levels, T = [], self.team                    # lists of node ids, NOPs as None
        while pending:
            ready = [n for n in pending if all(o in done for o in _operands(desc[n]))]
            muls = [n for n in ready if desc[n][0] == "mul"][:T]
            lins = [n for n in ready if desc[n][0] == "lin"]
            if muls:
                free = T - len(muls)
                level = muls + lins[:free]
                for k in range(1, LIN_PER_THREAD):
                    more = lins[free * k:free * (k + 1)]
                    if not more:
                        break
                    level += [None] * len(muls) + more
            else:
                level = lins
            levels.append(level)
            placed = {n for n in level if n is not None}
            done |= placed
            pending = [n for n in pending if n not in placed]
        # an output is computed straight into its bound slot: a kernel never
        # binds an output to the memory of an input (a body copies an input
        # it returns, Builder.copy)
        home = {}
        for b, r in enumerate(results):
            for i, n in enumerate(r):
                if not is_op(n) or n in home:
                    raise ValueError(f"{self.name}: output {b}.{i} is not a value of its own")
                home[n] = BIND * (len(self.ins) + b) + i
        last = {}
        for li, level in enumerate(levels):
            for n in level:
                if n is not None:
                    for o in _operands(desc[n]):
                        last[o] = li
        # temporaries: a slot is free again in the level after its last read
        slot, free, release, self.n_tmp = dict(home), [], defaultdict(list), 0
        for li, level in enumerate(levels):
            free += release.pop(li, [])
            for n in level:
                if n is None or n in home:
                    continue
                if free:
                    slot[n] = free.pop()
                else:
                    slot[n] = TMP0 + self.n_tmp
                    self.n_tmp += 1
                release[last[n] + 1].append(slot[n])

        def where(n):
            return slot[n] if is_op(n) else desc[n][1]

        def op(n):
            if n is None:
                return (NOP, NONE, ())
            d = desc[n]
            groups = d[1:] if d[0] == "mul" else (d[1],)
            return (MUL if d[0] == "mul" else LIN, slot[n],
                    tuple(tuple((where(m), s) for m, s in g) for g in groups))
        self.levels = [[op(n) for n in level] for level in levels]

    # -------------------------------------------------------------- model

    def run(self, args):
        """Execute on python ints (Montgomery form, like the kernel's words):
        ``args`` the inputs as lists of ints; returns the outputs.  Each
        level reads the slots as they were before it and writes after it,
        and the level rules are asserted."""
        mem = {}
        for b, vals in enumerate(args):
            assert len(vals) == self.ins[b]
            for i, v in enumerate(vals):
                mem[BIND * b + i] = v
        for i, v in enumerate(self.consts):
            mem[BIND * CONST_BIND + i] = v
        for level in self.levels:
            writes, reads, muls_on = {}, set(), set()
            for pos, (kind, out, terms) in enumerate(level):
                if kind == NOP:
                    continue
                vals = []
                for group in terms:
                    acc = 0
                    for s, coef in group:
                        reads.add(s)
                        acc += coef * mem[s]
                    vals.append(acc % P)
                if kind == MUL:
                    thread = pos % self.team
                    assert thread not in muls_on, "two products on one thread"
                    muls_on.add(thread)
                    v = vals[0] * vals[1] * R_INV % P
                else:
                    v = vals[0]
                assert out not in writes, "two writes of one slot in a level"
                writes[out] = v
            assert not reads & set(writes), "a level reads what it writes"
            mem.update(writes)
        nin = len(self.ins)
        return [[mem[BIND * (nin + b) + i] for i in range(n)] for b, n in enumerate(self.outs)]

    def tables(self, terms: list) -> list:
        """The ops as two words each, their terms appended to ``terms``: word
        0 is out | kind << 16 | (terms of the first sum) << 20 | (terms of
        a product's second operand) << 26, word 1 the index of the first
        term; a term is slot | (coefficient & 0xff) << 16."""
        out = []
        for level in self.levels:
            for kind, dst, groups in level:
                n = [len(g) for g in groups] + [0, 0]
                assert n[0] < 64 and n[1] < 64
                out += [dst | kind << 16 | n[0] << 20 | n[1] << 26, len(terms)]
                terms += [s | (c & 0xFF) << 16 for g in groups for s, c in g]
        return out


_CACHE = {}


def program(name: str) -> Program:
    if name not in _CACHE:
        if name in PROGRAMS:
            body, ins, outs = PROGRAMS[name]
            _CACHE[name] = Program(name, body, ins, outs)
        else:
            body, ins, outs = G2_PROGRAMS[name]
            _CACHE[name] = Program(name, body, ins, outs, G2_TEAM, G2_CONSTS)
    return _CACHE[name]


def product_levels(name: str) -> int:
    """Levels of a program that hold a product: the dependent product
    latencies of one run."""
    return sum(1 for level in program(name).levels if any(op[0] == MUL for op in level))


def header() -> str:
    """``pairing_programs.cuh``: every program of :data:`PROGRAMS` as
    tables (ops, each level's first op, each program's first level) and
    the temporaries each needs."""
    ops, terms, level0, prog0, tmps = [], [], [0], [0], []
    names = list(PROGRAMS) + list(G2_PROGRAMS)
    for name in names:
        p = program(name)
        for level in p.levels:
            level0.append(level0[-1] + len(level))
        prog0.append(len(level0) - 1)
        ops += p.tables(terms)
        tmps.append(p.n_tmp)

    def arr(ctype, name, vals):
        body = ",".join(f"0x{v:x}u" for v in vals)
        return f"DCONST {ctype} {name}[{len(vals)}] = {{{body}}};"
    lines = ["// generated by consensus_specs_tpu_torch/ops/torch_bls/team_programs.py;"
             " do not edit",
             "#pragma once",
             f"#define PP_TEAM {TEAM}",
             f"#define PP_BIND {BIND}",
             f"#define PP_CONST_BIND {CONST_BIND}",
             f"#define PP_TMP0 {TMP0}",
             f"#define PP_NONE 0x{NONE:x}u",
             f"#define PP_MUL {MUL}",
             f"#define PP_LIN {LIN}",
             f"#define PP_NOP {NOP}",
             f"#define PP_N_CONSTS {len(CONSTS)}",
             f"#define PP_QDIV 0x{(P >> 352) + 1:x}ull"]
    lines += [f"#define PROG_{n.upper()} {i}" for i, n in enumerate(names)]
    lines += [f"#define PP_TMP_{n.upper()} {t}" for n, t in zip(names, tmps)]
    lines.append(arr("uint32_t", "PP_OPS", ops))
    lines.append(arr("uint32_t", "PP_TERMS", terms))
    lines.append(arr("uint32_t", "PP_LEVELS", level0))
    lines.append(arr("uint32_t", "PP_PROGS", prog0))
    lines.append(arr("uint32_t", "PP_WEIGHT_P",
                     [((WEIGHT * P) >> (32 * i)) & 0xFFFFFFFF for i in range(13)]))
    words = lambda vals: [(c >> (32 * i)) & 0xFFFFFFFF for c in vals for i in range(12)]
    lines.append(arr("uint32_t", "PP_CONSTS", words(CONSTS)))
    lines += [f"#define G2_TEAM {G2_TEAM}", f"#define G2_N_CONSTS {len(G2_CONSTS)}",
              f"#define G2_K_B {_K_B}", f"#define G2_K_ZA {_K_ZA}",
              f"#define ISO_N_COEFS {len(ISO_COEFS)}",
              f"#define LADDER_W {LADDER_W}", f"#define LADDER_FIRST {LADDER_FIRST}",
              f"#define K2_WIN {K2_WIN}", f"#define G2_STEP_FQ {STEP_FQ}",
              f"#define LADDER_N_STEPS {len(LADDER_STEPS)}", f"#define LADDER_TAIL {LADDER_TAIL}"]
    lines.append(arr("uint32_t", "G2_CONSTS", words(G2_CONSTS)))
    lines.append(arr("uint32_t", "ISO_COEFS", words(ISO_COEFS)))
    for name in G2_STEPS:
        st, tag = g2_step(name), f"G2S_{name.upper()}"
        terms = [max(len(t) for pair in st["wave1"] for t in pair),
                 max(len(t) for t in st["mids"]), max(len(t) for t in st["out"])]

        def pad(t, n):
            return [slot | (c & 0xFF) << 8 for slot, c in t] + [0] * (n - len(t))
        lines += [f"#define {tag}_SIZES {len(st['wave1'])}, {len(st['mids'])}, "
                  f"{len(st['wave2'])}, {terms[0]}, {terms[1]}, {terms[2]}"]
        lines.append(arr("uint16_t", f"{tag}_W1",
                         [w for pair in st["wave1"] for t in pair for w in pad(t, terms[0])]))
        lines.append(arr("uint16_t", f"{tag}_MID", [w for t in st["mids"] for w in pad(t, terms[1])]))
        lines.append(arr("uint8_t", f"{tag}_W2", [i for pair in st["wave2"] for i in pair]))
        lines.append(arr("uint16_t", f"{tag}_OUT", [w for t in st["out"] for w in pad(t, terms[2])]))
    lines.append(arr("uint8_t", "LADDER_SQ", [sq for sq, _ in LADDER_STEPS]))
    lines.append(arr("uint8_t", "LADDER_DIGIT", [d for _, d in LADDER_STEPS]))
    return "\n".join(lines) + "\n"
