"""K2 (g2_scale_sum) and K3 (hash_to_g2) as their kernels run them: the
laid-out G2 team steps (``team_programs.G2_STEPS``, the tables
``csrc/g2_team.cuh`` g2_step runs) and the G2 team programs
(``team_programs.G2_PROGRAMS``) on python ints, against the plain
versions' complete formulas and the oracle; a model of K3's schedule
(the fraction x1 = N / D, both candidates' norms through one ladder each,
the square test read off the first root, both (a +- alpha) / 2 roots at
once, the selections, the inversions, the programs of the maps, the
steps of the cofactor chain) against ``hash_to_g2_plain``, the oracle and
the JAX package's ``_staged_sswu_iso`` and ``hash_to_g2_batch``; a model
of K2's lanes (4-bit sliding windows over a table of odd multiples) and
of its tree of team additions (in either finishing order) against
``g2_scale_sum_plain``, the oracle and the JAX package's
``g2_scalar_mul`` + ``g2_tree_sum``.  Exact comparisons.  The JAX
programs run in the package's numpy-kernel mode in a subprocess."""
import json
import os

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch.ops.bls12_381 import hash_to_curve as H
from consensus_specs_tpu_torch.ops.bls12_381.curve import G2_GENERATOR, G2Point
from consensus_specs_tpu_torch.ops.bls12_381.fields import P, X_PARAM, Fq2
from consensus_specs_tpu_torch.ops.torch_bls import convert as C
from consensus_specs_tpu_torch.ops.torch_bls import htc
from consensus_specs_tpu_torch.ops.torch_bls import limbs as L
from consensus_specs_tpu_torch.ops.torch_bls import points as PT
from consensus_specs_tpu_torch.ops.torch_bls import team_programs as TP
from tests.test_hash_to_curve import G2_DST, G2_VECTORS
from tests._torch_port import one_torch_thread, run_numpy_kernels  # noqa: F401

HEAVY = os.environ.get("CS_TPU_HEAVY") == "1"
ONE = L.R_MONT % P
ABS_X_BITS = [int(c) for c in bin(-X_PARAM)[3:]]      # after the leading 1
K = TP.G2_CONSTS


def mm(x, y):
    """The kernel's Montgomery product on python ints."""
    return x * y * L.R_INV % P


def mont(v):
    return v * L.R_MONT % P


def inv(x):
    """The binary Euclid's value: the unique inverse, Montgomery form."""
    return pow(x, -1, P) * L.R_MONT * L.R_MONT % P


def half(x):
    return (x + (P if x & 1 else 0)) >> 1


def run(name, *args):
    return TP.program(name).run(list(args))[0]


def sgn0(c):
    return (c[0] & 1) if c[0] else (c[1] & 1)


def flat_point(p):
    """An oracle G2Point -> the programs' flat projective Montgomery ints."""
    if p.infinity:
        return [0, 0, ONE, 0, 0, 0]
    return [mont(p.x.a.n), mont(p.x.b.n), mont(p.y.a.n), mont(p.y.b.n), ONE, 0]


def affine(flat):
    """Flat projective ints -> the oracle point (by python inversion)."""
    z = Fq2(flat[4] * L.R_INV % P, flat[5] * L.R_INV % P)
    if z.is_zero():
        return G2Point.inf()
    zi = z.inv()
    x = Fq2(flat[0] * L.R_INV % P, flat[1] * L.R_INV % P) * zi
    y = Fq2(flat[2] * L.R_INV % P, flat[3] * L.R_INV % P) * zi
    return G2Point(x, y)


def plain_point(flat):
    """Flat ints -> the plain version's (3, 2, 24) point tensor."""
    return L.unpack(torch.from_numpy(L.words_from_ints(flat, mont_form=False)
                                     .reshape(3, 2, 12).copy()))


def plain_flat(t):
    return L.ints_from_words(L.pack(t).reshape(-1, 12), mont_form=False)


# ---------------------------------------------------------------------------
# the G2 team steps and programs
# ---------------------------------------------------------------------------

def _g2_points():
    rng = np.random.default_rng(91)
    a, b = (G2_GENERATOR.mult(int(rng.integers(1, 1 << 62))) for _ in range(2))
    return a, b


def step(name, p, q=None):
    """A laid-out step (``TP.g2_step``'s tables) on python ints, level by
    level as ``g2_step`` runs them: every sum reduced, every product
    Montgomery's."""
    st = TP.g2_step(name)
    inp = list(p) + list(q or [0] * 6)
    lin = lambda t, vals: sum(c * vals[s] for s, c in t) % P
    w1 = [mm(lin(a, inp), lin(b, inp)) for a, b in st["wave1"]]
    mids = [lin(t, w1) for t in st["mids"]]
    w2 = [mm(mids[a], mids[b]) for a, b in st["wave2"]]
    return [lin(t, w2) for t in st["out"]]


@pytest.mark.parametrize("case", ["P + Q", "P + P", "P + (-P)", "O + P", "P + O", "O + O"])
def test_g2_add_step_equals_complete_add(case):
    """The laid-out addition's projective output equals the plain
    version's ``complete_add`` word for word, also on a doubling, on a
    point and its negation, and on the identity; its affine point is the
    oracle's sum; the negated addition negates Y alone."""
    a, b = _g2_points()
    p, q = {"P + Q": (a, b), "P + P": (a, a), "P + (-P)": (a, -a), "O + P": (G2Point.inf(), a),
            "P + O": (a, G2Point.inf()), "O + O": (G2Point.inf(), G2Point.inf())}[case]
    # a representative with Z != 1 where the point is finite
    fp, fq = flat_point(p), step("dbl", flat_point(q)) if not q.infinity else flat_point(q)
    got = step("add", fp, fq)
    want = plain_flat(PT.complete_add(PT._G2, plain_point(fp), plain_point(fq)))
    assert got == want
    assert affine(got) == p + q + q
    assert step("add_neg", fp, fq) == got[:2] + [(-v) % P for v in got[2:4]] + got[4:]


@pytest.mark.parametrize("case", ["P", "2P", "-P", "O"])
def test_g2_dbl_step_equals_complete_dbl(case):
    a, _ = _g2_points()
    flat = {"P": flat_point(a), "2P": step("dbl", flat_point(a)), "-P": flat_point(-a),
            "O": flat_point(G2Point.inf())}[case]
    got = step("dbl", flat)
    assert got == plain_flat(PT.complete_dbl(PT._G2, plain_point(flat)))
    assert affine(got) == affine(flat) + affine(flat)


def test_g2_steps_fit_a_warp_and_their_terms():
    """Every level of a step fits the warp, every sum its term count and
    the kernel's coefficient limits; a step is two product waves."""
    for name in TP.G2_STEPS:
        st = TP.g2_step(name)
        assert max(len(st["wave1"]), len(st["mids"]), len(st["wave2"])) <= TP.G2_TEAM
        assert len(st["wave1"]) + len(st["mids"]) + len(st["wave2"]) <= TP.STEP_FQ
        assert len(st["out"]) == 6
    assert [len(TP.g2_step(n)["wave2"]) for n in ("dbl", "add")] == [12, 18]


def test_g2_norm_and_affine_programs():
    a, b = _g2_points()
    flat = step("add", step("dbl", flat_point(a)), flat_point(b))
    n = run("g2_norm", flat)[0]
    assert n == (mm(flat[4], flat[4]) + mm(flat[5], flat[5])) % P
    x = run("g2_affine", flat, [inv(n)])
    want = a + a + b
    assert x == [mont(want.x.a.n), mont(want.x.b.n), mont(want.y.a.n), mont(want.y.b.n)]


def test_ladder_is_the_fixed_power():
    """K3's sliding-window ladder is a^((p - 3) / 4), in 461 products."""
    rng = np.random.default_rng(92)
    for _ in range(4):
        v = int.from_bytes(rng.bytes(48), "little") % P
        assert TP.ladder(mont(v)) * L.R_INV % P == pow(v, TP.LADDER_EXP, P)
    assert TP.ladder(0) == 0
    assert TP.LADDER_MULS == 461


# ---------------------------------------------------------------------------
# K3: a model of the kernel's schedule
# ---------------------------------------------------------------------------

def root(w, alpha):
    """The kernel's square root of the square W = (a, b) from alpha =
    sqrt(N(W)): both candidates (a +- alpha) / 2 (a and -a for b = 0)
    through the ladder at once, the first kept when its root squares back;
    y0 = (b / 2) c with c = candidate^((p - 3) / 4) = 1 / x0.  Returns
    (the root, which candidate)."""
    a, b = w
    cand = [a, (-a) % P] if b == 0 else [half((a + alpha) % P), half((a - alpha) % P)]
    ts = [TP.ladder(c) for c in cand]
    xs = [mm(c, t) for c, t in zip(cand, ts)]
    plus = mm(xs[0], xs[0]) == cand[0]
    j = 0 if plus else 1
    if b == 0:
        return ([xs[0], 0] if plus else [0, xs[1]]), j
    return [xs[j], mm(half(b), ts[j])], j


def k3_map(u):
    """One map (a warp of the kernel): the front, the tv = 0 case, both
    candidates' W and norms, the first ladders and the square test, the
    root, N(D)^-1 (the Euclid's value), the affine point, the sign, the
    isogeny, the x_den y_den = 0 case.  Returns (the projective point,
    (the candidate taken, the root's candidate, tv = 0))."""
    f = run("h2c_front", list(u))
    zu2, tv, N, D, cu = f[0:2], f[2:4], f[4:6], f[6:8], f[8:10]
    if tv == [0, 0]:
        N, D = K[TP._K_B:TP._K_B + 2], K[TP._K_ZA:TP._K_ZA + 2]
    g = run("h2c_gx", N, D, zu2)
    W, norms, nD, N2 = [g[0:2], g[2:4]], g[4:6], g[6], g[7:9]
    alphas = [mm(n, TP.ladder(n)) for n in norms]
    square = mm(alphas[0], alphas[0]) == norms[0]
    sel = 0 if square else 1
    assert mm(alphas[sel], alphas[sel]) == norms[sel]
    s, j = root(W[sel], alphas[sel])
    xy = run("h2c_xy", s, N if sel == 0 else N2, D, [inv(nD)])
    x, y, cy = xy[0:2], xy[2:4], xy[4:6]
    if sgn0(cu) != sgn0(cy):
        y = [(-v) % P for v in y]
    pt = run("h2c_iso", x, y, TP.ISO_COEFS[:16], TP.ISO_COEFS[16:])
    if pt[4:6] == [0, 0]:
        pt = [0, 0, 0, 0, ONE, 0]
    return pt, (sel, j, tv == [0, 0])


def mul_abs_x(p):
    acc = p
    for bit in ABS_X_BITS:
        acc = step("dbl", acc)
        if bit:
            acc = step("add", acc, p)
    return acc


def k3_model(u):
    """K3 on one message's (u0, u1) Montgomery ints [u0.a, u0.b, u1.a,
    u1.b]: both maps, Q0 + Q1, the cofactor chain, the normalization.
    Returns ((x.a, x.b, y.a, y.b) Montgomery ints, infinity, the maps'
    branches)."""
    q0, b0 = k3_map(u[:2])
    q1, b1 = k3_map(u[2:])
    q = step("add", q0, q1)
    r = step("add_neg", mul_abs_x(q), q)
    out = run("h2c_tail", mul_abs_x(r), r, q)
    n = run("g2_norm", out)[0]
    if n == 0:
        return [0] * 4, True, (b0, b1)
    return run("g2_affine", out, [inv(n)]), False, (b0, b1)


def _u_words(us):
    """[(u0, u1) oracle Fq2 pairs] -> K3's (B, 2, 2, 12) words."""
    vals = [c for pair in us for x in pair for c in (x.a.n, x.b.n)]
    return torch.from_numpy(L.words_from_ints(vals).reshape(len(us), 2, 2, 12).copy())


def _oracle_from_u(u0, u1):
    q0 = G2Point(*H.iso_map_g2(*H.map_to_curve_sswu(u0)))
    q1 = G2Point(*H.iso_map_g2(*H.map_to_curve_sswu(u1)))
    return H.clear_cofactor(q0 + q1)


def _edge_us():
    """Seeded u's whose maps take x1 and x2 in either half and both root
    candidates, u = 0 (tv = 0), u's with zero imaginary parts."""
    rng = np.random.default_rng(93)
    need, picked = {(s, j) for s in (0, 1) for j in (0, 1)}, []
    while need:
        u = Fq2(*(int.from_bytes(rng.bytes(48), "little") % P for _ in range(2)))
        _, (sel, j, _) = k3_map([mont(u.a.n), mont(u.b.n)])
        if (sel, j) in need:
            need.discard((sel, j))
            picked.append(u)
    pairs = [(picked[i], picked[(i + 1) % 4]) for i in range(4)]
    zero = Fq2(0, 0)
    real = Fq2(int.from_bytes(rng.bytes(48), "little") % P, 0)
    return pairs + [(zero, zero), (zero, picked[0]), (real, Fq2(5, 0)), (Fq2(0, 7), real)]


def test_k3_model_covers_both_branches_and_candidates():
    seen = set()
    for u0, u1 in _edge_us():
        _, _, branches = k3_model([mont(c) for x in (u0, u1) for c in (x.a.n, x.b.n)])
        seen |= {b[:2] for b in branches}
        seen |= {("tv0",) for b in branches if b[2]}
    assert {(0, 0), (0, 1), (1, 0), (1, 1), ("tv0",)} <= seen


def test_k3_root_of_real_squares():
    """W = (a, 0): sqrt(a) for a square a, sqrt(-a) u otherwise; W = 0."""
    rng = np.random.default_rng(94)
    seen = set()
    for _ in range(8):
        a = mont(int.from_bytes(rng.bytes(48), "little") % P)
        alpha = mm(mm(a, a), TP.ladder(mm(a, a)))
        s, j = root([a, 0], alpha)
        seen.add(j)
        assert s[0] == 0 or s[1] == 0
        sq = [(mm(s[0], s[0]) - mm(s[1], s[1])) % P, 2 * mm(s[0], s[1]) % P]
        assert sq == [a, 0]
    assert seen == {0, 1}
    assert root([0, 0], 0)[0] == [0, 0]


def test_k3_model_equals_plain_and_oracle_on_edge_us():
    us = _edge_us()
    words = _u_words(us)
    plain, pinf = htc.hash_to_g2_plain(words)
    for i, (u0, u1) in enumerate(us):
        ints = [mont(c) for x in (u0, u1) for c in (x.a.n, x.b.n)]
        aff, inf, _ = k3_model(ints)
        assert not inf and not bool(pinf[i])
        assert aff == L.ints_from_words(plain[i].reshape(4, 12), mont_form=False)
        want = _oracle_from_u(u0, u1)
        assert [v * L.R_INV % P for v in aff] == [want.x.a.n, want.x.b.n, want.y.a.n,
                                                  want.y.b.n]


_JAX_H2C = r"""
import json, sys
from consensus_specs_tpu.ops.jax_bls.backend import NUMPY_KERNELS
assert NUMPY_KERNELS
import jax
from consensus_specs_tpu.ops.jax_bls import htc as JH
from consensus_specs_tpu.ops.jax_bls import limbs as JL
from consensus_specs_tpu.ops.jax_bls import points as JP
spec = json.loads(sys.argv[1])
halves = [[int(c) for c in h] for h in spec["halves"]]
X, Y = JH._staged_sswu_iso((JL.pack_ints_mont([h[0] for h in halves]),
                            JL.pack_ints_mont([h[1] for h in halves])))
cols = [JL.unpack_mont(X[0]), JL.unpack_mont(X[1]), JL.unpack_mont(Y[0]), JL.unpack_mont(Y[1])]
maps = [[str(cols[k][i]) for k in range(4)] for i in range(len(halves))]
msgs = [bytes.fromhex(m) for m in spec["msgs"]]
pts = JH.hash_to_g2_batch(msgs, bytes.fromhex(spec["dst"]))
one = lambda t, i: jax.tree_util.tree_map(lambda a: a[i], t)
h2g = [JP.g2_unpack(one(pts, i)) for i in range(len(msgs))]
print("RESULT=" + json.dumps({"maps": maps, "h2g": [
    [str(p.x.a.n), str(p.x.b.n), str(p.y.a.n), str(p.y.b.n)] for p in h2g]}))
"""


@pytest.fixture(scope="module")
def jax_h2c():
    """The JAX package's staged SSWU + isogeny on every half of the edge
    u's, and its hash_to_g2_batch on the RFC 9380 vectors' messages."""
    us = _edge_us()
    halves = [[str(x.a.n), str(x.b.n)] for pair in us for x in pair]
    msgs = list(G2_VECTORS)
    out = run_numpy_kernels(_JAX_H2C, json.dumps(
        {"halves": halves, "msgs": [m.hex() for m in msgs], "dst": G2_DST.hex()}))
    res = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT=")][0][7:])
    return us, msgs, res


def test_k3_model_maps_equal_jax_staged_sswu_iso(jax_h2c):
    """Each map of the model (its projective isogeny point made affine)
    equals the JAX package's ``_staged_sswu_iso`` on the same u."""
    us, _, res = jax_h2c
    halves = [x for pair in us for x in pair]
    for u, want in zip(halves, res["maps"]):
        pt, _ = k3_map([mont(u.a.n), mont(u.b.n)])
        got = affine(pt)
        assert [got.x.a.n, got.x.b.n, got.y.a.n, got.y.b.n] == [int(v) for v in want]


def test_k3_model_equals_rfc_vectors_jax_batch_and_plain(jax_h2c):
    """The RFC 9380 vectors' messages: the model's points equal the
    vectors, the JAX package's ``hash_to_g2_batch`` and the plain version."""
    _, msgs, res = jax_h2c
    words = htc.hash_to_field_host(msgs, G2_DST)
    plain, _ = htc.hash_to_g2_plain(words)
    for i, msg in enumerate(msgs):
        ints = L.ints_from_words(words[i].reshape(4, 12), mont_form=False)
        aff, inf, _ = k3_model(ints)
        canon = [v * L.R_INV % P for v in aff]
        assert not inf
        assert canon == list(G2_VECTORS[msg]) == [int(v) for v in res["h2g"][i]]
        assert aff == L.ints_from_words(plain[i].reshape(4, 12), mont_form=False)


def test_k3_chain_floor_counts_the_schedule():
    """``hash_to_g2_chain`` is the model's dependent products: the product
    levels of every program run on the chain, two waves a step (Q0 + Q1,
    63 doublings and 5 additions a [|x|] chain, R) and both ladders'
    products with their roots' and tests' products."""
    lv = TP.product_levels
    steps = 1 + 2 * (len(ABS_X_BITS) + sum(ABS_X_BITS)) + 1
    want = (lv("h2c_front") + lv("h2c_gx") + 2 * (TP.LADDER_MULS + 2) + lv("h2c_xy")
            + lv("h2c_iso") + 2 * steps + lv("h2c_tail") + lv("g2_norm") + lv("g2_affine"))
    assert htc.hash_to_g2_chain() == want == 1229


@pytest.mark.skipif(not HEAVY, reason="wider sweep: CS_TPU_HEAVY=1")
def test_k3_model_wide_sweep():
    msgs = [bytes([i]) * i for i in range(48)]
    words = htc.hash_to_field_host(msgs)
    for i, msg in enumerate(msgs):
        aff, _, _ = k3_model(L.ints_from_words(words[i].reshape(4, 12), mont_form=False))
        want = H.hash_to_g2(msg)
        assert [v * L.R_INV % P for v in aff] == [want.x.a.n, want.x.b.n, want.y.a.n,
                                                  want.y.b.n]


# ---------------------------------------------------------------------------
# K2: a model of the lanes and of the tree
# ---------------------------------------------------------------------------

def k2_lane(p, k):
    """One lane: the identity for k = 0 or P at infinity, else the table
    P, 3P, ..., 15P (2P, then an addition each) and the 4-bit sliding
    windows from the leading bit."""
    if p.infinity or k == 0:
        return [0, 0, ONE, 0, 0, 0]
    tab = [flat_point(p)]
    two = step("dbl", tab[0])
    while len(tab) < 1 << (TP.K2_WIN - 1):
        tab.append(step("add", tab[-1], two))
    first, windows, tail = TP.sliding_windows(k, TP.K2_WIN)
    acc = tab[first >> 1]
    for dbls, d in windows:
        for _ in range(dbls):
            acc = step("dbl", acc)
        acc = step("add", acc, tab[d >> 1])
    for _ in range(tail):
        acc = step("dbl", acc)
    return acc


def k2_model(sigs, scalars, order):
    """K2 on oracle points: every lane, then the tree."""
    return k2_tree([k2_lane(p, k) for p, k in zip(sigs, scalars)], order)


def k2_tree(partial, order):
    """K2's tree over the lanes' partials, in which a pair's second
    finisher adds left + right (the lanes finish in ``order``; a block
    goes on up while it is a pair's second or has no right sibling), then
    N(Z), its inverse and the affine point."""
    B = len(partial)
    arrived, acc_of, root = [0] * B, {}, None
    for b in order:
        idx, acc, span, done = b, partial[b], 1, False
        while span < B:
            right = bool(idx & span)
            if not right and idx + span >= B:
                span <<= 1
                continue
            acc_of[idx] = acc
            arrived[idx | span] += 1
            if arrived[idx | span] == 1:
                done = True
                break
            other = acc_of[idx ^ span]
            acc = step("add", other, acc) if right else step("add", acc, other)
            idx &= ~span
            span <<= 1
        if not done:
            assert root is None and idx == 0
            root = acc
    n = run("g2_norm", root)[0]
    if n == 0:
        return None
    return run("g2_affine", root, [inv(n)])


def _k2_case(B, seed):
    """B lanes: seeded signatures with a repeat, a point at infinity, a
    zero scalar and a pair P, -P with one scalar (from B = 4)."""
    rng = np.random.default_rng(seed)
    gs = [G2_GENERATOR.mult(int(rng.integers(1, 1 << 62))) for _ in range(6)]
    sigs = [gs[i % 6] for i in range(B)]
    scalars = [int.from_bytes(rng.bytes(16), "little") for _ in range(B)]
    if B >= 4:
        sigs[1], scalars[2] = G2Point.inf(), 0
        sigs[3], scalars[3] = -sigs[0], scalars[0]
    return sigs, scalars


def _scalar_words(scalars):
    raw = b"".join(s.to_bytes(16, "little") for s in scalars)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.int32).reshape(-1, 4).copy())


def _oracle_sum(sigs, scalars):
    acc = G2Point.inf()
    for p, k in zip(sigs, scalars):
        acc = acc + p.mult(k)
    return acc


K2_CASES = ("B = 1", "B = 2", "B = 2, P and -P", "all infinity", "B = 16", "B = 131")


def _k2_inputs(case):
    if case == "B = 2, P and -P":
        s, k = _k2_case(2, 97)
        return [s[0], -s[0]], [k[0], k[0]]
    if case == "all infinity":
        return [G2Point.inf()] * 3, [5, 0, 7]
    B = int(case.split()[-1])
    return _k2_case(B, 95 + B)


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_model_equals_plain_and_oracle(case):
    """The model, finishing in order and in reverse, gives the plain
    version's affine sum word for word and the oracle's point."""
    sigs, scalars = _k2_inputs(case)
    sw, si = C.pack_g2(sigs)
    out, inf = PT.g2_scale_sum_plain(sw, si, _scalar_words(scalars))
    want = _oracle_sum(sigs, scalars)
    assert C.unpack_g2(out[None], inf.reshape(1))[0] == want
    for order in (range(len(sigs)), reversed(range(len(sigs)))):
        got = k2_model(sigs, scalars, list(order))
        if want.infinity:
            assert got is None and bool(inf)
        else:
            assert got == L.ints_from_words(out.reshape(4, 12), mont_form=False)


_JAX_K2 = r"""
import json, sys
import numpy as np
from consensus_specs_tpu.ops.jax_bls.backend import NUMPY_KERNELS
assert NUMPY_KERNELS
import jax
from consensus_specs_tpu.ops.jax_bls import points as PT
from consensus_specs_tpu.ops.bls12_381.curve import g2_from_compressed
spec = json.loads(sys.argv[1])
sigs = PT.g2_pack([g2_from_compressed(bytes.fromhex(s)) for s in spec["sigs"]])
scaled = PT.g2_scalar_mul(sigs, np.array(spec["bits"], dtype=np.uint32))
out = {}
for case, (lo, hi) in spec["cases"].items():
    part = jax.tree_util.tree_map(lambda a: a[lo:hi], scaled)
    out[case] = PT.g2_unpack(PT.g2_tree_sum(part)).to_compressed().hex()
print("RESULT=" + json.dumps(out))
"""


@pytest.mark.parametrize("cases", [
    ("B = 1", "B = 2", "B = 2, P and -P", "B = 16"),
    pytest.param(("B = 131",), marks=pytest.mark.skipif(
        not HEAVY, reason="the JAX ladder takes ~1.5 s a lane in numpy-kernel mode: "
                          "CS_TPU_HEAVY=1"))])
def test_k2_model_equals_jax_scalar_mul_and_tree_sum(cases):
    """The model at B = 1, 2 and 16 (with an infinity lane, a zero scalar,
    a repeated signature and P, -P; B = 131 in the heavy tier) equals the
    JAX package's ``g2_scalar_mul`` (one call over every case's lanes) +
    ``g2_tree_sum`` (per case)."""
    cases = {c: _k2_inputs(c) for c in cases}
    sigs, bits, bounds = [], [], {}
    for c, (s, ks) in cases.items():
        bounds[c] = (len(sigs), len(sigs) + len(s))
        sigs += [p.to_compressed().hex() for p in s]
        bits += [[(k >> (127 - i)) & 1 for i in range(128)] for k in ks]
    out = run_numpy_kernels(_JAX_K2, json.dumps({"sigs": sigs, "bits": bits, "cases": bounds}))
    res = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT=")][0][7:])
    for c, (s, ks) in cases.items():
        got = k2_model(s, ks, list(range(len(s))))
        pt = G2Point.inf() if got is None else G2Point(
            Fq2(got[0] * L.R_INV % P, got[1] * L.R_INV % P),
            Fq2(got[2] * L.R_INV % P, got[3] * L.R_INV % P))
        assert pt.to_compressed().hex() == res[c]


_JAX_TREE = r"""
import json, sys
from consensus_specs_tpu.ops.jax_bls.backend import NUMPY_KERNELS
assert NUMPY_KERNELS
from consensus_specs_tpu.ops.jax_bls import limbs as JL
from consensus_specs_tpu.ops.jax_bls import points as PT
cols = [JL.pack_ints_mont([int(v) for v in c]) for c in json.loads(sys.argv[1])]
pts = ((cols[0], cols[1]), (cols[2], cols[3]), (cols[4], cols[5]))
print("RESULT=" + PT.g2_unpack(PT.g2_tree_sum(pts)).to_compressed().hex())
"""


def test_k2_tree_equals_jax_tree_sum_at_the_flush_width():
    """B = 131, the flush's lanes (with an infinity lane, a zero scalar,
    repeated signatures and P, -P): the model's tree over its per-lane
    partials, finishing in order and in reverse, equals the JAX package's
    ``g2_tree_sum`` of the same projective partials."""
    sigs, scalars = _k2_inputs("B = 131")
    partial = [k2_lane(p, k) for p, k in zip(sigs, scalars)]
    cols = [[str(v[i] * L.R_INV % P) for v in partial] for i in range(6)]
    out = run_numpy_kernels(_JAX_TREE, json.dumps(cols))
    want = [ln for ln in out.splitlines() if ln.startswith("RESULT=")][0][7:]
    for order in (range(131), reversed(range(131))):
        got = k2_tree(partial, list(order))
        pt = G2Point(Fq2(got[0] * L.R_INV % P, got[1] * L.R_INV % P),
                     Fq2(got[2] * L.R_INV % P, got[3] * L.R_INV % P))
        assert pt.to_compressed().hex() == want


def test_k2_bound_counts_the_cheaper_lane_method():
    """A lane's products in K2's ops bound: the cheaper of binary
    double-and-add (mixed additions) and the kernel's sliding windows with
    their table, so a random 128-bit scalar counts the windows and a small
    one the binary ladder; the lanes' sum adds full additions, an Fq2
    inversion and two Fq2 products."""
    dbl, add, madd = PT.G2_DBL, PT.G2_ADD, PT.G2_MADD
    rng = np.random.default_rng(98)
    k = int.from_bytes(rng.bytes(16), "little") | 1 << 127
    _, windows, tail = TP.sliding_windows(k, TP.K2_WIN)
    win = dbl + 7 * add + sum(d * dbl + add for d, _ in windows) + tail * dbl
    binary = 127 * dbl + (bin(k).count("1") - 1) * madd
    assert win < binary and PT._g2_lane_fq_products(k) == win
    assert [PT._g2_lane_fq_products(v) for v in (0, 1, 2, 3)] == [0, 0, dbl, dbl + madd]
    sigs, scalars = _k2_case(5, 99)
    sw, si = C.pack_g2(sigs)
    lanes = sum(PT._g2_lane_fq_products(v) for p, v in zip(sigs, scalars) if not p.infinity)
    live = sum(1 for p in sigs if not p.infinity)
    assert PT.g2_scale_sum_fq_products(sw, si, _scalar_words(scalars)) == \
        lanes + (live - 1) * add + 4 + 2 * 3


def test_k3_bound_counts_the_ladder_roots(monkeypatch):
    """K3's ops bound counts each square root as the kernel's ladder and one
    product (c = a^((p - 3) / 4), then a c): 462 products, four a message."""
    u = torch.zeros((3, 2, 2, 12), dtype=torch.int32)
    per_msg = htc.hash_to_g2_fq_products(u) // 3
    assert htc.hash_to_g2_fq_products(u[:1]) == per_msg
    assert TP.LADDER_MULS + 1 == 462
    monkeypatch.setattr(TP, "LADDER_MULS", TP.LADDER_MULS + 1)
    assert htc.hash_to_g2_fq_products(u[:1]) == per_msg + 4


def test_k2_chain_floor_counts_the_longest_lane():
    """Two product waves a step: the longest lane's table (8 steps),
    doublings and window additions, the tree's levels, the normalization."""
    sigs, scalars = _k2_case(5, 99)
    inf = torch.tensor([p.infinity for p in sigs])
    lanes = []
    for p, k in zip(sigs, scalars):
        if k and not p.infinity:
            _, windows, tail = TP.sliding_windows(k, TP.K2_WIN)
            lanes.append(8 + sum(d + 1 for d, _ in windows) + tail)
    assert PT.g2_scale_sum_chain(inf, _scalar_words(scalars)) == 2 * (max(lanes) + 3) + 1 + 2
