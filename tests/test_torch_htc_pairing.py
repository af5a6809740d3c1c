"""K3 (hash_to_g2) and K4 (pairing_check), plain versions: K3 against the
RFC 9380 vectors and the oracle's hash_to_g2, K4 for bilinearity and
degenerate pairs against the oracle pairing.  K4's team programs (the
tables ``csrc/pairing.cu`` runs), run on python ints as the kernel runs
them, against the plain version and the JAX package, the kernel's fold
order and whole pipeline against the plain GT values, and the GT value
against the oracle and the JAX package's staged chain.  Exact
comparisons."""
import json

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch.ops.bls12_381 import hash_to_curve as H
from consensus_specs_tpu_torch.ops.bls12_381.curve import (
    G1_GENERATOR, G2_GENERATOR, G1Point)
from consensus_specs_tpu_torch.ops.bls12_381.fields import R_ORDER
from consensus_specs_tpu_torch.ops.bls12_381.pairing import multi_pairing_check
from consensus_specs_tpu_torch.ops.torch_bls import convert as C
from consensus_specs_tpu_torch.ops.torch_bls import htc, pairing
from tests.test_hash_to_curve import G2_DST, G2_VECTORS
from tests._torch_port import one_torch_thread  # noqa: F401


def test_k3_matches_rfc_vectors_and_oracle():
    vec_msgs = list(G2_VECTORS)
    own_msgs = [b"torch-port-0", bytes(range(200))]
    u = torch.cat([htc.hash_to_field_host(vec_msgs, G2_DST),
                   htc.hash_to_field_host(own_msgs)])
    aff, inf = htc.hash_to_g2(u)
    assert not inf.any()
    got = C.unpack_g2(aff, inf)
    for pt, msg in zip(got, vec_msgs):
        xr, xi, yr, yi = G2_VECTORS[msg]
        assert (pt.x.a.n, pt.x.b.n, pt.y.a.n, pt.y.b.n) == (xr, xi, yr, yi)
    for pt, msg in zip(got[len(vec_msgs):], own_msgs):
        assert pt.to_compressed() == H.hash_to_g2(msg).to_compressed()


def test_k4_bilinearity_degenerate_pairs_and_groups():
    rng = np.random.default_rng(17)
    a = int.from_bytes(rng.bytes(32), "little") % R_ORDER
    b = int.from_bytes(rng.bytes(32), "little") % R_ORDER
    P, Q = G1_GENERATOR.mult(b), G2_GENERATOR
    groups = [
        [(P.mult(a), Q, False), (-P, Q.mult(a), False)],           # bilinear: 1
        [(P.mult(a), Q, False), (-P, Q.mult(a + 1), False)],       # != 1
        [(P, Q, True), (G1Point.inf(), Q, True)],                  # all degenerate: 1
        [(P, Q, False), (P, Q.mult(a), True)],                     # e(P, Q) != 1
        [],                                                        # empty: 1
    ]
    flat = [pr for g in groups for pr in g]
    offsets = np.cumsum([0] + [len(g) for g in groups]).astype(np.int32)
    out = pairing.pairing_check(
        C.pack_g1([p for p, _, _ in flat])[0], C.pack_g2([q for _, q, _ in flat])[0],
        torch.tensor([d for _, _, d in flat]), torch.from_numpy(offsets))
    assert out.tolist() == [True, False, True, False, True]
    assert multi_pairing_check([(p, q) for p, q, _ in groups[1]]) is False
    assert multi_pairing_check([(p, q) for p, q, _ in groups[0]]) is True


@pytest.mark.parametrize("bad", ["dtype", "empty", "past_end", "falling"])
def test_k4_rejects_malformed_offsets(bad):
    p = torch.zeros((2, 2, 12), dtype=torch.int32)
    q = torch.zeros((2, 2, 2, 12), dtype=torch.int32)
    d = torch.ones((2,), dtype=torch.bool)
    off = {"dtype": torch.tensor([0, 2], dtype=torch.int64),
           "empty": torch.zeros((0,), dtype=torch.int32),
           "past_end": torch.tensor([0, 3], dtype=torch.int32),
           "falling": torch.tensor([0, 2, 1, 2], dtype=torch.int32)}[bad]
    with pytest.raises((TypeError, ValueError)):
        pairing.pairing_check(p, q, d, off)


def test_k1_rejects_counts_outside_the_row():
    from consensus_specs_tpu_torch.ops.torch_bls import points
    pk = torch.zeros((1, 2, 2, 12), dtype=torch.int32)
    for bad in (3, -1):
        with pytest.raises(ValueError):
            points.g1_aggregate_scale(pk, torch.tensor([bad], dtype=torch.int32))


# ---------------------------------------------------------------------------
# K4's team programs (ops/torch_bls/team_programs.py): the tables the kernel
# runs, executed level by level on python ints (the level rules asserted),
# against the plain version, the JAX package and the oracle.  Exact.
# ---------------------------------------------------------------------------

from consensus_specs_tpu_torch.ops.bls12_381.fields import P as FIELD_P  # noqa: E402
from consensus_specs_tpu_torch.ops.torch_bls import limbs as L  # noqa: E402
from consensus_specs_tpu_torch.ops.torch_bls import team_programs as TP  # noqa: E402
from consensus_specs_tpu_torch.ops.torch_bls import tower as T  # noqa: E402


def _mont_ints(rng, n):
    """n seeded field elements as Montgomery-form ints (the kernel's words)."""
    return [int.from_bytes(rng.bytes(48), "little") % FIELD_P for _ in range(n)]


def _tensor(vals, shape):
    """Montgomery-form ints -> plain-version limbs of ``shape`` + (24,)."""
    words = L.words_from_ints([v * L.R_INV % FIELD_P for v in vals])
    return L.unpack(torch.from_numpy(words).reshape(shape + (12,)))


def _ints(t):
    return [v * L.R_MONT % FIELD_P for v in L.ints_from_words(L.pack(t).reshape(-1, 12))]


def _cyclotomic(rng):
    """An element of the cyclotomic subgroup: the easy part of a random f."""
    f = _tensor(_mont_ints(rng, 12), (2, 3, 2))
    g = T.f12_mul(T.f12_conj(f), T.f12_inv(f))
    return T.f12_mul(T.f12_frobenius(T.f12_frobenius(g)), g)


def _plain_case(name, rng):
    """(program inputs as ints, the plain version's outputs as ints)."""
    x, y = _mont_ints(rng, 12), _mont_ints(rng, 12)
    X, Y = _tensor(x, (2, 3, 2)), _tensor(y, (2, 3, 2))
    if name == "cyc":
        c = _cyclotomic(rng)
        return [_ints(c)], [_ints(T.f12_cyclotomic_sqr(c))]
    if name == "line":
        ln = _mont_ints(rng, 6)
        c0, c3, c5 = _tensor(ln, (3, 2)).unbind(0)
        return [x, ln], [_ints(T.f12_mul(X, pairing._line(c0, c3, c5)))]
    if name in ("dbl", "add"):
        r, pt, q = _mont_ints(rng, 6), _mont_ints(rng, 2), _mont_ints(rng, 4)
        R, Pt, Q = _tensor(r, (3, 2)), _tensor(pt, (2,)), _tensor(q, (2, 2))
        if name == "dbl":
            r2, line = pairing.dbl_step(tuple(R), Pt[0], Pt[1])
            return [x, r, pt], [_ints(T.f12_mul(T.f12_sqr(X), line)), _ints(torch.stack(r2))]
        r2, line = pairing.add_step(tuple(R), Q[0], Q[1], Pt[0], Pt[1])
        return [x, r, pt, q], [_ints(T.f12_mul(X, line)), _ints(torch.stack(r2))]
    want = {"mul": lambda: T.f12_mul(X, Y), "sqr": lambda: T.f12_sqr(X),
            "conj": lambda: T.f12_conj(X),
            "mulconj": lambda: T.f12_conj(T.f12_mul(X, Y)),
            "t3": lambda: T.f12_mul(T.f12_conj(X), T.f12_frobenius(Y)),
            "t4": lambda: T.f12_mul(T.f12_mul(X, T.f12_frobenius(T.f12_frobenius(Y))),
                                    T.f12_conj(Y)),
            "final": lambda: T.f12_mul(X, T.f12_mul(T.f12_cyclotomic_sqr(Y), Y))}[name]()
    args = [x] if name in ("sqr", "conj") else [x, y]
    return args, [_ints(want)]


# the Fq12 square and the sparse line product alone (the kernel runs them
# inside the Miller doubling): bodies, input sizes, output sizes
_ALONE = {
    "sqr": (lambda B, x: (TP._flat(TP.f12_sqr(B, TP._f12(x))),), (12,), (12,)),
    "line": (lambda B, f, ln: (TP._flat(TP.mul_by_line(B, TP._f12(f), *TP._f2s(ln))),),
             (12, 6), (12,)),
}


@pytest.mark.parametrize("name", ["mul", "sqr", "cyc", "line", "conj", "mulconj", "t3", "t4",
                                  "final", "dbl", "add"])
def test_k4_team_program_matches_plain(name):
    """Each team program, scheduled for the kernel's team, gives the plain
    version's words: the Fq12 product, square and cyclotomic square, the
    sparse line product against the full product by the line, the Miller
    steps with their lines, the final exponentiation's combinations."""
    rng = np.random.default_rng(sum(name.encode()))
    args, want = _plain_case(name, rng)
    prog = TP.program(name) if name in TP.PROGRAMS else TP.Program(name, *_ALONE[name])
    assert prog.run(args) == want
    # the team split: no level holds more products than the team
    assert all(sum(op[0] == TP.MUL for op in lv) <= TP.TEAM for lv in prog.levels)


def test_k4_easy_part_program_matches_plain():
    """The easy part's two programs around the kernel's one Fq inversion
    give g = f^((p^6 - 1)(p^2 + 1)) of the plain version."""
    rng = np.random.default_rng(31)
    f = _mont_ints(rng, 12)
    front = TP.program("easy_a").run([f])[0]
    norm = front[8] * L.R_INV % FIELD_P
    ninv = pow(norm, -1, FIELD_P) * L.R_MONT % FIELD_P
    g = TP.program("easy_b").run([f, front + [ninv]])[0]
    F = _tensor(f, (2, 3, 2))
    want = T.f12_mul(T.f12_conj(F), T.f12_inv(F))
    assert g == _ints(T.f12_mul(T.f12_frobenius(T.f12_frobenius(want)), want))


def test_k4_f12_mul_program_matches_jax():
    """The Fq12 product's team split against the JAX package's
    ``_j_f12_mul`` on the same inputs."""
    from consensus_specs_tpu.ops.jax_bls import pairing as JP
    from consensus_specs_tpu.ops.jax_bls import tower as JT
    from consensus_specs_tpu.ops.bls12_381.fields import Fq2 as JFq2, Fq6 as JFq6, Fq12 as JFq12
    rng = np.random.default_rng(32)
    x, y = _mont_ints(rng, 12), _mont_ints(rng, 12)

    def oracle(v):
        c = [JFq2(v[i] * L.R_INV % FIELD_P, v[i + 1] * L.R_INV % FIELD_P)
             for i in range(0, 12, 2)]
        return JFq12(JFq6(*c[:3]), JFq6(*c[3:]))
    got = TP.program("mul").run([x, y])[0]
    want = JT.f12_to_oracle(JP._j_f12_mul(JT.f12_const(oracle(x)), JT.f12_const(oracle(y))))
    assert [c * L.R_INV % FIELD_P for c in got] == [
        c.n for six in (want.c0, want.c1) for two in (six.c0, six.c1, six.c2)
        for c in (two.a, two.b)]


@pytest.mark.parametrize("sizes", [[1], [2], [3], [0, 5, 1], [8, 9], [132]])
def test_k4_tree_fold_equals_serial_product(sizes):
    """The kernel's fold (level l multiplies value i by value i + 2^l where
    i - offsets[g] is a multiple of 2^(l+1)) leaves each group's product in
    its first slot, equal to the serial product; the levels are
    ``fold_levels``."""
    from consensus_specs_tpu_torch.ops.bls12_381.fields import Fq2, Fq6, Fq12
    rng = np.random.default_rng(sum(sizes) + 40)
    offsets = np.cumsum([0] + sizes).astype(np.int32)
    n = int(offsets[-1])
    vals = [Fq12(Fq6(*[Fq2(*_mont_ints(rng, 2)) for _ in range(3)]),
                 Fq6(*[Fq2(*_mont_ints(rng, 2)) for _ in range(3)])) for _ in range(n)]
    fs = list(vals)
    levels = pairing.fold_levels(torch.from_numpy(offsets))
    for lev in range(levels):
        stride = 1 << lev
        for i in range(n):                      # one team per pair, as k_fold
            g = int(np.searchsorted(offsets, i, side="right")) - 1
            if (i - offsets[g]) % (2 * stride) == 0 and i + stride < offsets[g + 1]:
                fs[i] = fs[i] * fs[i + stride]
    for g, size in enumerate(sizes):
        serial = Fq12.one()
        for v in vals[offsets[g]:offsets[g + 1]]:
            serial = serial * v
        assert (fs[offsets[g]] if size else Fq12.one()) == serial
    assert levels == (max(sizes) - 1).bit_length() if max(sizes) else levels == 0


def _k4_model(p, q, degenerate, offsets):
    """K4 as the kernel runs it, on the team programs: each pair's Miller
    loop (doubling and addition programs, the conjugation), the fold, each
    group's final exponentiation (the binary inversion's value taken from
    python); returns each group's GT value as Montgomery-form ints."""
    P_ = [_ints(L.unpack(p[i])) for i in range(p.shape[0])]
    Q_ = [_ints(L.unpack(q[i])) for i in range(q.shape[0])]
    one = [L.R_MONT % FIELD_P] + [0] * 11
    run = lambda name, *a: TP.program(name).run(list(a))
    fs = []
    for i in range(len(P_)):
        f, r = one, Q_[i] + [L.R_MONT % FIELD_P, 0]
        if not bool(degenerate[i]):
            for bit in pairing.MILLER_BITS:
                f, r = run("dbl", f, r, P_[i])
                if bit:
                    f, r = run("add", f, r, P_[i], Q_[i])
            f = run("conj", f)[0]
        fs.append(f)
    off = offsets.tolist()
    for lev in range(pairing.fold_levels(offsets)):
        s = 1 << lev
        for i in range(len(fs)):
            g = max(j for j in range(len(off) - 1) if off[j] <= i)
            if (i - off[g]) % (2 * s) == 0 and i + s < off[g + 1]:
                fs[i] = run("mul", fs[i], fs[i + s])[0]

    def pow_x(b):
        acc = b
        for bit in pairing.MILLER_BITS:
            acc = run("cyc", acc)[0]
            if bit:
                acc = run("mul", acc, b)[0]
        return acc
    out = []
    for g in range(len(off) - 1):
        f = fs[off[g]] if off[g] < off[g + 1] else one
        front = run("easy_a", f)[0]
        norm = front[8] * L.R_INV % FIELD_P
        ninv = pow(norm, -1, FIELD_P) * L.R_MONT % FIELD_P if norm else 0
        gg = run("easy_b", f, front + [ninv])[0]
        t1 = run("mulconj", pow_x(gg), gg)[0]
        t2 = run("mulconj", pow_x(t1), t1)[0]
        t3 = run("t3", pow_x(t2), t2)[0]
        t4 = run("t4", pow_x(pow_x(t3)), t3)[0]
        out.append(run("final", t4, gg)[0])
    return out


def test_k4_kernel_model_gt_values_equal_plain():
    """The whole K4 pipeline on its team programs gives the plain version's
    GT value for every group, byte for byte: a group that holds, one that
    fails, a degenerate pair and an empty group."""
    rng = np.random.default_rng(41)
    a = int.from_bytes(rng.bytes(32), "little") % R_ORDER
    Pg, Qg = G1_GENERATOR.mult(a), G2_GENERATOR
    groups = [[(Pg.mult(3), Qg, False), (-Pg, Qg.mult(3), False)],
              [(Pg, Qg, False), (Pg, Qg, True), (Pg, Qg.mult(2), False)], []]
    flat = [pr for g in groups for pr in g]
    offsets = torch.from_numpy(np.cumsum([0] + [len(g) for g in groups]).astype(np.int32))
    args = (C.pack_g1([x for x, _, _ in flat])[0], C.pack_g2([y for _, y, _ in flat])[0],
            torch.tensor([d for _, _, d in flat]), offsets)
    verdicts, gt = pairing.pairing_check_gt(*args)
    assert verdicts.tolist() == [True, False, True]
    assert _k4_model(*args) == [_ints(L.unpack(gt[g])) for g in range(3)]


def test_k4_gt_value_is_the_cube_of_the_oracle_final_exponentiation():
    """The plain GT value is f^(3 (p^12 - 1) / r): the oracle's final
    exponentiation of the product of its Miller loops, cubed (the 3h
    chain's exponent); its verdict is the oracle's multi_pairing_check."""
    from consensus_specs_tpu_torch.ops.bls12_381.pairing import (
        final_exponentiation, miller_loop)
    rng = np.random.default_rng(42)
    ks = [int.from_bytes(rng.bytes(8), "little") for _ in range(4)]
    pairs = [(G1_GENERATOR.mult(ks[0]), G2_GENERATOR.mult(ks[1])),
             (G1_GENERATOR.mult(ks[2]), G2_GENERATOR.mult(ks[3]))]
    args = (C.pack_g1([x for x, _ in pairs])[0], C.pack_g2([y for _, y in pairs])[0],
            torch.tensor([False, False]), torch.tensor([0, 2], dtype=torch.int32))
    verdicts, gt = pairing.pairing_check_gt_plain(*args)
    f = miller_loop(*pairs[0]) * miller_loop(*pairs[1])
    e = final_exponentiation(f)
    assert T.f12_to_oracle(L.unpack(gt[0].reshape(2, 3, 2, 12))) == e * e * e
    assert bool(verdicts[0]) == multi_pairing_check(pairs) is False


_JAX_FINAL = r"""
import json, sys
from consensus_specs_tpu.ops.jax_bls.backend import NUMPY_KERNELS
assert NUMPY_KERNELS
from consensus_specs_tpu.ops.jax_bls import pairing as JP
from consensus_specs_tpu.ops.jax_bls import tower as JT
from consensus_specs_tpu.ops.bls12_381.fields import Fq2, Fq6, Fq12
v = [int(x) for x in json.loads(sys.argv[1])]
c = [Fq2(v[i], v[i + 1]) for i in range(0, 12, 2)]
f = JT.f12_const(Fq12(Fq6(*c[:3]), Fq6(*c[3:])))
g = JP._staged_easy_part(f)
t1 = JP._j_conj(JP._j_f12_mul(JP._staged_pow_x(g), g))
t2 = JP._j_conj(JP._j_f12_mul(JP._staged_pow_x(t1), t1))
t3 = JP._j_hard_combine_t3(t2, JP._staged_pow_x(t2))
xx = JP._j_conj(JP._staged_pow_x(JP._j_conj(JP._staged_pow_x(t3))))
t4 = JP._j_hard_combine_t4(t3, xx)
out = JT.f12_to_oracle(JT.f12_mul(t4, JT.f12_mul(JT.f12_cyclotomic_sqr(g), g)))
print("GT=" + json.dumps([str(x.n) for six in (out.c0, out.c1)
                          for two in (six.c0, six.c1, six.c2) for x in (two.a, two.b)]))
"""


def test_k4_gt_value_equals_jax_staged_chain():
    """The plain GT value of a group equals the JAX package's staged easy
    and hard parts composed up to the product ``_j_final_combine`` tests
    (numpy-kernel mode, in a subprocess), on the same Miller product."""
    from tests._torch_port import run_numpy_kernels
    rng = np.random.default_rng(43)
    ks = [int.from_bytes(rng.bytes(8), "little") for _ in range(2)]
    args = (C.pack_g1([G1_GENERATOR.mult(ks[0])])[0], C.pack_g2([G2_GENERATOR.mult(ks[1])])[0],
            torch.tensor([False]), torch.tensor([0, 1], dtype=torch.int32))
    pp, qq = L.unpack(args[0]), L.unpack(args[1])
    f = pairing.miller_loop(pp[:, 0], pp[:, 1], qq[:, 0], qq[:, 1], args[2])[0]
    f_vals = [v * L.R_INV % FIELD_P for v in _ints(f)]
    out = run_numpy_kernels(_JAX_FINAL, json.dumps([str(v) for v in f_vals]))
    jax_gt = [int(x) for x in json.loads(out.split("GT=", 1)[1])]
    _, gt = pairing.pairing_check_gt_plain(*args)
    assert [v * L.R_INV % FIELD_P for v in _ints(L.unpack(gt[0]))] == jax_gt


@pytest.mark.parametrize("case", ["extremes", "random"])
def test_k4_lazy_sum_reduction(case):
    """The kernel's signed sums (``pairing_team.cuh`` pp_sum) in python,
    step for step: words accumulated apart from WEIGHT p, one carry pass,
    the quotient estimate from the top 64 bits, one conditional
    subtraction; equal to the sum mod p for terms at p - 1 with the
    largest coefficients the scheduler allows, and for random ones."""
    rng = np.random.default_rng(44 if case == "random" else 45)
    mask, wp = (1 << 32) - 1, TP.WEIGHT * FIELD_P
    for _ in range(200):
        n = int(rng.integers(1, 48))
        if case == "extremes":
            xs = [FIELD_P - 1] * n
            coefs = [min(TP.MAX_COEF, (TP.WEIGHT - 1) // n)] * n
            coefs = [c if i % 2 else -c for i, c in enumerate(coefs)] if rng.integers(2) else coefs
        else:
            xs = _mont_ints(rng, n)
            coefs = [int(rng.integers(-TP.MAX_COEF, TP.MAX_COEF + 1)) or 1 for _ in range(n)]
            while sum(map(abs, coefs)) >= TP.WEIGHT:
                coefs = [c // 2 or 1 for c in coefs]
        assert TP._fits(coefs)
        acc = [(wp >> (32 * i)) & mask for i in range(12)]
        for c, x in zip(coefs, xs):
            acc = [a + c * ((x >> (32 * i)) & mask) for i, a in enumerate(acc)]
        carry, w = 0, []
        for a in acc:
            s = a + carry
            w.append(s & mask)
            carry = s >> 32
        top = carry + (wp >> 384)
        q = ((top << 32) | w[11]) // ((FIELD_P >> 352) + 1)
        rem = sum(v << (32 * i) for i, v in enumerate(w)) + (top << 384) - q * FIELD_P
        assert 0 <= rem < 2 * FIELD_P
        assert (rem - FIELD_P if rem >= FIELD_P else rem) == sum(
            c * x for c, x in zip(coefs, xs)) % FIELD_P
