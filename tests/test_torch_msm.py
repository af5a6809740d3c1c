"""K7 (expand_windows) and K8 (g1_msm), plain versions, against the JAX
package's ``_expand_windows`` and ``_msm_core`` (through its ``g1_msm``)
(``consensus_specs_tpu/ops/jax_bls/msm.py``) and the oracle.  Exact:
points compare as compressed bytes (the window tables are projective, so
each entry is normalized first).  The JAX programs run in the package's
numpy-kernel mode in one subprocess, started first so both sides compute
at once.

Edge cases at N = 1, 3, 8: scalars 0, 1 and r - 1; bases with a repeated
point, a point beside its negation, and the point at infinity.

A model of K8's bucket schedule (``csrc/msm.cu``: digit histograms, the
scan, the scatter, the chunk levels, the superset-sum combine) runs on
the plain point operations with the kernel's index arithmetic and is
held byte-exact against the oracle's Pippenger and the JAX ``_msm_core``
under skewed digits: every scalar one repeated byte (one bucket), one
non-zero digit, N = 1 and N = 300.

K7's schedule in python (``team_dbl``'s two waves of products, the warp
packing and the coalesced stores) is held byte-exact against
``PT.complete_dbl`` and ``expand_windows_plain`` in projective form."""
import json

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls12_381.curve import G1_GENERATOR as JG1, G1Point as JG1Point
from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.ops import msm
from consensus_specs_tpu_torch.ops.bls12_381.curve import G1Point, g1_from_compressed
from consensus_specs_tpu_torch.ops.bls12_381.fields import Fq, R_ORDER
from consensus_specs_tpu_torch.ops.torch_bls import convert as C
from consensus_specs_tpu_torch.ops import kzg as K
from consensus_specs_tpu_torch.ops.torch_bls import limbs as L
from consensus_specs_tpu_torch.ops.torch_bls import points as PT
from tests._torch_port import finish, one_torch_thread, start_numpy_kernels  # noqa: F401

SEED = 38
SIZES = (1, 3, 8)
ONE_BYTE = int.from_bytes(bytes([0x5A]) * 32, "little")   # < r: every digit 0x5A
# skewed digit distributions on the 8-point base, run by JAX as well
SKEWED = {"one_byte": [ONE_BYTE] * 8, "one_digit": [0] * 7 + [7 << 64]}

_JAX_MSM = r"""
import json, sys
import numpy as np
from consensus_specs_tpu.ops.jax_bls.backend import NUMPY_KERNELS
assert NUMPY_KERNELS
from consensus_specs_tpu.ops.jax_bls import msm as M
from consensus_specs_tpu.ops.jax_bls import points as PT
from consensus_specs_tpu.ops.bls12_381.curve import g1_from_compressed
out = {}
for n, case in json.loads(sys.argv[1]).items():
    pts = [g1_from_compressed(bytes.fromhex(p)) for p in case["points"]]
    scalars = [int(s) for s in case["scalars"]]
    stacked = M._expand_windows(PT.g1_pack(pts))
    # g1_msm is _msm_core over these windows and the scalars' digit planes:
    # seeding its setup cache runs that core once, not a second expansion
    M._setup_cache._cache[("case", n)] = M._flatten_windows(stacked)
    core = M.g1_msm(pts, scalars, cache_key=("case", n))
    out[n] = {"windows": [np.asarray(a).tolist() for a in stacked],
              "msm": core.to_compressed().hex()}
print("RESULT=" + json.dumps(out))
"""


def _case(n: int, rng):
    p = JG1.mult(int(rng.integers(1, 2**62)))
    q = JG1.mult(int(rng.integers(1, 2**62)))
    pts = [p, q, p, -p, JG1Point.inf(), JG1, q.mult(5), JG1.mult(77)][:n]
    scalars = [R_ORDER - 1, 0, 1, int.from_bytes(rng.bytes(32), "big") % R_ORDER,
               12345, 2**255 % R_ORDER, R_ORDER - 2, 255][:n]
    return pts, scalars


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(SEED)
    cases = {n: _case(n, rng) for n in SIZES}
    arg = {str(n): {"points": [p.to_compressed().hex() for p in pts],
                    "scalars": [str(s) for s in sc]} for n, (pts, sc) in cases.items()}
    for name, sc in SKEWED.items():
        arg[name] = {"points": arg["8"]["points"], "scalars": [str(s) for s in sc]}
    proc = start_numpy_kernels(_JAX_MSM, json.dumps(arg))
    ours = {}
    for n, (pts, sc) in cases.items():
        port_pts = [g1_from_compressed(p.to_compressed()) for p in pts]
        aff, inf = C.pack_g1(port_pts)
        windows = msm.expand_windows(aff, inf)
        ours[n] = {"pts": port_pts, "scalars": sc, "windows": windows,
                   "msm": msm.g1_msm(port_pts, sc, device="cpu")}
    out = finish(proc)
    theirs = json.loads(out.split("RESULT=", 1)[1])
    return ours, {int(k) if k.isdigit() else k: v for k, v in theirs.items()}


def _affine(words: torch.Tensor) -> list:
    """(..., 3, 12) projective words -> compressed affine points."""
    flat = L.ints_from_words(words.reshape(-1, 12))
    out = []
    for i in range(0, len(flat), 3):
        x, y, z = flat[i:i + 3]
        if z == 0:
            out.append(G1Point.inf().to_compressed())
            continue
        zi = pow(z, -1, L.P)
        out.append(G1Point(Fq(x * zi % L.P), Fq(y * zi % L.P)).to_compressed())
    return out


def _jax_windows(stacked) -> torch.Tensor:
    """The JAX (X, Y, Z) (32, N, 24) limb lists -> (32, N, 3, 12) words."""
    return C.from_jax_g1([np.asarray(c, dtype=np.uint32) for c in stacked])


@pytest.mark.parametrize("n", SIZES)
def test_expand_windows_plain_matches_jax(case, n):
    ours, theirs = case
    assert ours[n]["windows"].shape == (msm.N_WINDOWS, n, 3, 12)
    assert _affine(ours[n]["windows"]) == _affine(_jax_windows(theirs[n]["windows"]))


@pytest.mark.parametrize("n", SIZES)
def test_expand_windows_plain_matches_oracle(case, n):
    ours, _ = case
    pts, want = list(ours[n]["pts"]), []
    for _ in range(msm.N_WINDOWS):
        want += [p.to_compressed() for p in pts]
        for _ in range(msm.WINDOW_BITS):
            pts = [p.double() for p in pts]
    assert _affine(ours[n]["windows"]) == want


@pytest.mark.parametrize("n", SIZES)
def test_msm_core_plain_matches_jax_on_its_windows(case, n):
    """K8's plain version on the JAX program's own window table and the
    same scalars gives the JAX ``_msm_core``'s point."""
    ours, theirs = case
    out, inf = msm.msm_core(_jax_windows(theirs[n]["windows"]),
                            msm.scalar_words(ours[n]["scalars"]))
    got = C.unpack_g1(out[None], inf.reshape(1))[0].to_compressed()
    assert got.hex() == theirs[n]["msm"]


@pytest.mark.parametrize("n", SIZES)
def test_g1_msm_matches_jax_and_oracle(case, n):
    ours, theirs = case
    want = G1Point.inf()
    for p, s in zip(ours[n]["pts"], ours[n]["scalars"]):
        want = want + p.mult(s)
    got = ours[n]["msm"].to_compressed()
    assert got == want.to_compressed()
    assert got.hex() == theirs[n]["msm"]


def test_identity_and_cancellation():
    """An all-zero scalar vector and P + (-P) both give the identity."""
    p = g1_from_compressed(JG1.mult(9).to_compressed())
    assert msm.g1_msm([p, p], [0, 0], device="cpu").infinity
    assert msm.g1_msm([p, -p], [3, 3], device="cpu").infinity
    assert msm.g1_msm([], [], device="cpu").infinity


# RCB addition and doubling without their products by 3b = 12; an
# inversion by the extended Euclid needs no products
_ADD, _DBL, _AFFINE = 12, 8, 2


@pytest.mark.parametrize("scalars, finite, want", [
    # digits 3 and 1 in two buckets (the infinite third point's 7 drops):
    # 2 combining additions and one doubling for the gap of 2
    ([1, 3, 7], [True, True, False], 2 * _ADD + _DBL + _AFFINE),
    # three lanes of digit 5 in one bucket: 2 additions, then [5] S_1
    ([5, 5 + 5 * 256], [True, True], 2 * _ADD + 2 * _DBL + _ADD + _AFFINE),
    ([0, 0], [True, True], _AFFINE),
])
def test_msm_bound_counts_the_bucket_method(scalars, finite, want):
    """K8's bound counts what the function needs (buckets over the
    expanded table), not the ladder per lane that K8 itself runs."""
    win = torch.zeros((32, len(scalars), 3, 12), dtype=torch.int32)
    win[:, torch.tensor(finite), 2, 0] = 1
    sc = msm.scalar_words(scalars)
    assert msm.msm_core_fq_products(win, sc) == want
    assert msm.msm_core_ladder_fq_products(win, sc) >= want


def _k_calls():
    pts = torch.zeros((2, 2, 12), dtype=torch.int32)
    inf = torch.zeros((2,), dtype=torch.bool)
    win = torch.zeros((32, 2, 3, 12), dtype=torch.int32)
    sc = torch.zeros((2, 8), dtype=torch.int32)
    return [lambda: msm.expand_windows(pts, inf), lambda: msm.msm_core(win, sc)]


@pytest.mark.parametrize("k", range(2))
def test_cuda_tensors_never_take_the_plain_version(monkeypatch, k):
    def no_plain(*a, **kw):
        raise AssertionError("plain version used for CUDA tensors")
    monkeypatch.setattr(msm, "expand_windows_plain", no_plain)
    monkeypatch.setattr(msm, "msm_core_plain", no_plain)
    monkeypatch.setattr(_build, "same_device", lambda *t: torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError)) as exc:
        _k_calls()[k]()
    assert "plain version used" not in str(exc.value)


@pytest.mark.parametrize("k", range(3))
def test_wrappers_validate_arguments(k):
    with pytest.raises((TypeError, ValueError)):
        [lambda: msm.expand_windows(torch.zeros((2, 2, 12), dtype=torch.int64),
                                    torch.zeros((2,), dtype=torch.bool)),
         lambda: msm.msm_core(torch.zeros((31, 2, 3, 12), dtype=torch.int32),
                              torch.zeros((2, 8), dtype=torch.int32)),
         lambda: msm.msm_core(torch.zeros((32, 2, 3, 12), dtype=torch.int32),
                              torch.zeros((3, 8), dtype=torch.int32))][k]()


# ---------------------------------------------------------------------------
# a model of K8's bucket schedule (csrc/msm.cu) on the plain point operations
# ---------------------------------------------------------------------------

def _add(p, q):
    return PT.complete_add(PT._G1, p, q)


def _schedule_msm(windows, scalars, seed=0):
    """K8's stages with the kernel's index arithmetic: per-block digit
    histograms of HIST_LANES lanes (digit 0 and infinite window points
    skipped), the scan (counts, every block's offsets, the level
    schedule), the scatter (a seeded order inside each block: the order
    in a bucket is free), the chunk levels (chunks of FIRST_CHUNK, then
    CHUNK, never crossing a bucket), the superset-sum combine and the
    normalization.  Returns the affine words, the infinity flag and every
    level's output total."""
    n = windows.shape[1]
    plan = msm.msm_plan(n)
    nb, hl = msm.N_BUCKETS, msm.HIST_LANES
    pts = L.unpack(windows).reshape(plan.lanes, 3, L.NLIMB)
    finite = (windows[:, :, 2] != 0).any(dim=-1).reshape(-1)
    digit = torch.where(finite, msm._digits(scalars).reshape(-1), 0)
    hist = torch.stack([torch.bincount(digit[b * hl:(b + 1) * hl], minlength=nb)
                        for b in range(plan.hist_blocks)])
    hist[:, 0] = 0
    count = hist.sum(0)
    boff = torch.cumsum(count, 0) - count + torch.cumsum(hist, 0) - hist
    sched, m = [], count
    for k in range(plan.levels + 1):
        sched.append(torch.cat([torch.cumsum(m, 0) - m, m.sum().reshape(1)]))
        m = -(-m // (msm.CHUNK if k else msm.FIRST_CHUNK))
    order = torch.empty(int(count.sum()), dtype=torch.int64)
    gen = torch.Generator().manual_seed(seed)
    for b in range(plan.hist_blocks):
        off = boff[b].clone()
        lanes = torch.arange(b * hl, min((b + 1) * hl, plan.lanes))
        for lane in lanes[torch.randperm(len(lanes), generator=gen)].tolist():
            d = int(digit[lane])
            if d:
                order[off[d]] = lane
                off[d] += 1
    vals, totals = pts[order], []
    for k in range(plan.levels):
        chunk = msm.CHUNK if k else msm.FIRST_CHUNK
        o_in, o_out = sched[k], sched[k + 1]
        j = torch.arange(int(o_out[nb]))
        totals.append(len(j))
        d = torch.searchsorted(o_out[:nb], j, right=True) - 1      # the kernels' bucket_of
        s = o_in[d] + (j - o_out[d]) * chunk
        e = torch.minimum(s + chunk, o_in[d + 1])
        acc = vals[s]
        for i in range(1, chunk):
            ok = (s + i < e)[:, None, None]
            acc = torch.where(ok, _add(acc, vals[torch.where(s + i < e, s + i, s)]), acc)
        vals = acc
    fin = sched[plan.levels]
    filled = fin[1:] > fin[:-1]
    filled[0] = False
    assert int((fin[1:] - fin[:-1]).max()) <= 1
    buckets = PT.identity_like(PT._G1, torch.zeros((nb, L.NLIMB), dtype=torch.int64))
    buckets[filled] = vals[fin[:nb][filled]]
    for b in range(msm.WINDOW_BITS):
        low = torch.tensor([d for d in range(nb) if not d >> b & 1])
        buckets[low] = _add(buckets[low], buckets[low | 1 << b])
    g = buckets[[1 << b for b in range(msm.WINDOW_BITS)]]
    for i in range(msm.WINDOW_BITS - 1):
        more = (torch.arange(msm.WINDOW_BITS) > i)[:, None, None]
        g = torch.where(more, PT.complete_dbl(PT._G1, g), g)
    for w in (4, 2, 1):
        g = _add(g[:w], g[w:2 * w])
    out, inf = PT.normalize(PT._G1, g[0])
    return L.pack(out), inf, totals


def _schedule_point(windows, scalars, seed=0):
    out, inf, totals = _schedule_msm(windows, scalars, seed)
    bounds = msm.msm_plan(windows.shape[1]).bounds
    assert all(t <= b for t, b in zip(totals, bounds[1:])), (totals, bounds)
    return C.unpack_g1(out[None], inf.reshape(1))[0]


def _oracle_case(name: str):
    rng = np.random.default_rng(SEED + 1)
    p, step = G1Point.inf(), g1_from_compressed(JG1.mult(int(rng.integers(2, 2**62))).to_compressed())
    walk = []
    for _ in range(300):
        p = p + step
        walk.append(p)
    uniform = [int.from_bytes(rng.bytes(32), "big") % R_ORDER for _ in range(300)]
    edges = [walk[0], walk[0], -walk[0], G1Point.inf(), walk[5], walk[6], walk[6], -walk[6]]
    return {"uniform": (walk[:8], uniform[:8]),
            "one_byte": (walk[:8], [ONE_BYTE] * 8),
            "one_digit": (walk[:8], [0] * 7 + [7 << 64]),
            "zero_one_r-1": (walk[:3], [0, 1, R_ORDER - 1]),
            "n1": (walk[:1], uniform[:1]),
            "n300": (walk, uniform),
            "edges": (edges, uniform[:8]),
            "all_zero": (walk[:8], [0] * 8)}[name]


@pytest.mark.parametrize("name", ["uniform", "one_byte", "one_digit", "zero_one_r-1", "n1",
                                  "n300", "edges", "all_zero"])
def test_bucket_schedule_matches_pippenger(name):
    """The schedule model is byte-exact against the oracle's Pippenger
    (and, at 8 points or fewer, against K8's plain version) whatever the
    digits; two scatter orders give the same point."""
    pts, scalars = _oracle_case(name)
    aff, inf = C.pack_g1(pts)
    windows = msm.expand_windows(aff, inf)
    sc = msm.scalar_words(scalars)
    got = _schedule_point(windows, sc)
    assert got.to_compressed() == K._pippenger_msm(pts, scalars).to_compressed()
    if len(pts) <= 8:
        assert got == _schedule_point(windows, sc, seed=1)
        out, flag = msm.msm_core_plain(windows, sc)
        assert got == C.unpack_g1(out[None], flag.reshape(1))[0]


@pytest.mark.parametrize("key", list(SIZES) + list(SKEWED))
def test_bucket_schedule_matches_jax_msm_core(case, key):
    """The schedule model on the JAX ``_expand_windows`` table gives the
    JAX ``_msm_core``'s point, byte for byte."""
    ours, theirs = case
    scalars = SKEWED[key] if key in SKEWED else ours[key]["scalars"]
    got = _schedule_point(_jax_windows(theirs[key]["windows"]), msm.scalar_words(scalars))
    assert got.to_compressed().hex() == theirs[key]["msm"]


@pytest.mark.parametrize("n", [1, 6, 300, 4032, 4096])
def test_msm_plan_covers_extreme_digit_spreads(n):
    """The plan's bounds cover every level's output total, and its levels
    take every bucket down to one point, both when one bucket holds every
    lane and when the lanes spread over all 255 buckets."""
    plan = msm.msm_plan(n)
    for counts in ([plan.lanes], [plan.lanes // 255 + (i < plan.lanes % 255) for i in range(255)]):
        m = counts
        for k in range(plan.levels):
            m = [-(-x // (msm.CHUNK if k else msm.FIRST_CHUNK)) for x in m]
            assert sum(m) <= plan.bounds[k + 1]
        assert max(m) == 1


# ---------------------------------------------------------------------------
# K7's schedule (csrc/msm.cu k_expand_windows over team.cuh team_dbl)
# ---------------------------------------------------------------------------

_MASK32 = (1 << 32) - 1


def _mont(a: int, b: int) -> int:
    """The CIOS product's value: a b 2^-384 mod p (Montgomery form)."""
    return a * b * L.R_INV % L.P


def _team_dbl(x: int, y: int, z: int) -> tuple:
    """team_dbl's two waves on Montgomery-form ints: wave 1, one product a
    thread, t0 = y^2, t1 = y z, xy = x y, zz = z^2; the operands by
    additions (t2 = 12 zz, z3 = 8 t0, w = t0 - 3 t2, y3 = t0 + t2); wave 2,
    m1 = t2 z3, m2 = t1 z3, m3 = w y3, m4 = w xy; r = (2 m4, m1 + m3, m2)."""
    p = L.P
    t0, t1, xy, zz = _mont(y, y), _mont(y, z), _mont(x, y), _mont(z, z)
    t2 = 12 * zz % p
    z3, y3, w = 8 * t0 % p, (t0 + t2) % p, (t0 - 3 * t2) % p
    m1, m2, m3, m4 = _mont(t2, z3), _mont(t1, z3), _mont(w, y3), _mont(w, xy)
    return 2 * m4 % p, (m1 + m3) % p, m2


def _words(vals) -> list:
    return [(v >> (32 * i)) & _MASK32 for v in vals for i in range(12)]


@pytest.mark.parametrize("case", ["identity", "generator", "random_points", "any_triples"])
def test_k7_team_dbl_waves_match_complete_dbl(case):
    """team_dbl's waves give PT.complete_dbl's projective words, byte for
    byte, on the identity, on points and on arbitrary triples."""
    rng = np.random.default_rng(SEED + 2)
    one = L.R_MONT
    if case == "identity":
        triples = [(0, one, 0)]
    elif case == "generator":
        g = g1_from_compressed(JG1.to_compressed())
        triples = [(L.mont(g.x.n), L.mont(g.y.n), one)]
    elif case == "random_points":
        pts = [g1_from_compressed(JG1.mult(int(rng.integers(2, 2**62))).to_compressed())
               for _ in range(4)]
        triples = [(L.mont(q.x.n), L.mont(q.y.n), one) for q in pts]
    else:
        triples = [tuple(int.from_bytes(rng.bytes(48), "little") % L.P for _ in range(3))
                   for _ in range(6)]
    for t in triples:
        proj = torch.from_numpy(L.words_from_ints([v * L.R_INV % L.P for v in t]))
        want = L.pack(PT.complete_dbl(PT._G1, L.unpack(proj)))
        got = _team_dbl(*t)
        assert [w & _MASK32 for w in want.reshape(-1).tolist()] == _words(got)


def _k7_model(pts, inf):
    """k_expand_windows on python ints: 32 points a block, 8 teams of 4
    threads a warp; a team past the end doubles the identity; each warp
    copies its live points' 36-word entries (contiguous in shared memory
    and in the output) as one word-per-lane store per window."""
    n = pts.shape[0]
    vals = L.ints_from_words(pts.reshape(-1, 12), mont_form=False)
    out = [0] * (32 * n * 36)
    for first in range(0, n, 8):                        # one warp
        live = min(8, n - first)
        cur = []
        for tw in range(8):
            i = first + tw
            if tw >= live or bool(inf[i]):
                cur.append((0, L.R_MONT, 0))
            else:
                cur.append((vals[2 * i], vals[2 * i + 1], L.R_MONT))
        for w in range(msm.N_WINDOWS):
            mine = _words([c for pt in cur for c in pt])
            base = (w * n + first) * 36
            for lane in range(32):
                for j in range(lane, live * 36, 32):
                    out[base + j] = mine[j]
            if w + 1 < msm.N_WINDOWS:
                for _ in range(msm.WINDOW_BITS):
                    cur = [_team_dbl(*c) for c in cur]
    return torch.tensor(np.array(out, dtype=np.uint32).view(np.int32).reshape(32, n, 3, 12))


@pytest.mark.parametrize("n", [1, 5, 6, 33])
def test_k7_schedule_matches_plain(n):
    """The kernel's packing (teams, warps, the partial last warp) and its
    coalesced stores give expand_windows_plain's table, byte for byte, at
    sizes that fill no warp, with points at infinity and P beside -P."""
    rng = np.random.default_rng(SEED + n)
    pts = [g1_from_compressed(JG1.mult(int(rng.integers(2, 2**62))).to_compressed())
           for _ in range(min(n, 6))]
    while len(pts) < n:
        pts.append(pts[-1] + pts[-2])
    if n > 2:
        pts[1] = G1Point.inf()
    if n > 4:
        pts[4] = -pts[3]
    aff, inf = C.pack_g1(pts)
    assert torch.equal(_k7_model(aff, inf), msm.expand_windows_plain(aff, inf))
