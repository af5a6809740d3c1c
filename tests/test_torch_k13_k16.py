"""K13 ``altair_deltas`` and K16 ``incl_scan`` as redesigned for the H100,
on the CPU.

K13 divides by the exact reciprocals of its four divisors
(``epoch_kernels.reciprocal``, packed by ``altair_params``;
``csrc/udiv.cuh``): a python emulation of the kernel's sequence
(multiply-high, subtract, halve, add, shift, on 64-bit words) equals
``n // d`` for the divisors both epoch engines pass at the minimal and
mainnet presets, for a fixed list of divisors and numerators at their
edges, and on a hypothesis sweep.  A model of the kernel's lane that
reads the parameter array at the words ``csrc/epoch.cu``'s entry reads
equals the plain version, and so, through it, the JAX composition
(``tests/test_torch_epoch_kernels.py``).  Models of K13's 4-lane groups
(lane by lane where a column starts off 16 bytes) and K16's fill and
entry pairs (a head and a tail entry where idx and keys start off 16
bytes) visit every lane and entry once.  K16's plain version
equals a numpy scatter-min on the edge inputs the smoke holds the
kernel to.  On CUDA tensors the wrappers launch or raise, never the
plain versions (tolerance 0 throughout: integers).
"""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.parallel import mesh_state as jax_mesh_state
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.ops import sha256
from consensus_specs_tpu_torch.parallel import mesh_epoch as me
from consensus_specs_tpu_torch.parallel import mesh_state
from consensus_specs_tpu_torch.utils import bls, ssz
from consensus_specs_tpu_torch.utils.ssz import merkle
from tests._torch_port import REPO, one_torch_thread  # noqa: F401
from tests.test_epoch_vectorized import _altair_state

U64 = 1 << 64
MASK = U64 - 1
GWEI = 10**9
EPOCH_CU = open(os.path.join(REPO, "consensus_specs_tpu_torch", "csrc", "epoch.cu")).read()


def kernel_div(n: int, m: int, ell: int) -> int:
    """``udiv`` of csrc/udiv.cuh on 64-bit words: t = mulhi(m, n), then
    (t + ((n - t) >> s1)) >> s2 with s1 = min(l, 1), s2 = max(l - 1, 0)."""
    s1, s2 = (1, ell - 1) if ell else (0, 0)
    t = (m * n) >> 64
    return (((t + (((n - t) & MASK) >> s1)) & MASK) >> s2) & MASK


def edge_numerators(d: int) -> list:
    out = {0, 1, d - 1, d, d + 1, (1 << 63) - 1, MASK}
    for k in (2, 3, 1000, MASK // d):
        if 1 <= k * d <= U64:
            out.add(k * d - 1)
    return sorted(n for n in out if 0 <= n <= MASK)


def check_divisor(d: int) -> None:
    m, ell = ek.reciprocal(d)
    assert 0 <= m < U64 and 0 <= ell <= 64
    for n in edge_numerators(d):
        assert kernel_div(n, m, ell) == n // d, (d, n)


FIXED_DIVISORS = [1, 2, 3, 7, 64, 10**9, 2**32 - 1, 2**32 + 1, 2**63 - 1, 2**63, 2**64 - 1]


@pytest.mark.parametrize("d", FIXED_DIVISORS)
def test_reciprocal_divides_exactly(d):
    check_divisor(d)


def test_reciprocal_forms():
    """Powers of two (1 included) are shifts; every other divisor takes
    l = ceil(log2 d); a divisor outside [1, 2^64) is refused."""
    assert ek.reciprocal(1) == (0, 0)
    assert ek.reciprocal(64) == (0, 6)
    assert ek.reciprocal(2**63) == (0, 63)
    assert ek.reciprocal(3)[1] == 2 and ek.reciprocal(10**9)[1] == 30
    assert ek.reciprocal(2**64 - 1) == (2, 64)
    for bad in (0, -1, 2**64):
        with pytest.raises(ValueError):
            ek.reciprocal(bad)


@settings(max_examples=300, deadline=None)
@given(d=st.one_of(st.integers(1, 2**20), st.integers(1, MASK),
                   st.integers(0, 63).map(lambda k: 1 << k)),
       n=st.one_of(st.integers(0, 2**40), st.integers(0, MASK)))
def test_reciprocal_sweep(d, n):
    m, ell = ek.reciprocal(d)
    assert kernel_div(n, m, ell) == n // d


# ---------------------------------------------------------------------------
# the divisors the two epoch engines pass
# ---------------------------------------------------------------------------

def _divisors(s: ek.AltairScalars) -> tuple:
    return (s.increment, s.active_increments * s.weight_denominator, s.weight_denominator,
            s.inactivity_denominator)


@pytest.fixture(scope="module")
def engine_scalars():
    """The AltairScalars each engine passes K13 on the minimal preset: the
    port's columnar engine (``use_fallback``) and its mesh engine
    (``use_mesh``), across one epoch boundary of the scattered and the
    leaking ``_altair_state`` cases (64 validators)."""
    jax_mesh_state.use_fallback()
    jax_mode = jek._mode            # the state builder switches the JAX engine to its loops
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    saved = (merkle._batched_hasher, merkle._batched_hasher_np, ek.altair_deltas)
    seen = {"columnar": [], "mesh": []}
    spec = build_spec("altair", "minimal")
    try:
        ek.use_vectorized("cpu")
        sha256.install_merkle_hasher("cpu")
        for case in ({}, {"leak": True, "seed": 23}):
            _, jstate = _altair_state("altair", **case)
            target = int(jstate.slot) + spec.SLOTS_PER_EPOCH \
                - int(jstate.slot) % spec.SLOTS_PER_EPOCH
            for engine, use in (("columnar", mesh_state.use_fallback),
                                ("mesh", mesh_state.use_mesh)):
                def record(*args, _seen=seen[engine]):
                    _seen.append(args[-1])
                    return saved[2](*args)
                ek.altair_deltas = record
                use()
                s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
                spec.process_slots(s, target)
                ek.altair_deltas = saved[2]
    finally:
        ek.altair_deltas = saved[2]
        merkle.set_batched_hasher(saved[0])
        merkle.set_batched_hasher_np(saved[1])
        jax_bls.bls_active, bls.bls_active = jax_active, port_active
        ek.use_auto()
        mesh_state.use_auto()
        jax_mesh_state.use_auto()
        jek._mode = jax_mode
    return seen


@pytest.mark.parametrize("engine", ["columnar", "mesh"])
def test_engine_divisors_minimal(engine_scalars, engine):
    calls = engine_scalars[engine]
    assert len(calls) == 2 and {s.in_leak for s in calls} == {False, True}
    for s in calls:
        for d in _divisors(s):
            check_divisor(d)


def test_engines_pass_the_same_scalars(engine_scalars):
    assert engine_scalars["columnar"] == engine_scalars["mesh"]


@pytest.mark.parametrize("active_increments", [1, 64 * 32, 2**25 - 12345, 2**25, 2**38])
def test_engine_divisors_mainnet(active_increments):
    """Mainnet's increment, weight and inactivity denominators, and the
    reward denominator from one increment up to 2^20 validators at 32 ETH
    and past it."""
    spec = build_spec("altair", "mainnet")
    wd = int(spec.WEIGHT_DENOMINATOR)
    for d in (int(spec.EFFECTIVE_BALANCE_INCREMENT), wd, active_increments * wd,
              int(spec.config.INACTIVITY_SCORE_BIAS) * int(spec.INACTIVITY_PENALTY_QUOTIENT_ALTAIR)):
        check_divisor(d)


# ---------------------------------------------------------------------------
# K13's parameter array and a model of its lane
# ---------------------------------------------------------------------------

# the words csrc/epoch.cu's entry reads: h[1] brpi, h[2 + f] the weights,
# h[5 + f] the participating increments, h[10] the leak flag, and the
# (m, l) pairs of the increment, reward, weight and inactivity divisors
READS = {"brpi": 1, "weight": 2, "part_inc": 5, "in_leak": 10,
         "inc": 12, "reward": 14, "weight_den": 16, "inact": 18}


def test_entry_reads_the_documented_words():
    assert int(re.search(r"#define ALTAIR_PARAMS (\d+)", EPOCH_CU).group(1)) == 20
    pairs = re.findall(r"p\.(\w+) = udiv_make\(h\[(\d+)\], h\[(\d+)\]\)", EPOCH_CU)
    assert pairs == [("inc", "12", "13"), ("reward", "14", "15"), ("weight", "16", "17"),
                     ("inact", "18", "19")]
    assert "p.brpi = h[1];" in EPOCH_CU and "p.in_leak = h[10];" in EPOCH_CU
    assert "p.weight_of[f] = h[2 + f];" in EPOCH_CU
    assert "p.wp[f] = h[2 + f] * h[5 + f];" in EPOCH_CU


def _scalars(inc=GWEI, brpi=1234, pinc=(5, 7, 9), active=97, wd=64, leak=False,
             inact=4 * 50331648):
    return ek.AltairScalars(inc, brpi, (14, 26, 14), pinc, active, wd, leak, inact)


@pytest.mark.parametrize("s", [
    _scalars(),
    _scalars(leak=True),
    _scalars(inc=1, brpi=1, active=1, wd=1, inact=1),
    _scalars(inc=2**30, active=2**20, inact=2**26),
    _scalars(inc=1000000007, wd=61, active=1000003, inact=2**31 - 1),
    _scalars(active=2**56 + 1),                 # a reciprocal m at and above 2^63
])
def test_params_pack_the_scalars_and_reciprocals(s):
    words = [w % U64 for w in ek.altair_params(s).tolist()]
    reward_den = s.active_increments * s.weight_denominator
    assert words[:12] == [s.increment, s.base_reward_per_increment, *s.weights,
                          *s.participating_increments, reward_den % U64,
                          s.weight_denominator, int(s.in_leak), s.inactivity_denominator]
    for name, d in (("inc", s.increment), ("reward", reward_den),
                    ("weight_den", s.weight_denominator), ("inact", s.inactivity_denominator)):
        k = READS[name]
        assert (words[k], words[k + 1]) == ek.reciprocal(d)


def k13_model(words, eff, bal, scores, part, elig, active):
    """csrc/epoch.cu ``altair_lane`` per lane on 64-bit words, every value
    read from the parameter array where the entry reads it."""
    h = [w % U64 for w in words]
    div = {k: (h[READS[k]], h[READS[k] + 1]) for k in ("inc", "reward", "weight_den", "inact")}
    brpi, leak = h[READS["brpi"]], h[READS["in_leak"]]
    weight = h[2:5]
    wp = [(h[2 + f] * h[5 + f]) & MASK for f in range(3)]
    out = []
    for e, b, sc, pa, el, ac in zip(eff, bal, scores, part, elig, active):
        e, b, sc = e % U64, b % U64, sc % U64
        if el:
            base = (kernel_div(e, *div["inc"]) * brpi) & MASK
            flags = pa if ac else 0
            for f in range(3):
                rew = pen = 0
                if (flags >> f) & 1:
                    if not leak:
                        rew = kernel_div((base * wp[f]) & MASK, *div["reward"])
                elif f != 2:
                    pen = kernel_div((base * weight[f]) & MASK, *div["weight_den"])
                up = (b + rew) & MASK
                b = 0 if pen > up else up - pen
            if not (flags >> 1) & 1:
                pen = kernel_div((e * sc) & MASK, *div["inact"])
                b = 0 if pen > b else b - pen
        out.append(b - U64 if b >= 1 << 63 else b)
    return out


@pytest.mark.parametrize("case", ["mainnet-like", "ones", "powers", "primes", "limits"])
@pytest.mark.parametrize("leak", [False, True])
def test_lane_model_equals_the_plain_version(case, leak):
    """The kernel's lane, fed the packed array, equals plain K13 on seeded
    columns with every flag combination, clamps, and (``limits``) lane
    products at the guards' limit."""
    n, limit = 96, 2**63 - 1
    rng = np.random.default_rng(len(case) + 7 * leak)
    divs = {"mainnet-like": (GWEI, 64, 3000, 4 * 50331648), "ones": (1, 1, 1, 1),
            "powers": (2**30, 64, 2**20, 2**26), "primes": (1000000007, 61, 1000003, 2**31 - 1),
            "limits": (GWEI, 64, 1000003, 2**31 - 1)}[case]
    inc, wd, active_inc, inact = divs
    eff = rng.integers(0, 32 * GWEI + 1, n, dtype=np.int64)
    eff[:3] = 32 * GWEI
    brpi = 64 * GWEI // int(np.sqrt(int(eff.sum())))
    br_max = (32 * GWEI // inc) * brpi
    cap = limit // (br_max * 14 * 4)
    p0, p2 = min(1 + n // 3, cap), min(1 + n // 4, cap)
    p1 = (limit - br_max * 14 * (p0 + p2)) // (br_max * 26) if case == "limits" else n // 2
    reward_bound = sum(br_max * w * p // (active_inc * wd) for w, p in zip((14, 26, 14),
                                                                           (p0, p1, p2)))
    bal = np.minimum(rng.integers(0, 40 * GWEI, n, dtype=np.int64), limit - reward_bound)
    bal[1] = limit - reward_bound
    scores = rng.integers(0, 100, n, dtype=np.int64)
    scores[2] = limit // (32 * GWEI)
    part = rng.integers(0, 8, n).astype(np.uint8)
    part[:8] = np.arange(8)
    part[1], part[2] = 7, 0
    elig, active = rng.random(n) < 0.8, rng.random(n) < 0.85
    elig[:10], active[:10] = True, True
    bal[3], bal[4] = 0, 1                          # clamps
    s = ek.AltairScalars(inc, brpi, (14, 26, 14), (p0, p1, p2), active_inc, wd, leak, inact)
    cols = [torch.from_numpy(a) for a in (eff, bal, scores, part, elig, active)]
    want = ek.altair_deltas_plain(*cols, s).tolist()
    got = k13_model(ek.altair_params(s).tolist(), eff.tolist(), bal.tolist(), scores.tolist(),
                    part.tolist(), elig.tolist(), active.tolist())
    assert got == want


# ---------------------------------------------------------------------------
# work splits: K13's 4-lane groups, K16's fill and entry pairs
# ---------------------------------------------------------------------------

def k13_lanes(addr_bytes, addr_wide, n, blocks, threads=256):
    """The lanes ``k_altair_deltas`` visits, as (lane, 'vec' | 'one'): 4-lane
    groups from lane 0 where ``altair_vec`` holds (every uint64 column and
    the output on 16 bytes, every byte column on 4), the rest one at a
    time."""
    vec = all(p % 16 == 0 for p in addr_wide) and all(p % 4 == 0 for p in addr_bytes)
    v_hi = n & ~3 if vec else 0
    out, step = [], blocks * threads
    for t in range(step):
        for i in range(4 * t, v_hi, 4 * step):
            assert all((p + i) % 4 == 0 for p in addr_bytes)
            assert all((p + 8 * i) % 16 == 0 for p in addr_wide)
            out += [(i + k, "vec") for k in range(4)]
        out += [(i, "one") for i in range(v_hi + t, n, step)]
    return out


@pytest.mark.parametrize("n", [1, 3, 4, 5, 7, 9, 1000, 1003])
@pytest.mark.parametrize("lane_off", [0, 1, 2, 3, "uint64 alone"])
def test_k13_groups_cover_every_lane_once(n, lane_off):
    """Columns on their storage take 4-lane groups and a tail; columns
    ``lane_off`` lanes in (all of them, or the uint64 inputs alone) take
    every lane one at a time; either way every lane once."""
    off = 1 if lane_off == "uint64 alone" else lane_off
    base = 1 << 20
    addr_bytes = [base + (0 if lane_off == "uint64 alone" else off) + k * 4096 for k in range(3)]
    addr_wide = [base + 2**16 * (k + 1) + 8 * off for k in range(3)] + [base + 2**19]   # out
    for blocks in (1, 3):
        lanes = k13_lanes(addr_bytes, addr_wide, n, blocks, threads=4)
        assert sorted(i for i, _ in lanes) == list(range(n))
        kinds = {k for _, k in lanes}
        assert kinds == ({"one"} if off or n < 4 else {"vec"} | ({"one"} if n % 4 else set()))


def k16_visits(idx_addr, key_addr, m, n_total, blocks, threads=4):
    """Lanes filled and entries taken by ``k_incl_scan`` with ``incl_scan``'s
    ``e_lo`` (out is the wrapper's allocation, on 16 bytes)."""
    e_lo = m
    if m > 0 and idx_addr % 8 == 0 and key_addr % 8 == 0 and idx_addr % 16 == key_addr % 16:
        e_lo = 1 if idx_addr & 15 else 0
    step = blocks * threads
    filled, taken = [], []
    e_pairs = (m - e_lo) >> 1
    e_hi = e_lo + 2 * e_pairs
    for t in range(step):
        for p in range(t, n_total >> 1, step):
            filled += [2 * p, 2 * p + 1]
        if t == 0 and n_total & 1:
            filled.append(n_total - 1)
        for p in range(t, e_pairs, step):
            e = e_lo + 2 * p
            assert (idx_addr + 8 * e) % 16 == 0 and (key_addr + 8 * e) % 16 == 0
            taken += [e, e + 1]
        for q in range(t, e_lo + (m - e_hi), step):
            taken.append(q if q < e_lo else e_hi + (q - e_lo))
    return filled, taken


@pytest.mark.parametrize("m", [0, 1, 2, 3, 5, 64, 301])
@pytest.mark.parametrize("layout", ["aligned", "both one in", "idx alone one in"])
def test_k16_pairs_cover_every_lane_and_entry_once(m, layout):
    base = 1 << 20
    idx_addr = base + 2**16 + (8 if layout != "aligned" else 0)
    key_addr = base + 2**17 + (8 if layout == "both one in" else 0)
    for n_total in (1, 2, 7, 100, 101):
        for blocks in (1, 3):
            filled, taken = k16_visits(idx_addr, key_addr, m, n_total, blocks)
            assert sorted(filled) == list(range(n_total))
            assert sorted(taken) == list(range(m))


# ---------------------------------------------------------------------------
# K16's plain version on the smoke's edge inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,spans", [(1, 1), (7, 1), (1001, 1), (1000, 4)])
@pytest.mark.parametrize("m", [0, 1, 2, 3, 5, "3n", "3n+1"])
def test_k16_plain_on_the_edges(n, spans, m):
    """Pads, negative and out-of-range indices, three entries a lane, keys
    at and above 2^63 and the sentinel as a key: the plain version equals
    a numpy unsigned scatter-min, on slices one entry into their storage."""
    rng = np.random.default_rng(n + len(str(m)))
    m = {"3n": 3 * n, "3n+1": 3 * n + 1}.get(m, m)
    if m >= 3 * n:
        idx = np.concatenate([rng.permutation(np.tile(np.arange(n, dtype=np.int64), 3)),
                              rng.integers(0, n, m - 3 * n)])
    else:
        idx = rng.integers(0, n, m).astype(np.int64)
    bad = rng.random(m) < 0.1
    idx[bad] = rng.choice(np.array([-1, -7, n, n + 5, 2**62]), int(bad.sum()))
    keys = (rng.integers(1, 33, m).astype(np.uint64) << np.uint64(32)) \
        | rng.integers(0, 2048, m).astype(np.uint64)
    hi = rng.random(m) < 0.1
    keys[hi] = rng.integers(2**63, MASK, int(hi.sum()), dtype=np.uint64)
    keys[rng.random(m) < 0.05] = np.uint64(MASK)
    want = np.full(n, MASK, dtype=np.uint64)
    ok = (idx >= 0) & (idx < n)
    np.minimum.at(want, idx[ok], keys[ok])
    ti = torch.from_numpy(np.concatenate([[3], idx]))[1:]
    tk = torch.from_numpy(np.concatenate([np.array([9], dtype=np.uint64), keys])
                          .view(np.int64))[1:]
    got = me.incl_scan(ti, tk, n, spans)
    assert got.numpy().view(np.uint64).tolist() == want.tolist()


# ---------------------------------------------------------------------------
# CUDA tensors
# ---------------------------------------------------------------------------

def test_cuda_tensors_never_take_the_plain_versions(monkeypatch):
    """On a CUDA tensor K13 and K16 (and K12, which shares K13's design)
    launch their kernels or raise: here the build fails (no nvcc), and no
    plain version runs."""
    def no_plain(*a, **kw):
        raise AssertionError("plain version used for CUDA tensors")
    monkeypatch.setattr(ek, "altair_deltas_plain", no_plain)
    monkeypatch.setattr(ek, "slashings_plain", no_plain)
    monkeypatch.setattr(me, "incl_scan_plain", no_plain)
    monkeypatch.setattr(_build, "same_device", lambda *t: torch.device("cuda"))
    col = torch.zeros(8, dtype=torch.int64)
    flags = torch.zeros(8, dtype=torch.uint8)
    mask = torch.zeros(8, dtype=torch.bool)
    for call in (lambda: ek.altair_deltas(col, col, col, flags, mask, mask, _scalars()),
                 lambda: me.incl_scan(col, col, 8),
                 lambda: ek.slashings(col, col, mask, GWEI, 0, GWEI)):
        with pytest.raises((RuntimeError, AssertionError)) as exc:
            call()
        assert "plain version used" not in str(exc.value)
