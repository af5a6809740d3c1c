"""Models of the schedules of K1 (``g1_aggregate_scale``) and K18
(``merkle_levels``) on the CPU, held against the plain versions, the
oracle, hashlib and the JAX package (tolerance 0: words and bytes).

K1's model runs the kernel's order on the plain G1 formulas
(``points.complete_add`` / ``complete_dbl``): team t of 40 sums keys t,
t + 40, ...; a tree joins the 40 partials (the upper half onto the
lower at each level); the scale walks 4-bit sliding windows over the
odd multiples S, 3S, ..., 15S; the plain normalization makes it affine.
The JAX side is ``bls_jax._j_tree_sum``, ``_j_g1_scale`` and the staged
normalization (``points._j_g1_norm_post``), in the package's numpy-kernel
mode in a subprocess.

K18's model runs ``mesh_merkle.tiers`` CTA by CTA with hashlib: which
CTA hashes which nodes, where each level lands in the output, the group
counters (the last sibling to arrive goes on up and leaves its counter
at zero), in order, in reverse and shuffled, for CTAs of 1 to 512
threads and spans 1, 2 and 4.  The JAX side is
``mesh_merkle._sequential_levels`` (JAX's ``_program`` does not run under
this JAX: see ``tests/test_torch_mesh_merkle.py``).
"""
import hashlib
import json

import numpy as np
import pytest
import torch

from consensus_specs_tpu.parallel import mesh_merkle as jax_mesh_merkle
from consensus_specs_tpu_torch.ops.bls12_381.curve import G1_GENERATOR, G1Point
from consensus_specs_tpu_torch.ops.torch_bls import convert as C
from consensus_specs_tpu_torch.ops.torch_bls import limbs as L
from consensus_specs_tpu_torch.ops.torch_bls import points as PT
from consensus_specs_tpu_torch.ops.torch_bls import team_programs as TP
from consensus_specs_tpu_torch.parallel import mesh_merkle as mm
from tests._torch_port import one_torch_thread, run_numpy_kernels  # noqa: F401

# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

N_KEYS = 45                     # teams 0-4 hold two keys, the rest one or none
EDGE_SCALARS = (0, 1, (1 << 128) - 1, 1 << 77,
                ((1 << 128) - 1) ^ (((1 << 70) - 1) << 30),   # runs of ones and of zeros
                0x5A5A_0000_0000_FFFF_FFFF_0000_0001_8000)


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return [G1_GENERATOR.mult(int(rng.integers(1, 1 << 62))) for _ in range(n)]


def _rows():
    """Rows of 0, 1 and N keys, P and -P, a key seven times, and 40 keys
    that cancel in pairs across teams (key i beside -key i in team i + 20)."""
    k = _keys(N_KEYS, 11)
    return [[], [k[0]], list(k), [k[1], -k[1]], [k[2]] * 7,
            k[:20] + [-p for p in k[:20]]]


def _pack(rows):
    pk = torch.zeros((len(rows), N_KEYS, 2, 12), dtype=torch.int32)
    for i, r in enumerate(rows):
        if r:
            pk[i, :len(r)] = C.pack_g1(r)[0]
    return pk, torch.tensor([len(r) for r in rows], dtype=torch.int32)


def _scalar_words(scalars):
    raw = b"".join(s.to_bytes(16, "little") for s in scalars)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.int32).reshape(-1, 4).copy())


def _identity(n):
    return PT.identity_like(PT._G1, torch.zeros((n, L.NLIMB), dtype=torch.int64))


def k1_model(pk, counts, scalars=None):
    """K1's schedule on the plain formulas: (B, 2, 12) affine words and the
    (B,) infinity flags."""
    B, N = pk.shape[:2]
    add = lambda p, q: PT.complete_add(PT._G1, p, q)
    dbl = lambda p: PT.complete_dbl(PT._G1, p)
    ks = PT.scalar_ints(scalars) if scalars is not None else [None] * B
    out, flags = [], []
    for b in range(B):
        cnt = int(counts[b])
        keys = PT.from_affine(PT._G1, L.unpack(pk[b]), torch.zeros(N, dtype=torch.bool))
        acc = _identity(PT.K1_TEAMS)
        for j in range(0, cnt, PT.K1_TEAMS):             # a round of the teams' keys
            idx = torch.arange(j, j + PT.K1_TEAMS)
            live = idx < cnt
            key = keys[idx.clamp(max=N - 1)]
            acc = PT._select(PT._G1, live, key if j == 0 else add(acc, key), acc)
        n = PT.K1_TEAMS
        while n > 1:                                     # the tree
            h = (n + 1) // 2
            acc = torch.cat([add(acc[:n - h], acc[h:n]), acc[n - h:h]])
            n = h
        s = acc[:1]
        k = ks[b]
        if k == 0:
            s = _identity(1)
        elif k is not None:                              # the sliding windows
            tab = [s]
            two = dbl(s)
            while len(tab) < 1 << (PT.K1_WIN - 1):
                tab.append(add(tab[-1], two))
            first, windows, tail = TP.sliding_windows(k, PT.K1_WIN)
            s = tab[first >> 1]
            for dbls, d in windows:
                for _ in range(dbls):
                    s = dbl(s)
                s = add(s, tab[d >> 1])
            for _ in range(tail):
                s = dbl(s)
        aff, inf = PT.normalize(PT._G1, s)
        out.append(L.pack(aff)[0])
        flags.append(bool(inf[0]))
    return torch.stack(out), torch.tensor(flags)


def _oracle(rows, scalars=None):
    want = []
    for i, r in enumerate(rows):
        acc = G1Point.inf()
        for p in r:
            acc = acc + p
        want.append((acc if scalars is None else acc.mult(scalars[i])).to_compressed().hex())
    return want


def _edge_scalars(shift):
    return [EDGE_SCALARS[(i + shift) % len(EDGE_SCALARS)] for i in range(len(_rows()))]


@pytest.mark.parametrize("shift", [None, 0, 3])
def test_k1_model_equals_plain_and_oracle(shift):
    """Rows of 0, 1 and N keys, P and -P, a repeated key, keys cancelling
    across teams; each row with two of the edge scalars (0, 1, 2^128 - 1,
    one set bit, long runs, a mixed one) over the shifts, and no scalars."""
    rows = _rows()
    pk, counts = _pack(rows)
    scalars = None if shift is None else _edge_scalars(shift)
    sc = None if scalars is None else _scalar_words(scalars)
    got = k1_model(pk, counts, sc)
    plain = PT.g1_aggregate_scale_plain(pk, counts, sc)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert [p.to_compressed().hex() for p in C.unpack_g1(*got)] == _oracle(rows, scalars)
    assert got[1].tolist()[0] and got[1].tolist()[3] and got[1].tolist()[5]


def test_k1_model_team_split_and_tree_order():
    """The teams' split: team t holds keys t + 40 j, so with 45 keys teams
    0-4 hold two and teams 5-39 one; the tree over the 40 partials takes
    six levels (40 -> 20 -> 10 -> 5 -> 3 -> 2 -> 1)."""
    teams = [list(range(t, N_KEYS, PT.K1_TEAMS)) for t in range(PT.K1_TEAMS)]
    assert [len(t) for t in teams] == [2] * 5 + [1] * 35
    assert sorted(j for t in teams for j in t) == list(range(N_KEYS))
    n, levels = PT.K1_TEAMS, []
    while n > 1:
        n = (n + 1) // 2
        levels.append(n)
    assert levels == [20, 10, 5, 3, 2, 1] and len(levels) == (PT.K1_TEAMS - 1).bit_length()


_JAX_K1 = r"""
import json, sys
import numpy as np
from consensus_specs_tpu.ops.jax_bls.backend import NUMPY_KERNELS
assert NUMPY_KERNELS
import jax
from consensus_specs_tpu.ops import bls_jax
from consensus_specs_tpu.ops.jax_bls import points as PT
from consensus_specs_tpu.ops.bls12_381.curve import g1_from_compressed
spec = json.loads(sys.argv[1])
rows = [[g1_from_compressed(bytes.fromhex(p)) for p in r] for r in spec["rows"]]
packed = PT.g1_stack_packed([[PT.g1_pack_affine_rows(p) for p in r] for r in rows],
                            spec["n_pad"])
pts = jax.tree_util.tree_map(
    lambda a: a.reshape((len(rows), spec["n_pad"]) + a.shape[1:]), packed)
total = bls_jax._j_tree_sum(pts)
one = lambda t, i: jax.tree_util.tree_map(lambda a: a[i], t)
out = {}
for tag, bits in [("sum", None)] + list(spec["bits"].items()):
    p = total if bits is None else bls_jax._j_g1_scale(total, np.array(bits, dtype=np.uint32))
    norm, inf = PT.g1_normalize_flag_staged(p)
    out[tag] = [PT.g1_unpack(one(norm, i)).to_compressed().hex() for i in range(len(rows))]
print("RESULT=" + json.dumps(out))
"""


def test_k1_model_equals_jax_tree_sum_scale_and_normalization():
    """The model on the edge rows, without scalars and with the edge
    scalars at two shifts, equals the JAX package's ``_j_tree_sum``,
    ``_j_g1_scale`` and staged normalization on the same keys."""
    rows = _rows()
    pk, counts = _pack(rows)
    bits = {str(s): [[(k >> (127 - i)) & 1 for i in range(128)] for k in _edge_scalars(s)]
            for s in (0, 3)}
    spec = {"rows": [[p.to_compressed().hex() for p in r] for r in rows],
            "n_pad": 1 << (N_KEYS - 1).bit_length(), "bits": bits}   # JAX pads to 2^k
    out = run_numpy_kernels(_JAX_K1, json.dumps(spec))
    res = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT=")][0][7:])
    for tag in ("sum", "0", "3"):
        sc = None if tag == "sum" else _scalar_words(_edge_scalars(int(tag)))
        got = k1_model(pk, counts, sc)
        assert [p.to_compressed().hex() for p in C.unpack_g1(*got)] == res[tag]


def test_k1_bound_counts_the_cheaper_scale():
    """A row's scale in K1's ops bound: the cheaper of binary double-and-add
    over the projective sum (full additions) and the windows with their
    table; the keys' mixed additions and the two affine products beside."""
    dbl, add, madd = PT.G1_DBL, PT.G1_ADD, PT.G1_MADD
    k = int.from_bytes(np.random.default_rng(98).bytes(16), "little") | 1 << 127
    _, windows, tail = TP.sliding_windows(k, PT.K1_WIN)
    win = dbl + 7 * add + sum(d * dbl + add for d, _ in windows) + tail * dbl
    binary = 127 * dbl + (bin(k).count("1") - 1) * add
    assert win < binary
    counts = torch.tensor([5, 0, 1], dtype=torch.int32)
    scalars = [k, 0, 3]
    assert PT.g1_aggregate_scale_fq_products(None, counts, _scalar_words(scalars)) == \
        4 * madd + win + 0 + (dbl + add) + 3 * 2
    assert PT.g1_aggregate_scale_fq_products(None, counts) == 4 * madd + 3 * 2


def test_k1_chain_floor_counts_the_longest_row():
    """Two product waves a step: a team's further keys (ceil(count / 40) -
    1), the tree's six levels, the scale's table (8 steps) and windows,
    then one wave for the affine point."""
    k = int.from_bytes(np.random.default_rng(99).bytes(16), "little") | 1 << 127
    _, windows, tail = TP.sliding_windows(k, PT.K1_WIN)
    scale = 8 + sum(d + 1 for d, _ in windows) + tail
    counts = torch.tensor([512, 1, 0], dtype=torch.int32)
    sc = _scalar_words([k, 5, 0])
    assert PT.g1_aggregate_scale_chain(counts, sc) == 2 * (12 + 6 + scale) + 1
    assert PT.g1_aggregate_scale_chain(counts) == 2 * (12 + 6) + 1
    assert PT.g1_aggregate_scale_chain(torch.tensor([1], dtype=torch.int32),
                                       _scalar_words([0])) == 2 * 6 + 1


# ---------------------------------------------------------------------------
# K18
# ---------------------------------------------------------------------------

def _leaves(n: int, seed: int) -> bytes:
    return hashlib.shake_256(b"k18-model" + bytes([seed]) + n.to_bytes(4, "little")).digest(32 * n)


def _hashlib_levels(leaves: bytes, depth: int) -> list:
    out, level = [], leaves
    for _ in range(depth):
        level = b"".join(hashlib.sha256(level[i:i + 64]).digest()
                         for i in range(0, len(level), 64))
        out.append(level)
    return out


def k18_model(leaves: bytes, spans: int, threads: int, plan: list, order="forward"):
    """K18 run CTA by CTA on hashlib with CTAs of ``threads`` following
    ``plan``: returns the output (levels 1 to the spans' roots), the times
    each node was written and the counters after the launch, with the
    first tier's CTAs finishing in ``order`` (each group's last arrival
    going on up at once)."""
    n = len(leaves) // 32
    depth = (n // spans).bit_length() - 1
    assert sum(fold for _, fold, _ in plan) == depth
    start = [0]                                   # where level i + 1 starts (nodes)
    for i in range(1, depth):
        start.append(start[-1] + (n >> i))
    out = [None] * (n - spans)
    writes = [0] * (n - spans)
    counters = [0] * mm.tier_counters(n, plan)

    def node(level, i):
        return leaves[32 * i:32 * i + 32] if level == 0 else out[start[level - 1] + i]

    def cta(g, r, base):
        s, fold, width = plan[r]
        assert width <= 2 * threads
        for level in range(s + 1, s + fold + 1):
            per = width >> (level - s)            # this CTA's nodes of the level
            for i in range(g * per, (g + 1) * per):
                pos = start[level - 1] + i
                out[pos] = hashlib.sha256(node(level - 1, 2 * i) + node(level - 1, 2 * i + 1)).digest()
                writes[pos] += 1
        if r + 1 == len(plan):
            return
        nxt = plan[r + 1]
        group = nxt[2] // (width >> fold)
        counters[base + g // group] += 1
        if counters[base + g // group] == group:  # the last sibling resets and goes on
            counters[base + g // group] = 0
            cta(g // group, r + 1, base + (n >> nxt[0]) // nxt[2])

    blocks = list(range(n // plan[0][2]))
    if order == "reverse":
        blocks.reverse()
    elif order == "shuffled":
        np.random.default_rng(n + threads).shuffle(blocks)
    for g in blocks:
        cta(g, 0, 0)
    return b"".join(out), writes, counters


def _k18_cases():
    """Small CTAs (1, 2 and 4 threads: whole subtrees of k = 1, 2, 3
    levels) at every depth from 1 to 3k + 1, with every first tier's fold
    from 1 to k; the kernel's CTA sizes (32 to 512 threads) at depths up
    to 13, with the two first folds ``launch_plan`` picks (k - 5 and k)."""
    cases = []
    for threads in (1, 2, 4):
        k = (2 * threads).bit_length() - 1
        for depth in range(1, 3 * k + 2):
            for spans in (1, 2, 4):
                for first in range(1, k + 1) if depth > k else (k,):
                    cases.append((threads, depth, spans, first))
    for threads in (32, 64, 128, 256, 512):
        k = (2 * threads).bit_length() - 1
        for depth in (5, 9, 11, 13):
            for spans in (1, 4):
                for first in (k - mm.LOG_KEEP, k) if depth > k else (k,):
                    cases.append((threads, depth, spans, first))
    return cases


@pytest.mark.parametrize("threads,depth,spans,first", _k18_cases())
def test_k18_model_equals_plain_hashlib_and_jax(threads, depth, spans, first):
    n = spans << depth
    leaves = _leaves(n, depth)
    want = b"".join(_hashlib_levels(leaves, depth))
    t = torch.frombuffer(bytearray(leaves), dtype=torch.uint8).reshape(n, 32)
    assert mm.merkle_levels_plain(t, spans).numpy().tobytes() == want
    plan = mm.tiers(depth, threads, first)
    for order in ("forward", "reverse", "shuffled"):
        got, writes, counters = k18_model(leaves, spans, threads, plan, order)
        assert got == want
        assert writes == [1] * (n - spans)
        assert not any(counters)
    if spans == 1:
        jax_levels = jax_mesh_merkle._sequential_levels(leaves, depth)
        assert got == b"".join(bytes(x) for x in jax_levels[1:])


def test_k18_plans():
    """Tiers cover a span's depth, each within a CTA (at most 2 x threads
    nodes), each later tier's group whole (its input nodes a multiple of a
    CTA's outputs); the first tier folds the levels asked for, and the
    later tiers whole subtrees; the plan packs a byte a tier, and the
    counters are one per CTA of every later tier."""
    for threads in (32, 64, 128, 256, 512):
        k = (2 * threads).bit_length() - 1
        for depth in range(1, 31):
            for first in range(1, k + 1):
                plan = mm.tiers(depth, threads, first)
                assert sum(f for _, f, _ in plan) == depth
                assert [s for s, _, _ in plan] == [sum(f for _, f, _ in plan[:i])
                                                   for i in range(len(plan))]
                assert all(w <= 2 * threads and f <= w.bit_length() - 1 for _, f, w in plan)
                assert all(b[2] % (a[2] >> a[1]) == 0 for a, b in zip(plan, plan[1:]))
                if depth > k:
                    assert plan[0] == (0, first, 2 * threads)
                    assert len(plan) == 1 + -(-(depth - first) // k)
                assert len(plan) <= 8
                word = mm.pack_plan(plan)
                assert [((word >> (8 * r)) & 15, 1 << ((word >> (8 * r + 4)) & 15))
                        for r in range(len(plan))] == [(f, w) for _, f, w in plan]
                assert word >> (8 * len(plan)) == 0
                n = 4 << depth
                assert mm.tier_counters(n, plan) == sum((n >> s) // w for s, _, w in plan[1:])
    assert mm.tiers(20, 512, 5) == [(0, 5, 1024), (5, 10, 1024), (15, 5, 32)]
    assert mm.tiers(18, 256, 9) == [(0, 9, 512), (9, 9, 512)]
    assert mm.tiers(20, 256, 4) == [(0, 4, 512), (4, 9, 512), (13, 7, 128)]


def test_k18_chain_floor_is_a_spans_depth():
    assert mm.merkle_levels_chain(1 << 20) == 20
    assert mm.merkle_levels_chain(1 << 20, 4) == 18
    assert mm.merkle_levels_chain(2, 1) == 1


@pytest.mark.parametrize("logn,spans", [(10, 1), (12, 4), (14, 1), (16, 1), (19, 1)])
def test_k18_model_on_the_wrappers_plans(logn, spans):
    """The plans the wrapper launches (``launch_plan``: CTAs of 128 threads
    folding whole subtrees up to 2^14 leaves, 256 below 2^19, 512 keeping
    a warp's width of nodes from 2^19 on), run CTA by CTA, equal hashlib."""
    n = 1 << logn
    depth = logn - (spans.bit_length() - 1)
    threads, plan = mm.launch_plan(n, depth)
    leaves = _leaves(n, logn)
    want = b"".join(_hashlib_levels(leaves, depth))
    for order in ("forward", "reverse") if logn < 19 else ("reverse",):
        got, writes, counters = k18_model(leaves, spans, threads, plan, order)
        assert got == want and writes == [1] * (n - spans) and not any(counters)


def test_k18_launch_plans():
    """Every launch plan covers its spans' depth within its CTAs in at most
    eight tiers; the measured choices at the main path's widths."""
    for logn in range(1, 25):
        for spans in (1, 2, 4):
            n = 1 << logn
            if n < 2 * spans:
                continue
            depth = logn - (spans.bit_length() - 1)
            threads, plan = mm.launch_plan(n, depth)
            assert sum(f for _, f, _ in plan) == depth and len(plan) <= 8
            assert all(w <= 2 * threads for _, _, w in plan)
            mm.pack_plan(plan)
    assert mm.launch_plan(1 << 14, 14) == (128, [(0, 8, 256), (8, 6, 64)])
    assert mm.launch_plan(1 << 16, 16) == (256, [(0, 9, 512), (9, 7, 128)])
    assert mm.launch_plan(1 << 18, 18) == (256, [(0, 9, 512), (9, 9, 512)])
    assert mm.launch_plan(1 << 20, 20) == (512, [(0, 5, 1024), (5, 10, 1024), (15, 5, 32)])
    with pytest.raises(ValueError):
        mm.tiers(20, 256, 10)
