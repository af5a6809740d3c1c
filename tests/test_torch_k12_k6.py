"""K12 ``slashings`` and K6 ``sha256_blocks`` as redesigned for the H100,
on the CPU.

K12 divides by the exact reciprocals of its two divisors, the increment
and the total balance (``epoch_kernels.slashings_params``;
``csrc/udiv.cuh``).  A model of the kernel's lane that reads the
parameter array at the words ``csrc/epoch.cu``'s entry reads, and
divides as the kernel does (``kernel_div``, the python emulation of
``udiv`` from ``tests/test_torch_k13_k16.py``), equals the plain version
and the JAX ``slashing_penalty_kernel`` with the clamped decrease on the
edges: no targets, all of them, every fourth; ``adjusted`` 0 and equal to
the total; the total at the increment; increments 1, a power of two and
a prime; products at the guard's limit; the divisors both engines pass
at the minimal preset and mainnet's.  A model of K12's 4-lane groups
(lane by lane where a column starts off its alignment) visits every lane
once.

K6 takes one warp a CTA: a model of its CTAs visits every message once,
and of each thread's loads every 16-byte piece of its message once, each
block's before its compression.  Its plain version equals the JAX ``sha256_blocks`` and hashlib at
1, 2, 5 and 17 blocks with leading shapes; the chain counts and the
round-latency probe's plain version are checked against an independent
FIPS 180-4 round.  On CUDA tensors the wrappers launch or raise, never
the plain versions (tolerance 0 throughout: integers and bytes).
"""
import hashlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.ops import sha256 as jax_sha
from consensus_specs_tpu.parallel import mesh_state as jax_mesh_state
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from consensus_specs_tpu_torch.ops import sha256
from consensus_specs_tpu_torch.parallel import mesh_state
from consensus_specs_tpu_torch.utils import bls, ssz
from consensus_specs_tpu_torch.utils.ssz import merkle
from tests._torch_port import REPO, one_torch_thread  # noqa: F401
from tests.test_epoch_vectorized import _altair_state, _phase0_state
from tests.test_torch_k13_k16 import U64, MASK, check_divisor, kernel_div

GWEI = 10**9
LIMIT = 2**63 - 1
CSRC = os.path.join(REPO, "consensus_specs_tpu_torch", "csrc")
EPOCH_CU = open(os.path.join(CSRC, "epoch.cu")).read()
SHA_CU = open(os.path.join(CSRC, "sha256.cu")).read()

# ---------------------------------------------------------------------------
# K12's parameter array and a model of its lane
# ---------------------------------------------------------------------------

# the words csrc/epoch.cu's entry reads: h[0] the increment, h[1] the
# adjusted total slashing balance, and the (m, l) pairs of the increment
# and of the total balance
READS = {"inc": 0, "adjusted": 1, "inc_div": 3, "total_div": 5}


def test_entry_reads_the_documented_words():
    assert int(re.search(r"#define SLASHINGS_PARAMS (\d+)", EPOCH_CU).group(1)) == 7
    assert "a.inc = h[0]; a.adjusted = h[1];" in EPOCH_CU
    pairs = re.findall(r"a\.(\w+) = udiv_make\(h\[(\d+)\], h\[(\d+)\]\)", EPOCH_CU)
    assert pairs == [("inc_div", "3", "4"), ("total_div", "5", "6")]


@pytest.mark.parametrize("inc,adjusted,total", [
    (GWEI, 0, 2**20 * 32 * GWEI), (GWEI, 3 * GWEI, 3 * GWEI), (1, 1, 1),
    (2**30, 2**40, 2**45), (1000000007, 999, 1000000007 * 1000003),
    (GWEI, 2**62 + 5, 2**62 + 5)])
def test_params_pack_the_scalars_and_reciprocals(inc, adjusted, total):
    words = [w % U64 for w in ek.slashings_params(inc, adjusted, total).tolist()]
    assert len(words) == 7 and words[:3] == [inc, adjusted, total]
    assert (words[3], words[4]) == ek.reciprocal(inc)
    assert (words[5], words[6]) == ek.reciprocal(total)


def k12_model(words, eff, bal, target):
    """csrc/epoch.cu ``slashings_lane`` per lane on 64-bit words, every
    value read from the parameter array where the entry reads it."""
    h = [w % U64 for w in words]
    inc, adjusted = h[READS["inc"]], h[READS["adjusted"]]
    inc_div = h[READS["inc_div"]:READS["inc_div"] + 2]
    total_div = h[READS["total_div"]:READS["total_div"] + 2]
    out = []
    for e, b, tg in zip(eff, bal, target):
        e, b = e % U64, b % U64
        if tg:
            q = (kernel_div(e, *inc_div) * adjusted) & MASK
            pen = (kernel_div(q, *total_div) * inc) & MASK
            b = 0 if pen > b else b - pen
        out.append(b - U64 if b >= 1 << 63 else b)
    return out


def jax_slashings(eff, bal, target, inc, adjusted, total):
    """The JAX kernel and the clamped decrease, as ``_p_slashings`` and the
    columnar ``_slashings`` compose them (uint64 numpy)."""
    pen = jek.slashing_penalty_kernel(np, eff, target, increment=inc,
                                      adjusted_total_slashing_balance=adjusted,
                                      total_balance=total)
    return np.where(pen > bal, np.uint64(0), bal - pen)


def k12_columns(n, inc, adjusted, pattern, seed):
    """Seeded columns with the effective balances at the guard's limit
    ((eff // inc) * adjusted just under 2^63 on lane 0), zero and small
    balances that clamp, and the target mask ``pattern``."""
    rng = np.random.default_rng(seed)
    cap = LIMIT // max(1, adjusted)                 # the largest eff // inc the guard passes
    top = min(cap, 2048 * GWEI // inc) * inc        # an effective balance the guard passes
    eff = (rng.integers(0, 33, n, dtype=np.uint64) * np.uint64(GWEI)) % np.uint64(top + 1)
    eff[0] = np.uint64(top)
    bal = rng.integers(0, 40 * GWEI, n, dtype=np.uint64)
    bal[1:4] = [0, 1, GWEI][:max(0, min(3, n - 1))]
    target = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
              "every fourth": np.arange(n) % 4 == 0, "random": rng.random(n) < 0.3}[pattern]
    return eff, bal, target


def check_k12(eff, bal, target, inc, adjusted, total):
    t = [torch.from_numpy(np.ascontiguousarray(a).view(np.int64) if a.dtype == np.uint64 else a)
         for a in (eff, bal, target)]
    want = ek.slashings_plain(*t, inc, adjusted, total).tolist()
    got = k12_model(ek.slashings_params(inc, adjusted, total).tolist(), *(a.tolist() for a in t))
    assert got == want
    jax_want = jax_slashings(eff, bal, target, inc, adjusted, total)
    assert np.array_equal(np.array(got, dtype=np.int64).view(np.uint64), jax_want)


# (increment, total): increments 1, a power of two and a prime, and
# mainnet's; totals from the increment itself up to 2^20 validators
DIVISORS = {"mainnet": (GWEI, 2**20 * 32 * GWEI), "total at the increment": (GWEI, GWEI),
            "ones": (1, 1), "power of two": (2**30, 2**30 * 12345),
            "prime": (1000000007, 1000000007 * 1000003 + 11)}


@pytest.mark.parametrize("divisors", list(DIVISORS))
@pytest.mark.parametrize("adjusted", ["zero", "a third", "the total"])
@pytest.mark.parametrize("pattern", ["none", "all", "every fourth", "random"])
def test_lane_model_equals_the_plain_and_jax_versions(divisors, adjusted, pattern):
    inc, total = DIVISORS[divisors]
    adj = {"zero": 0, "a third": total // 3, "the total": total}[adjusted]
    n = 67
    eff, bal, target = k12_columns(n, inc, adj, pattern, seed=len(divisors) + 3 * n)
    check_k12(eff, bal, target, inc, adj, total)


def test_lane_model_at_the_guards_limit():
    """(eff // inc) * adjusted one below 2^63 on a target lane, and the
    penalty there above and at its balance."""
    inc, total = GWEI, 2**20 * 32 * GWEI
    adj = total - 1
    q = LIMIT // adj
    eff = np.array([q * inc, q * inc + inc - 1, q * inc, 0], dtype=np.uint64)
    assert (int(eff[0]) // inc) * adj <= LIMIT
    pen = (q * adj // total) * inc
    bal = np.array([pen - 1, pen, pen + 1, 5], dtype=np.uint64)
    check_k12(eff, bal, np.ones(4, bool), inc, adj, total)


@pytest.fixture(scope="module")
def engine_calls():
    """The (increment, adjusted, total) each engine passes K12 at the
    minimal preset, with the columns: the port's columnar engine
    (``use_fallback``) and its mesh engine (``use_mesh``), across one epoch
    boundary of a phase0 and an Altair state with slashed validators at
    the target epoch (``tests/test_epoch_vectorized.py``, 64 validators)."""
    jax_mesh_state.use_fallback()
    jax_mode = jek._mode            # the state builders switch the JAX engine to its loops
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    saved = (merkle._batched_hasher, merkle._batched_hasher_np, ek.slashings)
    seen = {"columnar": [], "mesh": []}
    try:
        ek.use_vectorized("cpu")
        sha256.install_merkle_hasher("cpu")
        for fork, make in (("phase0", lambda: _phase0_state("phase0", empty_attestations=True)),
                           ("altair", lambda: _altair_state("altair"))):
            spec = build_spec(fork, "minimal")
            _, jstate = make()
            target = int(jstate.slot) + spec.SLOTS_PER_EPOCH \
                - int(jstate.slot) % spec.SLOTS_PER_EPOCH
            for engine, use in (("columnar", mesh_state.use_fallback),
                                ("mesh", mesh_state.use_mesh)):
                def record(*args, _seen=seen[engine]):
                    _seen.append([a.clone() if isinstance(a, torch.Tensor) else a for a in args])
                    return saved[2](*args)
                ek.slashings = record
                use()
                s = ssz.deserialize(spec.BeaconState, jax_ssz.serialize(jstate))
                spec.process_slots(s, target)
                ek.slashings = saved[2]
    finally:
        ek.slashings = saved[2]
        merkle.set_batched_hasher(saved[0])
        merkle.set_batched_hasher_np(saved[1])
        jax_bls.bls_active, bls.bls_active = jax_active, port_active
        ek.use_auto()
        mesh_state.use_auto()
        jax_mesh_state.use_auto()
        jek._mode = jax_mode
    return seen


@pytest.mark.parametrize("engine", ["columnar", "mesh"])
def test_engine_calls_minimal(engine_calls, engine):
    """Both forks' calls: the divisors divide exactly, the model equals the
    plain version and the JAX composition on the engine's own columns."""
    calls = engine_calls[engine]
    assert len(calls) == 2
    for eff, bal, target, inc, adjusted, total in calls:
        assert bool(target.any()) and 0 < adjusted <= total and total >= inc
        check_divisor(inc)
        check_divisor(total)
        check_k12(eff.numpy().view(np.uint64), bal.numpy().view(np.uint64), target.numpy(),
                  inc, adjusted, total)


def test_engines_pass_the_same_arguments(engine_calls):
    for a, b in zip(engine_calls["columnar"], engine_calls["mesh"]):
        assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(a, b))


@pytest.mark.parametrize("validators", [1, 64, 2**20 - 3, 2**20, 2**22])
def test_engine_divisors_mainnet(validators):
    """Mainnet's increment and the total balance the engines pass (clamped
    below at the increment) from one validator to past 2^20, with phase0's
    and Altair's slashing multipliers."""
    spec = build_spec("altair", "mainnet")
    inc = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    total = max(inc, validators * int(spec.MAX_EFFECTIVE_BALANCE) - 7 * inc)
    check_divisor(inc)
    check_divisor(total)
    for mult in (int(spec.PROPORTIONAL_SLASHING_MULTIPLIER),
                 int(spec.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR)):
        adjusted = min(5 * int(spec.MAX_EFFECTIVE_BALANCE) * mult, total)
        eff, bal, target = k12_columns(41, inc, adjusted, "random", seed=validators + mult)
        check_k12(eff, bal, target, inc, adjusted, total)


# ---------------------------------------------------------------------------
# K12's 4-lane groups
# ---------------------------------------------------------------------------

def k12_lanes(eff, bal, out, target, n, blocks, threads=256):
    """The lanes ``k_slashings`` visits, as (lane, 'vec' | 'one'): 4-lane
    groups from lane 0 where the entry's test holds (the effective
    balances, balances and output on 16 bytes, the target bytes on 4),
    the rest one at a time."""
    vec = (eff | bal | out) % 16 == 0 and target % 4 == 0
    v_hi = n & ~3 if vec else 0
    lanes, step = [], blocks * threads
    for t in range(step):
        for i in range(4 * t, v_hi, 4 * step):
            assert (target + i) % 4 == 0 and all((p + 8 * i) % 16 == 0 for p in (eff, bal, out))
            lanes += [(i + k, "vec") for k in range(4)]
        lanes += [(i, "one") for i in range(v_hi + t, n, step)]
    return lanes


@pytest.mark.parametrize("n", [1, 3, 4, 5, 7, 1000, 2**16 + 3])
@pytest.mark.parametrize("layout", ["on their storage", "one lane in", "target alone one in"])
def test_k12_groups_cover_every_lane_once(n, layout):
    base = 1 << 24
    off = 0 if layout == "on their storage" else 1
    wide = 8 if layout == "one lane in" else 0
    eff, bal, target = base + wide, base + 2**21 + wide, base + 2**22 + off
    out = base + 2**23                              # the wrapper's allocation
    for blocks in ((1, 3) if n < 2**16 else (5,)):
        lanes = k12_lanes(eff, bal, out, target, n, blocks, threads=4 if n < 2**16 else 256)
        assert sorted(i for i, _ in lanes) == list(range(n))
        kinds = {k for _, k in lanes}
        assert kinds == ({"one"} if off or n < 4 else {"vec"} | ({"one"} if n % 4 else set()))


# ---------------------------------------------------------------------------
# K6: CTAs of one warp, each message's blocks loaded ahead
# ---------------------------------------------------------------------------

def k6_threads(m):
    """The message of each working thread of ``sha256_blocks``'s launch:
    ceil(m / 32) CTAs of 32 threads, a thread past m idle."""
    threads = []
    for cta in range(-(-m // 32)):
        for lane in range(32):
            i = cta * 32 + lane
            if i < m:
                threads.append(i)
    return threads


def k6_loads(nb):
    """A thread's loads as (loop step, 16-byte piece) and the step of each
    block's compression: block 0's four pieces before the loop (step -1),
    then in step ``blk`` block ``blk + 1``'s before block ``blk`` is
    compressed."""
    loads = [(-1, k) for k in range(4)]
    compressions = []
    for blk in range(nb):
        if blk + 1 < nb:
            loads += [(blk, 4 * (blk + 1) + k) for k in range(4)]
        compressions.append(blk)
    return loads, compressions


@pytest.mark.parametrize("m", [1, 31, 32, 33, 255, 256, 257, 1000])
def test_k6_ctas_cover_every_message_once(m):
    assert sorted(k6_threads(m)) == list(range(m))
    assert re.search(r"#define K6_WARP 32\b", SHA_CU)
    assert "const int ctas = (m + K6_WARP - 1) / K6_WARP;" in SHA_CU


@pytest.mark.parametrize("nb", [1, 2, 5, 17])
def test_k6_loads_every_piece_once_ahead_of_its_block(nb):
    """Each of a message's 4 x nb pieces is loaded once, and block b's in
    the step before b's compression (block 0's before the loop)."""
    loads, compressions = k6_loads(nb)
    assert sorted(q for _, q in loads) == list(range(4 * nb))
    for step, q in loads:
        assert step == compressions[q // 4] - 1


# ---------------------------------------------------------------------------
# K6's plain version against the JAX package and hashlib
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 2, 5, 17])
@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_sha256_blocks_plain_matches_jax_and_hashlib(nb, lead):
    count = int(np.prod(lead))
    rng = np.random.default_rng(nb * 7 + count)
    lo, hi = 64 * (nb - 1), 64 * nb - 9                  # lengths that pad to nb blocks
    msgs = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(lo, hi + 1, count)]
    msgs[0] = b"\x80" * hi
    words = np.stack([sha256.pad_message(m) for m in msgs])
    got = sha256.sha256_blocks(torch.from_numpy(words.reshape(lead + (nb, 16))), nb)
    assert got.dtype == torch.int32 and tuple(got.shape) == lead + (8,)
    got_u32 = got.numpy().reshape(count, 8).view(np.uint32)
    ref = np.asarray(jax_sha.sha256_blocks(jnp.asarray(words.view(np.uint32)), nb))
    assert np.array_equal(got_u32, ref)
    assert got_u32.astype(">u4").tobytes() == b"".join(hashlib.sha256(m).digest() for m in msgs)


# ---------------------------------------------------------------------------
# chain counts and the round-latency probe
# ---------------------------------------------------------------------------

def fips_round(v, kw):
    """One FIPS 180-4 round (6.2.2 step 3) on python ints, written anew."""
    a, b, c, d, e, f, g, h = v
    rot = lambda x, n: ((x >> n) | (x << (32 - n))) & MASK32  # noqa: E731
    t1 = (h + (rot(e, 6) ^ rot(e, 11) ^ rot(e, 25)) + ((e & f) ^ (~e & g & MASK32)) + kw) & MASK32
    t2 = ((rot(a, 2) ^ rot(a, 13) ^ rot(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))) & MASK32
    return [(t1 + t2) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g]


MASK32 = 0xFFFFFFFF


@pytest.mark.parametrize("nb", [1, 2, 5, 17])
def test_chain_counts(nb):
    """K6's chain is nb x 64 rounds of 4 dependent instructions; K5's is
    the two compressions of a 64-byte message, K6's at two blocks."""
    assert sha256.sha256_blocks_chain_ops(nb) == nb * 64 * 4
    assert sha256.hash64_chain_ops() == sha256.sha256_blocks_chain_ops(2) == 512


@pytest.mark.parametrize("reps", [1, 3])
def test_chain_probe_plain_version(reps):
    """The probe's plain version runs reps x 64 rounds with K[i] as kw and
    the feed-forward after every 64: as an independent FIPS round does;
    the CPU wrapper returns its words as int32 bit patterns."""
    st = list(sha256.H0)
    for _ in range(reps):
        v = list(st)
        for i in range(64):
            v = fips_round(v, sha256.K[i])
        st = [(x + y) & MASK32 for x, y in zip(st, v)]
    assert sha256.sha256_chain_plain(reps) == st
    got = sha256.sha256_chain(reps, "cpu")
    assert got.dtype == torch.int32 and got.numpy().view(np.uint32).tolist() == st


# ---------------------------------------------------------------------------
# CUDA tensors
# ---------------------------------------------------------------------------

def test_cuda_tensors_never_take_the_plain_versions(monkeypatch):
    """On a CUDA tensor K12 and K6 (and the round-latency probe on the
    card) launch their kernels or raise: here the build fails (no nvcc),
    and no plain version runs."""
    def no_plain(*a, **kw):
        raise AssertionError("plain version used for CUDA tensors")
    monkeypatch.setattr(ek, "slashings_plain", no_plain)
    monkeypatch.setattr(sha256, "sha256_blocks_plain", no_plain)
    monkeypatch.setattr(sha256, "sha256_chain_plain", no_plain)
    monkeypatch.setattr(_build, "same_device", lambda *t: torch.device("cuda"))
    col = torch.zeros(8, dtype=torch.int64)
    mask = torch.zeros(8, dtype=torch.bool)
    for call in (lambda: ek.slashings(col, col, mask, GWEI, 0, GWEI),
                 lambda: sha256.sha256_blocks(torch.zeros((2, 5, 16), dtype=torch.int32), 5),
                 lambda: sha256.sha256_chain(64, "cuda")):
        with pytest.raises((RuntimeError, AssertionError)) as exc:
            call()
        assert "plain version used" not in str(exc.value)
