"""The port's epoch kernels (K10-K14) against the JAX package's
``*_kernel`` functions.

Each plain PyTorch version (int64 lanes) is held against its JAX
counterpart run with ``xp=numpy`` and under ``jax.jit`` with x64 on the
same seeded uint64 columns, exactly (tolerance 0: integers).  The
columns carry the edge values the kernels branch on: zero balances,
penalties above balance plus reward, balances exactly at the hysteresis
thresholds, and lane products just under the port's 2^63 guard.  The
fused compositions K10 and K12 compute are held against the JAX kernels
composed as ``_phase0_rewards_and_penalties`` and ``_slashings`` compose
them, K13 against the Altair kernels composed pair by pair as
``_altair_rewards_and_penalties`` applies them (with clamps at the first,
a middle and the last pair), K14 against ``inactivity_updates_kernel``,
and the host helpers against the JAX helpers on registry columns
with ``FAR_FUTURE_EPOCH`` lanes.  The wrappers take the plain versions
on CPU tensors, reject malformed arguments, and ``use_vectorized()``
raises without CUDA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import epoch_kernels as jek
from consensus_specs_tpu.state import arrays as jax_arrays
from consensus_specs_tpu_torch.ops import epoch_kernels as ek
from tests._torch_port import one_torch_thread  # noqa: F401

N = 512
GWEI = 10**9
FAR = 2**64 - 1
LIMIT = 2**63


def t(a):
    """uint64 numpy column -> int64 tensor of the same bits (or a mask)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)


def u(x):
    """A plain version's int64 tensor -> uint64 numpy (the same bits)."""
    return x.numpy().view(np.uint64)


@pytest.fixture(scope="module")
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def both(fn, *args, **kw):
    """The JAX kernel with xp=numpy and under jax.jit (x64), as numpy."""
    host = fn(np, *args, **kw)
    dev = jax.jit(lambda *a: fn(jnp, *a, **kw))(*args)
    if isinstance(host, tuple):
        return [tuple(np.asarray(x) for x in host), tuple(np.asarray(x) for x in dev)]
    return [np.asarray(host), np.asarray(dev)]


def columns(seed):
    rng = np.random.default_rng(seed)
    bal = rng.integers(0, 40 * GWEI, N, dtype=np.uint64)
    bal[:4] = 0
    eff = (rng.integers(0, 33, N, dtype=np.uint64) * np.uint64(GWEI))
    eligible = rng.random(N) < 0.8
    attesting = rng.random(N) < 0.6
    return rng, bal, eff, eligible, attesting


def test_apply_deltas_plain(x64):
    rng, bal, _, _, _ = columns(1)
    rew = rng.integers(0, 2**20, N, dtype=np.uint64)
    pen = rng.integers(0, 2**36, N, dtype=np.uint64)
    pen[4:8] = bal[4:8] + rew[4:8] + np.uint64(1)       # above balance + reward
    pen[8:12] = bal[8:12] + rew[8:12]                   # exactly balance + reward
    bal[12] = np.uint64(LIMIT - 2**21)                  # sum just under 2^63
    got = u(ek.apply_deltas_plain(t(bal), t(rew), t(pen)))
    for want in both(jek.apply_deltas_kernel, bal, rew, pen):
        np.testing.assert_array_equal(got, want)
    assert (got[4:12] == 0).all()


@pytest.mark.parametrize("in_leak", [False, True])
def test_phase0_component_plain(x64, in_leak):
    rng, _, _, eligible, attesting = columns(2)
    ti = 2**20
    ai = ti - 12345
    br = rng.integers(0, 2**20, N, dtype=np.uint64)
    br[0] = np.uint64((LIMIT - 1) // ai)                # br * ai just under 2^63
    eligible[0] = attesting[0] = True
    kw = dict(in_leak=in_leak, attesting_increments=ai, total_increments=ti)
    got = ek.phase0_component_plain(t(br), t(eligible), t(attesting), **kw)
    for want in both(jek.phase0_component_kernel, br, eligible, attesting, **kw):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(u(g), w)


def test_phase0_inactivity_plain(x64):
    rng, _, eff, eligible, attesting = columns(3)
    br = eff * np.uint64(64) // np.uint64(2**17) // np.uint64(4)
    fd = 9
    eff[0] = np.uint64((LIMIT - 1) // fd)               # eff * delay just under 2^63
    br[0] = np.uint64(2**40)
    eligible[0], attesting[0] = True, False
    kw = dict(base_rewards_per_epoch=4, proposer_reward_quotient=8, finality_delay=fd,
              inactivity_penalty_quotient=2**26)
    got = ek.phase0_inactivity_plain(t(br), t(eff), t(eligible), t(attesting), **kw)
    for want in both(jek.phase0_inactivity_kernel, br, eff, eligible, attesting, **kw):
        np.testing.assert_array_equal(u(got), want)


def test_effective_balance_plain(x64):
    rng, bal, eff, _, _ = columns(4)
    inc, down, up, max_eb = GWEI, GWEI // 4, 5 * GWEI // 4, 32 * GWEI
    # exactly at the thresholds (no change) and one gwei past them
    eff[20:32] = np.uint64(16 * GWEI)
    bal[20:24] = eff[20:24] - np.uint64(down)
    bal[24:28] = eff[24:28] + np.uint64(up)
    bal[28:32] = eff[28:32] + np.uint64(up + 1)
    eff[32:36] = np.uint64(32 * GWEI)
    bal[32:36] = np.uint64(32 * GWEI) - np.uint64(down + 1)
    bal[36] = np.uint64(LIMIT - 1 - down)               # balance + down just under 2^63
    args = (inc, down, up, max_eb)
    got = u(ek.effective_balance_plain(t(bal), t(eff), *args))
    kw = dict(increment=inc, downward_threshold=down, upward_threshold=up,
              max_effective_balance=max_eb)
    for want in both(jek.effective_balance_kernel, bal, eff, **kw):
        np.testing.assert_array_equal(got, want)
    assert (got[20:28] == eff[20:28]).all() and (got[28:32] != eff[28:32]).all()


def test_slashing_penalty_plain(x64):
    rng, _, eff, target, _ = columns(5)
    inc, total = GWEI, 2**20 * 32 * GWEI
    adjusted = total // 3
    eff[0] = np.uint64(((LIMIT - 1) // adjusted) * inc)   # (eff // inc) * adjusted < 2^63
    kw = dict(increment=inc, adjusted_total_slashing_balance=adjusted, total_balance=total)
    got = u(ek.slashing_penalty_plain(t(eff), t(target), **kw))
    for want in both(jek.slashing_penalty_kernel, eff, target, **kw):
        np.testing.assert_array_equal(got, want)


def _jax_phase0_deltas(xp, eff, incl, bal, elig, att, s):
    """The JAX kernels composed as ``_phase0_rewards_and_penalties``."""
    br = (eff * xp.uint64(s.base_reward_factor)) // xp.uint64(s.sqrt_total) \
        // xp.uint64(s.base_rewards_per_epoch)
    rewards, penalties = [incl], []
    for c in range(3):
        r, p = jek.phase0_component_kernel(
            xp, br, elig, att[c], in_leak=s.in_leak,
            attesting_increments=s.attesting_increments[c],
            total_increments=s.total_increments)
        rewards.append(r)
        penalties.append(p)
    if s.in_leak:
        penalties.append(jek.phase0_inactivity_kernel(
            xp, br, eff, elig, att[1], base_rewards_per_epoch=s.base_rewards_per_epoch,
            proposer_reward_quotient=s.proposer_reward_quotient,
            finality_delay=s.finality_delay,
            inactivity_penalty_quotient=s.inactivity_penalty_quotient))
    return jek.apply_deltas_kernel(xp, bal, sum(rewards[1:], rewards[0]),
                                   sum(penalties[1:], penalties[0]))


@pytest.mark.parametrize("in_leak", [False, True])
def test_phase0_deltas_plain_is_the_jax_composition(x64, in_leak):
    rng, bal, eff, elig, _ = columns(6)
    att = rng.random((3, N)) < np.array([[0.7], [0.6], [0.5]])
    incl = rng.integers(0, 2**25, N, dtype=np.uint64)
    # penalties above balance plus reward: the sum clamps at zero
    bal[40:44], incl[40:44], eff[40:44] = 0, 0, np.uint64(32 * GWEI)
    elig[40:44], att[:, 40:44] = True, False
    total = 2**20 * 32 * GWEI
    s = ek.Phase0Scalars(64, int(np.sqrt(total)), 4, (2**20 - 5, 2**20 - 9, 2**19), 2**20,
                         in_leak, 8, 6 if in_leak else 1, 2**26)
    got = u(ek.phase0_deltas_plain(t(eff), t(incl), t(bal), t(elig), t(att), s))
    want = _jax_phase0_deltas(np, eff, incl, bal, elig, att, s)
    np.testing.assert_array_equal(got, want)
    dev = jax.jit(lambda *a: _jax_phase0_deltas(jnp, *a, s))(eff, incl, bal, elig, att)
    np.testing.assert_array_equal(got, np.asarray(dev))
    # the wrapper on CPU tensors is the plain version
    wrapped = ek.phase0_deltas(t(eff), t(incl), t(bal), t(elig), t(att), s)
    np.testing.assert_array_equal(u(wrapped), want)
    assert (got[40:44] == 0).all()


def test_slashings_plain_is_the_jax_composition(x64):
    rng, bal, eff, target, _ = columns(7)
    inc, total = GWEI, 2**20 * 32 * GWEI
    adjusted = total // 2
    bal[target][:8] = 0
    bal[:16] = np.uint64(GWEI)                            # penalties above balance
    pen = jek.slashing_penalty_kernel(np, eff, target, increment=inc,
                                      adjusted_total_slashing_balance=adjusted,
                                      total_balance=total)
    want = np.where(pen > bal, np.uint64(0), bal - pen)
    got = u(ek.slashings_plain(t(eff), t(bal), t(target), inc, adjusted, total))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        u(ek.slashings(t(eff), t(bal), t(target), inc, adjusted, total)), want)
    np.testing.assert_array_equal(
        u(ek.effective_balance(t(bal), t(eff), inc, inc // 4, 5 * inc // 4, 32 * inc)),
        jek.effective_balance_kernel(np, bal, eff, increment=inc,
                                     downward_threshold=inc // 4,
                                     upward_threshold=5 * inc // 4,
                                     max_effective_balance=32 * inc))


def test_host_helpers_match_the_jax_helpers():
    """Masks, masked sums and the total active balance on registry columns
    with FAR_FUTURE_EPOCH lanes (read as -1 in int64, hence host uint64)."""
    rng = np.random.default_rng(8)
    cols = np.zeros(N, dtype=jax_arrays.VALIDATOR_DTYPE)
    cols["eff"] = rng.integers(0, 33, N, dtype=np.uint64) * np.uint64(GWEI)
    cols["act"] = np.where(rng.random(N) < 0.2, np.uint64(FAR), np.uint64(0))
    cols["ext"] = np.where(rng.random(N) < 0.7, np.uint64(FAR),
                           rng.integers(3, 8, N, dtype=np.uint64))
    cols["wd"] = np.where(cols["ext"] == np.uint64(FAR), np.uint64(FAR),
                          cols["ext"] + np.uint64(2))
    cols["sl"] = rng.random(N) < 0.1
    cols["aee"] = np.uint64(FAR)

    class Spec:
        EFFECTIVE_BALANCE_INCREMENT = GWEI

    for epoch in (0, 4, 5, 6):
        for a, b in zip(ek._epoch_masks(Spec, cols, epoch), jek._epoch_masks(Spec, cols, epoch)):
            np.testing.assert_array_equal(a, b)
        assert ek._total_active_balance(Spec, cols, epoch) \
            == jek._total_active_balance(Spec, cols, epoch)
    big = np.full(8, np.uint64(2**62))
    assert ek._masked_sum(big, np.ones(8, bool)) == jek._masked_sum(big, np.ones(8, bool)) \
        == 2**65
    np.testing.assert_array_equal(ek._mask_from_indices(N, {3, 7}),
                                  jek._mask_from_indices(N, {3, 7}))


def test_guard_limit_is_two_to_the_63():
    ek._guard(2**63 - 1)
    with pytest.raises(ek._Fallback):
        ek._guard(0, 2**63)
    jek._guard(2**63)         # the JAX engine's limit is 2^64


def test_wrappers_reject_malformed_arguments():
    z = torch.zeros(8, dtype=torch.int64)
    m = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        ek.effective_balance(z.to(torch.int32), z, 1, 1, 1, 1)
    with pytest.raises(ValueError):
        ek.slashings(z, z[:4], m, 1, 1, 1)
    with pytest.raises(ValueError):
        ek.phase0_deltas(z, z, z, m, torch.zeros((2, 8), dtype=torch.bool),
                         ek.Phase0Scalars(1, 1, 1, (1, 1, 1), 1, False, 1, 0, 1))


def test_use_vectorized_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: use_vectorized() is expected to succeed")
    with pytest.raises(RuntimeError, match="CUDA"):
        ek.use_vectorized()
    ek.use_auto()
    assert not ek.enabled() and ek.backend_name() == "loops"
    ek.use_vectorized("cpu")
    assert ek.enabled() and ek.engine_device() == torch.device("cpu")
    ek.use_auto()


# ---------------------------------------------------------------------------
# Altair: K13 altair_deltas and K14 inactivity_updates
# ---------------------------------------------------------------------------

ALTAIR_DENOM = 4 * 50331648       # INACTIVITY_SCORE_BIAS x INACTIVITY_PENALTY_QUOTIENT_ALTAIR


def altair_columns(seed):
    """Seeded Altair columns with the edges: every flag combination, zero
    balances, scores 0, 1 and the recovery rate, an eff x score product
    just under 2^63, and clamps at the first, a middle and the last of
    the four (reward, penalty) pairs."""
    rng, bal, eff, eligible, _ = columns(seed)
    scores = rng.integers(0, 100, N, dtype=np.uint64)
    part = rng.integers(0, 8, N).astype(np.uint8)
    active = rng.random(N) < 0.85
    part[:8] = np.arange(8)
    eligible[:16], active[:16], eff[:16] = True, True, np.uint64(32 * GWEI)
    scores[8:11] = [0, 1, 16]
    bal[11], part[11] = 1, 0                              # clamps at the first pair
    bal[12], part[12], scores[12] = 1, 5, 0               # at the middle pair (target)
    bal[13], part[13], scores[13] = 10 * GWEI, 5, 2**27   # at the last (inactivity)
    scores[14], part[14] = (LIMIT - 1) // (32 * GWEI), 0  # eff x score just under 2^63
    return bal, eff, eligible, scores, part, active


def altair_scalars(eff, in_leak):
    total = int(eff.sum())
    brpi = GWEI * 64 // int(np.sqrt(total))
    return ek.AltairScalars(GWEI, brpi, (14, 26, 14), (2**20 - 5, 2**20 - 9, 2**19),
                            2**20, 64, in_leak, ALTAIR_DENOM)


@pytest.mark.parametrize("in_leak", [False, True])
@pytest.mark.parametrize("flag", [0, 1, 2])
def test_flag_deltas_plain(x64, in_leak, flag):
    rng, _, eff, eligible, participating = columns(9)
    br = eff // np.uint64(GWEI) * np.uint64(3000)
    pinc, ainc, w = 2**20 - 3, 2**20, (14, 26, 14)[flag]
    br[0] = np.uint64((LIMIT - 1) // (w * pinc))          # br x w x pinc just under 2^63
    eligible[0] = participating[0] = True
    kw = dict(weight=w, weight_denominator=64, participating_increments=pinc,
              active_increments=ainc, in_leak=in_leak, is_head_flag=flag == 2)
    got = ek.flag_deltas_plain(t(br), t(eligible), t(participating), **kw)
    for want in both(jek.flag_deltas_kernel, br, eligible, participating, **kw):
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(u(g), w_)


def test_inactivity_penalty_plain(x64):
    bal, eff, eligible, scores, part, active = altair_columns(10)
    target = active & ((part >> 1) & 1).astype(bool)
    got = ek.inactivity_penalty_plain(t(eff), t(scores), t(eligible), t(target),
                                      denominator=ALTAIR_DENOM)
    for want in both(jek.inactivity_penalty_kernel, eff, scores, eligible, target,
                     denominator=ALTAIR_DENOM):
        np.testing.assert_array_equal(u(got), want)


@pytest.mark.parametrize("in_leak", [False, True])
def test_inactivity_score_plain(x64, in_leak):
    _, _, eligible, scores, part, active = altair_columns(11)
    target = active & ((part >> 1) & 1).astype(bool)
    scores[15] = np.uint64(LIMIT - 5)                     # score + bias just under 2^63
    kw = dict(bias=4, recovery_rate=16, in_leak=in_leak)
    got = ek.inactivity_score_plain(t(scores), t(eligible), t(target), **kw)
    for want in both(jek.inactivity_updates_kernel, scores, eligible, target, **kw):
        np.testing.assert_array_equal(u(got), want)
    # K14's plain version and its wrapper on CPU tensors take the flag column
    for fn in (ek.inactivity_updates_plain, ek.inactivity_updates):
        np.testing.assert_array_equal(
            u(fn(t(scores), t(part), t(eligible), t(active), 4, 16, in_leak)), u(got))


def _jax_altair_deltas(xp, eff, bal, scores, part, elig, active, s):
    """The JAX kernels composed as ``_altair_rewards_and_penalties``:
    three flag deltas and the inactivity penalty, applied pair by pair."""
    base = (eff // xp.uint64(s.increment)) * xp.uint64(s.base_reward_per_increment)
    pairs, target = [], None
    for f in range(3):
        participating = active & (((part >> f) & 1) == 1)
        if f == 1:
            target = participating
        pairs.append(jek.flag_deltas_kernel(
            xp, base, elig, participating, weight=s.weights[f],
            weight_denominator=s.weight_denominator,
            participating_increments=s.participating_increments[f],
            active_increments=s.active_increments, in_leak=s.in_leak, is_head_flag=f == 2))
    pen = jek.inactivity_penalty_kernel(xp, eff, scores, elig, target,
                                        denominator=s.inactivity_denominator)
    pairs.append((xp.zeros_like(bal), pen))
    for r, p in pairs:
        bal = jek.apply_deltas_kernel(xp, bal, r, p)
    return bal


@pytest.mark.parametrize("in_leak", [False, True])
def test_altair_deltas_plain_is_the_jax_composition(x64, in_leak):
    bal, eff, elig, scores, part, active = altair_columns(12)
    s = altair_scalars(eff, in_leak)
    got = u(ek.altair_deltas_plain(t(eff), t(bal), t(scores), t(part), t(elig), t(active), s))
    want = _jax_altair_deltas(np, eff, bal, scores, part, elig, active, s)
    np.testing.assert_array_equal(got, want)
    dev = jax.jit(lambda *a: _jax_altair_deltas(jnp, *a, s))(eff, bal, scores, part, elig,
                                                             active)
    np.testing.assert_array_equal(got, np.asarray(dev))
    wrapped = ek.altair_deltas(t(eff), t(bal), t(scores), t(part), t(elig), t(active), s)
    np.testing.assert_array_equal(u(wrapped), want)
    assert got[11] == 0 and got[13] == 0
    if not in_leak:
        # the head reward after the middle pair's clamp survives: one sum
        # of all four pairs, clamped once, would leave nothing
        assert got[12] > 0


def test_altair_wrappers_reject_malformed_arguments():
    z = torch.zeros(8, dtype=torch.int64)
    m = torch.zeros(8, dtype=torch.bool)
    p = torch.zeros(8, dtype=torch.uint8)
    s = ek.AltairScalars(1, 1, (14, 26, 14), (1, 1, 1), 1, 64, False, 1)
    with pytest.raises(TypeError):
        ek.altair_deltas(z, z, z, z, m, m, s)             # flags must be uint8
    with pytest.raises(ValueError):
        ek.inactivity_updates(z, p[:4], m, m, 4, 16, False)
    with pytest.raises(ValueError):
        ek.altair_deltas(z, z, z, p, m, m.to("meta"), s)


def test_altair_bound_helpers():
    """The bytes and operations K13/K14 need grow with the eligible lanes
    and stay within 35 and 19 bytes per lane."""
    elig = torch.tensor([True, True, False, True])
    part = torch.tensor([2, 0, 7, 7], dtype=torch.uint8)
    active = torch.tensor([True, True, True, False])
    assert ek.altair_deltas_bytes(elig, part, active) == 4 * 17 + 3 * 10 + 8 * 2
    assert ek.altair_deltas_bytes(elig, part, active) <= 35 * 4
    assert ek.inactivity_updates_bytes(elig) == 4 * 17 + 3 * 2 <= 19 * 4
    assert ek.altair_deltas_ops(elig) > ek.inactivity_updates_ops(elig) > 0
