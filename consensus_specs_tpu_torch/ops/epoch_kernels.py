"""Vectorized epoch engine for phase0 and the Altair family: kernels K10
``phase0_deltas``, K11 ``effective_balance``, K12 ``slashings``, K13
``altair_deltas`` and K14 ``inactivity_updates`` with their plain
versions, the engine switch and the ``try_process_*`` orchestrators.

Counterpart of ``consensus_specs_tpu/ops/epoch_kernels.py`` (the phase0
and Altair-family paths).  The per-validator epoch loops of ``forks/phase0.py`` are
O(validators) python passes over SSZ views; this module re-expresses
them over the state column store (``state/arrays.py``).  Each
``try_process_*`` offers its sub-transition to the mesh engine first
(``parallel/mesh_epoch.py``: the masks, masked sums, guard maxima, the
inclusion-delay scan and the registry scans on the card, K15-K17), as
the JAX engine does; when that declines (engine off, a registry below
its floor, a guard), the columnar body here runs them in host numpy, as
the JAX single-device engine does.  Either way the O(validators)
``*_kernel`` passes run on the card, fused as ``parallel/mesh_epoch.py``
composes them per shard:

  K10 ``phase0_deltas``      ``phase0_component_kernel`` x3 (:205),
                             ``phase0_inactivity_kernel`` (:223) and
                             ``apply_deltas_kernel`` (:162), as in
                             ``_p_phase0_deltas`` (mesh_epoch.py:363-416)
  K11 ``effective_balance``  ``effective_balance_kernel`` (:240), as in
                             ``_p_eff_balance`` (:473)
  K12 ``slashings``          ``slashing_penalty_kernel`` (:252) and the
                             clamped decrease, as in ``_p_slashings``
                             (:444-471)
  K13 ``altair_deltas``      ``flag_deltas_kernel`` x3 (:169),
                             ``inactivity_penalty_kernel`` (:185) and
                             ``apply_deltas_kernel`` (:162) once per pair,
                             as in ``_p_altair_deltas`` (:311-360)
  K14 ``inactivity_updates`` ``inactivity_updates_kernel`` (:192), as in
                             ``_p_inactivity`` (:418-441)

The CUDA side is ``csrc/epoch.cu``: each column read once and the
result written once; bound: bytes.  K10, K11 and K14 take one thread per
validator lane; K12 and K13 four lanes a thread, and they divide by the
exact reciprocals of their divisors (:func:`reciprocal`, packed by
:func:`slashings_params` and :func:`altair_params`), which are fixed for
the launch.  Columns are int64 tensors holding uint64 bits.  In torch,
uint64 tensors have no arithmetic, so the plain versions compute on
int64 lanes; that is exact because every lane product is guarded below
2^63 (``_guard``: the
JAX engine's limit is 2^64, so a state between the two limits runs the
spec loop here and gives the same root).  The kernels take eligibility
and activity masks as byte columns: from K15 on the mesh path, from host
numpy uint64 comparisons (``FAR_FUTURE_EPOCH`` is 2^64 - 1) on the
columnar path.

On Altair, ``process_inactivity_updates`` runs before the rewards: K14
writes the scores on the card and K13 reads them there, from the store's
pending value; scores, balances and effective balances each cross once
each way per epoch, and the previous epoch's flags go up once.

Switch: ``use_vectorized(device=None)`` (None: the card, raising
without CUDA; ``"cpu"``: the plain versions, as the tests run),
``use_loops()`` (the spec loops, the differential oracle), ``use_auto()``
(the default: the card when CUDA is available, else the loops).  A
kernel that fails to build or launch raises; a guard trip declines to
the spec loop and is counted in ``stats()``.

Bellatrix and Capella run the Altair path with the constants of their
fork lineage (:func:`inactivity_penalty_quotient`,
:func:`slashing_multiplier`): K13 takes Bellatrix's inactivity quotient
in its ``INACTIVITY_SCORE_BIAS * quotient`` scalar, K12 Bellatrix's
slashing multiplier in the adjusted total of its parameters.  From
Deneb on, the registry updates dequeue activations up to
``MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT`` (EIP-7514) and no further.

Not carried: the supervisor, fault sites and sentinel audits, the obs
registry and ``install_vectorized_epoch`` (the compiled ladder).
"""
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _build
from ..parallel import mesh_epoch
from ..state import arrays as state_arrays
from ..utils.ssz import sequence_items

_LANE_LIMIT = 1 << 63       # every lane value and product stays below it

# the spec's TIMELY_{SOURCE,TARGET,HEAD}_FLAG_INDEX (one value in every
# fork); K13 and K14 hard-code them the same way
SOURCE_FLAG, TARGET_FLAG, HEAD_FLAG = 0, 1, 2

# ---------------------------------------------------------------------------
# Runtime switch
# ---------------------------------------------------------------------------

_mode = "auto"
_device = None


def use_vectorized(device=None) -> None:
    """Force the engine on, on ``device`` (None: the card; raises without
    CUDA).  Guards can still decline to the spec loop."""
    global _mode, _device
    d = _build.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    _mode, _device = "on", d


def use_loops() -> None:
    """Force the per-validator spec loops (the differential oracle)."""
    global _mode
    _mode = "off"


def use_auto() -> None:
    """The default: the engine on the card when CUDA is available, the
    spec loops otherwise."""
    global _mode
    _mode = "auto"


def enabled() -> bool:
    if _mode == "auto":
        return torch.cuda.is_available()
    return _mode == "on"


def backend_name() -> str:
    return "vectorized" if enabled() else "loops"


def engine_device() -> torch.device:
    if _mode == "on":
        return _device
    return torch.device("cuda", torch.cuda.current_device())


_STATS = {"vectorized": 0, "loop": 0, "guard": 0}


def stats() -> dict:
    """``vectorized``: sub-transitions the engine committed; ``loop``:
    sub-transitions left to the spec loop (engine off, genesis no-op or a
    guard trip); ``guard``: the guard trips among them."""
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


class _Fallback(Exception):
    """A guard refused the array path (a lane could reach 2^63)."""


def _guard(*products) -> None:
    """Decline to the spec loop if any python-int bound reaches 2^63."""
    for p in products:
        if p >= _LANE_LIMIT:
            raise _Fallback()


# ---------------------------------------------------------------------------
# Plain versions (PyTorch, int64 lanes; any device)
# ---------------------------------------------------------------------------

def apply_deltas_plain(balances, rewards, penalties):
    """``apply_deltas_kernel``: increase_balance, then the clamped
    decrease_balance, per validator."""
    up = balances + rewards
    return torch.where(penalties > up, torch.zeros_like(up), up - penalties)


def base_reward_plain(eff, base_reward_factor, sqrt_total, base_rewards_per_epoch):
    """phase0 ``get_base_reward`` column."""
    return eff * base_reward_factor // sqrt_total // base_rewards_per_epoch


def phase0_component_plain(base_reward, eligible, attesting, *, in_leak,
                           attesting_increments, total_increments):
    """``phase0_component_kernel`` (source/target/head deltas)."""
    zero = torch.zeros_like(base_reward)
    if in_leak:
        reward = base_reward
    else:
        reward = base_reward * attesting_increments // total_increments
    rewards = torch.where(eligible & attesting, reward, zero)
    penalties = torch.where(eligible & ~attesting, base_reward, zero)
    return rewards, penalties


def phase0_inactivity_plain(base_reward, eff, eligible, target_attesting, *,
                            base_rewards_per_epoch, proposer_reward_quotient,
                            finality_delay, inactivity_penalty_quotient):
    """``phase0_inactivity_kernel`` (leak epochs only)."""
    zero = torch.zeros_like(base_reward)
    base_pen = base_rewards_per_epoch * base_reward - base_reward // proposer_reward_quotient
    extra = eff * finality_delay // inactivity_penalty_quotient
    pen = base_pen + torch.where(target_attesting, zero, extra)
    return torch.where(eligible, pen, zero)


@torch.inference_mode()
def effective_balance_plain(balances, eff, increment, downward_threshold,
                            upward_threshold, max_effective_balance):
    """``effective_balance_kernel``: the hysteresis update (plain K11)."""
    crossed = ((balances + downward_threshold < eff)
               | (eff + upward_threshold < balances))
    capped = torch.clamp(balances - balances % increment, max=max_effective_balance)
    return torch.where(crossed, capped, eff)


def slashing_penalty_plain(eff, target, *, increment, adjusted_total_slashing_balance,
                           total_balance):
    """``slashing_penalty_kernel`` (the spec's truncation order: divide by
    the total before multiplying back by the increment)."""
    penalty = eff // increment * adjusted_total_slashing_balance // total_balance * increment
    return torch.where(target, penalty, torch.zeros_like(penalty))


class Phase0Scalars(NamedTuple):
    """K10's scalars (python ints below 2^63)."""
    base_reward_factor: int
    sqrt_total: int
    base_rewards_per_epoch: int
    attesting_increments: Tuple[int, int, int]    # source, target, head
    total_increments: int
    in_leak: bool
    proposer_reward_quotient: int
    finality_delay: int
    inactivity_penalty_quotient: int


@torch.inference_mode()
def phase0_deltas_plain(eff, incl_rewards, balances, eligible, attesting, s):
    """Plain K10: the three component deltas, the inclusion rewards (an
    input), the leak's inactivity penalties, summed and applied once."""
    br = base_reward_plain(eff, s.base_reward_factor, s.sqrt_total,
                           s.base_rewards_per_epoch)
    rewards, penalties = incl_rewards, torch.zeros_like(eff)
    for c in range(3):
        r, p = phase0_component_plain(
            br, eligible, attesting[c], in_leak=s.in_leak,
            attesting_increments=s.attesting_increments[c],
            total_increments=s.total_increments)
        rewards, penalties = rewards + r, penalties + p
    if s.in_leak:
        penalties = penalties + phase0_inactivity_plain(
            br, eff, eligible, attesting[1],
            base_rewards_per_epoch=s.base_rewards_per_epoch,
            proposer_reward_quotient=s.proposer_reward_quotient,
            finality_delay=s.finality_delay,
            inactivity_penalty_quotient=s.inactivity_penalty_quotient)
    return apply_deltas_plain(balances, rewards, penalties)


@torch.inference_mode()
def slashings_plain(eff, balances, target, increment, adjusted, total_balance):
    """Plain K12: the slashing penalties subtracted with a clamp at zero."""
    pen = slashing_penalty_plain(eff, target, increment=increment,
                                 adjusted_total_slashing_balance=adjusted,
                                 total_balance=total_balance)
    return torch.where(pen > balances, torch.zeros_like(pen), balances - pen)


def flag_deltas_plain(base_reward, eligible, participating, *, weight, weight_denominator,
                      participating_increments, active_increments, in_leak, is_head_flag):
    """``flag_deltas_kernel``: one participation flag's (rewards,
    penalties) (Altair ``get_flag_index_deltas``)."""
    zero = torch.zeros_like(base_reward)
    if in_leak:
        rewards = zero
    else:
        reward = base_reward * weight * participating_increments \
            // (active_increments * weight_denominator)
        rewards = torch.where(eligible & participating, reward, zero)
    if is_head_flag:
        return rewards, zero
    penalty = base_reward * weight // weight_denominator
    return rewards, torch.where(eligible & ~participating, penalty, zero)


def inactivity_penalty_plain(eff, scores, eligible, target_participating, *, denominator):
    """``inactivity_penalty_kernel``: the score-scaled penalties of the
    eligible lanes without the target flag."""
    penalty = eff * scores // denominator
    return torch.where(eligible & ~target_participating, penalty, torch.zeros_like(penalty))


def inactivity_score_plain(scores, eligible, participating, *, bias, recovery_rate, in_leak):
    """``inactivity_updates_kernel``: the score transition of
    ``process_inactivity_updates`` (``participating``: the target flag)."""
    bumped = torch.where(participating, scores - torch.clamp(scores, max=1), scores + bias)
    if not in_leak:
        bumped = bumped - torch.clamp(bumped, max=recovery_rate)
    return torch.where(eligible, bumped, scores)


def has_flag_plain(part, active, flag: int):
    """The lanes of ``get_unslashed_participating_indices``: ``active``
    (active in the previous epoch and not slashed) holding ``flag``."""
    return active & ((part >> flag) & 1).bool()


class AltairScalars(NamedTuple):
    """K13's scalars (python ints below 2^63)."""
    increment: int
    base_reward_per_increment: int
    weights: Tuple[int, int, int]                     # source, target, head
    participating_increments: Tuple[int, int, int]
    active_increments: int
    weight_denominator: int
    in_leak: bool
    inactivity_denominator: int                       # bias x quotient


@torch.inference_mode()
def altair_deltas_plain(eff, balances, scores, part_prev, eligible, active, s):
    """Plain K13: the three flag deltas and the inactivity penalties,
    applied pair by pair (each pair's decrease clamps at zero before the
    next pair applies, as the spec's loop over the deltas does)."""
    base = eff // s.increment * s.base_reward_per_increment
    bal = balances
    for f in (SOURCE_FLAG, TARGET_FLAG, HEAD_FLAG):
        r, p = flag_deltas_plain(
            base, eligible, has_flag_plain(part_prev, active, f), weight=s.weights[f],
            weight_denominator=s.weight_denominator,
            participating_increments=s.participating_increments[f],
            active_increments=s.active_increments, in_leak=s.in_leak,
            is_head_flag=f == HEAD_FLAG)
        bal = apply_deltas_plain(bal, r, p)
    pen = inactivity_penalty_plain(eff, scores, eligible,
                                   has_flag_plain(part_prev, active, TARGET_FLAG),
                                   denominator=s.inactivity_denominator)
    return apply_deltas_plain(bal, torch.zeros_like(bal), pen)


@torch.inference_mode()
def inactivity_updates_plain(scores, part_prev, eligible, active, bias, recovery_rate,
                             in_leak):
    """Plain K14: the new inactivity scores."""
    return inactivity_score_plain(scores, eligible,
                                  has_flag_plain(part_prev, active, TARGET_FLAG),
                                  bias=bias, recovery_rate=recovery_rate, in_leak=in_leak)


# ---------------------------------------------------------------------------
# Kernel wrappers (the plain version for CPU tensors only)
# ---------------------------------------------------------------------------

def _columns(n, *named):
    for t, name, dtype in named:
        _build.check(t, name, dtype, (n,))


def phase0_deltas(eff, incl_rewards, balances, eligible, attesting, s: Phase0Scalars):
    """K10: new balances after the attestation deltas.  ``eff``,
    ``incl_rewards``, ``balances``: (V,) int64 holding uint64 bits;
    ``eligible``: (V,) bool; ``attesting``: (3, V) bool (source, target,
    head); ``s``: the scalars.  Bound: bytes (:func:`phase0_deltas_bytes`)."""
    dev = _build.same_device(eff, incl_rewards, balances, eligible, attesting)
    n = balances.shape[0]
    _columns(n, (eff, "eff", torch.int64), (incl_rewards, "incl_rewards", torch.int64),
             (balances, "balances", torch.int64), (eligible, "eligible", torch.bool))
    _build.check(attesting, "attesting", torch.bool, (3, n))
    if dev.type == "cpu":
        return phase0_deltas_plain(eff, incl_rewards, balances, eligible, attesting, s)
    out = torch.empty_like(balances)
    params = torch.tensor([s.base_reward_factor, s.sqrt_total, s.base_rewards_per_epoch,
                           *s.attesting_increments, s.total_increments, int(s.in_leak),
                           s.proposer_reward_quotient, s.finality_delay,
                           s.inactivity_penalty_quotient], dtype=torch.int64)
    if n:
        _build.launch("phase0_deltas", eff, incl_rewards, balances, eligible, attesting,
                      out, n, params)
    return out


def effective_balance(balances, eff, increment, down, up, max_effective_balance):
    """K11: the new effective balances.  ``balances``, ``eff``: (V,) int64
    holding uint64 bits.  Bound: bytes (24 B per lane)."""
    dev = _build.same_device(balances, eff)
    n = balances.shape[0]
    _columns(n, (balances, "balances", torch.int64), (eff, "eff", torch.int64))
    if dev.type == "cpu":
        return effective_balance_plain(balances, eff, increment, down, up,
                                       max_effective_balance)
    out = torch.empty_like(eff)
    if n:
        _build.launch("effective_balance", balances, eff, out, n, increment, down, up,
                      max_effective_balance)
    return out


def slashings(eff, balances, target, increment, adjusted, total_balance):
    """K12: balances after the slashing penalties of the ``target`` lanes
    (clamped at zero).  ``eff``, ``balances``: (V,) int64 holding uint64
    bits; ``target``: (V,) bool.  CUDA: one launch, four lanes a thread,
    both divisions by reciprocals from :func:`slashings_params`.  Bound:
    bytes (:func:`slashings_bytes`)."""
    dev = _build.same_device(eff, balances, target)
    n = balances.shape[0]
    _columns(n, (eff, "eff", torch.int64), (balances, "balances", torch.int64),
             (target, "target", torch.bool))
    if dev.type == "cpu":
        return slashings_plain(eff, balances, target, increment, adjusted, total_balance)
    out = torch.empty_like(balances)
    if n:
        _build.launch("slashings", eff, balances, target, out, n,
                      slashings_params(increment, adjusted, total_balance))
    return out


def altair_deltas(eff, balances, scores, part_prev, eligible, active, s: AltairScalars):
    """K13: new balances after the flag and inactivity deltas.  ``eff``,
    ``balances``, ``scores``: (V,) int64 holding uint64 bits;
    ``part_prev``: (V,) uint8 previous-epoch flags; ``eligible``,
    ``active`` (active in the previous epoch and unslashed): (V,) bool;
    ``s``: the scalars.  CUDA: one launch, four lanes a thread, each
    division by a reciprocal from :func:`altair_params`.  Bound: bytes
    (:func:`altair_deltas_bytes`)."""
    dev = _build.same_device(eff, balances, scores, part_prev, eligible, active)
    n = balances.shape[0]
    _columns(n, (eff, "eff", torch.int64), (balances, "balances", torch.int64),
             (scores, "scores", torch.int64), (part_prev, "part_prev", torch.uint8),
             (eligible, "eligible", torch.bool), (active, "active", torch.bool))
    if dev.type == "cpu":
        return altair_deltas_plain(eff, balances, scores, part_prev, eligible, active, s)
    out = torch.empty_like(balances)
    if n:
        _build.launch("altair_deltas", eff, balances, scores, part_prev, eligible, active,
                      out, n, altair_params(s))
    return out


def reciprocal(d: int) -> Tuple[int, int]:
    """(m, l) for an exact division by ``d`` (1 <= d < 2^64) as the kernels
    make it (``csrc/udiv.cuh``; Granlund and Montgomery, PLDI 1994): for
    d = 2^k, (0, k), a shift; else l = ceil(log2 d) and
    m = floor(2^64 (2^l - d) / d) + 1, so that for every 64-bit n, with
    t = (m n) >> 64, n // d = (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0)."""
    if not 1 <= d < 1 << 64:
        raise ValueError(f"reciprocal: divisor {d} outside [1, 2^64)")
    if d & (d - 1) == 0:
        return 0, d.bit_length() - 1
    ell = d.bit_length()
    return ((1 << 64) * ((1 << ell) - d)) // d + 1, ell


def altair_params(s: AltairScalars) -> torch.Tensor:
    """K13's host parameter array (``AltairParams`` in csrc/epoch.cu), int64
    holding uint64 bits: the increment, the base reward per increment, the
    three weights and participating increments, the reward denominator
    (active increments x weight denominator), the weight denominator, the
    leak flag, the inactivity denominator, then :func:`reciprocal` of the
    increment, the reward, weight and inactivity denominators."""
    reward_den = s.active_increments * s.weight_denominator
    words = [s.increment, s.base_reward_per_increment, *s.weights, *s.participating_increments,
             reward_den, s.weight_denominator, int(s.in_leak), s.inactivity_denominator]
    for d in (s.increment, reward_den, s.weight_denominator, s.inactivity_denominator):
        words += reciprocal(d)
    return torch.tensor([mesh_epoch.bits64(w) for w in words], dtype=torch.int64)


def slashings_params(increment: int, adjusted: int, total_balance: int) -> torch.Tensor:
    """K12's host parameter array (``SLASHINGS_PARAMS`` words in
    csrc/epoch.cu), int64 holding uint64 bits: the increment, the adjusted
    total slashing balance, the total balance, then :func:`reciprocal` of
    the increment and of the total balance."""
    words = [increment, adjusted, total_balance, *reciprocal(increment),
             *reciprocal(total_balance)]
    return torch.tensor([mesh_epoch.bits64(w) for w in words], dtype=torch.int64)


def inactivity_updates(scores, part_prev, eligible, active, bias, recovery_rate, in_leak):
    """K14: the new inactivity scores.  ``scores``: (V,) int64 holding
    uint64 bits; ``part_prev``: (V,) uint8; ``eligible``, ``active``:
    (V,) bool.  Bound: bytes (:func:`inactivity_updates_bytes`)."""
    dev = _build.same_device(scores, part_prev, eligible, active)
    n = scores.shape[0]
    _columns(n, (scores, "scores", torch.int64), (part_prev, "part_prev", torch.uint8),
             (eligible, "eligible", torch.bool), (active, "active", torch.bool))
    if dev.type == "cpu":
        return inactivity_updates_plain(scores, part_prev, eligible, active, bias,
                                        recovery_rate, in_leak)
    out = torch.empty_like(scores)
    if n:
        _build.launch("inactivity_updates", scores, part_prev, eligible, active, out, n,
                      bias, recovery_rate, int(in_leak))
    return out


def phase0_deltas_bytes(eligible) -> int:
    """Bytes K10's function must move: balances, inclusion rewards and the
    eligibility mask of every lane read, the new balances written, and the
    effective balance and three attester flags of the eligible lanes."""
    n, e = eligible.numel(), int(eligible.sum())
    return n * (8 + 8 + 1 + 8) + e * (8 + 3)


def effective_balance_bytes(n: int) -> int:
    """Bytes K11 must move: two columns read, one written."""
    return 24 * n


def slashings_bytes(target) -> int:
    """Bytes K12 must move: balances and the target mask read, the new
    balances written, and the effective balance of the target lanes."""
    return target.numel() * (8 + 1 + 8) + 8 * int(target.sum())


def altair_deltas_bytes(eligible, part_prev, active) -> int:
    """Bytes K13's function must move: balances and the eligibility mask
    of every lane read and the new balances written; the effective
    balance, flags and activity mask of the eligible lanes; the score of
    the eligible lanes without the target flag (at most 35 B per lane)."""
    target = has_flag_plain(part_prev, active, TARGET_FLAG)
    n, e = eligible.numel(), int(eligible.sum())
    return n * (8 + 1 + 8) + e * (8 + 1 + 1) + 8 * int((eligible & ~target).sum())


def inactivity_updates_bytes(eligible) -> int:
    """Bytes K14 must move: scores and the eligibility mask read and the
    new scores written on every lane; flags and activity mask of the
    eligible lanes (at most 19 B per lane)."""
    return eligible.numel() * (8 + 1 + 8) + 2 * int(eligible.sum())


def altair_deltas_ops(eligible) -> int:
    """64-bit integer operations K13's function does (one each): per lane
    the select of the result; per eligible lane the base reward (2), per
    flag a bit test (2), a reward (3) or a penalty (2) and the clamped
    application (3), and the inactivity penalty with its clamp (4)."""
    return eligible.numel() + int(eligible.sum()) * (2 + 3 * 8 + 4)


def inactivity_updates_ops(eligible) -> int:
    """Per lane a select; per eligible lane a bit test (2), the bump (2)
    and the recovery (2)."""
    return eligible.numel() + 6 * int(eligible.sum())


def phase0_deltas_ops(eligible, in_leak: bool) -> int:
    """64-bit integer operations K10's function does (one each): per lane
    the sum and the clamped subtraction (3); per eligible lane the base
    reward (3) and three components (4 each), and in a leak the
    inactivity penalty (7)."""
    n, e = eligible.numel(), int(eligible.sum())
    return 3 * n + e * (15 + (7 if in_leak else 0))


def effective_balance_ops(n: int) -> int:
    """Two sums, two compares, a remainder, a subtraction, a min and a
    select per lane."""
    return 8 * n


def slashings_ops(target) -> int:
    """A compare and a select per lane; two divisions, two products, a
    compare and a subtraction per target lane."""
    return 2 * target.numel() + 6 * int(target.sum())


# ---------------------------------------------------------------------------
# Host helpers (numpy uint64, exact)
# ---------------------------------------------------------------------------

def _fork_lineage(spec) -> frozenset:
    """Fork names along the spec class's inheritance chain (every class
    stamps ``fork``)."""
    return frozenset(c.__dict__["fork"] for c in type(spec).__mro__
                     if isinstance(c.__dict__.get("fork"), str))


def inactivity_penalty_quotient(spec) -> int:
    """The Altair-family inactivity penalty quotient of the spec's fork
    lineage: Bellatrix's from Bellatrix on, else Altair's."""
    if "bellatrix" in _fork_lineage(spec):
        return int(spec.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX)
    return int(spec.INACTIVITY_PENALTY_QUOTIENT_ALTAIR)


def slashing_multiplier(spec) -> int:
    """The proportional slashing multiplier of the spec's fork lineage:
    Bellatrix's from Bellatrix on, Altair's on Altair, else phase0's."""
    lineage = _fork_lineage(spec)
    if "bellatrix" in lineage:
        return int(spec.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX)
    if "altair" in lineage:
        return int(spec.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR)
    return int(spec.PROPORTIONAL_SLASHING_MULTIPLIER)


def _masked_sum(eff, mask) -> int:
    """Exact python-int sum of a masked uint64 column."""
    sub = eff[mask]
    if sub.size == 0:
        return 0
    mx = int(sub.max())
    if mx and sub.size > ((1 << 64) - 1) // mx:
        return sum(int(x) for x in sub.tolist())
    return int(sub.sum(dtype=np.uint64))


def _epoch_masks(spec, cols, previous_epoch):
    """Active-at-previous-epoch and reward-eligibility masks
    (``get_eligible_validator_indices``)."""
    prev = np.uint64(previous_epoch)
    active_prev = (cols["act"] <= prev) & (prev < cols["ext"])
    eligible = active_prev | (cols["sl"] & (np.uint64(previous_epoch + 1) < cols["wd"]))
    return active_prev, eligible


def _total_active_balance(spec, cols, current_epoch) -> int:
    """``get_total_active_balance`` from columns (same increment clamp)."""
    cur = np.uint64(current_epoch)
    active = (cols["act"] <= cur) & (cur < cols["ext"])
    return max(int(spec.EFFECTIVE_BALANCE_INCREMENT), _masked_sum(cols["eff"], active))


def _mask_from_indices(n, indices) -> np.ndarray:
    mask = np.zeros(n, dtype=bool)
    if indices:
        mask[np.fromiter(indices, dtype=np.int64, count=len(indices))] = True
    return mask


def _run(state, fn, *args) -> bool:
    """Run one engine sub-transition; a guard trip flushes the store and
    declines to the spec loop."""
    try:
        fn(*args)
    except _Fallback:
        state_arrays.flush(state)
        _STATS["guard"] += 1
        _STATS["loop"] += 1
        return False
    _STATS["vectorized"] += 1
    return True


def _decline(state) -> bool:
    state_arrays.flush(state)
    _STATS["loop"] += 1
    return False


def _mesh_committed() -> bool:
    """The mesh engine committed the sub-transition."""
    _STATS["vectorized"] += 1
    return True


# ---------------------------------------------------------------------------
# process_rewards_and_penalties
# ---------------------------------------------------------------------------

def try_process_rewards_and_penalties(spec, state) -> bool:
    if not enabled():
        return _decline(state)
    if spec.get_current_epoch(state) == spec.GENESIS_EPOCH:
        _STATS["loop"] += 1
        return False    # the spec body is a no-op early return
    if mesh_epoch.try_rewards_and_penalties(spec, state):
        return _mesh_committed()
    fn = (_altair_rewards_and_penalties if "altair" in _fork_lineage(spec)
          else _phase0_rewards_and_penalties)
    return _run(state, fn, spec, state, engine_device())


def _base_reward_host(eff, brf, sqrt_total, brpe):
    return eff * np.uint64(brf) // np.uint64(sqrt_total) // np.uint64(brpe)


def _phase0_rewards_and_penalties(spec, state, dev) -> None:
    """``get_attestation_deltas`` and the balance-update loop: the
    attester sets and the inclusion-delay pass on the host, every
    O(validators) delta in K10."""
    prev_epoch = spec.get_previous_epoch(state)
    # spec helpers first: their assertions must fire as in the loop
    # path, before any write
    src_atts = spec.get_matching_source_attestations(state, prev_epoch)
    tgt_atts = spec.get_matching_target_attestations(state, prev_epoch)
    head_atts = spec.get_matching_head_attestations(state, prev_epoch)
    src_set = spec.get_unslashed_attesting_indices(state, src_atts)
    tgt_set = spec.get_unslashed_attesting_indices(state, tgt_atts)
    head_set = spec.get_unslashed_attesting_indices(state, head_atts)

    sa = state_arrays.of(state)
    cols = sa.registry()
    n = len(cols)
    if n == 0:
        return
    eff = cols["eff"]
    _, eligible = _epoch_masks(spec, cols, int(prev_epoch))
    total_balance = _total_active_balance(spec, cols, int(spec.get_current_epoch(state)))
    _guard(total_balance)
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    total_increments = total_balance // increment
    in_leak = bool(spec.is_in_inactivity_leak(state))
    sqrt_total = int(spec.integer_squareroot(total_balance))
    brf, brpe = int(spec.BASE_REWARD_FACTOR), int(spec.BASE_REWARDS_PER_EPOCH)
    prq = int(spec.PROPOSER_REWARD_QUOTIENT)
    max_eff = int(eff.max(initial=0))
    _guard(max_eff * brf)
    br_max = max_eff * brf // sqrt_total // brpe

    masks, att_increments, rew_bound = [], [], 0
    for att_set in (src_set, tgt_set, head_set):
        mask = _mask_from_indices(n, att_set)
        att_inc = max(increment, _masked_sum(eff, mask)) // increment
        _guard(br_max * att_inc)
        masks.append(mask)
        att_increments.append(att_inc)
        rew_bound += br_max if in_leak else br_max * att_inc // total_increments

    # inclusion-delay rewards: one ordered pass over the source
    # attestations finds each attester's earliest-included attestation
    # (the spec's min() keeps the first minimum, hence the strict <);
    # np.add.at lets several proposer cuts land on one index
    best_delay = np.full(n, (1 << 64) - 1, dtype=np.uint64)
    best_proposer = np.zeros(n, dtype=np.int64)
    for att in src_atts:
        idxs = spec.get_attesting_indices(state, att.data, att.aggregation_bits)
        if not idxs:
            continue
        ii = np.fromiter(idxs, dtype=np.int64, count=len(idxs))
        upd = np.uint64(int(att.inclusion_delay)) < best_delay[ii]
        sel = ii[upd]
        best_delay[sel] = np.uint64(int(att.inclusion_delay))
        best_proposer[sel] = int(att.proposer_index)
    incl_rewards = np.zeros(n, dtype=np.uint64)
    src_idx = np.nonzero(masks[0])[0]
    if src_idx.size:
        br_src = _base_reward_host(eff[src_idx], brf, sqrt_total, brpe)
        pr_src = br_src // np.uint64(prq)
        incl_rewards[src_idx] = (br_src - pr_src) // best_delay[src_idx]
        # every attester's proposer cut could land on ONE proposer index
        _guard(br_max + src_idx.size * (br_max // prq))
        np.add.at(incl_rewards, best_proposer[src_idx], pr_src)
    rew_bound += int(incl_rewards.max(initial=0))

    finality_delay = int(spec.get_finality_delay(state))
    ipq = int(spec.INACTIVITY_PENALTY_QUOTIENT)
    pen_bound = 3 * br_max
    if in_leak:
        # base_pen + extra is one lane sum: bound the two together
        _guard(brpe * br_max + max_eff * finality_delay)
        pen_bound += brpe * br_max + max_eff * finality_delay // ipq
    bal_bound = sa.balances_bound()
    _guard(rew_bound, pen_bound, bal_bound + rew_bound)

    scalars = Phase0Scalars(brf, sqrt_total, brpe, tuple(att_increments), total_increments,
                            in_leak, prq, finality_delay, ipq)
    new = phase0_deltas(
        sa.registry_card("eff", dev),
        state_arrays.upload(incl_rewards, dev, "incl_rewards"),
        sa.balances_card(dev),
        state_arrays.upload(eligible, dev, "masks"),
        state_arrays.upload(np.stack(masks), dev, "masks"),
        scalars)
    sa.set_balances_card(new, bal_bound + rew_bound)


def _altair_masks(spec, state, cols):
    """Eligibility and ``active`` (active in the previous epoch, not
    slashed: the lanes a flag can count on) masks."""
    active_prev, eligible = _epoch_masks(spec, cols, int(spec.get_previous_epoch(state)))
    return eligible, active_prev & ~cols["sl"]


def _altair_rewards_and_penalties(spec, state, dev) -> None:
    """Altair's flag deltas and inactivity penalties: the participating
    balances on the host, every O(validators) delta in K13, applied pair
    by pair.  The scores are the store's current value: what
    ``process_inactivity_updates`` wrote earlier in this epoch, still on
    the card, as the spec loop would read them from SSZ."""
    sa = state_arrays.of(state)
    cols = sa.registry()
    n = len(cols)
    if n == 0:
        return
    eff = cols["eff"]
    eligible, active = _altair_masks(spec, state, cols)
    total_balance = _total_active_balance(spec, cols, int(spec.get_current_epoch(state)))
    _guard(total_balance)
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    active_increments = total_balance // increment
    in_leak = bool(spec.is_in_inactivity_leak(state))
    wd = int(spec.WEIGHT_DENOMINATOR)
    _guard(active_increments * wd)
    brpi = increment * int(spec.BASE_REWARD_FACTOR) // math.isqrt(total_balance)
    max_eff = int(eff.max(initial=0))
    br_max = (max_eff // increment) * brpi
    _guard(br_max)
    flags = sa.participation("previous")
    weights = tuple(int(w) for w in spec.PARTICIPATION_FLAG_WEIGHTS)
    part_inc, bal_bound = [], sa.balances_bound()
    for f, w in enumerate(weights):
        mask = active & (((flags >> np.uint8(f)) & np.uint8(1)) == np.uint8(1))
        up_inc = max(increment, _masked_sum(eff, mask)) // increment
        _guard(br_max * w * up_inc)
        part_inc.append(up_inc)
        # the pairs apply one after another: each may raise the maximum
        reward = 0 if in_leak else br_max * w * up_inc // (active_increments * wd)
        _guard(bal_bound + reward)
        bal_bound += reward
    quotient = inactivity_penalty_quotient(spec)
    _guard(max_eff * sa.column_bound("inactivity_scores"))
    s = AltairScalars(increment, brpi, weights, tuple(part_inc), active_increments, wd,
                      in_leak, int(spec.config.INACTIVITY_SCORE_BIAS) * quotient)
    new = altair_deltas(
        sa.registry_card("eff", dev), sa.balances_card(dev), sa.column_card("inactivity_scores", dev),
        sa.participation_card("previous", dev), state_arrays.upload(eligible, dev, "masks"),
        state_arrays.upload(active, dev, "masks"), s)
    sa.set_balances_card(new, bal_bound)


# ---------------------------------------------------------------------------
# process_inactivity_updates (Altair)
# ---------------------------------------------------------------------------

def try_process_inactivity_updates(spec, state) -> bool:
    if not enabled():
        return _decline(state)
    if spec.get_current_epoch(state) == spec.GENESIS_EPOCH \
            or "altair" not in _fork_lineage(spec):
        _STATS["loop"] += 1
        return False    # the spec body is a no-op early return
    if mesh_epoch.try_inactivity_updates(spec, state):
        return _mesh_committed()
    return _run(state, _inactivity_updates, spec, state, engine_device())


def _inactivity_updates(spec, state, dev) -> None:
    """The score transition in K14; the new scores stay on the card with
    the bound "old maximum plus bias" beside them."""
    sa = state_arrays.of(state)
    cols = sa.registry()
    if len(cols) == 0:
        return
    eligible, active = _altair_masks(spec, state, cols)
    bias = int(spec.config.INACTIVITY_SCORE_BIAS)
    bound = sa.column_bound("inactivity_scores") + bias
    _guard(bound)
    new = inactivity_updates(
        sa.column_card("inactivity_scores", dev), sa.participation_card("previous", dev),
        state_arrays.upload(eligible, dev, "masks"), state_arrays.upload(active, dev, "masks"),
        bias, int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE),
        bool(spec.is_in_inactivity_leak(state)))
    sa.set_column_card("inactivity_scores", new, bound)


# ---------------------------------------------------------------------------
# process_registry_updates
# ---------------------------------------------------------------------------

def try_process_registry_updates(spec, state) -> bool:
    if not enabled():
        return _decline(state)
    if mesh_epoch.try_registry_updates(spec, state):
        return _mesh_committed()
    return _run(state, _registry_updates, spec, state)


def _registry_updates(spec, state) -> None:
    """Eligibility scans and the activation-queue sort as array ops; the
    exit-queue recurrence of the ejections is simulated incrementally.
    Registry writes are copy-on-write and paired with the SSZ writes."""
    sa = state_arrays.of(state)
    cols = sa.registry()
    if len(cols) == 0:
        return
    current_epoch = int(spec.get_current_epoch(state))
    far_future = int(spec.FAR_FUTURE_EPOCH)
    aee = cols["aee"]
    queue_mask = (aee == np.uint64(far_future)) \
        & (cols["eff"] == np.uint64(int(spec.MAX_EFFECTIVE_BALANCE)))
    cur = np.uint64(current_epoch)
    active_cur = (cols["act"] <= cur) & (cur < cols["ext"])
    eject_mask = active_cur & (cols["eff"] <= np.uint64(int(spec.config.EJECTION_BALANCE)))
    # stamped-this-epoch entries carry aee == current_epoch + 1 > finalized
    # and unstamped candidates FAR_FUTURE_EPOCH: neither passes the
    # finalized bound, so this scan commutes with the stamps below
    eligible_mask = (aee <= np.uint64(int(state.finalized_checkpoint.epoch))) \
        & (cols["act"] == np.uint64(far_future))
    active_count = int(active_cur.sum(dtype=np.int64))
    _registry_apply_idx(spec, state, sa, cols, np.nonzero(queue_mask)[0],
                        np.nonzero(eject_mask)[0], np.nonzero(eligible_mask)[0],
                        active_count)


def _registry_apply_idx(spec, state, sa, cols, queue_idx, eject_idx, eligible_idx,
                        active_count) -> None:
    """Churn-ordered resolution of the registry scans: activation-queue
    stamps, the per-ejection exit-queue recurrence, and the
    (activation_eligibility_epoch, index)-sorted dequeue.  The written
    columns' card copies, where there are any, get the written lanes
    (:func:`_scatter_registry_card`) instead of going up again."""
    validators = sequence_items(state.validators)
    current_epoch = int(spec.get_current_epoch(state))
    far_future = int(spec.FAR_FUTURE_EPOCH)
    cards = sa.registry_cards()     # before the first write: the cell is fresh
    written = {}                    # column -> the lanes written
    wcols = None

    def writable(*fields):
        # copy-on-write BEFORE the paired SSZ writes: the generation bump
        # would otherwise read as a stale cell and re-extract.  Once per
        # call: after the first SSZ writes the cell is stale by design
        # until mark_registry_committed, so a later step only drops the
        # card copies of the columns it writes
        nonlocal wcols, cols
        if wcols is None:
            wcols = sa.registry_writable(*fields)
            cols = wcols
        else:
            sa.drop_registry_card(*fields)
        return wcols

    if queue_idx.size:
        stamp = current_epoch + 1
        aee = writable("aee")["aee"]
        for i in queue_idx.tolist():
            validators[i].activation_eligibility_epoch = stamp
        aee[queue_idx] = np.uint64(stamp)
        written["aee"] = queue_idx

    # ejections in index order; the churn limit is constant across them
    # (assigned exit epochs are all in the future)
    churn = max(int(spec.config.MIN_PER_EPOCH_CHURN_LIMIT),
                active_count // int(spec.config.CHURN_LIMIT_QUOTIENT))
    if eject_idx.size:
        w = writable("ext", "wd")
        ext, wd = w["ext"], w["wd"]
        # the exit-queue seed is a property of the full exit column
        exited = ext[ext != np.uint64(far_future)]
        queue_epoch = current_epoch + 1 + int(spec.MAX_SEED_LOOKAHEAD)
        if exited.size:
            queue_epoch = max(queue_epoch, int(exited.max()))
        queue_churn = int((ext == np.uint64(queue_epoch)).sum(dtype=np.int64))
        delay = int(spec.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)
        _guard(queue_epoch + eject_idx.size + delay)
        exits = []
        for i in eject_idx.tolist():
            if int(ext[i]) != far_future:
                continue
            exits.append(i)
            if queue_churn >= churn:
                queue_epoch += 1
                queue_churn = 0
            queue_churn += 1
            ext[i] = np.uint64(queue_epoch)
            wd[i] = np.uint64(queue_epoch + delay)
            validators[i].exit_epoch = queue_epoch
            validators[i].withdrawable_epoch = queue_epoch + delay
        written["ext"] = written["wd"] = np.array(exits, dtype=np.int64)

    # activations: eligibles sorted by (activation_eligibility_epoch,
    # index), dequeued up to the fork's activation churn limit
    idx = eligible_idx
    if idx.size:
        aee = cols["aee"]
        activation_churn = churn
        if "deneb" in _fork_lineage(spec):
            activation_churn = min(int(spec.MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT), churn)
        take = idx[np.lexsort((idx, aee[idx]))][:activation_churn].tolist()
        if take:
            activation_epoch = current_epoch + 1 + int(spec.MAX_SEED_LOOKAHEAD)
            act = writable("act")["act"]
            for i in take:
                validators[i].activation_epoch = activation_epoch
                act[i] = np.uint64(activation_epoch)
            written["act"] = np.array(take, dtype=np.int64)

    if wcols is not None:
        sa.mark_registry_committed(card=_scatter_registry_card(cards, written, cols))


def _scatter_registry_card(cards, written, cols) -> dict:
    """New card copies of the written registry columns that had one: the
    old copy with the written lanes replaced, out of place (forks share
    card copies), after one upload of every lane index and value."""
    parts = [(f, np.asarray(idx, dtype=np.int64)) for f, idx in written.items() if f in cards]
    if not parts:
        return {}
    flat = np.concatenate([np.concatenate([idx, cols[f][idx].view(np.int64)])
                           for f, idx in parts])
    lanes = state_arrays.upload(flat, cards[parts[0][0]].device, "registry_lanes") \
        if flat.size else None
    out, off = {}, 0
    for f, idx in parts:
        m = idx.size
        out[f] = cards[f].index_put((lanes[off:off + m],), lanes[off + m:off + 2 * m]) \
            if m else cards[f]
        off += 2 * m
    return out


# ---------------------------------------------------------------------------
# process_slashings
# ---------------------------------------------------------------------------

def try_process_slashings(spec, state) -> bool:
    if not enabled():
        return _decline(state)
    multiplier = slashing_multiplier(spec)
    if mesh_epoch.try_slashings(spec, state, multiplier):
        return _mesh_committed()
    return _run(state, _slashings, spec, state, multiplier, engine_device())


def _slashings(spec, state, multiplier, dev) -> None:
    sa = state_arrays.of(state)
    cols = sa.registry()
    if len(cols) == 0:
        return
    epoch = int(spec.get_current_epoch(state))
    total_balance = _total_active_balance(spec, cols, epoch)
    _guard(total_balance)
    slashed_sum = sum(int(s) for s in sequence_items(state.slashings))
    adjusted = min(slashed_sum * multiplier, total_balance)
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    target_epoch = epoch + int(spec.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    _guard(target_epoch)
    target = cols["sl"] & (cols["wd"] == np.uint64(target_epoch))
    if not target.any():
        return
    _guard((int(cols["eff"].max(initial=0)) // increment) * adjusted)
    bound = sa.balances_bound()     # a decrease keeps the bound
    new = slashings(sa.registry_card("eff", dev), sa.balances_card(dev),
                    state_arrays.upload(target, dev, "masks"), increment, adjusted,
                    total_balance)
    sa.set_balances_card(new, bound)


# ---------------------------------------------------------------------------
# process_effective_balance_updates
# ---------------------------------------------------------------------------

def try_process_effective_balance_updates(spec, state) -> bool:
    if not enabled():
        return _decline(state)
    if mesh_epoch.try_effective_balance_updates(spec, state):
        return _mesh_committed()
    return _run(state, _effective_balance_updates, spec, state, engine_device())


def _effective_balance_updates(spec, state, dev) -> None:
    sa = state_arrays.of(state)
    cols = sa.registry()
    if len(cols) == 0:
        return
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    hysteresis_increment = increment // int(spec.HYSTERESIS_QUOTIENT)
    down = hysteresis_increment * int(spec.HYSTERESIS_DOWNWARD_MULTIPLIER)
    up = hysteresis_increment * int(spec.HYSTERESIS_UPWARD_MULTIPLIER)
    eff = cols["eff"]
    # the store's balances include this transition's deferred writes,
    # which is what the spec loop would read
    _guard(sa.balances_bound() + down, int(eff.max(initial=0)) + up)
    new_c = effective_balance(sa.balances_card(dev), sa.registry_card("eff", dev),
                              increment, down, up, int(spec.MAX_EFFECTIVE_BALANCE))
    new_eff = state_arrays.download(new_c, "eff")
    changed = np.nonzero(eff != new_eff)[0]
    if changed.size == 0:
        return
    sa.registry_writable("eff")["eff"] = new_eff
    validators = sequence_items(state.validators)
    for i in changed.tolist():
        validators[i].effective_balance = int(new_eff[i])
    sa.mark_registry_committed(card={"eff": new_c})
