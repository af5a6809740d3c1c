"""G1 multi-scalar multiplication: kernels K7 ``expand_windows`` and K8
``g1_msm`` with their plain versions, and the host entry ``g1_msm``.

Counterpart of ``consensus_specs_tpu/ops/jax_bls/msm.py``; the CUDA side
is ``csrc/msm.cu`` over ``csrc/points.cuh``.  The MSM behind the KZG
library's ``g1_lincomb`` (``specs/deneb/polynomial-commitments.md:268``):

1. K7 expands each point into its 32 window multiples
   ``W[w][i] = [2^(8w)] P_i`` (8 doublings per window), once per fixed
   basis (the trusted setup, kept on the card by ``_setup_cache``) or
   once per call for any other basis;
2. K8 sums ``[d_{w,i}] W[w][i]`` over every (window, point) lane, d the
   w-th byte of scalar i read straight from its words, by Pippenger's
   bucket method: the table already carries each window's weight, so all
   lanes share one set of 255 buckets and the result is
   ``sum_d d B_d``.  The lanes are sorted into bucket order, each
   bucket's run is summed in chunks of at most :data:`FIRST_CHUNK`
   points over a few levels (:func:`msm_plan`), and the 255 bucket sums
   are weighted through their digits' bits and normalized.

K7 replaces ``msm.py:38`` ``_expand_windows``; K8 replaces ``msm.py:48``
``_msm_core`` (``points.py:244`` ``g1_scalar_mul``, ``:252``
``g1_tree_sum``, ``:306`` ``g1_normalize``) and the host digit planes of
``:55`` ``_digits_msb_bits``.  Scalars travel as ``(N, 8)`` int32 words
of the canonical scalar, little-endian.  The window table is projective
``(32, N, 3, 12)`` int32 words (Montgomery form), window-major.
"""
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..utils.lru import LRUDict
from .bls12_381.curve import G1Point
from .torch_bls import convert as C
from .torch_bls import limbs as L
from .torch_bls import points as PT

N_WINDOWS = 32           # ceil(255 / 8)
WINDOW_BITS = 8
SCALAR_WORDS = 8
# K8's schedule (csrc/msm.cu)
N_BUCKETS = 256          # digit values; bucket 0 stays empty
HIST_LANES = 1024        # lanes per block of the histogram and scatter launches
FIRST_CHUNK = 4          # window points per chunk at level 0
CHUNK = 2                # partials per chunk at the later levels
PT_WORDS = 36            # int32 words of a projective point
STAGES = ("histogram", "scan", "scatter", "level 0", "later levels", "combine",
          "normalize")


def scalar_words(scalars) -> torch.Tensor:
    """Python ints in [0, 2^256) -> (N, 8) int32 little-endian words."""
    raw = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    w = np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(np.int32)
    return torch.from_numpy(w.reshape(len(scalars), SCALAR_WORDS).copy())


def _digits(scalars: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (32, N) int64 bytes, window-major."""
    w = scalars.to(torch.int64) & 0xFFFFFFFF
    k = torch.arange(N_WINDOWS, device=w.device)
    return ((w[:, k // 4] >> (8 * (k % 4))) & 0xFF).T


# ---------------------------------------------------------------------------
# K7: window multiples
# ---------------------------------------------------------------------------

@torch.inference_mode()
def expand_windows_plain(pts, inf):
    """Plain PyTorch version of K7 (any device)."""
    p = PT.from_affine(PT._G1, L.unpack(pts), inf)          # (N, 3, 24)
    out = [p]
    for _ in range(N_WINDOWS - 1):
        for _ in range(WINDOW_BITS):
            p = PT.complete_dbl(PT._G1, p)
        out.append(p)
    return L.pack(torch.stack(out))


def expand_windows_fq_products(inf) -> int:
    """Fq products K7's function needs: 31 x 8 doublings per finite point."""
    return int((~inf).sum()) * (N_WINDOWS - 1) * WINDOW_BITS * PT.G1_DBL


def expand_windows(pts, inf):
    """K7.  ``pts``: (N, 2, 12) int32 affine G1 points (Montgomery words),
    ``inf``: (N,) bool infinity flags.  Returns the (32, N, 3, 12) int32
    projective window multiples [2^(8w)] P_i, window-major.

    CUDA: a team of 4 threads per point makes each of its 248 complete
    doublings (two waves of four products, ``csrc/team.cuh`` team_dbl),
    8 teams a warp; each warp writes its points' window entries as one
    coalesced store per window.  Bound: integer multiply-adds
    (``expand_windows_fq_products``); each point is read once (96 B) and
    written 32 times (4,608 B); the chain of 496 dependent products holds
    it at any N."""
    dev = _build.same_device(pts, inf)
    n = pts.shape[0]
    _build.check(pts, "pts", torch.int32, (n, 2, 12))
    _build.check(inf, "inf", torch.bool, (n,))
    if dev.type == "cpu":
        return expand_windows_plain(pts, inf)
    out = torch.empty((N_WINDOWS, n, 3, 12), dtype=torch.int32, device=dev)
    if n:
        _build.launch("expand_windows", pts, inf, out, n)
    return out


# ---------------------------------------------------------------------------
# K8: digit lanes, sum, normalize
# ---------------------------------------------------------------------------

@torch.inference_mode()
def msm_core_plain(windows, scalars):
    """Plain PyTorch version of K8 (any device)."""
    n = windows.shape[1]
    pts = L.unpack(windows).reshape(N_WINDOWS * n, 3, L.NLIMB)
    d = _digits(scalars).reshape(-1, 1)
    bits = (d >> torch.arange(WINDOW_BITS - 1, -1, -1, device=d.device)) & 1
    q = PT.scalar_mul(PT._G1, pts, bits.bool())
    out, inf = PT.normalize(PT._G1, PT.tree_sum(PT._G1, q, 0))
    return L.pack(out), inf


def msm_core_fq_products(windows, scalars) -> int:
    """Fq products K8's function needs on these inputs, by the bucket
    method over the expanded table: every lane with a non-zero digit and
    a finite window point joins its digit's bucket (an addition for each
    but the first of a bucket); the filled buckets, digits d_1 > ... > d_D,
    combine as sum_j (d_j - d_{j+1}) S_j over their running sums S_j
    (2 (D - 1) additions and a ladder for every gap above 1, d_{D+1} = 0);
    an inversion and two products make the sum affine."""
    finite = (windows[0, :, 2] != 0).any(dim=-1).cpu()
    d = _digits(scalars).cpu()[:, finite]
    live = d[d != 0]
    digits = sorted(set(live.tolist()), reverse=True)
    gaps = [a - b for a, b in zip(digits, digits[1:] + [0])]
    adds = len(live) - len(digits) + 2 * max(len(digits) - 1, 0)
    n = adds * PT.G1_ADD + sum(PT._ladder_fq_products(g, PT.G1_DBL, PT.G1_ADD) for g in gaps)
    return n + 2


def msm_core_ladder_fq_products(windows, scalars) -> int:
    """Fq products K8's design spends on these inputs (not its bound): per
    lane with a non-zero digit and a finite window point, the digit's
    ladder (base projective: full additions); the additions joining those
    lanes; an inversion and two products to make the sum affine."""
    finite = (windows[0, :, 2] != 0).any(dim=-1).cpu()
    d = _digits(scalars).cpu()[:, finite]
    live = d[d != 0].tolist()
    n = sum(PT._ladder_fq_products(k, PT.G1_DBL, PT.G1_ADD) for k in live)
    return n + max(len(live) - 1, 0) * PT.G1_ADD + 2


class MsmPlan(NamedTuple):
    """K8's launch and scratch plan for N points (the same arithmetic as
    ``csrc/msm.cu`` ``msm_plan``)."""
    lanes: int          # 32 N
    hist_blocks: int    # blocks of the histogram and scatter launches
    levels: int         # chunk levels: 1 + ceil(log2(ceil(lanes / FIRST_CHUNK)))
    bounds: tuple       # upper bound of each level's run total (level 0: lanes)
    words: int          # int32 words of scratch


def msm_plan(n: int) -> MsmPlan:
    """The levels reduce the largest possible run (every lane in one
    bucket) to one point; a level's outputs number at most
    ``floor(M / chunk) + 255`` for M inputs over at most 255 buckets.
    Scratch: per-block histograms, the (levels + 1, 257) schedule, the
    sorted lane indices, two partial buffers, the combine's 256 buckets,
    the projective sum."""
    if not 1 <= n <= (1 << 25) // N_WINDOWS:
        raise ValueError(f"msm_plan: n={n} out of range")
    lanes = N_WINDOWS * n
    hist_blocks = -(-lanes // HIST_LANES)
    m, levels = -(-lanes // FIRST_CHUNK), 1
    while m > 1:
        m, levels = -(-m // CHUNK), levels + 1
    bounds, b = [lanes], lanes
    for k in range(levels):
        b = min(b, b // (CHUNK if k else FIRST_CHUNK) + N_BUCKETS - 1)
        bounds.append(b)
    most = max(bounds[1:])
    sorted_at = hist_blocks * N_BUCKETS + (levels + 1) * (N_BUCKETS + 1)
    part_a = -(-(sorted_at + lanes) // 4) * 4
    return MsmPlan(lanes, hist_blocks, levels, tuple(bounds),
                   part_a + (2 * most + N_BUCKETS + 1) * PT_WORDS)


def msm_core(windows, scalars):
    """K8.  ``windows``: (32, N, 3, 12) int32 projective window multiples
    (K7's output), ``scalars``: (N, 8) int32 little-endian words of the
    canonical scalars.  Returns the affine sum_i [k_i] P_i as (2, 12)
    int32 and its infinity flag (bool, shape ()).

    CUDA: the bucket method in ``levels + 14`` launches on the current
    stream (:func:`msm_plan`; 30 at N = 4096): digit histograms, a scan,
    the scatter into bucket order, one launch per chunk level, ten that
    weight the 255 bucket sums through their digits' bits, one thread
    that inverts Z.  Past level 0 every point operation is made by a team
    of 6 threads (two waves of products, not one thread's chain of 14).
    Scratch: one int32 buffer of ``msm_plan(N).words``.  Bound: integer
    multiply-adds (``msm_core_fq_products``)."""
    dev = _build.same_device(windows, scalars)
    n = windows.shape[1]
    _build.check(windows, "windows", torch.int32, (N_WINDOWS, n, 3, 12))
    _build.check(scalars, "scalars", torch.int32, (n, SCALAR_WORDS))
    if n == 0:
        raise ValueError("msm_core: empty basis")
    if dev.type == "cpu":
        return msm_core_plain(windows, scalars)
    out, inf, _ = _msm_launch(windows, scalars, None)
    return out, inf


def _msm_launch(windows, scalars, marks):
    n = windows.shape[1]
    plan = msm_plan(n)
    scratch = torch.empty(plan.words, dtype=torch.int32, device=windows.device)
    out = torch.empty((2, 12), dtype=torch.int32, device=windows.device)
    inf = torch.empty((), dtype=torch.bool, device=windows.device)
    _build.launch("g1_msm", windows, scalars, scratch, plan.words, out, inf, n, marks)
    return out, inf, plan


def msm_core_stage_ms(windows, scalars, reps: int = 10) -> dict:
    """Device ms per call of each K8 stage (:data:`STAGES`) on CUDA
    tensors, from events the C entry records between its stages, over
    ``reps`` calls after one warm-up; "launches": CUDA launches per call."""
    msm_core(windows, scalars)
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]
           for _ in range(reps)]
    for row in evs:
        for e in row:
            e.record()
    torch.cuda.synchronize()
    for row in evs:
        handles = torch.tensor([e.cuda_event for e in row], dtype=torch.int64)
        _, _, plan = _msm_launch(windows, scalars, handles)
    torch.cuda.synchronize()
    out = {s: sum(row[i].elapsed_time(row[i + 1]) for row in evs) / reps
           for i, s in enumerate(STAGES)}
    out["launches"] = plan.levels + 14
    return out


# ---------------------------------------------------------------------------
# host entry
# ---------------------------------------------------------------------------

# (cache key, device) -> window table of a fixed basis, on that device;
# 18.9 MB per 4096-point basis on the card
_setup_cache = LRUDict(8)


def g1_msm(points, scalars, cache_key=None, device=None) -> G1Point:
    """sum_i [scalars_i] points_i over oracle ``G1Point``s, scalars in
    [0, r), on ``device`` (None: the card; "cpu": the plain versions).

    ``cache_key``: a hashable identity of a fixed basis (the caller keys
    it by content) whose window table is kept on ``device`` across
    calls, so K7 runs once per basis."""
    if len(points) != len(scalars):
        raise ValueError("g1_msm: ragged inputs")
    if not points:
        return G1Point.inf()
    dev = _build.device(device)
    key = (cache_key, str(dev))
    windows = _setup_cache.get(key) if cache_key is not None else None
    if windows is None:
        aff, inf = C.pack_g1(points)
        windows = expand_windows(_build.to_device(aff, dev), _build.to_device(inf, dev))
        if cache_key is not None:
            _setup_cache[key] = windows
    out, inf = msm_core(windows, _build.to_device(scalar_words(scalars), dev))
    return C.unpack_g1(out[None], inf.reshape(1))[0]
