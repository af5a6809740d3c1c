"""Batched radix-2 FFT over Fr: kernel K9 ``fr_butterfly`` with its plain
version, and the host entry ``fft_batch``.

Counterpart of ``consensus_specs_tpu/ops/jax_bls/fr_fft.py``; the CUDA
side is ``csrc/fr_fft.cu`` over ``csrc/fr.cuh``.  The DAS engine's
erasure recovery is FFT-bound: a group of blobs missing the same columns
pays 4 batched FFTs of 2N points per blob (``das/kernels.py``).

K9 replaces ``fr_fft.py:211`` ``_butterfly`` and the stage loop of
``:216`` ``fft_batch``.  The JAX program gathers each stage's lo/hi
halves through host index tables and undoes the layout with an argsort
after every stage; here a butterfly thread derives its pair and twiddle
from the stage's half h (see ``csrc/fr_fft.cu``), so only the twiddle
table goes to the card.  Rows are held as ``(rows, n, 8)`` int32 words of
the canonical values, bit-reversed on the host before the first stage;
the twiddles are in Montgomery form (R = 2^256), so ``mont_mul(b, wR)``
gives ``b w`` and the values never enter or leave Montgomery form.  The
inverse transform's 1/n scaling stays on the host, as in the JAX package.
"""
import numpy as np
import torch

from .. import _build
from .bls12_381.fields import R_ORDER
from .torch_bls import fr as F


def _pairs(n: int, half: int, device):
    """Stage with half ``half``: (lo, hi, twiddle) indices of its n/2
    butterflies, in the kernel's thread order."""
    k = torch.arange(n // 2, device=device)
    j = k % half
    lo = (k - j) * 2 + j
    return lo, lo + half, j * (n // (2 * half))


@torch.inference_mode()
def fr_butterfly_plain(vals, tw, half: int):
    """Plain PyTorch version of K9 (any device); updates ``vals`` in place
    and returns it."""
    lo, hi, t = _pairs(vals.shape[1], half, vals.device)
    a = F.unpack(vals[:, lo])
    b = F.mont_mul(F.unpack(vals[:, hi]), F.unpack(tw[t]))
    vals[:, lo] = F.pack(F.add_mod(a, b))
    vals[:, hi] = F.pack(F.sub_mod(a, b))
    return vals


def fr_butterfly(vals, tw, half: int):
    """K9: one radix-2 stage over every row, in place.  ``vals``: (rows,
    n, 8) int32 canonical words in the stage's order (bit-reversed input
    for the first stage), n a power of two; ``tw``: (n/2, 8) int32 words,
    the domain's first n/2 roots in Montgomery form; ``half``: the
    stage's half-width (1, 2, ..., n/2).  Returns ``vals``.

    CUDA: one thread per butterfly (rows * n/2 threads), a Montgomery
    product and an add/sub pair each.  Bound: bytes (2 * rows * n * 32 B
    per stage)."""
    dev = _build.same_device(vals, tw)
    rows, n = vals.shape[0], vals.shape[1]
    _build.check(vals, "vals", torch.int32, (rows, n, F.WORDS))
    _build.check(tw, "tw", torch.int32, (n // 2, F.WORDS))
    if n < 2 or n & (n - 1) or not (0 < half < n and half & (half - 1) == 0):
        raise ValueError(f"fr_butterfly: n = {n} and half = {half} must be powers "
                         "of two with half < n")
    if dev.type == "cpu":
        return fr_butterfly_plain(vals, tw, half)
    if rows:
        _build.launch("fr_butterfly", vals, tw, rows, n, half)
    return vals


def fr_butterfly_fr_products(rows: int, n: int) -> int:
    """Fr products one stage needs: one per butterfly."""
    return rows * (n // 2)


def fr_butterfly_bytes(rows: int, n: int) -> int:
    """Bytes one stage must move: the array read once and written once
    (the n/2-entry twiddle table is read by every row and counted once)."""
    return 2 * rows * n * 32 + (n // 2) * 32


# ---------------------------------------------------------------------------
# host entry
# ---------------------------------------------------------------------------

# (device, n, direction, the domain's values) -> (n/2, 8) Montgomery
# twiddle words
_TWIDDLES = {}


def _bit_reversal(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def fft_batch(rows, roots, inv: bool = False, device=None):
    """Batched FFT: ``rows`` is a list of equal-length int lists (one
    polynomial per row), ``roots`` the full forward domain.  Returns the
    transformed rows as python ints, identical to mapping
    ``ops.kzg_7594.fft_field`` over the rows.

    The twiddle table stays on ``device`` (None: the card), cached per
    (n, direction) by the domain's content."""
    if not rows:
        return []
    dev = _build.device(device)
    n = len(rows[0])
    if any(len(r) != n for r in rows):
        raise ValueError("fft_batch: rows of unequal length")
    if len(roots) != n or n & (n - 1):
        raise ValueError(f"fft_batch: {len(roots)} roots for {n} points")
    domain = list(roots[0:1]) + list(roots[:0:-1]) if inv else list(roots)
    out = [[int(x) % R_ORDER for x in r] for r in rows]
    if n > 1:
        key = (str(dev), n, inv, tuple(int(w) for w in domain))
        tw = _TWIDDLES.get(key)
        if tw is None:
            tw = torch.from_numpy(F.words_from_ints(domain[:n // 2], mont_form=True).copy())
            tw = _TWIDDLES.setdefault(key, _build.to_device(tw, dev))
        host = F.words_from_ints([x for r in out for x in r]).reshape(len(rows), n, F.WORDS)
        vals = _build.to_device(torch.from_numpy(
            np.ascontiguousarray(host[:, _bit_reversal(n)])), dev)
        half = 1
        while half < n:
            fr_butterfly(vals, tw, half)
            half *= 2
        flat = F.ints_from_words(vals)
        out = [flat[i * n:(i + 1) * n] for i in range(len(rows))]
    if inv:
        invlen = pow(n, R_ORDER - 2, R_ORDER)
        out = [[x * invlen % R_ORDER for x in r] for r in out]
    return out
