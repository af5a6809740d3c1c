"""Fr (the BLS12-381 scalar field, r = ``R_ORDER``), plain PyTorch version.

Counterpart of the field ops of ``consensus_specs_tpu/ops/jax_bls/fr_fft.py``
(``:30-142``: ``mont_mul``, ``add_mod``, ``sub_mod``, packing); the CUDA
counterpart is ``csrc/fr.cuh`` (8 x 32-bit limbs, CIOS Montgomery).

Kernel tensors hold an element as ``(..., 8)`` int32 words, the bit
patterns of eight 32-bit little-endian limbs.  The plain version computes
on ``(..., 16)`` int64 tensors of 16-bit limbs with the carry, borrow and
column helpers of ``limbs.py``: a limb product is below 2^32 and a
16-term column sum below 2^36, so every step is exact in signed 64-bit
arithmetic and no float product is involved.  The Montgomery radix is
R = 2^256, the JAX package's (``fr_fft.py:34``).
"""
import numpy as np
import torch

from ..bls12_381.fields import R_ORDER
from . import limbs as L

NLIMB = 16
WORDS = 8
MASK = L.MASK
R_MONT = (1 << 256) % R_ORDER
NPRIME = (-pow(R_ORDER, -1, 1 << 256)) % (1 << 256)


def int_to_limbs(n: int) -> list:
    """Python int -> 16 16-bit limbs, little-endian."""
    return [(n >> (16 * i)) & MASK for i in range(NLIMB)]


def mont(n: int) -> int:
    return n % R_ORDER * R_MONT % R_ORDER


_CONSTS = {}


def _const(n: int, like: torch.Tensor) -> torch.Tensor:
    """Cached (16,) limb constant on ``like``'s device (never mutated)."""
    key = (n, str(like.device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(int_to_limbs(n), dtype=torch.int64,
                                    device=like.device)
    return _CONSTS[key]


# ---------------------------------------------------------------------------
# words <-> internal limbs, words <-> python ints
# ---------------------------------------------------------------------------

def unpack(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 16-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> 16], dim=-1).reshape(words.shape[:-1] + (NLIMB,))


def pack(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 16-bit limbs -> (..., 8) int32 words."""
    pair = limbs.reshape(limbs.shape[:-1] + (WORDS, 2))
    w = pair[..., 0] | (pair[..., 1] << 16)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def words_from_ints(values, mont_form: bool = False) -> np.ndarray:
    """Iterable of python ints (each < r) -> (N, 8) int32 numpy words,
    canonical unless ``mont_form``."""
    conv = mont if mont_form else int
    raw = b"".join(conv(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(
        np.int32).reshape(-1, WORDS)


def ints_from_words(words) -> list:
    """(..., 8) int32 words (tensor or array) -> flat list of ints."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    raw = np.ascontiguousarray(words, dtype=np.int32).view("<u4").tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


# ---------------------------------------------------------------------------
# field ops (inputs and outputs reduced, internal form)
# ---------------------------------------------------------------------------

def _pick(x, y):
    """x and y: (..., 16) non-negative limb columns (each below 2^18) of
    two candidate sums below 2^257, normalized in one carry pass over 17
    limbs; returns x mod 2^256 where x reaches 2^256, else y."""
    r = L._carry(torch.nn.functional.pad(torch.stack([x, y]), (0, 1)), NLIMB + 1, 1)
    return torch.where(r[0, ..., NLIMB:] != 0, r[0, ..., :NLIMB], r[1, ..., :NLIMB])


def add_mod(a, b):
    """(a + b) mod r: a + b + (2^256 - r) reaches 2^256 exactly where
    a + b >= r, and then its low 256 bits are a + b - r."""
    s = a + b
    return _pick(s + _const((1 << 256) - R_ORDER, s), s)


def sub_mod(a, b):
    """(a - b) mod r: a + (2^256 - 1 - b) + 1 reaches 2^256 exactly where
    a >= b, and then its low 256 bits are a - b; otherwise a - b + r."""
    t = a + (MASK - b)
    t[..., 0] += 1
    return _pick(t, t + _const(R_ORDER, t))


def cond_sub_r(x):
    """x in [0, 2r) -> x mod r."""
    d, borrow = L._sub_limbs(x, _const(R_ORDER, x))
    return torch.where(borrow.unsqueeze(-1), x, d)


def mont_mul(a, b):
    """a * b * 2^-256 mod r."""
    t = L._cols(a, b)                                  # columns < 2^36
    m = L._carry(L._cols(t[..., :NLIMB], _const(NPRIME, t)), NLIMB, 4)
    s = L._carry(t + L._cols(m, _const(R_ORDER, m)), 2 * NLIMB, 3)
    return cond_sub_r(s[..., NLIMB:])


# A CIOS product over 8 words: 64 word products for a * b and 64 for m * r,
# each a low and a high 32-bit multiply-add, plus 8 low products for the m's.
IMAD_PER_FR_MUL = 2 * (2 * WORDS * WORDS) + WORDS
