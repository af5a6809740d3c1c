"""Fq (BLS12-381 base field) arithmetic, plain PyTorch version.

Counterpart of ``consensus_specs_tpu/ops/jax_bls/limbs.py``; the CUDA
counterpart is ``csrc/fq.cuh`` (12 x 32-bit limbs, CIOS Montgomery).

Kernel tensors hold an element as ``(..., 12)`` int32 words (see the
package docstring).  The plain version computes on ``(..., 24)`` int64
tensors of 16-bit limbs ("internal" form): a limb product is below 2^32
and a 24-term column sum below 2^37, so signed 64-bit arithmetic is
exact everywhere and no float product is ever involved.  ``unpack`` and
``pack`` move between the two forms.

Every op takes arbitrary leading batch dims.  Carries resolve without a
sequential loop: a few split-and-add passes bring every limb to
[0, 2^16], then the last limb that does not propagate a carry is found
with ``cummax`` and its generate bit is gathered (a prefix scan in a
handful of tensor ops).
"""
import numpy as np
import torch

from ..bls12_381.fields import P

NLIMB = 24
LIMB_BITS = 16
MASK = 0xFFFF
WORDS = 12
R_MONT = (1 << 384) % P
R_INV = pow(R_MONT, -1, P)
NPRIME = (-pow(P, -1, 1 << 384)) % (1 << 384)


def int_to_limbs(n: int) -> list:
    """Python int -> 24 16-bit limbs, little-endian."""
    return [(n >> (LIMB_BITS * i)) & MASK for i in range(NLIMB)]


def mont(n: int) -> int:
    """Python int -> its Montgomery form as a python int."""
    return (n % P) * R_MONT % P


def unmont(n: int) -> int:
    return n * R_INV % P


_CONSTS = {}


def _const(n: int, like: torch.Tensor) -> torch.Tensor:
    """Cached (24,) limb constant on ``like``'s device (never mutated)."""
    key = (n, str(like.device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(int_to_limbs(n), dtype=torch.int64,
                                    device=like.device)
    return _CONSTS[key]


def fq_const(n: int, like: torch.Tensor) -> torch.Tensor:
    """Montgomery constant for ``n`` on ``like``'s device, internal form."""
    return _const(mont(n), like)


def one_like(x: torch.Tensor) -> torch.Tensor:
    return fq_const(1, x).expand(x.shape).clone()


# ---------------------------------------------------------------------------
# words <-> internal limbs, words <-> python ints
# ---------------------------------------------------------------------------

def unpack(words: torch.Tensor) -> torch.Tensor:
    """(..., 12) int32 words -> (..., 24) int64 16-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> LIMB_BITS], dim=-1).reshape(
        words.shape[:-1] + (NLIMB,))


def pack(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 24) int64 16-bit limbs -> (..., 12) int32 words."""
    pair = limbs.reshape(limbs.shape[:-1] + (WORDS, 2))
    w = pair[..., 0] | (pair[..., 1] << LIMB_BITS)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def words_from_ints(values, mont_form: bool = True) -> np.ndarray:
    """Iterable of python ints -> (N, 12) int32 numpy words (Montgomery
    form unless ``mont_form`` is False)."""
    conv = mont if mont_form else (lambda v: v)
    raw = b"".join(conv(int(v)).to_bytes(48, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(
        np.int32).reshape(-1, WORDS)


def ints_from_words(words, mont_form: bool = True) -> list:
    """(..., 12) int32 words (tensor or array) -> flat list of ints."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    raw = np.ascontiguousarray(words, dtype=np.int32).view("<u4").tobytes()
    vals = [int.from_bytes(raw[i:i + 48], "little")
            for i in range(0, len(raw), 48)]
    return [unmont(v) for v in vals] if mont_form else vals


# ---------------------------------------------------------------------------
# carries and borrows
# ---------------------------------------------------------------------------

_ARANGE = {}


def _arange(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _ARANGE:
        _ARANGE[key] = torch.arange(n, device=device)
    return _ARANGE[key]


def _prefix_chain(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """out[j] = gen[j] | (prop[j] & out[j-1]), as a prefix scan: out[j] is
    gen at the last position <= j that does not propagate."""
    idx = _arange(gen.shape[-1], gen.device)
    last = torch.where(prop, -1, idx).cummax(dim=-1).values
    gen_ext = torch.nn.functional.pad(gen.to(torch.int64), (1, 0))
    return torch.gather(gen_ext, -1, last + 1)


def _carry(cols: torch.Tensor, n_out: int, passes: int) -> torch.Tensor:
    """Non-negative columns -> n_out normalized 16-bit limbs; the carry out
    of the top limb is dropped.  Each split-and-add pass shrinks the excess
    over 2^16 by 16 bits, so ``passes`` must bring every limb to
    [0, 2^16]: 1 for sums of two limbs, 3 for columns below 2^38, 4 for
    columns below 2^60."""
    c = cols[..., :n_out]
    for _ in range(passes):
        hi = c[..., :-1] >> LIMB_BITS
        c = c & MASK
        c[..., 1:] += hi
    lo = c & MASK
    carry_out = _prefix_chain(c >> LIMB_BITS, lo == MASK)
    lo[..., 1:] += carry_out[..., :-1]
    return lo & MASK


def _sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """a - b over normalized limbs: (difference mod 2^(16n), borrow)."""
    t = a - b
    borrow_out = _prefix_chain(t < 0, t == 0)
    t[..., 1:] -= borrow_out[..., :-1]
    return t & MASK, borrow_out[..., -1] != 0


_DIAG = {}


def _cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n) x (..., n) limbs -> (..., 2n) antidiagonal column sums:
    the outer product scattered onto column i + j with ``index_add_``."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    key = (n, str(a.device))
    if key not in _DIAG:
        ar = torch.arange(n, device=a.device)
        _DIAG[key] = (ar[:, None] + ar[None, :]).reshape(-1)
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(a.shape[:-1] + (n * n,))
    cols = torch.zeros(a.shape[:-1] + (2 * n,), dtype=torch.int64,
                       device=a.device)
    return cols.index_add_(-1, _DIAG[key], prod)


# ---------------------------------------------------------------------------
# field ops (inputs and outputs reduced, internal form)
# ---------------------------------------------------------------------------

def _p(like):
    return _const(P, like)


def cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """x in [0, 2p) -> x mod p."""
    d, borrow = _sub_limbs(x, _p(x))
    return torch.where(borrow.unsqueeze(-1), x, d)


def _pick(x, y):
    """x and y: (..., 24) non-negative limb columns (each below 2^18) of
    two candidate sums below 2^385.  Both are normalized in ONE carry
    pass over 25 limbs; returns x mod 2^384 where x reaches 2^384 (its
    carry out of limb 23), else y."""
    r = _carry(torch.nn.functional.pad(torch.stack([x, y]), (0, 1)), NLIMB + 1, 1)
    return torch.where(r[0, ..., NLIMB:] != 0, r[0, ..., :NLIMB], r[1, ..., :NLIMB])


def add_mod(a, b):
    """(a + b) mod p: a + b + (2^384 - p) reaches 2^384 exactly where
    a + b >= p, and then its low 384 bits are a + b - p."""
    s = a + b
    return _pick(s + _const((1 << 384) - P, s), s)


def sub_mod(a, b):
    """(a - b) mod p: a + (2^384 - 1 - b) + 1 (the complement is limbwise,
    MASK - b) reaches 2^384 exactly where a >= b, and then its low 384
    bits are a - b; otherwise a - b + p is the answer."""
    t = a + (MASK - b)
    t[..., 0] += 1
    return _pick(t, t + _p(t))


def neg_mod(a):
    return sub_mod(torch.zeros_like(a), a)


def mont_mul(a, b):
    """a * b * R^-1 mod p."""
    t = _cols(a, b)                                   # columns < 2^37
    # m = t * (-p^-1) mod R needs t only up to congruence mod R, so the
    # unnormalized low columns serve (products < 2^53, sums < 2^58)
    m = _carry(_cols(t[..., :NLIMB], _const(NPRIME, t)), NLIMB, 4)
    s = _carry(t + _cols(m, _p(m)), 2 * NLIMB, 3)     # t + m p = 0 mod R
    return cond_sub_p(s[..., NLIMB:])


def mont_sqr(a):
    return mont_mul(a, a)


def from_mont(a):
    """Montgomery form -> canonical value limbs (for parity tests)."""
    return mont_mul(a, _const(1, a))


def is_zero(a):
    return (a == 0).all(dim=-1)


def eq(a, b):
    return (a == b).all(dim=-1)


def select(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def pow_fixed(a, e: int):
    """a^e for a public exponent: MSB-first 4-bit fixed windows.

    a == 0 yields 0 for e > 0 (so inv(0) == 0, like the JAX ladder)."""
    table = [one_like(a), a]
    for _ in range(14):
        table.append(mont_mul(table[-1], a))
    nwin = max(1, (e.bit_length() + 3) // 4)
    acc = None
    for i in range(nwin - 1, -1, -1):
        w = (e >> (4 * i)) & 0xF
        if acc is None:
            acc = table[w]
            continue
        for _ in range(4):
            acc = mont_sqr(acc)
        if w:
            acc = mont_mul(acc, table[w])
    return acc


INV_EXP = P - 2
SQRT_EXP = (P + 1) // 4
LEGENDRE_EXP = (P - 1) // 2


# ---------------------------------------------------------------------------
# operation counts for the kernels' bounds: the Fq products a function
# needs, and the integer work of one product
# ---------------------------------------------------------------------------

# A 12-word CIOS Montgomery product: 144 word products for a * b and 144
# for m * p, each 32 x 32 -> 64 (a low and a high multiply-add), plus 12
# low products for the m's.
IMAD_PER_FQ_MUL = 2 * (2 * WORDS * WORDS) + WORDS


def pow_muls(e: int) -> int:
    """Fq products of a^e by the 4-bit fixed-window ladder (the cheaper of
    the package's two ladders: ``pow_fixed`` here, binary in CUDA)."""
    nwin = max(1, (e.bit_length() + 3) // 4)
    return 14 + 4 * (nwin - 1) + sum(1 for i in range(nwin - 1) if (e >> (4 * i)) & 0xF)


def inv_mod(a):
    return pow_fixed(a, INV_EXP)


def sqrt_candidate(a):
    """a^((p+1)/4): the square root when a is a residue (p = 3 mod 4)."""
    return pow_fixed(a, SQRT_EXP)


def legendre_is_qr(a):
    """True where a is zero or a quadratic residue (Euler criterion)."""
    return eq(pow_fixed(a, LEGENDRE_EXP), one_like(a)) | is_zero(a)


def parity(a):
    """Parity of the canonical value of a Montgomery element."""
    return from_mont(a)[..., 0] & 1


# ---------------------------------------------------------------------------
# batching helper: k independent ops as one wide op
# ---------------------------------------------------------------------------

def many(op, pairs):
    """[(a, b), ...] -> [op(a, b), ...] computed as ONE call of ``op`` on
    the stacked (broadcast) operands."""
    if len(pairs) == 1:
        return [op(*pairs[0])]
    shape = torch.broadcast_shapes(*[t.shape for pr in pairs for t in pr])
    a = torch.stack([x.expand(shape) for x, _ in pairs])
    b = torch.stack([y.expand(shape) for _, y in pairs])
    return list(op(a, b).unbind(0))
