"""Batched SHA-256: kernels K5 ``hash64`` and K6 ``sha256_blocks`` with
their plain versions, and the merkle engine's batched hasher.

Counterpart of ``consensus_specs_tpu/ops/sha256.py``; the CUDA side is
``csrc/sha256.cu``.

- K5 ``hash64`` replaces ``sha256.py:104`` ``_hash64_words`` (with
  ``:54`` ``_compress``): n independent 64-byte messages (a merkle
  tree's parent inputs) -> n digests, two compressions each, the second
  on the constant pad block.  uint8 ``(n, 64)`` rows -> uint8
  ``(n, 32)`` digests, on the card.
- K6 ``sha256_blocks`` replaces ``sha256.py:141`` ``sha256_blocks``:
  sequential compression of pre-padded blocks, ``(..., nb, 16)`` words
  -> ``(..., 8)`` words, carried as int32 bit patterns.

Both are bound by 32-bit integer operations (``hash64_int_ops``), not by
the 96 bytes a K5 message moves, and by the chain of a message's rounds
(``hash64_chain_ops``, ``sha256_blocks_chain_ops``), which
:func:`sha256_chain` (a measurement aid that replaces no TPU program)
turns into time; ``csrc/sha256.cu`` says what the designs do about it.
K6 takes one warp a CTA, each message's next block loaded ahead of its
rounds.  A CUDA launch takes any n, so the JAX package's power-of-two
padding (``_next_pow2``, there to bound XLA's program variants) is not
carried.

The plain versions compute on int64 lanes holding 32-bit words, masked
after every add (torch has no uint32 add, shift or compare); they serve
CPU tensors and, on the card, only the comparisons of ``chip_smoke.py``.

:func:`install_merkle_hasher` plugs the kernel into the port's merkle
engine (``utils/ssz/merkle.py``): rows are copied into a pinned staging
buffer, moved to the card in one ``non_blocking`` copy, hashed, and the
digests come back in one copy.  The engine needs the digests before it
builds the next tree level, so every call ends in that synchronizing
copy.  The installed hashers carry their ``device``: span builds
(``parallel/mesh_merkle.py``, K18) run on it.
"""
import threading

import numpy as np
import torch

from .. import _build

_M = 0xFFFFFFFF

# Round constants (FIPS 180-4 4.2.2): cube-root fractional parts of the
# first 64 primes.
K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

# Initial hash state (square-root fractional parts of the first 8 primes).
H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

# The pad block of a 64-byte message: 0x80 marker, zeros, 512-bit length.
PAD64 = (0x80000000,) + (0,) * 14 + (512,)


def _rotr_int(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M


def schedule_ints(block) -> list:
    """The 64-word message schedule of one block of 16 python-int words."""
    w = list(block)
    for i in range(16, 64):
        s0 = _rotr_int(w[i - 15], 7) ^ _rotr_int(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr_int(w[i - 2], 17) ^ _rotr_int(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M)
    return w


# K[i] + W[i] of the pad block: its schedule does not depend on the
# message, so both the kernel (csrc, generated header) and the plain
# version fold it into the round constants.
PAD_KW = tuple((k + w) & _M for k, w in zip(K, schedule_ints(PAD64)))


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------

def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M


def _rounds(state, kw):
    """64 rounds over ``state`` (8 int64 lanes); ``kw(i)`` gives K[i] +
    W[i] (a lane or a python int, unmasked)."""
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((_M ^ e) & g)
        t1 = h + s1 + ch + kw(i)
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M, c, b, a,
                                  (t1 + s0 + maj) & _M)
    return [(x + y) & _M for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _compress_plain(state, words):
    """One compression: ``state`` 8 lanes, ``words`` (m, 16) int64."""
    w = list(words.unbind(-1))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M)
    return _rounds(state, lambda i: w[i] + K[i])


def _initial_state(m: int, device):
    return [torch.full((m,), v, dtype=torch.int64, device=device) for v in H0]


@torch.inference_mode()
def hash64_plain(rows):
    """Plain PyTorch version of K5: uint8 (n, 64) -> uint8 (n, 32)."""
    n = rows.shape[0]
    b = rows.reshape(n, 16, 4).long()
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    st = _compress_plain(_initial_state(n, rows.device), words)
    st = _rounds(st, lambda i: PAD_KW[i])
    dig = torch.stack(st, dim=-1)                               # (n, 8)
    out = torch.stack([(dig >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1)
    return out.reshape(n, 32).to(torch.uint8)


@torch.inference_mode()
def sha256_blocks_plain(words):
    """Plain PyTorch version of K6: int32 (m, nb, 16) word bit patterns ->
    int32 (m, 8)."""
    m = words.shape[0]
    w = words.long() & _M
    st = _initial_state(m, words.device)
    for blk in range(words.shape[1]):
        st = _compress_plain(st, w[:, blk])
    dig = torch.stack(st, dim=-1)
    return torch.where(dig > 0x7FFFFFFF, dig - (1 << 32), dig).to(torch.int32)


def hash64_int_ops(n: int) -> int:
    """Integer-pipe instructions K5's function needs for n messages: the
    ones only the 32-bit integer ALU executes (a rotation is one funnel
    shift, each 3-input XOR, ch or maj one LOP3, a byte swap one PRMT).
    A round has 6 funnel shifts and 4 LOP3s (the two sigmas, ch, maj); a
    schedule step 4 funnel shifts, 2 shifts and 2 LOP3s, on the message
    block only (the pad block's schedule is constant); 16 words in and 8
    out are byte-swapped.  Per message: 2 x 64 rounds x 10 + 48 x 8 + 24
    = 1,688.  The 624 adds (4 per round, 2 per schedule step, 16
    feed-forward) are not counted: the compiler may issue them as IMAD
    on the FMA pipe, beside the integer ALU."""
    return n * (2 * 64 * 10 + 48 * 8 + 24)


HASH64_CHAIN_ROUNDS = 2 * 64        # the message block's and the pad block's rounds


def hash64_chain_ops() -> int:
    """K5's chain floor in dependent integer instructions, whatever the
    number of messages: one message's 128 rounds run one after another,
    and a round's e -> e path is 4 instructions deep (Sigma1's three
    funnel shifts side by side, their LOP3, the three-input add into t1,
    then d + t1), as deep as its a -> a path."""
    return HASH64_CHAIN_ROUNDS * 4


def sha256_blocks_int_ops(m: int, nb: int) -> int:
    """As :func:`hash64_int_ops`, for m messages of nb blocks: per block 64
    rounds and 48 schedule steps = 1,024 (words arrive unswapped)."""
    return m * nb * (64 * 10 + 48 * 8)


def sha256_blocks_chain_ops(nb: int) -> int:
    """K6's chain floor in dependent integer instructions, whatever the
    number of messages: a message's nb x 64 rounds run one after another,
    4 instructions deep each (as :func:`hash64_chain_ops`)."""
    return nb * 64 * 4


def sha256_chain_plain(reps: int) -> list:
    """Plain version of the round-latency probe: ``reps`` x 64 rounds from
    H0 with K[i] as K + W, the feed-forward after every 64 (python ints)."""
    st = list(H0)
    for _ in range(reps):
        st = _rounds(st, lambda i: K[i])
    return st


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _aligned(t, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel loads 16-byte words; the data "
                         f"must start on a 16-byte boundary")


def hash64(rows):
    """K5.  ``rows``: uint8 (n, 64), one 64-byte message per row.  Returns
    uint8 (n, 32) digests.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (one thread per message) or raise."""
    dev = _build.same_device(rows)
    n = rows.shape[0]
    _build.check(rows, "rows", torch.uint8, (n, 64))
    if dev.type == "cpu":
        return hash64_plain(rows)
    _aligned(rows, "rows")
    out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    if n:
        _build.launch("hash64", rows, out, n)
    return out


def sha256_blocks(words, num_blocks: int):
    """K6.  ``words``: int32 (..., num_blocks, 16), each message's
    pre-padded blocks as big-endian word values carried as int32 bit
    patterns.  Returns int32 (..., 8) digest words.  CUDA: one warp a
    CTA, one message a thread, the next block loaded during the current
    compression; words off 16 bytes take 4-byte loads."""
    dev = _build.same_device(words)
    if num_blocks < 1:
        raise ValueError("sha256_blocks: a padded message has at least one block")
    lead = tuple(words.shape[:-2])
    _build.check(words, "words", torch.int32, lead + (num_blocks, 16))
    flat = words.reshape(-1, num_blocks, 16)
    m = flat.shape[0]
    if dev.type == "cpu":
        return sha256_blocks_plain(flat).reshape(lead + (8,))
    out = torch.empty((m, 8), dtype=torch.int32, device=dev)
    if m:
        _build.launch("sha256_blocks", flat, out, m, num_blocks)
    return out.reshape(lead + (8,))


def sha256_chain(reps: int, device=None):
    """The round-latency probe (a measurement aid; it replaces no TPU
    program): one thread, ``reps`` x 64 dependent rounds.  Returns the
    int32 (8,) final state; the CPU runs :func:`sha256_chain_plain`."""
    dev = _build.device(device)
    if dev.type == "cpu":
        st = sha256_chain_plain(reps)
        return torch.tensor([v - (1 << 32) if v >> 31 else v for v in st], dtype=torch.int32)
    out = torch.empty(8, dtype=torch.int32, device=dev)
    _build.launch("sha256_chain", out, reps)
    return out


def pad_message(msg: bytes) -> np.ndarray:
    """FIPS 180-4 padding: ``msg`` -> (nb, 16) big-endian words as int32
    bit patterns."""
    padded = msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64) \
        + (8 * len(msg)).to_bytes(8, "big")
    return np.frombuffer(padded, dtype=">u4").astype(np.uint32) \
        .view(np.int32).reshape(-1, 16)


def sha256_bytes(msg: bytes, device=None) -> bytes:
    """One-shot SHA-256 of ``msg`` through K6 (a test aid; None = the card)."""
    dev = _build.device(device)
    words = torch.from_numpy(pad_message(bytes(msg)).copy())
    nb = words.shape[0]
    out = sha256_blocks(words.reshape(1, nb, 16).to(dev), nb)
    return out.cpu().numpy().astype(">u4").tobytes()


# ---------------------------------------------------------------------------
# the merkle engine's batched hasher
# ---------------------------------------------------------------------------

class _CardHasher:
    """Host side of K5 for the merkle engine: one growing pinned staging
    buffer, one H2D copy, the launch, one D2H copy (which synchronizes)."""

    def __init__(self, dev: torch.device):
        self.device = dev
        self._stage = None
        self._lock = threading.Lock()

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        n = rows.shape[0]
        if n == 0:
            return np.empty((0, 32), dtype=np.uint8)
        with self._lock:
            if self._stage is None or self._stage.shape[0] < n:
                self._stage = torch.empty((max(n, 1024), 64), dtype=torch.uint8,
                                          pin_memory=True)
            host = self._stage[:n]
            host.numpy()[:] = rows
            out = hash64(host.to(self.device, non_blocking=True))
            return out.cpu().numpy()


class _PlainHasher:
    """The plain K5 on the host."""

    device = torch.device("cpu")

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        return hash64(torch.from_numpy(np.array(rows))).numpy()


def install_merkle_hasher(device=None) -> None:
    """Route the merkle engine's batched layer and pair hashing through K5
    on ``device`` (both entry points: bytes layers and gathered rows).
    None means the card; a host without CUDA raises unless the CPU is
    named, where the plain version serves."""
    from ..utils.ssz import merkle
    dev = _build.device(device)
    fn = _PlainHasher() if dev.type == "cpu" else _CardHasher(dev)

    def layer(data: bytes, n: int) -> bytes:
        return fn(np.frombuffer(data, dtype=np.uint8).reshape(n, 64)).tobytes()

    layer.device = fn.device
    merkle.set_batched_hasher(layer)
    merkle.set_batched_hasher_np(fn)
