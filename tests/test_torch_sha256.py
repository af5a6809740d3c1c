"""Kernels K5 ``hash64`` and K6 ``sha256_blocks`` of the PyTorch port
(plain versions on the CPU) against the JAX package's SHA-256 programs
(jit on the CPU) and hashlib, exact: digests are bytes (tolerance 0)."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import sha256 as jax_sha
from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.ops import sha256
from consensus_specs_tpu_torch.utils.ssz import merkle
from tests._torch_port import one_torch_thread  # noqa: F401


def seeded_rows(n: int, seed: int = 5) -> np.ndarray:
    """Seeded 64-byte rows; the first three are all-zero, all-ones and
    top-bit-set in every byte (signed bit patterns once packed in int32)."""
    rows = np.random.default_rng(seed + n).integers(0, 256, (n, 64), dtype=np.uint8)
    for i, fill in enumerate((0x00, 0xFF, 0x80)[:n]):
        rows[i] = fill
    return rows


def hashlib_digests(rows: np.ndarray) -> bytes:
    return b"".join(hashlib.sha256(r.tobytes()).digest() for r in rows)


@pytest.mark.parametrize("n", [1, 3, 255, 256, 257, 1000])
def test_hash64_plain_matches_jax_and_hashlib(n):
    rows = seeded_rows(n)
    got = sha256.hash64(torch.from_numpy(rows))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, 32)
    words = rows.view(">u4").astype(np.uint32)
    ref = np.asarray(jax_sha._hash64_words(jnp.asarray(words)))
    assert got.numpy().tobytes() == ref.astype(">u4").tobytes() == hashlib_digests(rows)


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5])
def test_sha256_blocks_plain_matches_jax_and_hashlib(nb):
    rng = np.random.default_rng(nb)
    lo, hi = 64 * (nb - 1), 64 * nb - 9          # lengths that pad to nb blocks
    msgs = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(lo, hi + 1, 4)]
    msgs[0] = b"\xff" * hi
    words = np.stack([sha256.pad_message(m) for m in msgs])
    assert words.shape == (4, nb, 16) and words.dtype == np.int32
    got = sha256.sha256_blocks(torch.from_numpy(words.reshape(2, 2, nb, 16)), nb)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 2, 8)
    ref = np.asarray(jax_sha.sha256_blocks(jnp.asarray(words.view(np.uint32)), nb))
    got_u32 = got.numpy().reshape(4, 8).view(np.uint32)
    assert np.array_equal(got_u32, ref)
    assert got_u32.astype(">u4").tobytes() == b"".join(hashlib.sha256(m).digest() for m in msgs)
    assert [sha256.sha256_bytes(m, "cpu") for m in msgs] == \
        [hashlib.sha256(m).digest() for m in msgs]


def test_constants_match_the_jax_package():
    assert sha256.K == tuple(int(k) for k in jax_sha._K)
    assert sha256.H0 == tuple(int(h) for h in jax_sha._H0)
    assert sha256.PAD64 == tuple(int(w) for w in jax_sha._PAD64)
    header = _build.sha256_constants()
    assert "#define SHA_PAD_KW {" in header and f"0x{sha256.PAD_KW[63]:08x}u" in header


def test_install_merkle_hasher_cpu_routes_layers_and_rows():
    rows = seeded_rows(300)
    try:
        sha256.install_merkle_hasher("cpu")
        merkle.reset_stats()
        layer = merkle.hash_layer(rows.tobytes())
        got = merkle.hash_rows(rows)
        small = merkle.hash_rows(rows[:10])          # below the threshold
        st = merkle.stats()
    finally:
        merkle.set_batched_hasher(None)
        merkle.set_batched_hasher_np(None)
    want = hashlib_digests(rows)
    assert layer == want and got.tobytes() == want
    assert small.tobytes() == want[:320]
    assert st["layer_calls"] == 2 and st["pairs_batched"] == 600
    assert st["pairs_hashlib"] == 10 and st["pair_scalar"] == 10


def test_install_merkle_hasher_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is expected to be used")
    with pytest.raises(RuntimeError, match="CUDA"):
        sha256.install_merkle_hasher()
    with pytest.raises(RuntimeError, match="CUDA"):
        sha256.sha256_bytes(b"abc")


@pytest.mark.parametrize("k", ["hash64", "sha256_blocks", "sha256_chain"])
def test_cuda_tensors_never_take_the_plain_version(monkeypatch, k):
    """Handed CUDA tensors (or the card), a wrapper launches its kernel or
    raises; the plain version must not run."""
    def no_plain(*a, **kw):
        raise AssertionError("plain version used for CUDA tensors")
    monkeypatch.setattr(sha256, "hash64_plain", no_plain)
    monkeypatch.setattr(sha256, "sha256_blocks_plain", no_plain)
    monkeypatch.setattr(sha256, "sha256_chain_plain", no_plain)
    monkeypatch.setattr(_build, "same_device", lambda *t: torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError)) as exc:
        if k == "hash64":
            sha256.hash64(torch.zeros((2, 64), dtype=torch.uint8))
        elif k == "sha256_blocks":
            sha256.sha256_blocks(torch.zeros((2, 1, 16), dtype=torch.int32), 1)
        else:
            sha256.sha256_chain(64, "cuda")
    assert "plain version used" not in str(exc.value)


@pytest.mark.parametrize("k", range(4))
def test_wrappers_validate_arguments(k):
    with pytest.raises((TypeError, ValueError)):
        [lambda: sha256.hash64(torch.zeros((2, 64), dtype=torch.int32)),
         lambda: sha256.hash64(torch.zeros((2, 32), dtype=torch.uint8)),
         lambda: sha256.sha256_blocks(torch.zeros((2, 2, 16), dtype=torch.int32), 1),
         lambda: sha256.sha256_blocks(torch.zeros((2, 0, 16), dtype=torch.int32), 0)][k]()
