"""Plain Fr arithmetic (``ops/torch_bls/fr.py``) against python ints, and
K9's host entry ``fft_batch`` (``ops/fr_fft.py``) on the CPU, where
every stage runs the plain ``fr_butterfly``, against the JAX package's
``consensus_specs_tpu/ops/jax_bls/fr_fft.fft_batch`` (numpy-kernel mode,
in a subprocess started first) and against both packages' host
``kzg_7594.fft_field``.  Exact: field elements compare as ints."""
import json

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import kzg as JK
from consensus_specs_tpu.ops import kzg_7594 as JK7
from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.ops import fr_fft
from consensus_specs_tpu_torch.ops import kzg_7594 as PK7
from consensus_specs_tpu_torch.ops.torch_bls import fr as F
from tests._torch_port import finish, one_torch_thread, start_numpy_kernels  # noqa: F401

R = F.R_ORDER
R_INV = pow(1 << 256, -1, R)
SEED = 7594
SIZES = (1, 2, 256)
ROWS = 4

_JAX_FFT = r"""
import json, sys
from consensus_specs_tpu.ops.jax_bls.backend import NUMPY_KERNELS
assert NUMPY_KERNELS
from consensus_specs_tpu.ops import kzg as K
from consensus_specs_tpu.ops.jax_bls import fr_fft
out = {}
for n, rows in json.loads(sys.argv[1]).items():
    rows = [[int(x) for x in r] for r in rows]
    roots = list(K.compute_roots_of_unity(int(n)))
    out[n] = {"fwd": fr_fft.fft_batch(rows, roots),
              "inv": fr_fft.fft_batch(rows, roots, inv=True)}
print("RESULT=" + json.dumps({n: {k: [[str(x) for x in r] for r in v] for k, v in d.items()}
                              for n, d in out.items()}))
"""


def _values(rng, n):
    edge = [0, 1, R - 1, R - 2]
    return edge + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n - len(edge))]


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_plain_fr_ops_match_python_ints(op):
    rng = np.random.default_rng(SEED)
    a = _values(rng, 64)
    b = [R - 1, 0, 1, R - 1] + _values(rng, 60)
    la, lb = (F.unpack(torch.from_numpy(F.words_from_ints(v))) for v in (a, b))
    got = F.ints_from_words(F.pack(getattr(F, op)(la, lb)))
    want = {"mont_mul": lambda x, y: x * y * R_INV % R,
            "add_mod": lambda x, y: (x + y) % R,
            "sub_mod": lambda x, y: (x - y) % R}[op]
    assert got == [want(x, y) for x, y in zip(a, b)]


def test_words_and_montgomery_round_trip():
    """Words round-trip; ``words_from_ints(mont_form=True)`` (the twiddle
    tables) gives v R, which a product by R^2 also gives."""
    rng = np.random.default_rng(SEED + 1)
    vals = _values(rng, 16)
    assert F.ints_from_words(F.words_from_ints(vals)) == vals
    mont = F.ints_from_words(F.words_from_ints(vals, mont_form=True))
    assert mont == [v * (1 << 256) % R for v in vals]
    r2 = F.unpack(torch.from_numpy(F.words_from_ints([F.R_MONT * F.R_MONT % R])))
    x = F.unpack(torch.from_numpy(F.words_from_ints(vals)))
    assert F.ints_from_words(F.pack(F.mont_mul(x, r2))) == mont


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(SEED + 2)
    rows = {n: [_values(rng, max(n, 4))[:n]]
            + [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
               for _ in range(ROWS - 1)] for n in SIZES}
    rows[256][1] = [0] * 256
    proc = start_numpy_kernels(_JAX_FFT, json.dumps(
        {str(n): [[str(x) for x in r] for r in v] for n, v in rows.items()}))
    ours = {}
    for n, v in rows.items():
        roots = list(JK.compute_roots_of_unity(n))
        fwd = fr_fft.fft_batch(v, roots, device="cpu")
        inv = fr_fft.fft_batch(v, roots, inv=True, device="cpu")
        ours[n] = {"fwd": fwd, "inv": inv,
                   "round": fr_fft.fft_batch(fwd, roots, inv=True, device="cpu")}
    theirs = json.loads(finish(proc).split("RESULT=", 1)[1])
    theirs = {int(n): {k: [[int(x) for x in r] for r in rr] for k, rr in d.items()}
              for n, d in theirs.items()}
    return rows, ours, theirs


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_fft_batch_matches_jax_fft_batch(case, n, direction):
    _, ours, theirs = case
    assert ours[n][direction] == theirs[n][direction]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_fft_batch_matches_host_fft_field(case, n, direction):
    rows, ours, _ = case
    roots = list(JK.compute_roots_of_unity(n))
    inv = direction == "inv"
    assert ours[n][direction] == [JK7.fft_field(r, roots, inv=inv) for r in rows[n]]
    assert ours[n][direction] == [PK7.fft_field(r, roots, inv=inv) for r in rows[n]]


@pytest.mark.parametrize("n", SIZES)
def test_fft_batch_round_trip(case, n):
    rows, ours, _ = case
    assert ours[n]["round"] == rows[n]


def test_stage_pairs_cover_every_index_once():
    """The butterfly index rule of K9 (and its plain version) touches each
    position exactly once per stage, pairs at distance ``half`` and uses
    twiddle j * n / 2h."""
    n = 64
    half = 1
    while half < n:
        lo, hi, tw = fr_fft._pairs(n, half, "cpu")
        assert sorted(torch.cat([lo, hi]).tolist()) == list(range(n))
        assert ((hi - lo) == half).all() and (tw < n // 2).all()
        assert (tw == (lo % (2 * half)) * (n // (2 * half))).all()
        half *= 2


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    def no_plain(*a, **kw):
        raise AssertionError("plain version used for CUDA tensors")
    monkeypatch.setattr(fr_fft, "fr_butterfly_plain", no_plain)
    monkeypatch.setattr(_build, "same_device", lambda *t: torch.device("cuda"))
    vals = torch.zeros((1, 4, 8), dtype=torch.int32)
    with pytest.raises((RuntimeError, AssertionError)) as exc:
        fr_fft.fr_butterfly(vals, torch.zeros((2, 8), dtype=torch.int32), 1)
    assert "plain version used" not in str(exc.value)


@pytest.mark.parametrize("k", range(3))
def test_wrapper_validates_arguments(k):
    vals = torch.zeros((1, 4, 8), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        [lambda: fr_fft.fr_butterfly(vals.long(), torch.zeros((2, 8), dtype=torch.int32), 1),
         lambda: fr_fft.fr_butterfly(vals, torch.zeros((4, 8), dtype=torch.int32), 1),
         lambda: fr_fft.fr_butterfly(vals, torch.zeros((2, 8), dtype=torch.int32), 3)][k]()
