"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no silent CPU fallback for the CUDA paths."""
import ast
import os

import pytest
import torch

from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.ops.torch_bls import htc, pairing, points
from consensus_specs_tpu_torch.utils import bls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "consensus_specs_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name == "consensus_specs_tpu"
            or name.startswith("consensus_specs_tpu."))


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert bad == []


def test_use_torch_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: use_torch() is expected to succeed")
    with pytest.raises(RuntimeError, match="CUDA"):
        bls.use_torch()
    assert bls.backend_name() == "py"
    bls.use_torch("cpu")
    assert bls.backend_name() == "torch"
    bls.use_py()


def _k_calls():
    pk = torch.zeros((1, 1, 2, 12), dtype=torch.int32)
    cnt = torch.ones((1,), dtype=torch.int32)
    sig = torch.zeros((1, 2, 2, 12), dtype=torch.int32)
    flag = torch.zeros((1,), dtype=torch.bool)
    sc = torch.ones((1, 4), dtype=torch.int32)
    u = torch.zeros((1, 2, 2, 12), dtype=torch.int32)
    off = torch.tensor([0, 1], dtype=torch.int32)
    return [lambda: points.g1_aggregate_scale(pk, cnt, sc),
            lambda: points.g2_scale_sum(sig, flag, sc),
            lambda: htc.hash_to_g2(u),
            lambda: pairing.pairing_check(pk[0], sig, flag, off),
            lambda: pairing.pairing_check_gt(pk[0], sig, flag, off)]


@pytest.mark.parametrize("k", range(5))
def test_cuda_tensors_never_take_the_plain_version(monkeypatch, k):
    """A wrapper handed CUDA tensors launches its kernel or raises: with the
    device reported as CUDA on a host without one it must raise, and the
    plain version must not run."""
    def no_plain(*a, **kw):
        raise AssertionError("plain version used for CUDA tensors")
    for mod, name in ((points, "g1_aggregate_scale_plain"), (points, "g2_scale_sum_plain"),
                      (htc, "hash_to_g2_plain"), (pairing, "pairing_check_plain"),
                      (pairing, "pairing_check_gt_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    monkeypatch.setattr(_build, "same_device", lambda *t: torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError)) as exc:
        _k_calls()[k]()
    assert "plain version used" not in str(exc.value)


@pytest.mark.parametrize("k", range(4))
def test_wrappers_validate_arguments(k):
    """Wrong dtype, shape, contiguity or pair count is refused before any
    kernel or plain version runs."""
    with pytest.raises((TypeError, ValueError)):
        [lambda: points.g1_aggregate_scale(torch.zeros((1, 1, 2, 12), dtype=torch.int64),
                                           torch.ones((1,), dtype=torch.int32)),
         lambda: points.g2_scale_sum(torch.zeros((1, 2, 2, 11), dtype=torch.int32),
                                     torch.zeros((1,), dtype=torch.bool),
                                     torch.ones((1, 4), dtype=torch.int32)),
         lambda: htc.hash_to_g2(torch.zeros((2, 2, 12, 2), dtype=torch.int32).transpose(2, 3)),
         lambda: pairing.pairing_check(torch.zeros((2, 2, 12), dtype=torch.int32),
                                       torch.zeros((1, 2, 2, 12), dtype=torch.int32),
                                       torch.zeros((2,), dtype=torch.bool),
                                       torch.tensor([0, 2], dtype=torch.int32))][k]()


@pytest.mark.parametrize("k", ["counts", "offsets"])
def test_host_metadata_must_be_on_the_host(k):
    """Row counts and group offsets are validated on the host, so a wrapper
    refuses them on any other device instead of reading them back."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="host"):
        if k == "counts":
            points.g1_aggregate_scale(torch.zeros((1, 1, 2, 12), dtype=torch.int32),
                                      torch.ones((1,), dtype=torch.int32, device=meta))
        else:
            pairing.pairing_check(torch.zeros((1, 2, 12), dtype=torch.int32),
                                  torch.zeros((1, 2, 2, 12), dtype=torch.int32),
                                  torch.zeros((1,), dtype=torch.bool),
                                  torch.tensor([0, 1], dtype=torch.int32, device=meta))


def test_entry_device_resolution():
    assert _build.device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _build.device(None)


@pytest.mark.parametrize("module", ["consensus_specs_tpu_torch.forkchoice.proto_array",
                                    "consensus_specs_tpu_torch.forks.fork_choice"])
def test_fork_choice_modules_stand_alone(module):
    """The fork-choice modules are among the scanned files, and importing
    them (with the fork runtimes they pull in) loads neither JAX nor the
    JAX package."""
    import subprocess
    import sys
    assert os.path.join(REPO, *module.split(".")) + ".py" in _port_files()
    probe = ("import sys, importlib; importlib.import_module(sys.argv[1]); "
             "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
             "'consensus_specs_tpu') or m.startswith(('jax.', 'consensus_specs_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", probe, module], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
