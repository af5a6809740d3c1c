"""Device probe, kernel build and launch plumbing.

Counterpart of ``consensus_specs_tpu/utils/jax_env.py`` (device
selection) and ``tools/warm.py`` (ahead-of-use compilation).

On first use the package's ``csrc/*.cu`` compile with ``nvcc`` for
``sm_90a``, one process per source started together, into shared
libraries with a plain C interface under ``build/`` (which ``.gitignore``
lists), loaded with ``ctypes``.  The library names carry a hash of every
source and of the generated constants header, so an edit rebuilds and a
stale library is never loaded.  Nothing here runs at import.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .ops.bls12_381 import fields as _F

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
LIBS = ("points", "htc", "pairing", "sha256", "msm", "fr_fft", "epoch", "mesh",
        "mesh_merkle")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# kernel name -> launches on the card since the last reset (one per
# wrapper call that launched the kernel; CPU calls do not count)
launches = {"g1_aggregate_scale": 0, "g2_scale_sum": 0, "hash_to_g2": 0,
            "pairing_check": 0, "hash64": 0, "sha256_blocks": 0, "sha256_chain": 0,
            "expand_windows": 0, "g1_msm": 0, "fr_fft": 0,
            "phase0_deltas": 0, "effective_balance": 0, "slashings": 0,
            "altair_deltas": 0, "inactivity_updates": 0, "epoch_reduce": 0,
            "incl_scan": 0, "registry_scan": 0, "merkle_levels": 0}

_lock = threading.Lock()
_libs = {}
build_seconds = None
ptxas_report = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def device(dev=None) -> torch.device:
    """Resolve an entry point's ``device`` argument: None means the card.
    A CUDA device on a host without one raises; nothing drops to the CPU
    silently."""
    d = torch.device("cuda" if dev is None else dev)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' for the plain versions")
    return d


# ---------------------------------------------------------------------------
# constants header, generated from the python oracle
# ---------------------------------------------------------------------------

def _words(n: int, k: int = 12) -> str:
    return "{" + ", ".join(f"0x{(n >> (32 * i)) & 0xFFFFFFFF:08x}u"
                           for i in range(k)) + "}"


def _mont(n: int) -> int:
    return (n % _F.P) * ((1 << 384) % _F.P) % _F.P


def constants_header() -> str:
    """Every constant the kernels need, derived from the oracle modules:
    raw words for the moduli and exponents, Montgomery form otherwise
    (R = 2^384 for Fq, 2^256 for Fr)."""
    P, R = _F.P, _F.R_ORDER
    n0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
    out = ["// generated by consensus_specs_tpu_torch/_build.py; do not edit",
           "#pragma once",
           f"#define BLS_P_WORDS {_words(P)}",
           f"#define BLS_N0 0x{n0:08x}u",
           f"#define BLS_ONE_WORDS {_words(_mont(1))}",
           f"#define BLS_R3_WORDS {_words(pow(2, 3 * 384, P))}",
           f"#define BLS_B3_G1_WORDS {_words(_mont(12))}",
           f"#define BLS_ABS_X 0x{-_F.X_PARAM:016x}ull",
           f"#define BLS_R_WORDS {_words(R, 8)}",
           f"#define BLS_R_N0 0x{(-pow(R, -1, 1 << 32)) % (1 << 32):08x}u"]
    return "\n".join(out) + "\n"


def sha256_constants() -> str:
    """SHA-256's round constants, initial state and the pad block's K + W
    table, from the plain version's module."""
    from .ops import sha256 as S

    def arr(name, vals):
        return (f"#define {name} {{" + ", ".join(f"0x{v:08x}u" for v in vals)
                + "}")
    return "\n".join(["#pragma once", arr("SHA_K", S.K), arr("SHA_H0", S.H0),
                      arr("SHA_PAD_KW", S.PAD_KW)]) + "\n"


# The sources pairing_programs() generates K2-K4's tables from: the digest
# hashes them, so that loading a built library never traces the programs.
PROGRAM_SOURCES = ("ops/torch_bls/team_programs.py", "ops/torch_bls/limbs.py",
                   "ops/bls12_381/fields.py", "ops/bls12_381/hash_to_curve.py")


@functools.lru_cache(maxsize=None)
def pairing_programs() -> str:
    """K2-K4's team programs as tables (``ops/torch_bls/team_programs.py``;
    traced and scheduled once per process, ~3 s)."""
    from .ops.torch_bls import team_programs
    return team_programs.header()


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(constants_header().encode())
    h.update(sha256_constants().encode())
    for rel in PROGRAM_SOURCES:
        h.update(rel.encode())
        h.update((PKG / rel).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def build_all() -> dict:
    """Compile every library whose build is missing; one nvcc per source,
    all started together.  Returns {name: path}.  Raises on a failed
    build, with the compiler's output."""
    global build_seconds
    tag = _digest()
    gen = BUILD / f"gen-{tag}"
    paths = {n: BUILD / f"lib{n}-{tag}.so" for n in LIBS}
    todo = [n for n in LIBS if not paths[n].exists()]
    if not todo:
        return paths
    gen.mkdir(parents=True, exist_ok=True)
    (gen / "bls_constants.cuh").write_text(constants_header())
    (gen / "sha256_constants.cuh").write_text(sha256_constants())
    (gen / "pairing_programs.cuh").write_text(pairing_programs())
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-I", str(gen), "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        (BUILD / f"{n}-{tag}.log").write_text(text)
        ptxas_report[n] = text
        if proc.returncode != 0:
            errors.append(f"--- {n}.cu (rc {proc.returncode})\n{text[-4000:]}")
        else:
            os.replace(tmp, paths[n])
    build_seconds = time.perf_counter() - t0
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths


_VP = ctypes.c_void_p
_SIGS = {
    "g1_aggregate_scale": [_VP, _VP, _VP, _VP, _VP, ctypes.c_int,
                           ctypes.c_int, _VP],
    "g2_scale_sum": [_VP] * 7 + [ctypes.c_int, _VP],
    "hash_to_g2": [_VP, _VP, _VP, ctypes.c_int, _VP],
    "pairing_check": [_VP] * 7 + [ctypes.c_int] * 3 + [_VP],
    "hash64": [_VP, _VP, ctypes.c_int, _VP],
    "sha256_blocks": [_VP, _VP, ctypes.c_int, ctypes.c_int, _VP],
    "sha256_chain": [_VP, ctypes.c_int, _VP],
    "expand_windows": [_VP, _VP, _VP, ctypes.c_int, _VP],
    "g1_msm": [_VP, _VP, _VP, ctypes.c_longlong, _VP, _VP, ctypes.c_int, _VP, _VP],
    "fr_fft": [_VP, _VP, _VP] + [ctypes.c_int] * 5 + [_VP],
    "phase0_deltas": [_VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, _VP, _VP],
    "effective_balance": [_VP, _VP, _VP, ctypes.c_longlong] + [ctypes.c_ulonglong] * 4
    + [_VP],
    "slashings": [_VP, _VP, _VP, _VP, ctypes.c_longlong, _VP, _VP],
    "altair_deltas": [_VP] * 7 + [ctypes.c_longlong, _VP, _VP],
    "inactivity_updates": [_VP] * 5 + [ctypes.c_longlong, ctypes.c_ulonglong,
                                       ctypes.c_ulonglong, ctypes.c_int, _VP],
    "epoch_reduce": [_VP] * 16 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
    + [ctypes.c_ulonglong] * 3 + [_VP],
    "incl_scan": [_VP, _VP, ctypes.c_longlong, _VP, ctypes.c_longlong, ctypes.c_int, _VP],
    "registry_scan": [_VP] * 4 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_ulonglong] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [_VP] * 5,
    "merkle_levels": [_VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_ulonglong, _VP],
}
_HOME = {"g1_aggregate_scale": "points", "g2_scale_sum": "points",
         "hash_to_g2": "htc", "pairing_check": "pairing",
         "hash64": "sha256", "sha256_blocks": "sha256", "sha256_chain": "sha256",
         "expand_windows": "msm", "g1_msm": "msm", "fr_fft": "fr_fft",
         "phase0_deltas": "epoch", "effective_balance": "epoch", "slashings": "epoch",
         "altair_deltas": "epoch", "inactivity_updates": "epoch",
         "epoch_reduce": "mesh", "incl_scan": "mesh", "registry_scan": "mesh",
         "merkle_levels": "mesh_merkle"}


def load(lib: str) -> ctypes.CDLL:
    with _lock:
        if lib not in _libs:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            paths = build_all()
            handle = ctypes.CDLL(str(paths[lib]))
            for fn, argtypes in _SIGS.items():
                if _HOME[fn] == lib:
                    getattr(handle, fn).argtypes = argtypes
                    getattr(handle, fn).restype = ctypes.c_int
            _libs[lib] = handle
        return _libs[lib]


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Validate a kernel argument: dtype, shape (None = any extent), device
    and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_host(t: torch.Tensor, name: str) -> None:
    """Host metadata (row counts, group offsets) stays on the host, where
    validating it costs no wait on the card."""
    if t.device.type != "cpu":
        raise ValueError(f"{name}: expected a host (CPU) tensor, got {t.device}")


def to_card(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Copy a host tensor to ``dev`` through pinned memory, without waiting
    for work already queued on the card."""
    return t.pin_memory().to(dev, non_blocking=True)


def to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``to_card`` for a CUDA device; a host tensor stays as it is."""
    return to_card(t, dev) if dev.type == "cuda" else t


def same_device(*ts) -> torch.device:
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"arguments on several devices: {devs}")
    d = devs.pop()
    if d.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d}")
    return d


def launch(fn: str, *args, count: int = 1) -> None:
    """Call a kernel's C entry on the current stream; tensors pass as
    pointers.  Raises if the launch reported an error.  ``count``: the
    CUDA launches the entry makes (added to ``launches[fn]``)."""
    lib = load(_HOME[fn])
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, fn)(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")
    launches[fn] += count
