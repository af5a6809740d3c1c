"""Load preset and config YAML into typed python values.

Counterpart of ``consensus_specs_tpu/config/loader.py`` (reference
behavior: ``setup.py:306-331`` load_preset/load_config and
``config/config_util.py:5-63`` parse_config_vars).  The files are the
port's own copies, resolved from this package's root: ``presets/<name>/
<fork>.yaml`` and ``configs/<name>.yaml``.  Values that look like
integers become ``int``; ``0x...`` values stay hex strings here (the
spec converts them to the right SSZ byte types).
"""
import os
from pathlib import Path
from typing import Any, Dict

PKG_ROOT = Path(__file__).resolve().parent.parent

# the forks whose preset files this package carries, in fork order
FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb", "eip7594")


def _read_flat_yaml(path) -> Dict[str, str]:
    """Parse a flat ``KEY: value`` yaml file preserving ``0x...`` tokens
    (PyYAML would turn unquoted hex into int and lose the byte width)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = v.strip().strip("'\"")
    return out


def preset_dir(preset_name: str) -> Path:
    return PKG_ROOT / "presets" / preset_name


def config_path(config_name: str) -> Path:
    return PKG_ROOT / "configs" / (config_name + ".yaml")


def _parse_value(v: Any) -> Any:
    if isinstance(v, int):
        return v
    if isinstance(v, str):
        s = v.strip()
        if s.startswith("0x"):
            return s  # hex constant; typed later
        if s.isdigit() or (s.startswith("-") and s[1:].isdigit()):
            return int(s)
    return v


def load_preset(preset_name: str) -> Dict[str, Any]:
    """Merge the per-fork preset files of a preset base into one dict."""
    base = preset_dir(preset_name)
    if not base.is_dir():
        raise FileNotFoundError(f"unknown preset: {preset_name!r} ({base})")
    out: Dict[str, Any] = {}
    for fork in FORKS:
        p = base / (fork + ".yaml")
        if not p.exists():
            continue
        for k, v in _read_flat_yaml(p).items():
            out[k] = _parse_value(v)
    return out


def parse_config_vars(conf: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _parse_value(v) for k, v in conf.items()}


def load_config_file(path: os.PathLike) -> Dict[str, Any]:
    return parse_config_vars(_read_flat_yaml(path))


def load_config(config_name: str) -> Dict[str, Any]:
    return load_config_file(config_path(config_name))
