"""Preset / config system (counterpart of ``consensus_specs_tpu/config``):
presets are compile-time constants (SSZ list lengths, committee sizes),
configs are runtime parameters (fork versions, genesis parameters);
spec classes bind both at instance-build time."""
from .loader import (
    load_preset,
    load_config,
    load_config_file,
    parse_config_vars,
    preset_dir,
    config_path,
)

__all__ = [
    "load_preset",
    "load_config",
    "load_config_file",
    "parse_config_vars",
    "preset_dir",
    "config_path",
]
