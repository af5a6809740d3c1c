"""Per-fork spec runtimes.

Counterpart of ``consensus_specs_tpu/forks/__init__.py``.  Each fork is a
class extending the previous fork's class; ``build_spec(fork, preset)``
instantiates a fork spec bound to a preset and config, cached per
(fork, preset, overrides).  The port carries phase0, Altair, Bellatrix,
Capella, Deneb and EIP-7594.  ``register_fork`` installs the batched
attestation message preparation (``ops/att_prep.py``) on every fork
class.  The JAX package's tracing install and its markdown-compiled
ladder are not carried; what its DAS install does, the EIP-7594 spec's
own methods do (``forks/eip7594.py``).
"""
from typing import Dict, Optional, Tuple

_REGISTRY = {}


def register_fork(name):
    def deco(cls):
        from ..ops.att_prep import install_att_prep
        install_att_prep(cls)
        _REGISTRY[name] = cls
        cls.fork = name
        return cls
    return deco


def fork_registry() -> Dict[str, type]:
    if not _REGISTRY:
        from . import phase0, altair, bellatrix, capella, deneb, eip7594  # noqa: F401
    return dict(_REGISTRY)


_spec_cache: Dict[Tuple[str, str, Optional[frozenset]], object] = {}


def build_spec(fork: str, preset_name: str, config_overrides: Optional[dict] = None):
    """Build (or fetch cached) spec instance for fork x preset."""
    key = (fork, preset_name,
           frozenset(config_overrides.items()) if config_overrides else None)
    spec = _spec_cache.get(key)
    if spec is None:
        from ..config import load_preset, load_config
        registry = fork_registry()
        if fork not in registry:
            raise ValueError(f"unknown fork {fork!r}; have {sorted(registry)}")
        preset = load_preset(preset_name)
        config = load_config(preset_name)
        if config_overrides:
            config = {**config, **config_overrides}
        spec = registry[fork](preset, config, preset_name=preset_name)
        _spec_cache[key] = spec
    return spec
