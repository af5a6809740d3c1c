"""Incremental fork-choice engines.

Counterpart of ``consensus_specs_tpu/forkchoice/__init__.py``:
``proto_array`` holds the flat-array, delta-propagating LMD-GHOST
engine and the install hook that wraps a spec class's fork-choice
surface with its dispatch; the spec-shaped fork choice stays in
``forks/fork_choice.py``.
"""
from .proto_array import (  # noqa: F401
    ProtoArrayEngine, attach_store_accel, install_forkchoice_accel,
    enabled, use_proto, use_spec, use_auto, stats, reset_stats,
)
