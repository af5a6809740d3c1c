"""Columnar state layer.

Counterpart of ``consensus_specs_tpu/state``.  ``state.arrays`` is the
one place where SSZ beacon-state sequences are extracted into columns,
copied to and from the card, and committed back.
"""
from . import arrays  # noqa: F401
