"""Data-availability-sampling crypto (EIP-7594 / PeerDAS).

Counterpart of ``consensus_specs_tpu/das/``: :mod:`kernels` holds the
batched cell-proof verification (one product pairing per batch) and the
columnar multi-blob erasure recovery, whose FFT phases run on kernel K9
under the torch backend.  The JAX package's dispatch layer
(``das/engine.py``: the live switch, fault sites, breaker and audits)
is not carried.
"""
