"""SHA-256 ``hash`` primitive.

Counterpart of ``consensus_specs_tpu/utils/hash_function.py``: the spec's
``hash(data) -> Bytes32`` is plain SHA-256 of one message and stays on
hashlib on the host; batched layer hashing for merkleization goes
through ``ops/sha256.py`` (kernel K5) once a hasher is installed.
"""
from hashlib import sha256 as _sha256


def hash(data: bytes) -> bytes:
    return _sha256(data).digest()
