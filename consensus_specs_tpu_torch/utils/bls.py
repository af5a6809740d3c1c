"""BLS backend switch and the deferred block batch.

Counterpart of ``consensus_specs_tpu/utils/bls.py``:

  use_py()                 the pure-Python oracle
  use_torch(device=None)   the CUDA kernels (None means the card; a host
                           without CUDA raises - pass "cpu" for the
                           plain PyTorch versions)

plus the test kill-switch ``bls_active`` (when False, signing returns
stubs and verification passes, as the reference's ``bls.py:49-57``).

``batched_verification()`` opens a block's deferred-verification scope:
inside it, ``Verify`` and ``FastAggregateVerify`` queue their triple in
the scope's ``DeferredBatch`` and return True, and the caller's
``assert_valid()`` flushes the queue as one RLC product pairing
(``ops/bls_rlc.py``); when the combined check fails, or an item is
structurally invalid, it bisects through the per-lane batch verify so
``last_results`` names exactly the failing items, as
``utils/bls.py:207-294`` of the JAX package does.

Raw pairing-product checks join the same flush: inside a scope,
``defer_pairing_check(pairs, label)`` queues ``prod e(P_i, Q_i) == 1``
(the blob-KZG batch, the DAS cell batch) and answers True; the flush
folds each check's pairs in with a scalar of its own, and on a failure
evaluates every deferred check alone, so ``last_pairing_results`` names
the failing checks.  Outside a scope it answers False and the caller
evaluates the check at once.  ``pairings`` counts pairing-check
evaluations, so a run can show one product pairing per block.  Verdicts
are memoized by their byte inputs (cleared on a backend switch).  The
JAX package's supervisor, fault sites, observability counters and its
``CS_TPU_BLS_RLC`` switch (the port always folds) are host machinery
this port does not carry.
"""
from contextlib import contextmanager

from ..ops import bls_rlc
from ..ops.bls12_381 import ciphersuite as _py_backend
from .lru import LRUDict

bls_active = True

STUB_SIGNATURE = b"\x11" * 96
STUB_PUBKEY = b"\x22" * 48

_backend = _py_backend
_backend_name = "py"
_device = None


def use_py():
    global _backend, _backend_name, _device
    if _backend_name != "py":
        clear_verify_memo()
    _backend, _backend_name, _device = _py_backend, "py", None


def use_torch(device=None):
    """Select the CUDA backend on ``device`` (None = the card).  Raises on a
    host without CUDA unless ``device`` names the CPU."""
    global _backend, _backend_name, _device
    from .. import _build
    from ..ops import bls_torch
    _device = _build.device(device)
    clear_verify_memo()
    _backend, _backend_name = bls_torch, "torch"


def backend_name() -> str:
    return _backend_name


def backend_device():
    """The torch backend's device (None under the py backend)."""
    return _device


def _call(fn, *args):
    if _backend_name == "torch":
        return getattr(_backend, fn)(*args, device=_device)
    return getattr(_backend, fn)(*args)


def only_with_bls(alt_return=None):
    """Decorator: skip the wrapped call when bls is disabled."""
    def decorator(fn):
        def wrapper(*args, **kwargs):
            if not bls_active:
                return alt_return
            return fn(*args, **kwargs)
        return wrapper
    return decorator


# Verification results are pure functions of their byte inputs, so a
# bounded memo is transparent; a replayed block's signatures skip the
# card.  Cleared on every backend switch, and by callers that time the
# kernels.
_verify_memo = LRUDict(1 << 16)


def clear_verify_memo() -> None:
    _verify_memo.clear()


class DeferredBatch:
    """Signature-verification triples (and deferred raw pairing-product
    checks, e.g. the blob-KZG batch) collected under one block."""

    def __init__(self):
        self.items = []            # (pubkeys, message, signature)
        self.item_keys = []        # per item: memo keys to record at flush
        self.pairing_checks = []   # (pairs, label): raw product checks
        self._seen = {}            # triple -> index (in-batch dedup)
        self.last_results = None
        self.last_pairing_results = None
        self.pairings = 0          # pairing-check evaluations so far

    def add(self, pubkeys, message, signature, memo_key=None):
        item = ([bytes(pk) for pk in pubkeys], bytes(message), bytes(signature))
        if memo_key is None:
            memo_key = ("fav", tuple(item[0]), item[1], item[2])
        dedup = (tuple(item[0]), item[1], item[2])
        idx = self._seen.get(dedup)
        if idx is not None:
            # identical triple already queued: one lane serves both call
            # sites, both memo keys get the result
            if memo_key not in self.item_keys[idx]:
                self.item_keys[idx].append(memo_key)
            return
        self._seen[dedup] = len(self.items)
        self.items.append(item)
        self.item_keys.append([memo_key])

    def add_pairing_check(self, pairs, label=""):
        """Defer a raw product-pairing check ``prod e(P_i, Q_i) == 1``
        (oracle point pairs): it folds into the flush with a scalar of its
        own and is evaluated alone on the bisect path."""
        self.pairing_checks.append(([(p, q) for p, q in pairs], str(label)))

    @staticmethod
    def _lane_results(items) -> list:
        if not items:
            return []
        if _backend_name == "torch":
            return _backend.verify_aggregates_batch(items, device=_device)
        return [_backend.FastAggregateVerify(pks, msg, sig) for pks, msg, sig in items]

    def _record(self, keys, results) -> None:
        for ks, ok in zip(keys, results):
            for k in ks:
                _verify_memo[k] = ok
        self.last_results = results

    def flush(self) -> bool:
        items, keys, checks = self.items, self.item_keys, self.pairing_checks
        self.items, self.item_keys, self.pairing_checks, self._seen = [], [], [], {}
        if not items and not checks:
            return True
        verdict = bls_rlc.combined_check(items, checks, _backend_name, _device)
        if verdict is not None:
            self.pairings += 1     # the one combined product pairing
        if verdict is True:
            self._record(keys, [True] * len(items))
            self.last_pairing_results = [True] * len(checks)
            return True
        # combined failure or a structurally invalid item: bisect through
        # the per-lane path, and evaluate each deferred check alone, for
        # exact per-item and per-check results
        from ..ops.kzg import _pairing_check
        results = [bool(r) for r in self._lane_results(items)]
        pairing_results = [bool(_pairing_check(pairs)) for pairs, _ in checks]
        self.pairings += len(items) + len(checks)
        self._record(keys, results)
        self.last_pairing_results = pairing_results
        return all(results) and all(pairing_results)

    def assert_valid(self):
        if not self.flush():
            failed = [i for i, r in enumerate(self.last_results or []) if not r]
            failed_checks = [i for i, r in enumerate(self.last_pairing_results or []) if not r]
            raise AssertionError("batched signature verification failed "
                                 f"(items {failed}, deferred checks {failed_checks})")


_batch_stack = []


@contextmanager
def batched_verification():
    """Defer assert-style signature checks to one batched flush.

    Re-entrant: a nested context joins the enclosing batch, so a whole
    ``state_transition`` (block signature and body) flushes once."""
    if _batch_stack:
        yield _batch_stack[-1]
        return
    batch = DeferredBatch()
    _batch_stack.append(batch)
    try:
        yield batch
    finally:
        _batch_stack.pop()


def batch_scope_active() -> bool:
    """True while any deferred-verification scope is open."""
    return bool(_batch_stack)


@contextmanager
def scoped_batch(batch):
    """Install ``batch`` as the outermost deferred-verification scope, so
    the caller keeps the batch a transition flushes (its ``pairings`` and
    ``last_results``).  Refuses to nest inside an active scope."""
    if _batch_stack:
        raise RuntimeError("bls.scoped_batch: a batch scope is already active")
    _batch_stack.append(batch)
    try:
        yield batch
    finally:
        popped = _batch_stack.pop()
        assert popped is batch


def defer_pairing_check(pairs, label="") -> bool:
    """Queue a raw product-pairing check ``prod e(P_i, Q_i) == 1`` (oracle
    point pairs) into the active batch scope, to fold into the block's one
    product pairing; True once queued.  False when no scope is open: the
    caller then evaluates the check at once.  Deferred checks are
    assert-style, as every deferred verification is."""
    if not _batch_stack:
        return False
    _batch_stack[-1].add_pairing_check(pairs, label)
    return True


def _verify_or_queue(fn, pks, msg, sig, eager) -> bool:
    """Memo first (a memoized failure surfaces at once, as it would at the
    flush); inside a batch scope queue the triple and answer True, else
    call the backend's ``fn``."""
    key = ("v", pks[0], msg, sig) if fn == "Verify" else ("fav", tuple(pks), msg, sig)
    hit = _verify_memo.get(key)
    if hit is not None:
        return hit
    if _batch_stack and not eager:
        _batch_stack[-1].add(pks, msg, sig, memo_key=key)
        return True
    ok = bool(_call(fn, pks[0] if fn == "Verify" else pks, msg, sig))
    _verify_memo[key] = ok
    return ok


@only_with_bls(alt_return=True)
def Verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    return _verify_or_queue("Verify", [bytes(pk)], bytes(msg), bytes(sig), eager=False)


@only_with_bls(alt_return=True)
def VerifyEager(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Immediate verification even inside a batch scope, for call sites
    where the verdict steers state (the deposit proof of possession,
    ``specs/phase0/beacon-chain.md:1877``) rather than block validity."""
    return _verify_or_queue("Verify", [bytes(pk)], bytes(msg), bytes(sig), eager=True)


@only_with_bls(alt_return=True)
def FastAggregateVerify(pks, msg: bytes, sig: bytes) -> bool:
    return _verify_or_queue("FastAggregateVerify", [bytes(p) for p in pks],
                            bytes(msg), bytes(sig), eager=False)


@only_with_bls(alt_return=True)
def AggregateVerify(pks, msgs, sig: bytes) -> bool:
    return _call("AggregateVerify", [bytes(p) for p in pks],
                 [bytes(m) for m in msgs], bytes(sig))


@only_with_bls(alt_return=STUB_SIGNATURE)
def Sign(sk: int, msg: bytes) -> bytes:
    return _py_backend.Sign(sk, bytes(msg))


@only_with_bls(alt_return=STUB_PUBKEY)
def SkToPk(sk: int) -> bytes:
    return _py_backend.SkToPk(sk)


@only_with_bls(alt_return=STUB_SIGNATURE)
def Aggregate(signatures) -> bytes:
    return _py_backend.Aggregate([bytes(s) for s in signatures])


@only_with_bls(alt_return=STUB_PUBKEY)
def AggregatePKs(pubkeys) -> bytes:
    return _backend.AggregatePKs([bytes(p) for p in pubkeys])


@only_with_bls(alt_return=True)
def KeyValidate(pk: bytes) -> bool:
    return _py_backend.KeyValidate(bytes(pk))
