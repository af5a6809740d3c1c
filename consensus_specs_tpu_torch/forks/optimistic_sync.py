"""Optimistic sync (Bellatrix and later).

Counterpart of ``consensus_specs_tpu/forks/optimistic_sync.py``.
Behavioral source: ``sync/optimistic.md`` (compiled into bellatrix+ by the
reference, ``pysetup/md_doc_paths.py:34-36``): the OptimisticStore, the
optimistic/verified block distinction, and the candidate-import rule that
lets nodes import execution blocks before the execution engine has
validated them.
"""
from dataclasses import dataclass, field
from typing import Dict, Set

from ..utils.ssz import hash_tree_root

SAFE_SLOTS_TO_IMPORT_OPTIMISTICALLY = 128  # preset (optimistic.md:55)


@dataclass
class OptimisticStore:
    """optimistic.md:87"""
    optimistic_roots: Set[bytes]
    head_block_root: bytes
    blocks: Dict[bytes, object] = field(default_factory=dict)
    block_states: Dict[bytes, object] = field(default_factory=dict)


class OptimisticSyncMixin:
    """Mixed into bellatrix+ spec classes."""

    OptimisticStore = OptimisticStore
    SAFE_SLOTS_TO_IMPORT_OPTIMISTICALLY = SAFE_SLOTS_TO_IMPORT_OPTIMISTICALLY

    def get_optimistic_store(self, anchor_state, anchor_block):
        # anchor must be self-consistent (optimistic.md store init)
        assert bytes(anchor_block.state_root) == hash_tree_root(anchor_state)
        root = hash_tree_root(anchor_block)
        return OptimisticStore(
            optimistic_roots=set(),
            head_block_root=bytes(root),
            blocks={bytes(root): anchor_block.copy()},
            block_states={bytes(root): anchor_state.copy()},
        )

    def is_optimistic(self, opt_store, block) -> bool:
        """optimistic.md:96"""
        return bytes(hash_tree_root(block)) in opt_store.optimistic_roots

    def latest_verified_ancestor(self, opt_store, block):
        """optimistic.md:101 — ``block`` must not be INVALIDATED."""
        while True:
            if not self.is_optimistic(opt_store, block) \
                    or bytes(block.parent_root) == b"\x00" * 32:
                return block
            block = opt_store.blocks[bytes(block.parent_root)]

    def is_execution_block(self, block) -> bool:
        """optimistic.md:110"""
        return block.body.execution_payload != self.ExecutionPayload()

    def is_optimistic_candidate_block(self, opt_store, current_slot,
                                      block) -> bool:
        """optimistic.md:115 — import optimistically once the parent is an
        execution block or the block is old enough."""
        if self.is_execution_block(opt_store.blocks[bytes(block.parent_root)]):
            return True
        if block.slot + self.SAFE_SLOTS_TO_IMPORT_OPTIMISTICALLY \
                <= current_slot:
            return True
        return False

    def import_optimistic_block(self, opt_store, block) -> None:
        """Import a block whose execution payload has NOT been validated
        (optimistic.md "when importing an optimistic block").  The parent
        must already be in the store and not INVALIDATED."""
        root = bytes(hash_tree_root(block))
        assert bytes(block.parent_root) in opt_store.blocks
        opt_store.blocks[root] = block.copy()
        opt_store.optimistic_roots.add(root)

    def on_payload_status(self, opt_store, block_root: bytes,
                          valid: bool) -> None:
        """Execution-engine verdict for an optimistically-imported block
        (optimistic.md "how to apply" transitions):

        - VALID: the block and every optimistic ancestor become verified
          (a payload is only valid if its ancestors are).
        - INVALIDATED: the block and all its descendants are removed from
          the store entirely — they can never become canonical.
        """
        block_root = bytes(block_root)
        assert block_root in opt_store.blocks
        if valid:
            block = opt_store.blocks[block_root]
            while True:
                opt_store.optimistic_roots.discard(
                    bytes(hash_tree_root(block)))
                parent = bytes(block.parent_root)
                if parent not in opt_store.blocks:
                    break
                parent_block = opt_store.blocks[parent]
                if not self.is_optimistic(opt_store, parent_block):
                    break
                block = parent_block
            return
        # INVALIDATED: only not-yet-validated blocks can transition
        # (a verified block's payload verdict is final)
        assert block_root in opt_store.optimistic_roots
        # drop the subtree rooted at block_root
        doomed = {block_root}
        changed = True
        while changed:
            changed = False
            for root, blk in list(opt_store.blocks.items()):
                if root in doomed:
                    continue
                if bytes(blk.parent_root) in doomed:
                    doomed.add(root)
                    changed = True
        for root in doomed:
            opt_store.blocks.pop(root, None)
            opt_store.block_states.pop(root, None)
            opt_store.optimistic_roots.discard(root)
