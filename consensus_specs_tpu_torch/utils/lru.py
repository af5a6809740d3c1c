"""Minimal bounded LRU mapping for the spec runtime's committee, proposer
and balance caches and the BLS verification memo.

Counterpart of ``consensus_specs_tpu/utils/lru.py`` without its
telemetry counters.
"""
from collections import OrderedDict


class LRUDict(OrderedDict):

    def __init__(self, maxsize: int):
        super().__init__()
        self._maxsize = maxsize

    def get(self, key, default=None):
        if key in self:
            self.move_to_end(key)
            return self[key]
        return default

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self._maxsize:
            self.popitem(last=False)
