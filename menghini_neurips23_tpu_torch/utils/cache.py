"""Byte-capped LRU for per-key host arrays.

Used for per-image frozen features (VPT/UPT patch tokens are ~150 KB/image
fp32) and for decoded uint8 images (~150 KB at 224px) - an unbounded dict
would silently grow to tens of GB on a large GRIP pool.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class BoundedFeatureCache:
    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.nbytes = 0
        self._d: "OrderedDict[str, np.ndarray]" = OrderedDict()

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key):
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
        return v

    def put(self, key, value: np.ndarray):
        old = self._d.pop(key, None)
        if old is not None:
            self.nbytes -= old.nbytes
        self._d[key] = value
        self.nbytes += value.nbytes
        while self.nbytes > self.max_bytes and len(self._d) > 1:
            _, evicted = self._d.popitem(last=False)
            self.nbytes -= evicted.nbytes

    def clear(self):
        self._d.clear()
        self.nbytes = 0

    def get_or_fill(self, keys, compute, store: bool = True):
        """Batch lookup: return {key: row} for `keys`, computing misses via
        `compute(missing_keys) -> (len(missing), ...) array` in one call.

        Rows handed to the cache are COPIED - `compute` typically returns a
        batch array whose rows are views; caching a view would pin the whole
        batch while nbytes accounting only counted one row.  `store=False`
        computes misses without inserting them (streaming passes)."""
        have = {k: self.get(k) for k in keys if k in self}
        missing = list(dict.fromkeys(k for k in keys if k not in have))
        if missing:
            rows = compute(missing)
            for k, row in zip(missing, rows):
                have[k] = row
                if store:
                    self.put(k, row.copy())
        return have
