"""BoundedKeySet — an insertion-ordered set with FIFO eviction.

Copy of ``pslite_tpu/utils/bounded.py``: the bounded dedup window of the
resender's ack cache and the KV worker's error/timeout marks.  Not
thread-safe: every user serializes access under its own lock.  One
difference: ``discard`` returns whether the key was present (the JAX
copy returns False either way, as its values are all None).
"""

from __future__ import annotations

import collections
from typing import Callable, Hashable, Optional


class BoundedKeySet:
    def __init__(self, cap: int,
                 on_evict: Optional[Callable[[Hashable], None]] = None):
        """``on_evict(key)`` (optional) observes every cap eviction —
        telemetry for the dedup windows (an evicted signature that is
        later needed again is a silent correctness hazard worth
        counting).  Must not raise and must not call back into the
        set."""
        self._cap = max(1, int(cap))
        self._on_evict = on_evict
        self._d: "collections.OrderedDict[Hashable, None]" = (
            collections.OrderedDict()
        )

    def add(self, key: Hashable) -> bool:
        """Record ``key``; returns True when it was new.  Evicts the
        OLDEST entries beyond the cap (never the one just added)."""
        if key in self._d:
            return False
        self._d[key] = None
        while len(self._d) > self._cap:
            evicted, _ = self._d.popitem(last=False)
            if self._on_evict is not None:
                self._on_evict(evicted)
        return True

    def discard(self, key: Hashable) -> bool:
        """Drop ``key``; True when it was present."""
        if key in self._d:
            del self._d[key]
            return True
        return False

    def discard_where(self, pred: Callable[[Hashable], bool]) -> int:
        """Drop every key ``pred`` holds for; returns how many."""
        stale = [k for k in self._d if pred(k)]
        for k in stale:
            del self._d[k]
        return len(stale)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)
