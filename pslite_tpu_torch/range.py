"""Key ranges and binary search over sorted key arrays.

Copy of ``pslite_tpu/range.py`` (the reference's ``include/ps/range.h``
and ``SArray::FindRange``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Range:
    """Half-open interval [begin, end)."""

    begin: int
    end: int

    def size(self) -> int:
        return self.end - self.begin

    def contains(self, key: int) -> bool:
        return self.begin <= key < self.end


def find_range(sorted_keys: np.ndarray, begin: int, end: int) -> Range:
    """Index range of keys in [begin, end) within a sorted key array."""
    lo = int(np.searchsorted(sorted_keys, begin, side="left"))
    hi = int(np.searchsorted(sorted_keys, end, side="left"))
    return Range(lo, hi)
