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
    """Index range of keys in [begin, end) within a sorted key array.

    The bounds are searched as the array's own unsigned type:
    ``np.searchsorted`` compares a uint64 array with a Python int
    through float64, which merges every key within 2**10 of a bound
    near 2**63 with the bound (a key just below an elastic cut at
    ``MAX_KEY // 2`` would go to the range above it)."""
    cast = sorted_keys.dtype.type if sorted_keys.dtype.kind == "u" else int
    lo = int(np.searchsorted(sorted_keys, cast(begin), side="left"))
    hi = int(np.searchsorted(sorted_keys, cast(end), side="left"))
    return Range(lo, hi)
