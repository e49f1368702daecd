"""Read views of registry counters under the names older callers use.

The port kept some counters in plain dicts (``.stats``) before its
registry was real; they now live in the node registry under the JAX
package's names, and ``.stats`` stays as a read-only view of them, as
the JAX package keeps its legacy counter properties.
"""

from __future__ import annotations

from typing import Mapping, Optional


class CounterView:
    """``view[short]``: the value of registry counter ``names[short]``,
    or of ``prefix + short`` for a name not in ``names``; a counter
    never created reads 0.  Reading creates nothing."""

    __slots__ = ("_reg", "_prefix", "_names")

    def __init__(self, registry, prefix: str = "",
                 names: Optional[Mapping[str, str]] = None):
        self._reg = registry
        self._prefix = prefix
        self._names = dict(names or {})

    def name_of(self, key: str) -> str:
        return self._names.get(key, self._prefix + key)

    def __getitem__(self, key: str) -> int:
        name = self.name_of(key)
        return self._reg.counters_with_prefix(name).get(name, 0)
