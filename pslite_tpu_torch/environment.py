"""Process-wide configuration lookup.

Counterpart of ``pslite_tpu/environment.py`` (the reference's
``Environment`` singleton, ``include/ps/internal/env.h:15-63``): values
come from OS environment variables, optionally overridden by an injected
dict, so one process can host several logical nodes with different
configs.
"""

from __future__ import annotations

import os
import threading
from typing import Mapping, Optional


class Environment:
    """Env-var lookup with an optional injected override map."""

    def __init__(self, overrides: Optional[Mapping[str, str]] = None):
        self._overrides = dict(overrides) if overrides else {}

    def find(self, key: str, default: Optional[str] = None) -> Optional[str]:
        if key in self._overrides:
            return self._overrides[key]
        return os.environ.get(key, default)

    def find_int(self, key: str, default: int = 0) -> int:
        val = self.find(key)
        if val is None or val == "":
            return default
        return int(val)

    def find_float(self, key: str, default: float = 0.0) -> float:
        val = self.find(key)
        if val is None or val == "":
            return default
        return float(val)

    def find_bool(self, key: str, default: bool = False) -> bool:
        val = self.find(key)
        if val is None or val == "":
            return default
        return val.strip().lower() not in ("0", "false", "no", "off")

    def set(self, key: str, value: str) -> None:
        self._overrides[key] = str(value)


_lock = threading.Lock()
_default: Optional[Environment] = None


def get() -> Environment:
    """The process-wide default environment (OS env vars only)."""
    global _default
    with _lock:
        if _default is None:
            _default = Environment()
        return _default
