"""Multi-tenant QoS configuration (``PS_TENANTS``).

Copy of ``pslite_tpu/tenants.py``: ``PS_TENANTS=serve:8,train:1``
declares two tenants whose bulk traffic shares every contended queue
(send lanes, receive intake, apply shards) in an 8:1 byte ratio.  The
tenant id is assigned by position in the spec (1-based; id 0 is the
implicit ``default`` tenant of every unlabeled message) and rides the
wire in the ``EXT_QOS`` meta extension, so every node of a cluster,
JAX or port, must be launched with the same ``PS_TENANTS`` string.

Scheduling contract of every tenant-aware queue
(``utils/queues.py``): ``priority > 0`` is the express band, strict
highest-priority-first across all tenants; ``priority <= 0`` is the
bulk pool, weighted fair across tenants by bytes and
highest-priority-first FIFO within a tenant; the shutdown drain level
drains last.  With ``PS_TENANTS`` unset every message is tenant 0 and
the order is the single ``(-priority, seq)`` heap.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from .utils import logging as log

# Tenant id 0: the implicit tenant of every unlabeled message.
DEFAULT_TENANT = 0
DEFAULT_NAME = "default"

# meta.tenant wire field width (EXT_QOS packs it as u16).
MAX_TENANT_ID = 0xFFFF


class TenantTable:
    """Immutable name <-> id <-> weight mapping parsed from
    ``PS_TENANTS`` (``name:weight,name:weight,...``; a bare ``name``
    gets weight 1).  The reserved name ``default`` re-weights tenant 0
    instead of allocating a new id."""

    def __init__(self, spec: Optional[str] = None):
        self._by_name: Dict[str, int] = {DEFAULT_NAME: DEFAULT_TENANT}
        self._names: Dict[int, str] = {DEFAULT_TENANT: DEFAULT_NAME}
        self._weights: Dict[int, float] = {DEFAULT_TENANT: 1.0}
        spec = (spec or "").strip()
        next_id = 1
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            name, _, w = entry.partition(":")
            name = name.strip()
            log.check(name != "", f"PS_TENANTS: empty tenant name in "
                                  f"{spec!r}")
            # Names feed dotted metric paths (tenant.<name>.requests)
            # and the psmon rollup parser — keep them identifier-like.
            log.check(
                "." not in name and ":" not in name
                and not any(c.isspace() for c in name),
                f"PS_TENANTS: tenant name {name!r} may not contain "
                f"dots, colons, or whitespace",
            )
            weight = float(w) if w.strip() else 1.0
            log.check(weight > 0,
                      f"PS_TENANTS: tenant {name!r} needs weight > 0")
            if name == DEFAULT_NAME:
                self._weights[DEFAULT_TENANT] = weight
                continue
            log.check(name not in self._by_name,
                      f"PS_TENANTS: duplicate tenant {name!r}")
            log.check(next_id <= MAX_TENANT_ID, "PS_TENANTS: too many "
                                                "tenants")
            self._by_name[name] = next_id
            self._names[next_id] = name
            self._weights[next_id] = weight
            next_id += 1

    @classmethod
    def from_env(cls, env) -> "TenantTable":
        spec = env.find("PS_TENANTS") if env is not None else None
        return cls(spec)

    @property
    def enabled(self) -> bool:
        """True when the spec named at least one non-default tenant."""
        return len(self._names) > 1

    def resolve(self, tenant) -> int:
        """Tenant id of a name, an id, or None (the default tenant).
        Unknown names AND ids not in the table fail loudly — a typo'd
        tenant silently riding as ``default`` (or an out-of-range id
        truncated by the u16 wire field onto some OTHER tenant's quota
        and counters) would bypass the isolation this layer exists
        for."""
        if tenant is None:
            return DEFAULT_TENANT
        if isinstance(tenant, (int,)) and not isinstance(tenant, bool):
            tid = int(tenant)
            log.check(tid in self._names,
                      f"unknown tenant id {tid} (PS_TENANTS declares "
                      f"ids {sorted(self._names)})")
            return tid
        tid = self._by_name.get(str(tenant))
        log.check(tid is not None,
                  f"unknown tenant {tenant!r} (PS_TENANTS names: "
                  f"{sorted(self._by_name)})")
        return tid

    def name(self, tid: int) -> str:
        return self._names.get(tid, f"t{tid}")

    def weight(self, tid: int) -> float:
        return self._weights.get(tid, 1.0)

    def weights_by_id(self) -> Dict[int, float]:
        return dict(self._weights)

    def names(self) -> Tuple[str, ...]:
        return tuple(self._by_name)


_cache_mu = threading.Lock()
_cache: Dict[str, TenantTable] = {}


def table_for(env) -> TenantTable:
    """Shared TenantTable for an environment's ``PS_TENANTS`` value
    (parsed once per distinct spec — every van lane, receive queue and
    apply pool of a node asks for it)."""
    spec = (env.find("PS_TENANTS") or "") if env is not None else ""
    with _cache_mu:
        table = _cache.get(spec)
        if table is None:
            table = _cache[spec] = TenantTable(spec)
        return table
