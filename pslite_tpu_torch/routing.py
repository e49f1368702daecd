"""Versioned key-range routing for elastic membership.

Copy of ``pslite_tpu/routing.py`` (it imports nothing of JAX); the
tables and their JSON are the JAX package's byte for byte, so JAX and
port nodes of one elastic cluster read each other's broadcasts.


The scheduler owns ONE :class:`RoutingTable` — an epoch-stamped
assignment of contiguous key ranges to server group ranks — and
broadcasts it (``Command.ROUTING``, JSON in ``meta.body``) on every
membership change.  It replaces the static
``Postoffice.get_server_key_ranges`` uniform split the moment a cluster
becomes elastic (``PS_ELASTIC=1``):

- **Workers** slice every push/pull over ``entries`` and send each
  slice to its entry's ``owner`` rank (not the entry index), so the
  number of entries may exceed the number of servers (a server that
  absorbed a decommissioned neighbor's range owns two entries until
  they coalesce on the next epoch).
- **Servers** read the table to learn what they own; an entry whose
  ``prev`` names another rank IS the migration plan — the previous
  owner streams the range's state to the new owner (chunked, replica-
  style), and the new owner parks requests for the range until the
  handoff lands.
- **Epochs** are strictly increasing; every node applies a table only
  when its epoch exceeds the one it holds, so reordered broadcasts can
  never roll routing backwards.

Tables are immutable: every membership change derives a NEW table via
:meth:`with_join` / :meth:`with_leave` / :meth:`with_departed`.
``active`` is the set of live server ranks (rank holes are legal after
an out-of-order decommission — the node-id tables and replica chains
follow it, not ``num_servers``); ``leaving`` marks ranks that are
mid-decommission: still addressable, already owning nothing.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .base import MAX_KEY
from .range import Range
from .utils import logging as log


@dataclass(frozen=True)
class RouteEntry:
    """One contiguous key range and its owning server group rank.
    ``prev`` != -1 marks an ownership change THIS epoch: ``prev`` must
    migrate the range's state to ``owner`` (the migration plan rides
    the table itself, so receivers never need the previous epoch)."""

    begin: int
    end: int
    owner: int
    prev: int = -1


@dataclass(frozen=True)
class RoutingTable:
    epoch: int
    num_servers: int                    # max(active) + 1 — id-table sizing
    active: Tuple[int, ...]             # live server group ranks, sorted
    leaving: Tuple[int, ...] = ()       # mid-decommission (own nothing)
    entries: Tuple[RouteEntry, ...] = ()

    # -- construction --------------------------------------------------------

    @staticmethod
    def initial(num_servers: int) -> "RoutingTable":
        """Epoch-0 table: the exact uniform split of
        ``Postoffice.get_server_key_ranges`` (postoffice.cc:257-268),
        so a cluster that never changes membership routes identically
        to a static one."""
        log.check(num_servers > 0, "routing needs >= 1 server")
        span = MAX_KEY // num_servers
        entries = tuple(
            RouteEntry(
                begin=span * i,
                end=span * (i + 1) if i + 1 < num_servers else MAX_KEY,
                owner=i,
            )
            for i in range(num_servers)
        )
        return RoutingTable(
            epoch=0, num_servers=num_servers,
            active=tuple(range(num_servers)), entries=entries,
        )

    def _settled(self) -> List[RouteEntry]:
        """Entries with last epoch's migration markers cleared and
        adjacent same-owner entries coalesced — the base every new
        epoch derives from."""
        out: List[RouteEntry] = []
        for e in sorted(self.entries, key=lambda e: e.begin):
            if out and out[-1].owner == e.owner and out[-1].end == e.begin:
                out[-1] = RouteEntry(out[-1].begin, e.end, e.owner)
            else:
                out.append(RouteEntry(e.begin, e.end, e.owner))
        return out

    def _range_load(self, begin: int, end: int,
                    hot: Optional[Dict[int, int]]) -> int:
        if not hot:
            return 0
        return sum(n for k, n in hot.items() if begin <= k < end)

    def with_join(self, rank: int,
                  hot: Optional[Dict[int, int]] = None) -> "RoutingTable":
        """Admit server ``rank``: split the most loaded range (by the
        ``kv.hot_keys`` hint when the scheduler has one, else the
        widest) and hand the upper half to the joiner, marked for
        migration from the donor."""
        log.check(rank not in self.active,
                  f"rank {rank} is already a member")
        base = self._settled()
        splittable = [e for e in base if e.end - e.begin >= 2]
        log.check(bool(splittable), "no splittable range left")
        loads = [self._range_load(e.begin, e.end, hot) for e in splittable]
        if any(loads):
            donor = splittable[loads.index(max(loads))]
        else:
            donor = max(splittable, key=lambda e: e.end - e.begin)
        # Load-weighted cut: split at the median hot key of the donor
        # range so the two halves carry comparable traffic; cold ranges
        # split at the byte midpoint.
        cut = donor.begin + (donor.end - donor.begin) // 2
        if hot:
            inside = sorted(k for k in hot if donor.begin <= k < donor.end)
            if inside:
                cut = inside[len(inside) // 2]
        cut = min(max(cut, donor.begin + 1), donor.end - 1)
        out: List[RouteEntry] = []
        for e in base:
            if e is donor:
                out.append(RouteEntry(e.begin, cut, e.owner))
                out.append(RouteEntry(cut, e.end, rank, prev=e.owner))
            else:
                out.append(e)
        active = tuple(sorted(set(self.active) | {rank}))
        return RoutingTable(
            epoch=self.epoch + 1, num_servers=max(active) + 1,
            active=active, leaving=tuple(r for r in self.leaving
                                         if r != rank),
            entries=tuple(out),
        )

    def with_rebalance(self, src: int, dst: int,
                       hot: Optional[Dict[int, int]] = None
                       ) -> "RoutingTable":
        """Shift load from ``src`` to ``dst`` (both live members):
        move ``src``'s most loaded range to ``dst`` outright when
        ``src`` owns several, else split it (median hot key, byte
        midpoint when cold) and hand the hotter half over — marked for
        migration so the existing handoff machinery moves the state.
        Membership is unchanged; only ownership shifts.  This is the
        autopilot's skew actuator (docs/autopilot.md)."""
        log.check(src in self.active, f"rank {src} is not a member")
        log.check(dst in self.active, f"rank {dst} is not a member")
        log.check(src != dst, "rebalance needs two distinct ranks")
        log.check(dst not in self.leaving,
                  f"rank {dst} is mid-decommission")
        base = self._settled()
        owned = [e for e in base if e.owner == src]
        log.check(bool(owned), f"rank {src} owns no range")
        loads = [self._range_load(e.begin, e.end, hot) for e in owned]
        victim = (owned[loads.index(max(loads))] if any(loads)
                  else max(owned, key=lambda e: e.end - e.begin))
        out: List[RouteEntry] = []
        for e in base:
            if e is not victim:
                out.append(e)
                continue
            if len(owned) > 1 or e.end - e.begin < 2:
                # Whole-entry move: src keeps its other holdings (or
                # the range is too narrow to split).
                out.append(RouteEntry(e.begin, e.end, dst, prev=src))
                continue
            # src's only range: split it and hand over the HOTTER half
            # (ties go to the upper half, matching with_join's cut).
            cut = e.begin + (e.end - e.begin) // 2
            inside = []
            if hot:
                inside = sorted(k for k in hot if e.begin <= k < e.end)
                if inside:
                    cut = inside[len(inside) // 2]
            cut = min(max(cut, e.begin + 1), e.end - 1)
            lower_mass = self._range_load(e.begin, cut, hot)
            upper_mass = self._range_load(cut, e.end, hot)
            if lower_mass > upper_mass:
                out.append(RouteEntry(e.begin, cut, dst, prev=src))
                out.append(RouteEntry(cut, e.end, src))
            else:
                out.append(RouteEntry(e.begin, cut, src))
                out.append(RouteEntry(cut, e.end, dst, prev=src))
        return RoutingTable(
            epoch=self.epoch + 1, num_servers=self.num_servers,
            active=self.active, leaving=self.leaving,
            entries=tuple(out),
        )

    def with_leave(self, rank: int) -> "RoutingTable":
        """Begin decommissioning ``rank``: every range it owns is
        reassigned to the owner of an adjacent range (keeping each
        survivor's holdings contiguous) and marked for migration.
        ``rank`` stays in ``active`` (it must keep serving the
        migration and WRONG_OWNER bounces) and joins ``leaving`` until
        :meth:`with_departed` retires it."""
        log.check(rank in self.active, f"rank {rank} is not a member")
        log.check(len(self.active) >= 2,
                  "cannot decommission the last server")
        base = self._settled()
        out: List[RouteEntry] = []
        for i, e in enumerate(base):
            if e.owner != rank:
                out.append(e)
                continue
            heir = next(
                (base[j].owner
                 for j in list(range(i + 1, len(base)))
                 + list(range(i - 1, -1, -1))
                 if base[j].owner != rank),
                None,
            )
            log.check(heir is not None, "no surviving heir rank")
            out.append(RouteEntry(e.begin, e.end, heir, prev=rank))
        return RoutingTable(
            epoch=self.epoch + 1, num_servers=self.num_servers,
            active=self.active,
            leaving=tuple(sorted(set(self.leaving) | {rank})),
            entries=tuple(out),
        )

    def with_departed(self, rank: int) -> "RoutingTable":
        """Retire a decommissioned rank: its migrations completed, so
        it leaves the membership entirely (node tables, barriers, the
        failure detector's expectations, and replica chains all stop
        counting it)."""
        entries = self._settled()
        log.check(all(e.owner != rank for e in entries),
                  f"rank {rank} still owns ranges; with_leave first")
        active = tuple(r for r in self.active if r != rank)
        log.check(bool(active), "cannot retire the last server")
        return RoutingTable(
            epoch=self.epoch + 1, num_servers=max(active) + 1,
            active=active,
            leaving=tuple(r for r in self.leaving if r != rank),
            entries=tuple(entries),
        )

    # -- queries -------------------------------------------------------------

    def owner_of(self, key: int) -> int:
        for e in self.entries:
            if e.begin <= key < e.end:
                return e.owner
        return self.entries[-1].owner if self.entries else 0

    def ranges_of(self, rank: int) -> List[Range]:
        return [Range(e.begin, e.end) for e in self.entries
                if e.owner == rank]

    def migrations(self) -> List[RouteEntry]:
        """Entries changing hands this epoch (the migration plan)."""
        return [e for e in self.entries
                if e.prev not in (-1, e.owner)]

    # -- wire ----------------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "epoch": self.epoch,
            "num_servers": self.num_servers,
            "active": list(self.active),
            "leaving": list(self.leaving),
            "entries": [[e.begin, e.end, e.owner, e.prev]
                        for e in self.entries],
        })

    @staticmethod
    def from_json(raw) -> "RoutingTable":
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode()
        d = json.loads(raw)
        return RoutingTable(
            epoch=int(d["epoch"]),
            num_servers=int(d["num_servers"]),
            active=tuple(int(r) for r in d["active"]),
            leaving=tuple(int(r) for r in d.get("leaving", ())),
            entries=tuple(
                RouteEntry(int(b), int(e), int(o), int(p))
                for b, e, o, p in d["entries"]
            ),
        )
