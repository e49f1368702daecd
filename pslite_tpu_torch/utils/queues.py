"""Thread-safe queues used by vans and customers.

Counterpart of ``pslite_tpu/utils/queues.py``:

- ``ThreadsafeQueue`` (the reference's ``threadsafe_queue.h``): a
  mutex+condvar MPMC FIFO, optionally bounded (a full queue blocks the
  pusher).
- ``PriorityRecvQueue``: highest priority first, FIFO within a level; the
  receive side of the send lanes' discipline.  Items at ``DRAIN_LEVEL``
  (the shutdown sentinel, TERMINATE) pop only when nothing else is
  queued.
- ``LaneQueue``: one per-peer send lane, the same order, with the
  drain/stop handshake of the van's lane scheduler.

Both priority queues sit on per-tenant heaps (``_TenantHeaps``): with
``PS_TENANTS`` weights, bulk items (``priority <= 0``) dequeue in
weighted-fair byte shares across tenants while express items
(``priority > 0``) keep strict global order.  With no tenants
configured every item is tenant 0 and the pop order is the single
``(-priority, seq)`` heap, as in JAX.
"""

from __future__ import annotations

import collections
import heapq
import threading
import time
from typing import (Callable, Deque, Dict, Generic, List, Optional, Tuple,
                    TypeVar)

T = TypeVar("T")

# Items at this level (the shutdown sentinel / TERMINATE) drain last.
DRAIN_LEVEL = -(1 << 30)


class _TenantHeaps:
    """Per-tenant ``(-priority, seq, cost, item)`` heaps with a
    start-time-fair (virtual time) selector for the bulk band.

    Pop discipline (docs/qos.md):

    1. If the globally best head has ``priority > 0`` (express data and
       control), pop it — strict ``(-priority, seq)`` across all
       tenants, exactly the pre-tenant order.
    2. Otherwise pop from the backlogged tenant with the smallest
       virtual time; its clock advances by ``cost / weight``, so over a
       contended window tenants dequeue bytes proportionally to their
       weights.  Within a tenant the order stays ``(-priority, seq)``.
    3. Drain-level items (shutdown sentinel, TERMINATE) pop only when
       they are all that remains.

    NOT thread-safe — owners hold their own lock around every call.
    """

    __slots__ = ("_heaps", "_weights", "_vtime", "_vfloor", "_n")

    def __init__(self, weights: Optional[Dict[int, float]] = None):
        self._heaps: Dict[int, List[tuple]] = {}
        self._weights = dict(weights) if weights else {}
        self._vtime: Dict[int, float] = {}
        self._vfloor = 0.0
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def weight(self, tid: int) -> float:
        return max(self._weights.get(tid, 1.0), 1e-9)

    def push(self, tenant: int, priority: int, seq: int, cost: int,
             item) -> None:
        h = self._heaps.get(tenant)
        if h is None:
            h = self._heaps[tenant] = []
        if not h:
            # (Re)activation: an idle tenant must not bank credit — its
            # clock catches up to the fair floor before competing.
            self._vtime[tenant] = max(
                self._vtime.get(tenant, 0.0), self._vfloor
            )
        heapq.heappush(h, (-priority, seq, max(int(cost), 1), item))
        self._n += 1

    def _pop_from(self, tid: int) -> tuple:
        entry = heapq.heappop(self._heaps[tid])
        self._n -= 1
        return entry

    def _best_head(self) -> Tuple[Optional[int], Optional[tuple]]:
        best_tid, best = None, None
        for tid, h in self._heaps.items():
            if h and (best is None or h[0][:2] < best[:2]):
                best, best_tid = h[0], tid
        return best_tid, best

    def pop(self) -> Optional[tuple]:
        """Remove and return the next ``(-priority, seq, cost, item)``
        entry, or None when empty."""
        best_tid, best = self._best_head()
        if best is None:
            return None
        if -best[0] > 0:
            return self._pop_from(best_tid)  # express band
        cands = [tid for tid, h in self._heaps.items()
                 if h and -h[0][0] > DRAIN_LEVEL]
        if not cands:
            return self._pop_from(best_tid)  # only drain-level left
        if len(cands) == 1:
            # Uncontended (the single-tenant / quiet-cluster fast
            # path): no clock charge — fairness is a property of
            # contended windows only, and solo drain must not bank
            # debt against a tenant for work nobody competed for.
            return self._pop_from(cands[0])
        chosen = min(cands, key=lambda t: (self._vtime.get(t, 0.0), t))
        entry = self._pop_from(chosen)
        self._vfloor = self._vtime.get(chosen, 0.0)
        self._vtime[chosen] = self._vfloor + entry[2] / self.weight(chosen)
        return entry

    def pop_at_or_before(self, max_seq: int) -> Optional[tuple]:
        """Best entry with ``seq <= max_seq`` (the fence path — rare,
        so the scan + re-heapify stays off hot pops)."""
        best_tid, best = None, None
        for tid, h in self._heaps.items():
            for e in h:
                if e[1] <= max_seq and (best is None or e[:2] < best[:2]):
                    best, best_tid = e, tid
        if best is None:
            return None
        h = self._heaps[best_tid]
        h.remove(best)
        heapq.heapify(h)
        self._n -= 1
        return best

    def clear(self) -> int:
        n = self._n
        self._heaps.clear()
        self._n = 0
        return n

    def sorted_entries(self) -> List[tuple]:
        out = [e for h in self._heaps.values() for e in h]
        out.sort()
        return out


class ThreadsafeQueue(Generic[T]):
    def __init__(self, maxsize: int = 0):
        self._q: Deque[T] = collections.deque()
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)
        self._maxsize = maxsize

    def push(self, item: T) -> None:
        with self._cv:
            while self._maxsize > 0 and len(self._q) >= self._maxsize:
                self._not_full.wait()
            self._q.append(item)
            self._cv.notify()

    def _pop_locked(self) -> T:
        if self._maxsize > 0:
            self._not_full.notify()
        return self._q.popleft()

    def wait_and_pop(self, timeout: Optional[float] = None) -> Optional[T]:
        """Pop the next item, blocking; None on timeout."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._q, timeout):
                return None
            return self._pop_locked()

    def try_pop(self) -> Optional[T]:
        with self._mu:
            return self._pop_locked() if self._q else None

    def __len__(self) -> int:
        with self._mu:
            return len(self._q)




class PriorityRecvQueue(Generic[T]):
    """Highest priority first, FIFO within a level.  ``priority_fn``
    maps an item to its level unless ``push`` is given one.

    ``tenant_fn``/``cost_fn`` (or ``push``'s ``tenant=``/``cost=``)
    place bulk items into per-tenant heaps dequeued in weighted-fair
    byte shares per ``weights``; unset, every item is tenant 0.

    ``push(..., fence=True)``: while a fence item is queued, nothing
    pushed after it may overtake it (pops take the best item at or
    before the earliest fence, bypassing the weighted-fair selector),
    which keeps the apply pool's all-shard barrier ops from starving
    under a stream of higher priority."""

    def __init__(self, priority_fn: Callable[[T], int],
                 tenant_fn: Optional[Callable[[T], int]] = None,
                 cost_fn: Optional[Callable[[T], int]] = None,
                 weights: Optional[Dict[int, float]] = None):
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._heaps = _TenantHeaps(weights)
        self._seq = 0
        self._priority_fn = priority_fn
        self._tenant_fn = tenant_fn
        self._cost_fn = cost_fn
        self._fences: set = set()

    def push(self, item: T, priority: Optional[int] = None,
             fence: bool = False, tenant: Optional[int] = None,
             cost: Optional[int] = None) -> None:
        if priority is None:
            priority = self._priority_fn(item)
        if tenant is None:
            tenant = self._tenant_fn(item) if self._tenant_fn else 0
        if cost is None:
            cost = self._cost_fn(item) if self._cost_fn else 1
        with self._cv:
            self._heaps.push(tenant, priority, self._seq, cost, item)
            if fence:
                self._fences.add(self._seq)
            self._seq += 1
            self._cv.notify()

    def _pop_locked(self) -> T:
        if self._fences:
            entry = self._heaps.pop_at_or_before(min(self._fences))
            self._fences.discard(entry[1])
            return entry[3]
        return self._heaps.pop()[3]

    def wait_and_pop(self, timeout: Optional[float] = None) -> Optional[T]:
        with self._cv:
            if not self._cv.wait_for(lambda: len(self._heaps), timeout):
                return None
            return self._pop_locked()

    def try_pop(self) -> Optional[T]:
        with self._mu:
            return self._pop_locked() if len(self._heaps) else None

    def __len__(self) -> int:
        with self._mu:
            return len(self._heaps)


class LaneQueue(Generic[T]):
    """Priority queue of one send lane: highest priority first, FIFO
    within a level; with ``weights``, bulk items of the tenants named by
    ``push(..., tenant=, cost=)`` share the lane in weighted-fair byte
    shares.  The consumer loop is ``pop`` -> work -> ``done``;
    ``inflight`` covers the window between the two, so ``wait_idle``
    cannot report a drained lane while its last item is still being
    dispatched."""

    def __init__(self, weights: Optional[Dict[int, float]] = None):
        self.cv = threading.Condition()
        self._heaps = _TenantHeaps(weights)
        self._seq = 0
        self._inflight = False

    def push(self, priority: int, item: T,
             unless: Optional[Callable[[], bool]] = None,
             tenant: int = 0, cost: int = 1) -> bool:
        """Enqueue ``item``; False (nothing queued) when ``unless()``
        holds, checked under the lock so a concurrent drain retiring the
        consumer cannot strand the item."""
        with self.cv:
            if unless is not None and unless():
                return False
            self._heaps.push(tenant, priority, self._seq, cost, item)
            self._seq += 1
            self.cv.notify()
            return True

    def pop(self, stopping: Callable[[], bool],
            aborting: Callable[[], bool]) -> Tuple[Optional[T], int]:
        """Blocking pop: ``(item, 0)``, or ``(None, n)`` when the consumer
        must exit, with ``n`` the items an abort discarded."""
        with self.cv:
            while True:
                if aborting():
                    dropped = self._heaps.clear()
                    self.cv.notify_all()
                    return None, dropped
                if len(self._heaps):
                    self._inflight = True
                    return self._heaps.pop()[3], 0
                if stopping():
                    return None, 0
                self.cv.wait()

    def done(self) -> None:
        with self.cv:
            self._inflight = False
            if not len(self._heaps):
                self.cv.notify_all()

    def wait_idle(self, deadline: float) -> bool:
        """Block until empty with nothing in flight, or until
        ``time.monotonic()`` passes ``deadline``; True when idle."""
        with self.cv:
            while ((len(self._heaps) or self._inflight)
                   and time.monotonic() < deadline):
                self.cv.wait(timeout=0.1)
            return not (len(self._heaps) or self._inflight)

    def wake(self) -> None:
        """Nudge the consumer to re-check its stop/abort predicates."""
        with self.cv:
            self.cv.notify_all()

    def drain(self) -> List[T]:
        """Remove and return every queued item (heap order)."""
        with self.cv:
            items = [e[3] for e in self._heaps.sorted_entries()]
            self._heaps.clear()
            self.cv.notify_all()
            return items

    def __len__(self) -> int:
        with self.cv:
            return len(self._heaps)
