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

The JAX queues keep one heap per tenant for weighted-fair dequeue across
``PS_TENANTS``; tenants are not ported (ROADMAP Queue 1), and with none
configured the JAX pop order is the single ``(-priority, seq)`` heap
kept here.
"""

from __future__ import annotations

import collections
import heapq
import threading
import time
from typing import Callable, Deque, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")

# Items at this level (the shutdown sentinel / TERMINATE) drain last.
DRAIN_LEVEL = -(1 << 30)


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
    maps an item to its level unless ``push`` is given one."""

    def __init__(self, priority_fn: Callable[[T], int]):
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._heap: List[tuple] = []
        self._seq = 0
        self._priority_fn = priority_fn

    def push(self, item: T, priority: Optional[int] = None) -> None:
        if priority is None:
            priority = self._priority_fn(item)
        with self._cv:
            heapq.heappush(self._heap, (-priority, self._seq, item))
            self._seq += 1
            self._cv.notify()

    def wait_and_pop(self, timeout: Optional[float] = None) -> Optional[T]:
        with self._cv:
            if not self._cv.wait_for(lambda: self._heap, timeout):
                return None
            return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        with self._mu:
            return len(self._heap)


class LaneQueue(Generic[T]):
    """Priority queue of one send lane: highest priority first, FIFO
    within a level.  The consumer loop is ``pop`` -> work -> ``done``;
    ``inflight`` covers the window between the two, so ``wait_idle``
    cannot report a drained lane while its last item is still being
    dispatched."""

    def __init__(self):
        self.cv = threading.Condition()
        self._heap: List[tuple] = []
        self._seq = 0
        self._inflight = False

    def push(self, priority: int, item: T,
             unless: Optional[Callable[[], bool]] = None) -> bool:
        """Enqueue ``item``; False (nothing queued) when ``unless()``
        holds, checked under the lock so a concurrent drain retiring the
        consumer cannot strand the item."""
        with self.cv:
            if unless is not None and unless():
                return False
            heapq.heappush(self._heap, (-priority, self._seq, item))
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
                    dropped = len(self._heap)
                    self._heap.clear()
                    self.cv.notify_all()
                    return None, dropped
                if self._heap:
                    self._inflight = True
                    return heapq.heappop(self._heap)[2], 0
                if stopping():
                    return None, 0
                self.cv.wait()

    def done(self) -> None:
        with self.cv:
            self._inflight = False
            if not self._heap:
                self.cv.notify_all()

    def wait_idle(self, deadline: float) -> bool:
        """Block until empty with nothing in flight, or until
        ``time.monotonic()`` passes ``deadline``; True when idle."""
        with self.cv:
            while ((self._heap or self._inflight)
                   and time.monotonic() < deadline):
                self.cv.wait(timeout=0.1)
            return not (self._heap or self._inflight)

    def wake(self) -> None:
        """Nudge the consumer to re-check its stop/abort predicates."""
        with self.cv:
            self.cv.notify_all()

    def drain(self) -> List[T]:
        """Remove and return every queued item (heap order)."""
        with self.cv:
            items = [e[2] for e in sorted(self._heap)]
            self._heap.clear()
            self.cv.notify_all()
            return items

    def __len__(self) -> int:
        with self.cv:
            return len(self._heap)
