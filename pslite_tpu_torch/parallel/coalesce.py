"""Coalescing dispatcher: push_pulls issued one at a time, from one or
many threads, run as groups.

Counterpart of ``pslite_tpu/parallel/coalesce.py`` (``Ticket`` and
``CoalescingDispatcher``, :50-239), with the same semantics.  Each
``push_pull`` on the engine costs the host a fixed amount (checks,
allocation, the launch); ``CollectiveEngine.push_pull_group`` pays it
once for a list of buckets, and this dispatcher builds such lists for
callers that issue ops one at a time: ops enqueue into a short window and
a drain thread runs each window as one group.

The window is adaptive: ``window_us`` is the hard cap, and the window
closes as soon as no new op has arrived for ``idle_us`` (default
window/10, at least 20 µs), so a burst still coalesces while a lone op
does not wait out the cap.  ``idle_us=0`` restores the fixed window.

:meth:`CoalescingDispatcher.push_pull` returns a :class:`Ticket` at once;
``ticket.result()`` flushes the window if it is still open, waits for the
dispatch and returns the pulled tensor.  Ops on different buckets may
share one group; ops on the same bucket keep their issue order (a window
holding a bucket twice splits into consecutive sub-batches).  An unknown
bucket fails only its own ticket, and a window of one op runs as a
single ``push_pull``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils import logging as log


class Ticket:
    """Handle of one coalesced op.  ``result()`` blocks until the op's
    window has run and returns the pulled tensor; an exception of the
    dispatch re-raises here."""

    __slots__ = ("_disp", "_done", "_value", "_error")

    def __init__(self, disp: "CoalescingDispatcher"):
        self._disp = disp
        self._done = threading.Event()
        self._value = None
        self._error = None

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the op's window runs on its own (hard cap or idle
        close), without flushing it; returns whether the op completed."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._done.is_set():
            self._disp.flush()
            if not self._done.wait(timeout):
                raise TimeoutError("coalesced op not dispatched in time")
        if self._error is not None:
            raise self._error
        return self._value


class CoalescingDispatcher:
    """Micro-batching front end over one ``CollectiveEngine``, for one
    stateless handle (a group runs one handle)."""

    def __init__(self, engine, handle=None, max_pending: int = 64,
                 window_us: int = 200, idle_us: Optional[int] = None):
        log.check(not engine._is_stateful(engine._resolve_handle(handle)),
                  "coalescing supports stateless handles only (the "
                  "group's constraint)")
        self._eng = engine
        self._handle = handle
        self._max_pending = max_pending
        self._window_s = window_us / 1e6
        if idle_us is None:
            idle_us = max(20, window_us // 10)
        self._idle_s = idle_us / 1e6
        self._last_enq = 0.0
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._queue: list = []  # [(name, grads, Ticket)]
        self._flush_now = False
        self._closed = False
        self._thread = threading.Thread(target=self._drain,
                                        name="ps-coalesce", daemon=True)
        self._thread.start()

    # -- public surface ------------------------------------------------------

    def push_pull(self, name: str, grads) -> Ticket:
        """Enqueue one push_pull of a registered bucket; returns at once.
        An unknown bucket fails only this ticket: it never reaches a
        group, where it would fail the group's other tickets."""
        t = Ticket(self)
        if name not in self._eng._buckets:
            t._error = KeyError(name)
            t._done.set()
            return t
        with self._cv:
            log.check(not self._closed, "dispatcher closed")
            self._queue.append((name, grads, t))
            self._last_enq = time.monotonic()
            if len(self._queue) >= self._max_pending:
                self._flush_now = True
            self._cv.notify()
        return t

    def flush(self) -> None:
        """Run the current window now.  Nothing happens when no op is
        pending (a flag set on an empty queue would close the NEXT window
        early)."""
        with self._cv:
            if self._queue:
                self._flush_now = True
                self._cv.notify()

    def close(self) -> None:
        """Flush and stop the drain thread (idempotent)."""
        with self._cv:
            self._closed = True
            self._flush_now = True
            self._cv.notify()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- drain ---------------------------------------------------------------

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                # Give concurrent issuers time to join the window, until
                # the hard cap or idle_us without a new op.  A loop on a
                # deadline: every enqueue notifies, and one wait would
                # close the window at the second op.
                if not self._flush_now:
                    hard = time.monotonic() + self._window_s
                    while not self._flush_now and not self._closed:
                        deadline = hard
                        if self._idle_s > 0:
                            deadline = min(hard,
                                           self._last_enq + self._idle_s)
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                batch = self._queue
                self._queue = []
                self._flush_now = False
            self._dispatch(batch)

    def _dispatch(self, batch) -> None:
        # Ops on one bucket keep their issue order: the window splits into
        # consecutive sub-batches without a repeated bucket.
        sub: list = []
        seen: set = set()
        for item in batch:
            if item[0] in seen:
                self._run(sub)
                sub, seen = [], set()
            sub.append(item)
            seen.add(item[0])
        if sub:
            self._run(sub)

    def _run(self, sub) -> None:
        try:
            if len(sub) == 1:
                name, grads, _ = sub[0]
                outs = [self._eng.push_pull(name, grads,
                                            handle=self._handle)]
            else:
                outs = self._eng.push_pull_group(
                    [s[0] for s in sub], [s[1] for s in sub],
                    handle=self._handle)
            for (_, _, t), out in zip(sub, outs):
                t._value = out
                t._done.set()
        except Exception as exc:  # noqa: BLE001 - delivered to the tickets
            for _, _, t in sub:
                t._error = exc
                t._done.set()
