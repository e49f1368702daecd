"""Customer — per-app request/response tracker and receive pump.

Counterpart of ``pslite_tpu/customer.py`` (the reference's
``include/ps/internal/customer.h`` / ``src/customer.cc``):
``new_request(recver)`` allocates a timestamp and records how many
responses to expect; a dedicated thread pops the receive queue, runs the
app's handle, then counts the response (after the handle, which
KVWorker's completion logic relies on — ``customer.cc:59-74``).

Both kinds of timestamp of a worker complete through this one customer,
as in the JAX package: a message-path request counts responses, and an
engine request is issued expecting none and carries *completion hooks*
(each blocks until its part of the device work is done), which
``wait_request`` runs before it checks the count.  So a message request
never finishes through a hook, and an engine request never waits for a
response.

Executor mode (``PS_CUSTOMER_EXECUTOR=N``): handlers run on N threads
fed by a bounded queue, so the pump keeps draining while handlers run;
a full queue blocks the pump.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, Dict, List, Optional

from .message import Command, Message
from .utils import logging as log
from .tenants import table_for
from .utils.queues import ThreadsafeQueue, recv_queue
from .vans.chunking import recv_cost, recv_priority, recv_tenant


class Customer:
    _MAX_TRACKER_ENTRIES = 8192
    _MAX_HOOK_ENTRIES = 256

    def __init__(
        self,
        app_id: int,
        customer_id: int,
        recv_handle: Callable[[Message], None],
        postoffice,
        on_request_error: Optional[Callable[[Message, Exception], None]] = None,
        executor_workers: Optional[int] = None,
    ):
        self.app_id = app_id
        self.customer_id = customer_id
        self._recv_handle = recv_handle
        self._po = postoffice
        # A handler exception on a REQUEST (the remote side is waiting):
        # KVServer answers error-marked so the waiter fails fast.
        self._on_request_error = on_request_error
        # ts -> [expected, received], insertion-ordered and pruned of old
        # completed entries.
        self._tracker: Dict[int, List[int]] = {}
        self._next_ts = 0
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._hooks: Dict[int, List[Callable[[], None]]] = {}
        # Intake by receive level, as the van's queue: a priority op does
        # not wait behind the handling of earlier bulk messages; bulk
        # intake is weighted fair across PS_TENANTS, by the van's own
        # tenant and cost model.
        # PS_RECV_PRIORITY=0: strict FIFO, as the van's intake.
        tenants = table_for(postoffice.env)
        self._queue = recv_queue(
            postoffice.env, recv_priority, tenant_fn=recv_tenant,
            cost_fn=recv_cost,
            weights=tenants.weights_by_id() if tenants.enabled else None)
        if executor_workers is None:
            executor_workers = postoffice.env.find_int(
                "PS_CUSTOMER_EXECUTOR", 0)
        self._exec_queue: Optional[ThreadsafeQueue] = None
        self._exec_threads: List[threading.Thread] = []
        if executor_workers > 0:
            self._exec_queue = ThreadsafeQueue(maxsize=4 * executor_workers)
            for i in range(executor_workers):
                t = threading.Thread(
                    target=self._exec_loop,
                    name=f"customer-exec-{app_id}-{customer_id}-{i}",
                    daemon=True,
                )
                t.start()
                self._exec_threads.append(t)
        self._thread = threading.Thread(
            target=self._receiving, name=f"customer-{app_id}-{customer_id}",
            daemon=True,
        )
        self._thread.start()
        postoffice.add_customer(self)

    # -- request tracking ----------------------------------------------------

    def new_request(self, recver: int,
                    num_responses: Optional[int] = None) -> int:
        """Allocate a timestamp expecting one response per addressed node.

        With instance groups a worker instance talks only to the matching
        server instance of each group, so a group's count is
        ``len(ids) / group_size``, the scheduler counted apart
        (reference: customer.cc:32-40)."""
        if num_responses is None:
            ids = self._po.get_node_ids(recver)
            if recver < 8:
                sched = 1 if 1 in ids else 0
                num = max(sched + (len(ids) - sched) // self._po.group_size,
                          1)
            else:
                num = len(ids)
        else:
            num = num_responses
        with self._cv:
            ts = self._next_ts
            self._next_ts += 1
            self._tracker[ts] = [num, 0]
            self._prune_tracker_locked()
            return ts

    def _prune_tracker_locked(self) -> None:
        """Sweep old COMPLETED entries beyond the window (a pruned
        timestamp reads back as complete); in-flight ones stay."""
        if len(self._tracker) <= self._MAX_TRACKER_ENTRIES:
            return
        keep_recent = self._MAX_TRACKER_ENTRIES // 2
        completed = [ts for ts, (exp, got) in self._tracker.items()
                     if got >= exp]
        for ts in completed[: max(0, len(completed) - keep_recent)]:
            del self._tracker[ts]

    def _entry(self, timestamp: int):
        entry = self._tracker.get(timestamp)
        if entry is not None:
            return entry
        if 0 <= timestamp < self._next_ts:
            return (0, 0)  # pruned: long complete
        raise KeyError(f"unknown timestamp {timestamp}")

    def wait_request(self, timestamp: int,
                     timeout: Optional[float] = None) -> bool:
        """Run the timestamp's completion hooks, then wait until every
        expected response has been counted; False on timeout."""
        for hook in self._take_hooks(timestamp):
            hook()
        with self._cv:
            def done():
                exp, got = self._entry(timestamp)
                return exp <= got

            return self._cv.wait_for(done, timeout)

    def num_response(self, timestamp: int) -> int:
        with self._mu:
            return self._entry(timestamp)[1]

    def num_expected(self, timestamp: int) -> int:
        with self._mu:
            return self._entry(timestamp)[0]

    def add_response(self, timestamp: int, num: int = 1) -> None:
        with self._cv:
            if timestamp in self._tracker:
                self._tracker[timestamp][1] += num
            self._cv.notify_all()

    def add_wait_hook(self, timestamp: int, hook: Callable[[], None]) -> None:
        """Attach a completion hook run by wait_request (the engine path).
        Hooks must be idempotent (e.g. ``Future.result``): they run on
        every wait of the timestamp.  Entries are evicted FIFO beyond a
        bounded window (an evicted timestamp reads back as long
        complete)."""
        with self._mu:
            self._hooks.setdefault(timestamp, []).append(hook)
            while len(self._hooks) > self._MAX_HOOK_ENTRIES:
                self._hooks.pop(next(iter(self._hooks)))

    def _take_hooks(self, timestamp: int) -> List[Callable[[], None]]:
        with self._mu:
            return list(self._hooks.get(timestamp, ()))

    # -- receive pump --------------------------------------------------------

    def accept(self, msg: Message) -> None:
        self._queue.push(msg)

    def _receiving(self) -> None:
        while True:
            msg = self._queue.wait_and_pop()
            if msg is None or msg.meta.control.cmd == Command.TERMINATE:
                break
            if self._exec_queue is not None:
                self._exec_queue.push(msg)  # blocks when saturated
            else:
                self._handle_msg(msg)
        if self._exec_queue is not None:
            for _ in self._exec_threads:
                self._exec_queue.push(None)
            for t in self._exec_threads:
                t.join(timeout=5)

    def _exec_loop(self) -> None:
        while True:
            msg = self._exec_queue.wait_and_pop()
            if msg is None:
                return
            self._handle_msg(msg)

    def _handle_msg(self, msg: Message) -> None:
        try:
            self._recv_handle(msg)
        except Exception as exc:
            # A handler bug must not kill the pump: responses still have
            # to be counted or every waiter on this node hangs.
            log.warning(f"recv handle raised: {exc!r}\n"
                        f"{traceback.format_exc()}")
            if msg.meta.request and self._on_request_error is not None:
                try:
                    self._on_request_error(msg, exc)
                except Exception as hook_exc:  # noqa: BLE001
                    log.warning(f"on_request_error hook failed: "
                                f"{hook_exc!r}")
        finally:
            # A batched response envelope carries N sub-ops with N
            # timestamps: the app counts each; the envelope's own
            # timestamp is its first op's and must not count twice.
            if not msg.meta.request and msg.meta.batch is None:
                self.add_response(msg.meta.timestamp)

    def stop(self) -> None:
        self._queue.push(None)
        self._thread.join(timeout=5)
        self._po.remove_customer(self)
