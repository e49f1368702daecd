"""Sharded server-side apply (``PS_APPLY_SHARDS``).

Counterpart of ``pslite_tpu/kv/apply_shards.py``.  Without it one
customer thread runs the KV handler inline, so every worker's pushes
serialize on it.  The pool hashes keys into ``num_shards`` shards, gives
each shard a thread that owns its slice of the store, and turns one
request into per-shard tasks applied concurrently.

Invariants:

- **Shard affinity**: ``shard(key) = key % num_shards``; every op on a
  key runs on one shard thread in submission order, so ``push +=`` never
  races and each key's apply order is the serial path's, bit for bit.
- **Completion barrier**: a request's response leaves only after all of
  its shard tasks completed (a counter, not a join).
- **Per-sender response order**: responses leave in arrival order per
  sender (a FIFO ticket gate), as the serial thread sent them; a done
  response of strictly higher priority than every unfinished one ahead
  of it overtakes them.
- **Error fast-fail**: a handler exception on any shard answers with an
  empty ``OPT_APPLY_ERROR`` response instead of hanging the worker.

Requests the hash split cannot express (``lens``, empty key sets,
malformed shapes) run as **global ops**: every shard thread meets at a
barrier and the full handler runs once while the others are parked.
Codec pushes may arrive undecoded (``KVPairs.enc``): each shard decodes
its own keys' segments (``codecs.decode_key_ranges``).  A chunked push
can be streamed in (``begin_stream``): each whole-key slice is applied
as it lands, and the response waits for the last.

Batched frames (``submit_batch``, EXT_BATCH) enter as a group: one
order-gate ticket for the whole frame, per-op shard tasks completing
independently, and the last sub-op to finish publishes one batched
response (``_BatchGroup``, ``_complete_batch_op``).  Shard queues are
weighted fair across ``PS_TENANTS`` (each task charged its share of the
request's bytes), and the pool counts every tenant's in-flight requests
(``tenant_backlog``), the probe of the server's admission control.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback
from typing import Deque, Dict, List, Optional

import numpy as np

from ..ops import codecs as codecs_mod
from ..telemetry import node_registry
from ..tenants import table_for
from ..utils import logging as log
from ..utils.queues import DRAIN_LEVEL, PriorityRecvQueue

# Queue-item task tags.
_ALL = ("all",)        # the whole request on one shard
_GLOBAL = ("global",)  # barrier op: the full handler under all shards
# ("slice", positions): this shard's keys of the request;
# ("feed", kvs, positions | None): one fed slice of a streamed push.


class _Pending:
    """One in-flight request: completion counter and response slot."""

    __slots__ = ("meta", "kvs", "mu", "remaining", "parts", "error", "done",
                 "response", "arrived", "barrier", "emitted", "tracked",
                 "seq", "group", "op_idx", "backlog_n")

    def __init__(self, meta, kvs):
        self.meta = meta
        self.kvs = kvs
        self.mu = threading.Lock()
        self.remaining = 0
        # (positions | None, snapshot, lens) per completed pull task.
        self.parts: List[tuple] = []
        self.error: Optional[BaseException] = None
        self.done = False
        self.response: tuple = ("none",)
        self.arrived = 0
        self.barrier: Optional[threading.Event] = None
        self.emitted: Optional[threading.Event] = None  # submit(wait=True)
        # Counted in the pool's per-tenant backlog: set at submit,
        # released once in _finish.
        self.tracked = False
        self.seq = 0  # submission number (quiesce)
        # A batched sub-op reports into ``group.results[op_idx]`` instead
        # of entering the order gate; the group's gate pending holds the
        # frame's one ticket and ``backlog_n`` admission slots (one per
        # sub-op that entered apply; a plain request holds 1).
        self.group: Optional["_BatchGroup"] = None
        self.op_idx = 0
        self.backlog_n = 1


class _BatchGroup:
    """Completion fan-in of one batched frame: the gate pending (the
    frame's one order-gate ticket), the per-op metas and result slots;
    the last sub-op to finish publishes the frame's response."""

    __slots__ = ("gate", "metas", "results", "remaining", "mu")

    def __init__(self, gate: _Pending, metas, results):
        self.gate = gate
        self.metas = metas
        self.results = results
        self.remaining = 0
        self.mu = threading.Lock()


class _CaptureResponder:
    """The server as a global op's handler sees it: ``response`` is
    captured, so it still leaves through the order gate; everything else
    is the real server's."""

    def __init__(self, server, pending: _Pending):
        self._server = server
        self._pending = pending

    def response(self, req, res=None) -> None:
        self._pending.response = (("res", res) if res is not None
                                  else ("ok", None))

    def __getattr__(self, name):
        return getattr(self._server, name)


class ApplyShardPool:
    """Shard threads and per-request completion and order bookkeeping.

    ``handle`` exposes ``apply_shard(meta, keys, segs)`` (as
    ``KVServerDefaultHandle`` and ``KVServerOptimizerHandle`` do); global
    ops call it as ``handle(meta, kvs, server)``."""

    # Target bytes of one shard task (PS_APPLY_TASK_BYTES): a bulk
    # request splits into groups of about this size per shard, so a
    # priority op waits out at most one such task.
    _TASK_BYTES = 2 << 20

    def __init__(self, handle, num_shards: int, server):
        log.check(num_shards > 0, "ApplyShardPool needs >= 1 shard")
        self.handle = handle
        self.num_shards = num_shards
        self._server = server
        po = getattr(server, "po", None)
        env = getattr(po, "env", None)
        self._task_bytes = (env.find_int("PS_APPLY_TASK_BYTES",
                                         self._TASK_BYTES)
                            if env is not None else self._TASK_BYTES)
        tenants = table_for(env)
        # Highest meta.priority first, FIFO within a level (so one key's
        # same-priority ops keep arrival order), weighted fair across
        # tenants in the bulk band; the stop sentinel last.
        self._queues: List[PriorityRecvQueue] = [
            PriorityRecvQueue(self._task_priority,
                              tenant_fn=self._task_tenant,
                              weights=(tenants.weights_by_id()
                                       if tenants.enabled else None))
            for _ in range(num_shards)]
        # Per-tenant in-flight requests (admission control) and, for
        # quiesce, every submission's number, dropped in _finish.
        self._backlog_mu = threading.Lock()
        self._tenant_backlog: Dict[int, int] = {}
        self._submit_seq = 0
        self._inflight_seqs: set = set()
        # Per-sender FIFO ticket gate.
        self._order_mu = threading.Lock()
        self._order: Dict[int, Deque[_Pending]] = {}
        # Responses selected by the gate (under _order_mu) are sent
        # outside it, one drainer at a time: a codec pull response
        # encodes in _emit, which must not hold up every shard's
        # completion.
        self._emit_mu = threading.Lock()
        self._emit_q: Deque[_Pending] = collections.deque()
        self.sharded_requests = 0  # counted on the submitting thread
        self.global_requests = 0
        metrics = node_registry(getattr(po, "metrics", None))
        self._h_latency = metrics.histogram("apply.latency_s")
        for sid in range(num_shards):
            metrics.gauge(f"apply.shard{sid}.depth",
                          fn=(lambda q: (lambda: len(q)))(self._queues[sid]))
        self._stopping = False
        self._threads = [
            threading.Thread(target=self._worker, args=(sid,),
                             name=f"kv-apply-{sid}", daemon=True)
            for sid in range(num_shards)]
        for t in self._threads:
            t.start()

    @staticmethod
    def _task_priority(item) -> int:
        if item is None:
            return DRAIN_LEVEL
        return item[0].meta.priority

    @staticmethod
    def _task_tenant(item) -> int:
        """The request's wire tenant; the stop sentinel is tenantless."""
        if item is None:
            return 0
        return item[0].meta.tenant

    @staticmethod
    def _payload_bytes(kvs) -> int:
        enc = kvs.enc
        return enc[2].raw_len if enc is not None else kvs.vals.nbytes

    def _task_cost(self, kvs, n_positions: int) -> int:
        """Weighted-fair charge of one shard task: its share of the
        request's payload bytes."""
        n = len(kvs.keys)
        if n == 0:
            return 1
        return max(1, self._payload_bytes(kvs) * n_positions // n)

    def tenant_backlog(self, tenant: int) -> int:
        """In-flight (submitted, response not yet selected) requests of
        one tenant: the server's admission probe."""
        with self._backlog_mu:
            return self._tenant_backlog.get(tenant, 0)

    def _task_groups(self, kvs, positions) -> int:
        """How many groups of about ``_task_bytes`` one shard's positions
        split into (>= 1; a group holds at least one key)."""
        n = len(kvs.keys)
        if n == 0:
            return 1
        bytes_here = self._payload_bytes(kvs) // n * len(positions)
        if bytes_here <= self._task_bytes:
            return 1
        return min(len(positions),
                   (bytes_here + self._task_bytes - 1) // self._task_bytes)

    def submit_token(self) -> int:
        """The current submission number: :meth:`quiesce` on it waits for
        everything submitted so far, and nothing later."""
        with self._backlog_mu:
            return self._submit_seq

    def quiesce(self, token: int, timeout_s: float = 30.0) -> bool:
        """Block until every request submitted at or before ``token`` has
        completed (its response selected); False on timeout."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._backlog_mu:
                busy = any(s <= token for s in self._inflight_seqs)
            if not busy:
                return True
            if time.monotonic() >= deadline or self._stopping:
                return False
            time.sleep(0.002)

    # -- submission (the server's customer thread) -------------------------------

    def submit(self, meta, kvs, wait: bool = False) -> None:
        """Split the request across the shards and return; whichever shard
        finishes it last sends the response, behind the order gate.

        ``wait=True`` blocks until the response has left: for a payload
        that aliases a buffer the pump overwrites with the sender's next
        push (registered receive buffers), as the serial path's handler
        ran before the next copy."""
        if self._stopping:
            # Shard threads are retiring behind their sentinels: apply
            # inline rather than strand the request.
            try:
                kvs.materialize()
                self.handle(meta, kvs, self._server)
            except Exception as exc:  # noqa: BLE001 - answer the worker
                log.warning(f"apply (inline, stopping) failed for request "
                            f"ts={meta.timestamp}: {exc!r}\n"
                            f"{traceback.format_exc()}")
                try:
                    self._server.response_error(meta)
                except Exception:  # noqa: BLE001 - transport torn down
                    pass
            return
        pending = _Pending(meta, kvs)
        if wait:
            pending.emitted = threading.Event()
        pending.tracked = True
        tid = meta.tenant
        with self._backlog_mu:
            self._tenant_backlog[tid] = self._tenant_backlog.get(tid, 0) + 1
            self._submit_seq += 1
            pending.seq = self._submit_seq
            self._inflight_seqs.add(pending.seq)
        with self._order_mu:
            self._order.setdefault(meta.sender,
                                   collections.deque()).append(pending)
        plan = self._split(kvs)
        if plan is None:
            self.global_requests += 1
            pending.remaining = self.num_shards
            pending.barrier = threading.Event()
            # A fence: nothing queued later overtakes the barrier on any
            # shard, or a stream of priority ops on one shard would park
            # every other shard behind it for good.
            for q in self._queues:
                q.push((pending, _GLOBAL), fence=True)
        elif len(plan) == 1 and self._task_groups(kvs, plan[0][1]) <= 1:
            self.sharded_requests += 1
            pending.remaining = 1
            self._queues[plan[0][0]].push(
                (pending, _ALL), cost=self._task_cost(kvs, len(kvs.keys)))
        else:
            self.sharded_requests += 1
            tasks = []
            for sid, positions in plan:
                ngrp = self._task_groups(kvs, positions)
                for grp in np.array_split(positions, ngrp):
                    if len(grp):
                        tasks.append((sid, grp))
            pending.remaining = len(tasks)
            for sid, grp in tasks:
                self._queues[sid].push((pending, ("slice", grp)),
                                       cost=self._task_cost(kvs, len(grp)))
        if wait and not pending.emitted.wait(timeout=60.0):
            # stop() releases a pump caught between submit and stop; the
            # timeout is the last resort.
            log.warning(f"apply pool: registered-buffer apply for "
                        f"ts={meta.timestamp} did not complete in 60s "
                        f"(shutting down?)")

    def submit_batch(self, env_meta, metas, kvss, results) -> None:
        """Fan one batched frame's sub-ops into the shards as a group:
        one order-gate ticket (the frame's response leaves in its
        arrival slot), one quiesce number, an admission slot per sub-op
        that enters apply, and per-op shard tasks completing
        independently.  ``results[i]`` is preset for sub-ops decided at
        intake (admission sheds) and None for those that apply; the last
        sub-op to finish publishes one ``server.response_batch``."""
        if self._stopping:
            # Shard threads are retiring: apply each op inline and answer
            # it alone (the worker takes batched and single responses
            # alike); ops decided at intake still answer.
            for meta, kvs, pre in zip(metas, kvss, results):
                try:
                    if pre is not None:
                        if pre[0] == "overload":
                            self._server.response_overload(meta)
                        elif pre[0] == "error":
                            self._server.response_error(meta)
                        else:
                            self._server.response(meta)
                        continue
                    kvs.materialize()
                    self.handle(meta, kvs, self._server)
                except Exception as exc:  # noqa: BLE001 - answer the worker
                    log.warning(f"batched apply (inline, stopping) failed "
                                f"for ts={meta.timestamp}: {exc!r}")
                    try:
                        self._server.response_error(meta)
                    except Exception:  # noqa: BLE001 - transport torn down
                        pass
            return
        gate = _Pending(env_meta, None)
        gate.tracked = True
        gate.backlog_n = sum(1 for r in results if r is None)
        tid = env_meta.tenant
        with self._backlog_mu:
            self._tenant_backlog[tid] = (self._tenant_backlog.get(tid, 0)
                                         + gate.backlog_n)
            self._submit_seq += 1
            gate.seq = self._submit_seq
            self._inflight_seqs.add(gate.seq)
        with self._order_mu:
            self._order.setdefault(env_meta.sender,
                                   collections.deque()).append(gate)
        group = _BatchGroup(gate, metas, results)
        dispatch = []
        for i, (meta, kvs) in enumerate(zip(metas, kvss)):
            if results[i] is not None:
                continue
            plan = self._split(kvs)
            if plan is None:
                # The combiner merges only fixed-k lens-free ops: an
                # unsplittable sub-op is malformed; fail it alone.
                results[i] = ("error",)
                continue
            p = _Pending(meta, kvs)
            p.group = group
            p.op_idx = i
            tasks = []
            for sid, positions in plan:
                ngrp = self._task_groups(kvs, positions)
                if ngrp <= 1:
                    tasks.append((sid, positions))
                else:
                    tasks.extend((sid, grp) for grp in
                                 np.array_split(positions, ngrp) if len(grp))
            p.remaining = len(tasks)
            group.remaining += 1
            dispatch.append((p, kvs, tasks))
        self.sharded_requests += max(1, len(dispatch))
        if group.remaining == 0:
            # Every sub-op was decided at intake: the response is ready
            # (still behind earlier requests in the gate).
            gate.response = ("batch", group)
            self._finish(gate)
            return
        for p, kvs, tasks in dispatch:
            n = len(kvs.keys)
            for sid, grp in tasks:
                task = (_ALL if len(tasks) == 1 and len(grp) == n
                        else ("slice", grp))
                self._queues[sid].push((p, task),
                                       cost=self._task_cost(kvs, len(grp)))

    def _complete_batch_op(self, pending: _Pending) -> None:
        """A batched sub-op finished its shard tasks: record its result;
        the last sub-op publishes the gate's response."""
        meta = pending.meta
        if pending.error is not None:
            result = ("error",)
        elif meta.pull:
            try:
                result = ("res", self._assemble(pending))
            except Exception as exc:  # noqa: BLE001 - answered per op
                log.warning(f"batched pull assembly failed for "
                            f"ts={meta.timestamp}: {exc!r}")
                result = ("error",)
        else:
            result = ("ok", None)
        group = pending.group
        with group.mu:
            group.results[pending.op_idx] = result
            group.remaining -= 1
            last = group.remaining == 0
        if last:
            group.gate.response = ("batch", group)
            self._finish(group.gate)

    # -- streamed chunked pushes ---------------------------------------------------

    def begin_stream(self, meta) -> "_StreamHandle":
        """Open a streamed apply of one chunked push: ``feed`` each whole-key
        slice as it lands, ``close`` when the transfer completes.  The
        response waits for every fed slice and enters the order gate at
        close, where a whole delivery of the push would have arrived."""
        pending = _Pending(meta, None)
        pending.remaining = 1  # the open guard, released by close()
        return _StreamHandle(self, pending)

    def _feed_stream(self, pending, kvs) -> None:
        if self._stopping:
            # Shard threads are retiring: apply inline, do not lose it.
            from .kv_app import _push_segs

            try:
                self.handle.apply_shard(
                    pending.meta, kvs.keys,
                    _push_segs(pending.meta, kvs.keys, kvs.vals))
            except Exception as exc:  # noqa: BLE001 - fails the close
                with pending.mu:
                    if pending.error is None:
                        pending.error = exc
            return
        plan = self._split(kvs)
        log.check(plan is not None
                  and len(kvs.vals) % max(len(kvs.keys), 1) == 0,
                  "stream feed must be a fixed-k key/val slice")
        self.sharded_requests += 1
        with pending.mu:
            pending.remaining += len(plan)
        for sid, positions in plan:
            self._queues[sid].push(
                (pending, ("feed", kvs, None if len(plan) == 1
                           else positions)),
                cost=self._task_cost(kvs, len(positions)))

    def _close_stream(self, pending, error, respond: bool) -> None:
        if error is not None:
            with pending.mu:
                if pending.error is None:
                    pending.error = error
        if not respond:
            # An aborted stream may have applied part of its keys with no
            # response to come: the push version must still move on, or
            # a hot cache keeps serving values from before the write.
            done = getattr(self._server, "_qos_push_done", None)
            if done is not None:
                done(pending.meta)
        if respond and self._stopping:
            # The gate may never flush again: answer directly.
            with pending.mu:
                pending.remaining -= 1
            try:
                if pending.error is not None:
                    self._server.response_error(pending.meta)
                else:
                    self._server.response(pending.meta)
            except Exception:  # noqa: BLE001 - transport torn down
                pass
            return
        if respond:
            # Into the gate before the open guard goes: a shard finishing
            # in between would flush the gate without this response.
            with self._order_mu:
                self._order.setdefault(pending.meta.sender,
                                       collections.deque()).append(pending)
        with pending.mu:
            pending.remaining -= 1
            finished = pending.remaining == 0
        if finished:
            self._complete(pending)

    def _split(self, kvs) -> Optional[List[tuple]]:
        """[(shard, positions)] of a hash-splittable request, else None
        (a global op)."""
        keys = kvs.keys
        n = len(keys)
        if n == 0 or kvs.lens is not None:
            return None
        enc = kvs.enc
        total = enc[2].raw_len // 4 if enc is not None else len(kvs.vals)
        if total % n:
            return None  # malformed: the full handler raises on it
        shard_of = (keys % self.num_shards).astype(np.intp)
        plan = []
        for sid in range(self.num_shards):
            pos = np.nonzero(shard_of == sid)[0]
            if len(pos):
                plan.append((sid, pos))
        return plan

    # -- shard threads ---------------------------------------------------------------

    def _worker(self, sid: int) -> None:
        q = self._queues[sid]
        while True:
            item = q.wait_and_pop()
            if item is None:
                return
            pending, task = item
            if task is _GLOBAL:
                self._run_global(pending)
                continue
            part = None
            try:
                part = self._apply_slice(pending, task)
            except Exception as exc:  # noqa: BLE001 - answered as an error
                log.warning(f"apply shard {sid} failed for request "
                            f"ts={pending.meta.timestamp} from "
                            f"{pending.meta.sender}: {exc!r}\n"
                            f"{traceback.format_exc()}")
                with pending.mu:
                    if pending.error is None:
                        pending.error = exc
            with pending.mu:
                if part is not None:
                    pending.parts.append(part)
                pending.remaining -= 1
                finished = pending.remaining == 0
            if finished:
                self._complete(pending)

    def _apply_slice(self, pending: _Pending, task) -> Optional[tuple]:
        """This shard's keys through the handler's ``apply_shard``; a pull
        snapshots its values now (a later push queued on this shard must
        not change what the request saw)."""
        from .kv_app import _push_segs

        meta = pending.meta
        if task[0] == "feed":
            kvs, positions = task[1], task[2]  # streams are push-only
        else:
            kvs = pending.kvs
            positions = None if task is _ALL else task[1]
        keys = kvs.keys if positions is None else kvs.keys[positions]
        if kvs.enc is not None and meta.push:
            # Shard-side decode of exactly this shard's segments.
            codes, scales, info = kvs.enc
            segs = codecs_mod.decode_key_ranges(codes, scales, info,
                                                len(kvs.keys), positions)
        else:
            segs = _push_segs(meta, kvs.keys, kvs.vals, positions)
        t0 = time.monotonic()
        parts = self.handle.apply_shard(meta, keys, segs)
        self._h_latency.observe(time.monotonic() - t0)
        if not meta.pull:
            return None
        log.check(parts is not None and len(parts) == len(keys),
                  "apply_shard returned a bad pull result")
        lens = np.array([p.size for p in parts], dtype=np.int64)
        snap = parts[0].copy() if len(parts) == 1 else np.concatenate(parts)
        return (positions, snap, lens)

    def _run_global(self, pending: _Pending) -> None:
        """All-shard rendezvous: the last shard to arrive runs the full
        handler while the others wait."""
        with pending.mu:
            pending.arrived += 1
            last = pending.arrived >= self.num_shards
        if not last:
            pending.barrier.wait()
            return
        try:
            t0 = time.monotonic()
            pending.kvs.materialize()  # the full handler needs vals
            self.handle(pending.meta, pending.kvs,
                        _CaptureResponder(self._server, pending))
            self._h_latency.observe(time.monotonic() - t0)
        except Exception as exc:  # noqa: BLE001 - answered as an error
            log.warning(f"apply (global) failed for request "
                        f"ts={pending.meta.timestamp} from "
                        f"{pending.meta.sender}: {exc!r}\n"
                        f"{traceback.format_exc()}")
            pending.error = exc
            pending.response = ("error",)
        finally:
            pending.barrier.set()
        self._finish(pending)

    # -- completion --------------------------------------------------------------------

    def _complete(self, pending: _Pending) -> None:
        if pending.group is not None:
            self._complete_batch_op(pending)
            return
        meta = pending.meta
        if pending.error is not None:
            pending.response = ("error",)
        elif meta.pull:
            try:
                pending.response = ("res", self._assemble(pending))
            except Exception as exc:  # noqa: BLE001 - answered as an error
                log.warning(f"pull assembly failed for request "
                            f"ts={meta.timestamp}: {exc!r}\n"
                            f"{traceback.format_exc()}")
                pending.response = ("error",)
        else:
            pending.response = ("ok", None)
        self._finish(pending)

    def _assemble(self, pending: _Pending):
        """The per-shard pull snapshots as one response in the request's
        key order."""
        from .kv_app import KVPairs

        keys = pending.kvs.keys
        n = len(keys)
        parts = pending.parts
        if len(parts) == 1 and parts[0][0] is None:
            return KVPairs(keys=keys, vals=parts[0][1])
        lens_by_pos = np.zeros(n, dtype=np.int64)
        for positions, _snap, lens in parts:
            lens_by_pos[positions] = lens
        # Mixed per-key dtypes promote, as the serial path's concatenate.
        dtype = np.result_type(*[p[1].dtype for p in parts])
        k = int(lens_by_pos[0]) if n else 0
        if np.all(lens_by_pos == k):
            out = np.empty(n * k, dtype)
            rows = out.reshape(n, k)
            for positions, snap, _lens in parts:
                rows[positions] = snap.reshape(len(positions), k)
            return KVPairs(keys=keys, vals=out)
        offs = np.concatenate(([0], np.cumsum(lens_by_pos)))
        out = np.empty(int(offs[-1]), dtype)
        for positions, snap, lens in parts:
            so = 0
            for pos, ln in zip(positions, lens):
                ln = int(ln)
                out[offs[pos]:offs[pos] + ln] = snap[so:so + ln]
                so += ln
        return KVPairs(keys=keys, vals=out)

    def _finish(self, pending: _Pending) -> None:
        """Mark done and flush the sender's tickets in order: selected
        under the order lock, sent outside it (``_drain_emit_q``)."""
        if pending.tracked:
            # Release the admission slots once: _finish runs once per
            # pending, when its response is selected.
            pending.tracked = False
            tid = pending.meta.tenant
            with self._backlog_mu:
                n = self._tenant_backlog.get(tid, 0) - pending.backlog_n
                if n > 0:
                    self._tenant_backlog[tid] = n
                else:
                    self._tenant_backlog.pop(tid, None)
                self._inflight_seqs.discard(pending.seq)
        with self._order_mu:
            pending.done = True
            dq = self._order.get(pending.meta.sender)
            while dq and dq[0].done:
                self._emit_q.append(dq.popleft())
            if dq:
                # Priority overtake: a done response of strictly higher
                # priority than every unfinished one ahead of it leaves.
                blocked_prio = None
                for p in list(dq):
                    if not p.done:
                        bp = p.meta.priority
                        blocked_prio = (bp if blocked_prio is None
                                        else max(blocked_prio, bp))
                    elif (blocked_prio is not None
                          and p.meta.priority > blocked_prio):
                        dq.remove(p)
                        self._emit_q.append(p)
            if dq is not None and not dq:
                del self._order[pending.meta.sender]
        self._drain_emit_q()

    def _drain_emit_q(self) -> None:
        """Send the selected responses in selection order, one drainer at
        a time, never holding the order lock across a send."""
        while True:
            with self._emit_mu:
                with self._order_mu:
                    if not self._emit_q:
                        return
                    head = self._emit_q.popleft()
                self._emit(head)
                if head.emitted is not None:
                    head.emitted.set()

    def _emit(self, pending: _Pending) -> None:
        kind = pending.response[0]
        try:
            if kind == "res":
                self._server.response(pending.meta, pending.response[1])
            elif kind == "ok":
                self._server.response(pending.meta)
            elif kind == "error":
                self._server.response_error(pending.meta)
            elif kind == "batch":
                # One response frame for the whole batched request.
                group = pending.response[1]
                self._server.response_batch(pending.meta, group.metas,
                                            group.results)
            # "none": the handler chose not to respond.
        except Exception as exc:  # noqa: BLE001 - keep the pool running
            log.warning(f"apply-shard response emit failed: {exc!r}")

    # -- lifecycle ---------------------------------------------------------------------

    def stop(self) -> None:
        """Drain and retire the shard threads (queued work first: the
        sentinel drains last), then release any pump blocked in
        ``submit(wait=True)`` on a request that raced the stop."""
        self._stopping = True
        for q in self._queues:
            q.push(None)
        for t in self._threads:
            t.join(timeout=10)
        with self._order_mu:
            stranded = [p for dq in self._order.values() for p in dq]
            self._order.clear()
        for p in stranded:
            log.warning(f"apply pool stopping with request "
                        f"ts={p.meta.timestamp} from {p.meta.sender} "
                        f"undispatched")
            if p.emitted is not None:
                p.emitted.set()


class _StreamHandle:
    """One chunked push streamed into the pool (``begin_stream``).
    ``feed``/``close`` run on the server's request thread; ``t_last`` lets
    the server reclaim a stream whose transfer died at the assembler."""

    __slots__ = ("_pool", "pending", "closed", "t_last")

    def __init__(self, pool: ApplyShardPool, pending: _Pending):
        self._pool = pool
        self.pending = pending
        self.closed = False
        self.t_last = time.monotonic()

    def feed(self, kvs) -> None:
        self.t_last = time.monotonic()
        self._pool._feed_stream(self.pending, kvs)

    def close(self, error: Optional[BaseException] = None,
              respond: bool = True) -> None:
        """Release the open guard; ``respond=False`` aborts (no response,
        the pending never enters the gate: its sender is gone)."""
        if self.closed:
            return
        self.closed = True
        self._pool._close_stream(self.pending, error, respond)
