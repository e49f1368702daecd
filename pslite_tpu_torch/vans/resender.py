"""Resender — optional ACK/dedup/retransmit reliability layer.

Copy of ``pslite_tpu/vans/resender.py`` (the reference's
``src/resender.h``): every sent message is buffered under a signature;
the receiver acks everything and drops duplicates; a monitor thread
retransmits entries older than ``PS_RESEND_TIMEOUT`` ms, up to 10
retries.  Off unless ``PS_RESEND=1``; exercised with the ``PS_DROP_MSG``
fault injector.  Retransmits go through ``van.send_msg_locked``, i.e.
the destination's send lane.  Unlike JAX's copy, ``reset_peer`` forgets
a restarted peer (node recovery): its old life's signatures and the
messages still unacked toward it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

from ..message import Command, Control, Message
from ..utils import logging as log
from ..utils.bounded import BoundedKeySet


def _signature(msg: Message) -> int:
    m = msg.meta
    # Unlike the reference (which truncates ids to 8 bits — resender.h:98-100,
    # a known quirk), hash the full ids so large clusters stay collision-free.
    # option+addr are part of the identity: replication forwards carry the
    # ORIGIN (worker, timestamp) of the push they relay, so two forwards
    # relaying different workers' pushes share every other field — without
    # addr in the hash the receiver would drop the second as a duplicate.
    # sid too: it distinguishes a deadline-sweeper RETRY (a new message,
    # fresh sid at dispatch) from a van-level retransmit of the original
    # (same message, sid kept) — retransmit dupes still dedup, while a
    # retry whose original REQUEST was delivered but whose RESPONSE was
    # lost reaches the app again instead of being silently ack-dropped.
    # All three fields are stable across retransmits of one message.
    # Chunked transfers (docs/chunking.md) lean on sid the same way:
    # the N chunks of one transfer share every app-level field and
    # differ only in sid, so each chunk is tracked, acked, and
    # retransmitted INDEPENDENTLY — a drop costs one chunk's resend,
    # not the whole transfer.
    return hash(
        (m.app_id, m.customer_id, m.sender, m.recver, m.timestamp, m.request,
         m.push, m.simple_app, m.key, m.option, m.addr, m.sid, m.control.cmd)
    ) & ((1 << 64) - 1)


class Resender:
    def __init__(self, van, timeout_ms: int, max_retries: int = 10):
        self._van = van
        self._timeout_s = timeout_ms / 1000.0
        self._max_retries = max_retries
        self._mu = threading.Lock()
        self._send_buff: Dict[int, Tuple[Message, float, int]] = {}
        # Telemetry (docs/observability.md): retransmit volume is THE
        # health signal of a lossy link, and ack-cache evictions bound
        # how long the dedup window actually is in practice.  Test
        # doubles without a registry degrade to the no-op singletons.
        from ..telemetry import NULL_REGISTRY

        metrics = getattr(van, "metrics", None) or NULL_REGISTRY
        self._c_retransmits = metrics.counter("resender.retransmits")
        self._c_giveups = metrics.counter("resender.giveups")
        self._c_dup_dropped = metrics.counter("resender.dup_dropped")
        evict = metrics.counter("resender.ack_cache_evictions")
        # Receive-side dedup signatures, bounded FIFO: the reference's
        # (and our former) unbounded set leaks ~8 bytes per message
        # forever on long runs.  ~64k signatures cover far more in-
        # flight traffic than any retransmit window can hold; a sig
        # evicted this long after its ack can only dedup a duplicate
        # that 10 retransmit timeouts have already passed by.
        self._acked = BoundedKeySet(
            max(1024, van.env.find_int("PS_RESEND_ACK_CACHE", 65536)),
            on_evict=lambda _sig: evict.inc(),
        )
        # Per-sender epoch of the dedup keys, bumped when the sender
        # restarts (reset_peer): its new life counts timestamps and sids
        # from the start again, so its old life's signatures must not
        # swallow the new one's messages.
        self._epochs: Dict[int, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._monitoring, name="resender", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def drain(self, max_wait_s: float = 5.0) -> bool:
        """Keep retransmitting until every buffered message is acked (or the
        deadline passes).  Called before shutdown so peers whose barrier
        replies were dropped still get them; without this a lossy link can
        strand a peer in finalize forever."""
        deadline = time.monotonic() + max_wait_s
        while time.monotonic() < deadline:
            with self._mu:
                if not self._send_buff:
                    return True
            time.sleep(self._timeout_s / 4)
        with self._mu:
            return not self._send_buff

    def add_outgoing(self, msg: Message) -> None:
        if msg.meta.control.cmd in (Command.ACK, Command.TERMINATE):
            return
        sig = _signature(msg)
        msg.meta.control.msg_sig = sig
        with self._mu:
            self._send_buff[sig] = (msg, time.monotonic(), 0)

    def add_incoming(self, msg: Message) -> bool:
        """Returns True if the message was consumed (ACK) or is a duplicate."""
        cmd = msg.meta.control.cmd
        if cmd == Command.TERMINATE:
            return False
        if cmd == Command.ACK:
            with self._mu:
                self._send_buff.pop(msg.meta.control.msg_sig, None)
            return True
        sig = msg.meta.control.msg_sig or _signature(msg)
        if msg.meta.sender >= 0:
            ack = Message()
            ack.meta.recver = msg.meta.sender
            ack.meta.control = Control(cmd=Command.ACK, msg_sig=sig)
            try:
                # Runs on the receive pump: a transport error (sender
                # died between its send and our ack) must not kill it —
                # the sender's retransmit path owns that failure.
                self._van.send(ack)
            except Exception as exc:  # noqa: BLE001
                log.vlog(1, f"ack to {msg.meta.sender} failed: {exc!r}")
        with self._mu:
            epoch = (self._epochs.get(msg.meta.sender, 0) if self._epochs
                     else 0)
            duplicated = not self._acked.add(sig if epoch == 0
                                             else (sig, epoch))
        if duplicated:
            self._c_dup_dropped.inc()
            log.vlog(2, lambda: f"Duplicated message dropped: {msg.debug_string()}")
        return duplicated

    def forget(self, sig: int) -> None:
        """Stop tracking one outgoing message (the owning request was
        failed over to another destination; retransmitting the original
        would only end in a spurious give-up)."""
        with self._mu:
            self._send_buff.pop(sig, None)

    def reset_peer(self, node_id: int) -> List[Message]:
        """A peer restarted: move its dedup keys to a fresh epoch, and
        drop and return the messages still unacked toward its old life
        (the caller fails their requests)."""
        with self._mu:
            self._epochs[node_id] = self._epochs.get(node_id, 0) + 1
            stale = [sig for sig, (m, _t, _r) in self._send_buff.items()
                     if m.meta.recver == node_id]
            return [self._send_buff.pop(sig)[0] for sig in stale]

    def _monitoring(self) -> None:
        while not self._stop.wait(self._timeout_s / 2):
            now = time.monotonic()
            resend = []
            gave_up = []
            with self._mu:
                for sig, (msg, sent_at, retries) in list(self._send_buff.items()):
                    if self._van.is_peer_down(msg.meta.recver):
                        # The failure detector already declared the
                        # destination dead: burning the remaining retry
                        # budget against it only delays the owner's
                        # failover.
                        del self._send_buff[sig]
                        gave_up.append((msg, retries, "peer declared dead"))
                        continue
                    if now - sent_at <= self._timeout_s:
                        continue
                    if retries >= self._max_retries:
                        del self._send_buff[sig]
                        gave_up.append(
                            (msg, retries, f"{retries} retries exhausted")
                        )
                        continue
                    self._send_buff[sig] = (msg, now, retries + 1)
                    resend.append(msg)
            for msg, retries, why in gave_up:
                self._c_giveups.inc()
                log.warning(
                    f"Failed to deliver ({why}): {msg.debug_string()}"
                )
                # Flight recorder (docs/observability.md): a give-up is
                # the terminal fault of the reliability layer — the
                # postmortem wants the peer, the retry count, and why.
                flight = getattr(self._van, "flight", None)
                if flight is not None:
                    flight.record(
                        "retransmit_giveup", severity="warn",
                        peer=msg.meta.recver, retries=retries, why=why,
                        ts=msg.meta.timestamp,
                    )
                # Fail the owning request (or park a van error) instead
                # of the old silent delete, which left the waiting
                # caller hanging forever on a message the resender had
                # already abandoned.
                try:
                    self._van._delivery_failed(
                        msg, ConnectionError(f"resender gave up: {why}")
                    )
                except Exception as exc:  # noqa: BLE001
                    log.warning(f"delivery-failure report failed: {exc!r}")
            for msg in resend:
                self._c_retransmits.inc()
                log.vlog(1, f"Resend {msg.debug_string()}")
                try:
                    # Routed through the owning peer's send lane (no sid
                    # re-assignment, no re-buffering); lane-side failures
                    # surface via the van's parked-error path, not here.
                    self._van.send_msg_locked(msg)
                except Exception as exc:
                    log.warning(f"resend failed: {exc!r}")
