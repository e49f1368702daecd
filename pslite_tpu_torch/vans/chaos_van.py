"""Chaos-injection wrapper van (``PS_VAN_TYPE=chaos[+inner]``).

Copy of ``pslite_tpu/vans/chaos_van.py``: a seeded spec (``PS_CHAOS``)
injects drops, delays, reorders, duplicates, one-way partitions and
crash-at-phase hooks into any socket or loopback transport.  It is the
harness the recovery tier (failure detector, request deadlines, the
resender) is proven against.

Spec grammar (comma-separated ``key=value``)::

    PS_CHAOS="seed=42,drop=0.2,delay=1:20,reorder=0.1,dup=0.05,
              part=9>8,crash=recv:50"

    seed=N        RNG seed (mixed with the node id once assigned, so
                  every node draws a distinct but reproducible stream;
                  the same spec and ids draw what JAX's wrapper draws)
    drop=P        receive-side drop probability (0..1)
    send_drop=P   send-side drop probability
    delay=A[:B]   receive-side delay, uniform in [A, B] milliseconds
    send_delay=A[:B]   same, on the send path
    reorder=P     hold a message back and deliver its successor first
    dup=P         deliver a message twice
    part=A>B[;C>D]     one-way partition: traffic from node A to node B
                  vanishes (evaluated on both endpoints)
    crash=PHASE:N  after N data messages through PHASE the node goes
                  dark in that direction and stops heartbeating:
                    recv — deaf: swallows incoming data, still sends
                    send — mute: black-holes outgoing data
                    dead — both directions dark

Injection applies to data messages only, and only after bootstrap
(``van.ready``); a crashed node also suppresses its heartbeats, which is
what the failure detector notices.  Counters live in the node registry as
``chaos.*``, read through ``van.chaos_stats``; the crash
hook sets ``van.chaos_crashed``, a ``threading.Event``.  A chaos van
declines the native sender lanes and turns the core's reassembly off,
so injection sees every data message.
"""

from __future__ import annotations

import collections
import copy
import random
import threading
import time
from typing import Dict, Optional, Tuple

from ..message import Command, Message
from ..utils import logging as log


def _parse_prob(val: str) -> float:
    p = float(val)
    log.check(0.0 <= p <= 1.0, f"chaos probability out of range: {val}")
    return p


def _parse_ms_range(val: str) -> Tuple[float, float]:
    """``"5"`` / ``"5ms"`` / ``"1:20"`` -> (lo_s, hi_s)."""
    parts = val.split(":")
    log.check(len(parts) in (1, 2), f"bad chaos delay spec: {val}")
    nums = [float(p.strip().removesuffix("ms")) / 1000.0 for p in parts]
    lo = nums[0]
    hi = nums[1] if len(nums) == 2 else nums[0]
    log.check(0 <= lo <= hi, f"bad chaos delay range: {val}")
    return lo, hi


def parse_spec(spec: str) -> dict:
    """A ``PS_CHAOS`` spec string as a plain dict."""
    out: dict = {
        "seed": 0, "drop": 0.0, "send_drop": 0.0,
        "delay": (0.0, 0.0), "send_delay": (0.0, 0.0),
        "reorder": 0.0, "dup": 0.0,
        "partitions": set(), "crash_phase": None, "crash_after": 0,
    }
    for fld in spec.split(","):
        fld = fld.strip()
        if not fld:
            continue
        log.check("=" in fld, f"bad chaos field (want key=value): {fld}")
        key, val = fld.split("=", 1)
        key, val = key.strip(), val.strip()
        if key == "seed":
            out["seed"] = int(val)
        elif key in ("drop", "send_drop", "reorder", "dup"):
            out[key] = _parse_prob(val)
        elif key in ("delay", "send_delay"):
            out[key] = _parse_ms_range(val)
        elif key == "part":
            for edge in val.split(";"):
                a, b = edge.split(">")
                out["partitions"].add((int(a), int(b)))
        elif key == "crash":
            phase, n = val.split(":")
            log.check(phase in ("recv", "send", "dead"),
                      f"unknown chaos crash phase: {phase}")
            out["crash_phase"] = phase
            out["crash_after"] = int(n)
        else:
            log.check(False, f"unknown chaos spec key: {key}")
    return out


class ChaosPolicy:
    """Per-van decision engine over a parsed spec.  All randomness comes
    from one seeded stream (the seed mixed with the node id), under a
    lock: the receive pump and every send-lane thread draw from it, so a
    run replays exactly only under the same message interleaving."""

    def __init__(self, spec: str):
        self.spec = parse_spec(spec)
        self._rng: Optional[random.Random] = None
        self._rng_node = None
        self._rng_mu = threading.Lock()
        self._counts: collections.Counter = collections.Counter()
        self._mu = threading.Lock()
        self.crashed = threading.Event()

    def _roll_locked(self, node_id: int) -> random.Random:
        if self._rng is None or self._rng_node != node_id:
            # Knuth-style mix: nodes sharing one spec draw distinct (but
            # each reproducible) streams.
            self._rng = random.Random(
                self.spec["seed"] ^ (node_id * 2654435761))
            self._rng_node = node_id
        return self._rng

    def partitioned(self, sender: int, recver: int) -> bool:
        return (sender, recver) in self.spec["partitions"]

    def count_data(self, phase: str) -> None:
        """Advance the crash counter for one data message through
        ``phase``; trips the crash once the budget is spent."""
        want = self.spec["crash_phase"]
        if want is None or self.crashed.is_set():
            return
        if want != phase and want != "dead":
            return
        with self._mu:
            self._counts[want] += 1
            if self._counts[want] > self.spec["crash_after"]:
                self.crashed.set()

    def crash_blocks(self, phase: str) -> bool:
        if not self.crashed.is_set():
            return False
        want = self.spec["crash_phase"]
        return want == "dead" or want == phase

    def draw(self, node_id: int, kind: str) -> bool:
        p = self.spec[kind]
        if p <= 0:
            return False
        with self._rng_mu:
            return self._roll_locked(node_id).random() < p

    def delay_s(self, node_id: int, kind: str) -> float:
        lo, hi = self.spec[kind]
        if hi <= 0:
            return 0.0
        with self._rng_mu:
            return self._roll_locked(node_id).uniform(lo, hi)


class _ChaosStats:
    """A read view of the node registry's ``chaos.*`` counters with the
    ``van.chaos_stats`` surface of JAX's wrapper: ``stats["recv_dropped"]``,
    ``get``, ``items``, ``keys``, ``values``; an unseen key reads 0."""

    _PREFIX = "chaos."

    def __init__(self, registry):
        from ..telemetry.metrics import node_registry

        self._registry = node_registry(registry)

    def inc(self, key: str, n: int = 1) -> None:
        self._registry.counter(self._PREFIX + key).inc(n)

    def __getitem__(self, key: str) -> int:
        return self._registry.counter(self._PREFIX + key).value

    def get(self, key: str, default: int = 0) -> int:
        # dict.get: the default applies only to a counter never created.
        vals = self._registry.counters_with_prefix(self._PREFIX)
        return vals.get(self._PREFIX + key, default)

    def items(self):
        return {name[len(self._PREFIX):]: v
                for name, v in self._registry.counters_with_prefix(
                    self._PREFIX).items()}.items()

    def keys(self):
        return [k for k, _ in self.items()]

    def values(self):
        return [v for _, v in self.items()]


_CLASS_CACHE: Dict[type, type] = {}


def chaos_class(inner_cls: type) -> type:
    """``inner_cls`` with chaos injection around its ``send_msg`` /
    ``recv_msg`` (one class per transport, cached)."""
    cached = _CLASS_CACHE.get(inner_cls)
    if cached is not None:
        return cached

    class ChaosVan(inner_cls):  # type: ignore[misc, valid-type]
        def __init__(self, postoffice):
            super().__init__(postoffice)
            self.chaos = ChaosPolicy(self.env.find("PS_CHAOS") or "")
            self.chaos_stats = _ChaosStats(self.metrics)
            if getattr(self, "_native", None) is not None:
                # Drop/delay/dup act on delivered messages: the core's
                # reassembly would collapse a transfer into one delivery.
                self._native.set_reassembly(False)
            # Reorder holdback and redelivery queue: the receive pump's
            # thread alone touches these.
            self._chaos_held: Optional[Message] = None
            self._chaos_requeued: collections.deque = collections.deque()

        @property
        def chaos_crashed(self) -> threading.Event:
            return self.chaos.crashed

        # -- send path ---------------------------------------------------

        def _native_submit(self, msg: Message):
            """The native sender lanes would transmit around
            ``send_msg`` and so around every send-side fault: a chaos
            van always takes the Python lanes."""
            return None

        def send_msg(self, msg: Message) -> int:
            chaos = self.chaos
            ctrl = msg.meta.control
            if not self.ready.is_set():
                return super().send_msg(msg)
            if not ctrl.empty():
                if (chaos.crashed.is_set()
                        and ctrl.cmd == Command.HEARTBEAT):
                    # A crashed node stops heartbeating: the failure
                    # detector's signal.
                    self.chaos_stats.inc("heartbeat_suppressed")
                    return 0
                if (chaos.crash_blocks("send")
                        and ctrl.cmd != Command.TERMINATE
                        and chaos.spec["crash_phase"] == "dead"):
                    self.chaos_stats.inc("send_blackholed")
                    return 0
                return super().send_msg(msg)
            me = self.my_node.id
            chaos.count_data("send")
            if chaos.crash_blocks("send"):
                self.chaos_stats.inc("send_blackholed")
                return 0
            if chaos.partitioned(me, msg.meta.recver):
                self.chaos_stats.inc("send_partitioned")
                return 0
            if chaos.draw(me, "send_drop"):
                self.chaos_stats.inc("send_dropped")
                return 0
            d = chaos.delay_s(me, "send_delay")
            if d > 0:
                # Stalls only this peer's lane thread.
                self.chaos_stats.inc("send_delayed")
                time.sleep(d)
            return super().send_msg(msg)

        # -- receive path ------------------------------------------------

        def _chaos_dup(self, msg: Message) -> Message:
            dup = Message()
            dup.meta = copy.deepcopy(msg.meta)
            dup.data = list(msg.data)
            return dup

        def _chaos_release(self, msg: Message) -> Message:
            """Deliver ``msg``; a held (reordered) predecessor rides the
            redelivery queue right behind it."""
            if self._chaos_held is not None:
                held, self._chaos_held = self._chaos_held, None
                self._chaos_requeued.append(held)
            return msg

        def recv_msg(self) -> Optional[Message]:
            if self._chaos_requeued:
                return self._chaos_requeued.popleft()
            chaos = self.chaos
            while True:
                msg = super().recv_msg()
                if msg is None:
                    return None
                if not self.ready.is_set() or not msg.meta.control.empty():
                    if (msg.meta.control.cmd != Command.TERMINATE
                            and chaos.crash_blocks("recv")
                            and chaos.spec["crash_phase"] == "dead"):
                        self.chaos_stats.inc("recv_swallowed")
                        continue
                    return self._chaos_release(msg)
                me = self.my_node.id
                chaos.count_data("recv")
                if chaos.crash_blocks("recv"):
                    self.chaos_stats.inc("recv_swallowed")
                    continue
                if chaos.partitioned(msg.meta.sender, me):
                    self.chaos_stats.inc("recv_partitioned")
                    continue
                if chaos.draw(me, "drop"):
                    self.chaos_stats.inc("recv_dropped")
                    continue
                d = chaos.delay_s(me, "delay")
                if d > 0:
                    self.chaos_stats.inc("recv_delayed")
                    time.sleep(d)
                if self._chaos_held is None and chaos.draw(me, "reorder"):
                    # Hold this one back; its successor passes it.
                    self.chaos_stats.inc("reordered")
                    self._chaos_held = msg
                    continue
                if chaos.draw(me, "dup"):
                    self.chaos_stats.inc("duplicated")
                    self._chaos_requeued.append(self._chaos_dup(msg))
                return self._chaos_release(msg)

        def stop(self) -> None:
            super().stop()
            if self.chaos.crashed.is_set():
                # An abnormal stop: the flight recorder's fault event.
                self.flight.record("chaos_crash", severity="crit",
                                   phase=str(self.chaos.spec["crash_phase"]))

    ChaosVan.__name__ = f"Chaos{inner_cls.__name__}"
    ChaosVan.__qualname__ = ChaosVan.__name__
    _CLASS_CACHE[inner_cls] = ChaosVan
    return ChaosVan


def _inner_class(name: str) -> type:
    from . import transport_class

    if name.startswith("ici") or name == "xla":
        # The collective data plane runs on the device, not through the
        # send_msg/recv_msg hooks chaos wraps.
        raise ValueError(f"chaos van cannot wrap inner type {name!r}")
    cls = transport_class(name)
    if cls is None:
        raise ValueError(f"chaos van cannot wrap inner type {name!r}")
    return cls


def create_chaos(inner: str, postoffice):
    return chaos_class(_inner_class(inner))(postoffice)
