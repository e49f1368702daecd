"""Postoffice — per-role-instance center of the system.

Counterpart of ``pslite_tpu/postoffice.py`` (the reference's
``include/ps/internal/postoffice.h`` / ``src/postoffice.cc``): env
parsing, van creation, node-id bookkeeping and group membership tables,
barriers, server key ranges, the heartbeat registry, the customer
registry (requests that arrive before their app exists are parked, not
dropped) and the lifecycle (start/finalize).  One Postoffice exists per
role instance: worker, server or scheduler; ``start_ps`` expands the
joint role and ``DMLC_GROUP_SIZE`` instance groups into several.

Node recovery runs in the van (a restarted node takes its dead id back
and skips the startup barrier: ``is_recovery``).  The scheduler
coordinates cluster snapshots (``snapshot``, ``PS_SNAPSHOT_DIR``:
broadcast ``Command.SNAPSHOT``, gather every server's segment digests,
commit the manifest) and model namespaces (``publish_model``,
``rollback_model``) over the same channel; servers take the requests
through ``register_snapshot_hook``.  Elastic membership
(``PS_ELASTIC=1``): the routing surface (``routing_table``,
``apply_routing`` with its hooks, ``active_server_ranks``, the
scheduler's migration ledger that a snapshot waits on, and
``request_decommission``); the van admits joiners and retires leavers.
The scheduler passes its ``hot_key_hint`` (the servers' hot-key tables
of the last metrics pull) to ``with_join``.

Telemetry: one metrics ``Registry``, ``Tracer`` and ``FlightRecorder``
per node (``PS_TELEMETRY``), the scheduler's pulls
(``collect_cluster_metrics``, ``collect_cluster_traces``), its
``ClusterHistory`` sampler with the SLO watchdog (``start_history``,
``health``) and, under ``PS_AUTOPILOT``, the autopilot.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from . import environment, vans
from .base import (
    ALL_GROUP,
    EMPTY_ID,
    MAX_KEY,
    SCHEDULER_GROUP,
    SCHEDULER_ID,
    SERVER_GROUP,
    WORKER_GROUP,
    group_members,
    id_to_rank,
    is_server_id,
    server_rank_to_id,
    worker_rank_to_id,
)
from .message import Command, Control, Message, Node, Role
from .range import Range
from .routing import RoutingTable
from .telemetry.flight import FlightRecorder
from .telemetry.metrics import Registry
from .telemetry.tracing import Tracer
from .utils import logging as log


def parse_role(role) -> Role:
    """``role`` (a name in any case, or a :class:`Role`) as a Role."""
    if role is None:
        raise ValueError("role not given and DMLC_ROLE unset")
    if isinstance(role, Role):
        return role
    try:
        return Role[str(getattr(role, "name", role)).upper()]
    except KeyError:
        raise ValueError(f"unknown role {role!r}") from None


class Postoffice:
    _MAX_PENDING_PER_APP = 10000

    def __init__(self, role, instance_idx: int = 0,
                 env: Optional[environment.Environment] = None):
        self.role = parse_role(role)
        log.check(self.role != Role.JOINT,
                  "JOINT is expanded by start_ps, not hosted by one "
                  "Postoffice")
        self.env = env or environment.get()
        self.instance_idx = instance_idx
        self.num_workers = self.env.find_int("DMLC_NUM_WORKER", 0)
        self.num_servers = self.env.find_int("DMLC_NUM_SERVER", 0)
        self.group_size = max(self.env.find_int("DMLC_GROUP_SIZE", 1), 1)
        log.set_verbosity(self.env.find_int("PS_VERBOSE", 0))
        self._preferred_group_rank = self.env.find_int("DMLC_RANK", EMPTY_ID)
        self._customers: Dict[tuple, object] = {}
        self._pending_msgs: Dict[tuple, list] = {}
        self._customers_cv = threading.Condition()
        self._barrier_cv = threading.Condition()
        self._barrier_done = False
        self._heartbeats: Dict[int, float] = {}
        self._heartbeat_mu = threading.Lock()
        self._start_time = time.time()
        # Failure/recovery hooks: apps learn when the failure detector
        # declares a peer dead (down=True) or rehabilitates it.
        self._node_failure_hooks: List[Callable[[int, bool], None]] = []
        self._node_failure_mu = threading.Lock()
        self._exit_callback: Optional[Callable[[], None]] = None
        self._server_key_ranges: List[Range] = []
        self._server_key_ranges_mu = threading.Lock()
        # Elastic membership (PS_ELASTIC=1): the scheduler keeps one
        # versioned RoutingTable, broadcast on every membership change,
        # and every node applies it here.  None = static routing, the
        # uniform split below.
        self.elastic = self.env.find_int("PS_ELASTIC", 0) != 0
        # Set when the scheduler admitted this node as a live joiner
        # (ELASTIC_JOIN_OPT on the roster): it skips the startup barrier
        # as a recovered node does, but its state arrives by range
        # migration, not by a replica restore.
        self.elastic_join = False
        self._routing = None  # Optional[routing.RoutingTable]
        self._routing_mu = threading.Lock()
        self._routing_hooks: List[Callable[[object], None]] = []
        self._routing_hook_mu = threading.Lock()
        # Scheduler: {(epoch, begin): wall time the epoch shipped} of
        # every handoff not yet reported landed (MIGRATE_DONE_OPT); the
        # snapshot coordinator defers a cut while any remain.
        self._migrations_pending: Dict[tuple, float] = {}
        self._migration_settle_s = self.env.find_float(
            "PS_MIGRATION_SETTLE_S", 120.0)
        # Live server group ranks (None = the static 0..num_servers-1);
        # rank holes are legal after an out-of-order decommission.
        self._active_server_ranks: Optional[List[int]] = None
        # Completed by the scheduler's REMOVE_NODE ack.
        self._removed_event = threading.Event()
        self._node_ids: Dict[int, List[int]] = {}
        self._build_node_id_table()
        # Per-node telemetry: one metrics registry, tracer and flight
        # recorder per Postoffice (per node even when many logical nodes
        # share a process), built before the van so transports can
        # instrument from __init__.
        self.metrics = Registry(
            enabled=self.env.find_bool("PS_TELEMETRY", True))
        self.tracer = Tracer(self.env, self.role_str(),
                             metrics=self.metrics)
        self.flight = FlightRecorder(self.env, self.role_str())
        # METRICS_PULL / TRACE_PULL gather state (scheduler).  Whole
        # pulls serialize under _collect_mu: a second pull would bump
        # the token mid-collection and discard the first one's replies.
        self._collect_mu = threading.Lock()
        self._metrics_cv = threading.Condition()
        self._metrics_token = 0
        self._metrics_replies: Dict[int, dict] = {}
        self._metrics_last_seen: Dict[int, float] = {}
        self._trace_token = 0
        self._trace_replies: Dict[int, dict] = {}
        self._trace_collector = None  # telemetry.TraceCollector
        # The scheduler's ClusterHistory sampler and watchdog: built by
        # start_history(), started by start() when PS_METRICS_INTERVAL
        # > 0.
        self.history = None
        # The snapshot plane: the scheduler's token-gated gather and the
        # servers' hook registry (a KVServer takes SNAPSHOT requests off
        # the van pump).
        self._snapshot_mu = threading.Lock()
        self._snapshot_cv = threading.Condition()
        self._snapshot_token = 0
        self._snapshot_replies: Dict[int, dict] = {}
        self._snapshot_hooks: List[Callable[[Message], bool]] = []
        self.snapshot_dir = self.env.find("PS_SNAPSHOT_DIR") or None
        # The published model namespace (set by a server's flip).
        self.model_namespace: Optional[dict] = None
        van_type = (self.env.find("PS_VAN_TYPE")
                    or self.env.find("DMLC_ENABLE_RDMA") or "tcp")
        self.van = vans.create(van_type, self)

    # -- role & rank ---------------------------------------------------------

    @property
    def is_worker(self) -> bool:
        return self.role == Role.WORKER

    @property
    def is_server(self) -> bool:
        return self.role == Role.SERVER

    @property
    def is_scheduler(self) -> bool:
        return self.role == Role.SCHEDULER

    def role_str(self) -> str:
        return self.role.name.lower()

    @property
    def num_worker_instances(self) -> int:
        return self.num_workers * self.group_size

    @property
    def num_server_instances(self) -> int:
        return self.num_servers * self.group_size

    @property
    def active_server_ranks(self) -> Optional[List[int]]:
        """Live server group ranks under elastic membership (None =
        the static ``0..num_servers-1``)."""
        return self._active_server_ranks

    @property
    def num_active_servers(self) -> int:
        """The count of live server groups: differs from
        ``num_servers`` only under elastic membership with rank holes."""
        if self._active_server_ranks is not None:
            return len(self._active_server_ranks)
        return self.num_servers

    @property
    def num_active_server_instances(self) -> int:
        return self.num_active_servers * self.group_size

    @property
    def preferred_rank(self) -> int:
        """Preferred instance rank sent in ADD_NODE's aux_id
        (``DMLC_RANK``)."""
        if self._preferred_group_rank == EMPTY_ID:
            return EMPTY_ID
        return self._preferred_group_rank * self.group_size + self.instance_idx

    def instance_rank_to_id(self, role: Role, instance_rank: int) -> int:
        if role == Role.WORKER:
            return worker_rank_to_id(instance_rank)
        return server_rank_to_id(instance_rank)

    @property
    def is_recovery(self) -> bool:
        """This node took a dead node's id back after a restart."""
        return self.van.my_node.is_recovery

    def my_rank(self) -> int:
        """My instance rank within my role."""
        return id_to_rank(self.van.my_node.id)

    def my_group_rank(self) -> int:
        return self.my_rank() // self.group_size

    def id_to_group_rank(self, node_id: int) -> int:
        """Group rank of any node id; the scheduler maps to -1."""
        if node_id == SCHEDULER_ID:
            return -1
        return id_to_rank(node_id) // self.group_size

    def on_id_assigned(self, node: Node) -> None:
        self.tracer.node_id = node.id
        self.flight.node_id = node.id
        log.vlog(1, f"assigned id {node.id} (rank {id_to_rank(node.id)}) "
                    f"to me")

    # -- group membership ----------------------------------------------------

    def _build_node_id_table(self) -> None:
        """Group bitmask -> member instance ids (reference:
        postoffice.cc:115-137).  Under elastic membership the server ids
        follow the routing table's active ranks: barriers, broadcasts
        and the failure detector's expectations read this table."""
        worker_ids = [worker_rank_to_id(i)
                      for i in range(self.num_worker_instances)]
        if self._active_server_ranks is not None:
            server_ids = [server_rank_to_id(r * self.group_size + i)
                          for r in self._active_server_ranks
                          for i in range(self.group_size)]
        else:
            server_ids = [server_rank_to_id(i)
                          for i in range(self.num_server_instances)]
        for group in range(1, 8):
            sched, srv, wrk = group_members(group)
            self._node_ids[group] = (([SCHEDULER_ID] if sched else [])
                                     + (server_ids if srv else [])
                                     + (worker_ids if wrk else []))

    def get_node_ids(self, group_or_id: int) -> List[int]:
        if group_or_id in self._node_ids:
            return self._node_ids[group_or_id]
        return [group_or_id]

    # -- lifecycle -----------------------------------------------------------

    def start(self, customer_id: int = 0, do_barrier: bool = True) -> None:
        self._start_time = time.time()
        self.van.start(customer_id)
        if do_barrier and not self.van.my_node.is_recovery:
            self.barrier(customer_id, ALL_GROUP, instance=True)
        if (self.is_scheduler
                and self.env.find_float("PS_METRICS_INTERVAL", 0.0) > 0):
            self.start_history()
        log.vlog(1, f"{self.role_str()}[{self.instance_idx}] started")

    def finalize(self, customer_id: int = 0, do_barrier: bool = True) -> None:
        if do_barrier:
            self.barrier(customer_id, ALL_GROUP, instance=True)
        if customer_id == 0:
            self.van.stop()
            # Stop still-registered customers: their receive threads
            # would otherwise outlive the node.
            with self._customers_cv:
                leftover = list(self._customers.values())
            for cust in leftover:
                cust.stop()
            if self._exit_callback is not None:
                self._exit_callback()

    def register_exit_callback(self, cb: Callable[[], None]) -> None:
        self._exit_callback = cb

    # -- barriers ------------------------------------------------------------

    def barrier(self, customer_id: int, group: int = ALL_GROUP,
                instance: bool = False,
                timeout_s: Optional[float] = None) -> None:
        """Block until every member of ``group`` reaches the barrier
        (reference: postoffice.cc:224-250).  ``timeout_s`` bounds the
        wait (None = forever); on expiry this node's request is withdrawn
        and CheckError raised — treat the cluster as degraded."""
        if len(self.get_node_ids(group)) <= 1 or not self.van.control_plane:
            return
        with self._barrier_cv:
            self._barrier_done = False
        self.van.request_barrier(group, instance)
        with self._barrier_cv:
            ok = self._barrier_cv.wait_for(lambda: self._barrier_done,
                                           timeout_s)
        if not ok:
            try:
                self.van.request_barrier(group, instance, cancel=True)
            except Exception:  # noqa: BLE001 - best-effort withdrawal
                pass
        log.check(ok, f"barrier(group={group}) timed out after "
                      f"{timeout_s}s — peer dead before the barrier?")

    def manage(self, msg: Message) -> None:
        """Handle barrier responses (reference: postoffice.cc:270-283)."""
        if (msg.meta.control.cmd in (Command.BARRIER,
                                     Command.INSTANCE_BARRIER)
                and not msg.meta.request):
            with self._barrier_cv:
                self._barrier_done = True
                self._barrier_cv.notify_all()

    # -- key ranges ----------------------------------------------------------

    def get_server_key_ranges(self) -> List[Range]:
        """The key-range partition over server groups: the routing
        table's entries under elastic membership (one range per entry;
        entries outnumber servers after a merge), else the uniform split
        (reference: postoffice.cc:257-268)."""
        rt = self.current_routing()
        if rt is not None:
            return [Range(e.begin, e.end) for e in rt.entries]
        with self._server_key_ranges_mu:
            if not self._server_key_ranges:
                log.check(self.num_servers > 0, "no servers configured")
                span = MAX_KEY // self.num_servers
                for i in range(self.num_servers):
                    end = (span * (i + 1) if i + 1 < self.num_servers
                           else MAX_KEY)
                    self._server_key_ranges.append(Range(span * i, end))
            return self._server_key_ranges

    def server_key_ranges_of(self, rank: int) -> List[Range]:
        """Every key range a server group rank currently owns: one under
        static routing, possibly several under elastic."""
        rt = self.current_routing()
        if rt is not None:
            return rt.ranges_of(rank)
        ranges = self.get_server_key_ranges()
        return [ranges[rank]] if 0 <= rank < len(ranges) else []

    # -- elastic routing -----------------------------------------------------

    def current_routing(self):
        """The routing table this node holds (None = static)."""
        with self._routing_mu:
            return self._routing

    def routing_table(self):
        """As :meth:`current_routing`, but the elastic scheduler builds
        the epoch-0 table (equal to the static split) at first use, so
        a membership change always has a base to derive from."""
        with self._routing_mu:
            if self._routing is None and self.elastic and self.is_scheduler:
                self._routing = RoutingTable.initial(self.num_servers)
            return self._routing

    def apply_routing(self, table) -> bool:
        """Adopt a strictly newer routing table: update the membership
        state (server count, active ranks, node-id tables) and run the
        routing hooks.  False for a stale epoch: reordered broadcasts
        never roll routing back."""
        with self._routing_mu:
            cur = self._routing
            if cur is not None and table.epoch <= cur.epoch:
                return False
            self._routing = table
            if self.is_scheduler:
                # A new epoch derives from a settled base: the pending
                # handoffs of older epochs are superseded wholesale.
                now = time.time()
                self._migrations_pending = {
                    (table.epoch, e.begin): now for e in table.migrations()}
        if (table.num_servers != self.num_servers
                or self._active_server_ranks != list(table.active)):
            self.num_servers = table.num_servers
            self._active_server_ranks = list(table.active)
            self._build_node_id_table()
            # Departed servers must not linger as stale rows of the
            # last-seen table the pulls keep.
            live = set(table.active) | set(table.leaving)
            with self._metrics_cv:
                for nid in list(self._metrics_last_seen):
                    if (is_server_id(nid)
                            and id_to_rank(nid) // self.group_size
                            not in live):
                        del self._metrics_last_seen[nid]
        log.vlog(1, f"routing epoch {table.epoch}: active="
                    f"{list(table.active)} leaving={list(table.leaving)} "
                    f"entries={len(table.entries)}")
        self.flight.record("epoch_change", severity="info",
                           epoch=table.epoch, active=list(table.active),
                           leaving=list(table.leaving))
        with self._routing_hook_mu:
            hooks = list(self._routing_hooks)
        for hook in hooks:
            try:
                hook(table)
            except Exception as exc:  # noqa: BLE001 - isolate hooks
                log.warning(f"routing hook failed: {exc!r}")
        return True

    def register_routing_hook(self, hook: Callable[[object], None]) -> None:
        """``hook(table)`` runs on every adopted epoch (on the van's
        pump: keep it fast).  A table already held is replayed at once,
        so a late app (a joiner's KVServer) sees the current epoch."""
        with self._routing_hook_mu:
            self._routing_hooks.append(hook)
        table = self.current_routing()
        if table is not None:
            try:
                hook(table)
            except Exception as exc:  # noqa: BLE001
                log.warning(f"routing hook failed on replay: {exc!r}")

    def unregister_routing_hook(self, hook) -> None:
        with self._routing_hook_mu:
            if hook in self._routing_hooks:
                self._routing_hooks.remove(hook)

    def note_migration_done(self, epoch: int, begin: int) -> None:
        """Scheduler: a range handoff landed (the new owner's
        MIGRATE_DONE_OPT note, or its replica-fallback unpark)."""
        with self._routing_mu:
            if self._migrations_pending.pop((epoch, begin), None) is None:
                return
            left = len(self._migrations_pending)
        log.vlog(1, f"migration of [{begin}, ...) @epoch {epoch} settled "
                    f"({left} still in flight)")

    def migrations_in_flight(self) -> List[tuple]:
        """``(epoch, begin)`` of every handoff shipped but not seen
        landed.  Entries older than ``PS_MIGRATION_SETTLE_S`` expire
        with a warning: a lost note must not wedge snapshots (the
        server's own fence still refuses a cut mid-handoff)."""
        now = time.time()
        expired = []
        with self._routing_mu:
            for key, t0 in list(self._migrations_pending.items()):
                if now - t0 > self._migration_settle_s:
                    del self._migrations_pending[key]
                    expired.append(key)
            pending = list(self._migrations_pending)
        for epoch, begin in expired:
            log.warning(f"migration of [{begin}, ...) @epoch {epoch} "
                        f"unreported for {self._migration_settle_s:.0f}s; "
                        f"assuming settled")
            self.flight.record("migration_expired", severity="warn",
                               epoch=epoch, begin=begin)
        return pending

    def request_decommission(self, timeout_s: float = 60.0) -> None:
        """Leave the running cluster: ask the scheduler to reassign this
        server's ranges and wait for the migration and retirement
        handshake.  Afterwards finalize with ``do_barrier=False``: a
        retired node counts in no barrier."""
        log.check(self.is_server, "only servers decommission")
        log.check(self.elastic, "decommission requires PS_ELASTIC=1")
        self._removed_event.clear()
        msg = Message()
        msg.meta.recver = SCHEDULER_ID
        msg.meta.request = True
        msg.meta.body = json.dumps({"rank": self.my_group_rank()}).encode()
        msg.meta.control = Control(cmd=Command.REMOVE_NODE)
        msg.meta.timestamp = self.van.next_timestamp()
        self.van.send(msg)
        ok = self._removed_event.wait(timeout_s)
        log.check(ok, f"decommission did not complete in {timeout_s}s")

    def hot_key_hint(self) -> Dict[int, int]:
        """Scheduler: the load hint of a load-weighted range split, the
        union of the ``kv.hot_keys`` top-k tables of the last
        METRICS_PULL replies; empty before any pull (the split then
        falls back to the widest range)."""
        with self._metrics_cv:
            replies = dict(self._metrics_replies)
        hint: Dict[int, int] = {}
        for snap in replies.values():
            top = (snap.get("metrics", {}) or {}).get(
                "topk", {}).get("kv.hot_keys") or []
            for item in top:
                try:
                    k, n = int(item[0]), int(item[1])
                except (TypeError, ValueError, IndexError):
                    continue
                hint[k] = hint.get(k, 0) + n
        return hint

    # -- customers -----------------------------------------------------------

    def add_customer(self, customer) -> None:
        # Registration and the flush of parked messages happen under the
        # lock buffer_pending takes, so a message arriving meanwhile can
        # never overtake the parked ones.
        with self._customers_cv:
            key = (customer.app_id, customer.customer_id)
            log.check(key not in self._customers, f"customer {key} exists")
            for msg in self._pending_msgs.pop(key, []):
                customer.accept(msg)
            self._customers[key] = customer
    
    def buffer_pending(self, app_id: int, customer_id: int, msg) -> None:
        """Park a message that arrived before its app registered."""
        key = (app_id, customer_id)
        with self._customers_cv:
            customer = self._customers.get(key)
            if customer is None:
                queue = self._pending_msgs.setdefault(key, [])
                if not queue:
                    log.warning(f"parking message for not-yet-registered "
                                f"app {key}")
                # Overflow is fatal, like the reference's CHECK after its
                # 5 s readiness wait (van.cc:428-438): dropping a KV
                # message would strand its sender's wait forever.
                log.check(len(queue) < self._MAX_PENDING_PER_APP,
                          f"pending buffer overflow for app {key}: the app "
                          f"never registered a customer")
                queue.append(msg)
                return
        customer.accept(msg)

    def get_customer(self, app_id: int, customer_id: int):
        with self._customers_cv:
            return self._customers.get((app_id, customer_id))

    def remove_customer(self, customer) -> None:
        with self._customers_cv:
            self._customers.pop((customer.app_id, customer.customer_id), None)

    # -- heartbeats ----------------------------------------------------------

    def update_heartbeat(self, node_id: int, t: float) -> None:
        with self._heartbeat_mu:
            prev = self._heartbeats.get(node_id)
            self._heartbeats[node_id] = t
        if prev is not None and t > prev:
            # The observed beat gap: a p99 creeping toward
            # PS_HEARTBEAT_TIMEOUT warns before the detector fires.
            self.metrics.histogram("heartbeat.gap_s", lo=1e-3).observe(
                t - prev)

    def get_dead_nodes(self, timeout_s: float = 60) -> List[int]:
        """Nodes silent for more than ``timeout_s`` (reference:
        postoffice.cc:285-304); a node never heard from ages from its
        registration-time seed."""
        if timeout_s == 0:
            return []
        now = time.time()
        expected = self.get_node_ids(WORKER_GROUP + SERVER_GROUP
                                     if self.is_scheduler
                                     else SCHEDULER_GROUP)
        with self._heartbeat_mu:
            return [i for i in expected
                    if self._heartbeats.get(i, self._start_time) + timeout_s
                    < now]

    # -- cluster telemetry (METRICS_PULL, TRACE_PULL) ------------------------

    def telemetry_snapshot(self) -> dict:
        """This node's registry snapshot with its identity: the payload
        of a METRICS_PULL reply."""
        # Drain the wire plane's thread shards and the native core's
        # counter block first; a dying transport must not break the
        # snapshot.
        try:
            self.van.wire_sync()
        except Exception:  # noqa: BLE001
            pass
        snap = {
            "node_id": self.van.my_node.id,
            "role": self.role_str(),
            "rank": (id_to_rank(self.van.my_node.id)
                     if self.van.my_node.id > 1 else 0),
            "wall_time": time.time(),
            "metrics": self.metrics.snapshot(),
        }
        rt = self.current_routing()
        if rt is not None:
            routing = {"epoch": rt.epoch, "active": list(rt.active),
                       "leaving": list(rt.leaving)}
            if self.is_server:
                routing["owned"] = [
                    [r.begin, r.end]
                    for r in rt.ranges_of(self.my_group_rank())]
            snap["routing"] = routing
        if self.model_namespace:
            snap["namespace"] = self.model_namespace
        return snap

    def absorb_metrics_reply(self, msg: Message) -> None:
        """Van hook: a node's METRICS_PULL reply arrived."""
        try:
            snap = json.loads(msg.meta.body.decode())
        except Exception as exc:  # noqa: BLE001 - a corrupt reply must
            log.warning(f"bad METRICS_PULL reply: {exc!r}")  # not wedge
            snap = {"node_id": msg.meta.sender, "error": repr(exc)}
        with self._metrics_cv:
            self._metrics_last_seen[msg.meta.sender] = time.time()
            if msg.meta.timestamp != self._metrics_token:
                return  # a stale reply of an earlier (timed-out) pull
            self._metrics_replies[msg.meta.sender] = snap
            self._metrics_cv.notify_all()

    def _pull(self, cmd: Command, body: bytes, timeout_s: float,
              replies_attr: str, token_attr: str) -> Dict[int, dict]:
        """Broadcast one pull request to every live worker and server
        and gather the replies (absent: a node that did not answer in
        ``timeout_s``).  The caller holds ``_collect_mu``."""
        peers = [i for i in self.get_node_ids(WORKER_GROUP + SERVER_GROUP)
                 if not self.van.is_peer_down(i)]
        with self._metrics_cv:
            token = getattr(self, token_attr) + 1
            setattr(self, token_attr, token)
            setattr(self, replies_attr, {})
        reached = 0
        for peer in peers:
            msg = Message()
            msg.meta.recver = peer
            msg.meta.sender = self.van.my_node.id
            msg.meta.request = True
            msg.meta.timestamp = token
            msg.meta.body = body
            msg.meta.control = Control(cmd=cmd)
            try:
                self.van.send(msg)
                reached += 1
            except Exception as exc:  # noqa: BLE001 - a dead peer must
                # neither fail the pull nor be waited for.
                log.warning(f"{cmd.name} to {peer} failed: {exc!r}")
        deadline = time.monotonic() + timeout_s
        with self._metrics_cv:
            while len(getattr(self, replies_attr)) < reached:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._metrics_cv.wait(remaining)
            return dict(getattr(self, replies_attr))

    def collect_cluster_metrics(self, timeout_s: float = 5.0
                                ) -> Dict[int, dict]:
        """Scheduler: broadcast METRICS_PULL to every live worker and
        server and return ``{node_id: snapshot}``, the scheduler's own
        included.  A node that does not answer within ``timeout_s`` is
        absent."""
        log.check(self.is_scheduler,
                  "collect_cluster_metrics runs on the scheduler")
        with self._collect_mu:
            replies = self._pull(Command.METRICS_PULL, b"", timeout_s,
                                 "_metrics_replies", "_metrics_token")
            out = {self.van.my_node.id: self.telemetry_snapshot()}
            out.update(replies)
            return out

    def metrics_last_seen(self) -> Dict[int, float]:
        """Scheduler: wall time of each node's newest METRICS_PULL
        reply."""
        with self._metrics_cv:
            return dict(self._metrics_last_seen)

    def trace_collector(self):
        """The scheduler's cross-node trace assembler (built at first
        use; ``telemetry.TraceCollector``)."""
        if self._trace_collector is None:
            from .telemetry.trace_store import TraceCollector

            self._trace_collector = TraceCollector(
                ttl_s=self.env.find_float("PS_TRACE_TTL", 30.0),
                max_traces=self.env.find_int("PS_TRACE_KEEP", 4096))
        return self._trace_collector

    def absorb_trace_reply(self, msg: Message) -> None:
        """Van hook: a node's TRACE_PULL reply arrived."""
        try:
            rep = json.loads(msg.meta.body.decode())
        except Exception as exc:  # noqa: BLE001 - one corrupt reply
            log.warning(f"bad TRACE_PULL reply: {exc!r}")  # can't wedge
            rep = {"node_id": msg.meta.sender, "error": repr(exc)}
        with self._metrics_cv:
            if msg.meta.timestamp != self._trace_token:
                return  # a stale reply of an earlier (timed-out) pull
            self._trace_replies[msg.meta.sender] = rep
            self._metrics_cv.notify_all()

    def _tail_hints(self) -> dict:
        """Tail-keep threshold hints for the TRACE_PULL broadcast: the
        workers' worst windowed push/pull latency quantiles from the
        ClusterHistory sampler; empty without a history (nodes then use
        their local histograms)."""
        h = self.history
        if h is None or h.samples < 2:
            return {}
        hints: Dict[str, dict] = {}
        for path, hist in (("push", "kv.push_latency_s"),
                           ("pull", "kv.pull_latency_s")):
            for q, label in ((0.9, "p90"), (0.95, "p95"), (0.99, "p99")):
                worst = None
                for nid in h.node_ids():
                    if h.role_of(nid) != "worker":
                        continue
                    v = h.window_quantile(nid, hist, q)
                    if v is not None and (worst is None or v > worst):
                        worst = v
                if worst is not None:
                    hints.setdefault(path, {})[label] = worst
        return hints

    def collect_cluster_traces(self, timeout_s: float = 5.0):
        """Scheduler: broadcast TRACE_PULL (with the tail hints), drain
        the replies' span rings into :meth:`trace_collector`, retire
        expired partials and return the collector."""
        log.check(self.is_scheduler,
                  "collect_cluster_traces runs on the scheduler")
        hints = self._tail_hints()
        body = json.dumps({"hints": hints}).encode() if hints else b""
        with self._collect_mu:
            replies = self._pull(Command.TRACE_PULL, body, timeout_s,
                                 "_trace_replies", "_trace_token")
        coll = self.trace_collector()
        # The scheduler's own ring drains locally.
        spans, evicted = self.tracer.drain()
        coll.ingest(self.van.my_node.id, self.role_str(), spans,
                    [e for e in self.flight.events() if e.get("trace")],
                    evicted=evicted)
        for nid, rep in replies.items():
            coll.ingest(nid, rep.get("role", "?"),
                        rep.get("spans") or [], rep.get("flight") or [],
                        evicted=rep.get("evicted") or 0)
        coll.retire()
        return coll

    # -- continuous telemetry ------------------------------------------------

    def start_history(self, interval_s: Optional[float] = None):
        """Build (and start, when the interval is positive) the
        scheduler's :class:`~.telemetry.ClusterHistory` sampler and
        watchdog, with the autopilot under ``PS_AUTOPILOT``.
        Idempotent; returns the history."""
        log.check(self.is_scheduler, "ClusterHistory runs on the scheduler")
        if self.history is None:
            from .cluster.autopilot import Autopilot, parse_mode
            from .telemetry.timeseries import ClusterHistory

            self.history = ClusterHistory(po=self, env=self.env,
                                          interval_s=interval_s)
            # Built only when PS_AUTOPILOT opts in: unset leaves the
            # ingest path as without the engine.
            mode = parse_mode(self.env.find("PS_AUTOPILOT"))
            if mode is not None:
                self.history.autopilot = Autopilot(self, env=self.env,
                                                   mode=mode)
        if interval_s is not None and interval_s > 0:
            self.history.interval_s = float(interval_s)
        if self.history.interval_s > 0 and not self.history.running:
            self.history.start()
        return self.history

    def stop_history(self) -> None:
        if self.history is not None:
            self.history.stop()

    def health(self, min_severity: str = "warn",
               since: Optional[float] = None) -> List:
        """The watchdog's :class:`~.telemetry.HealthEvent` findings
        (scheduler; empty without a history)."""
        if self.history is None:
            return []
        return self.history.watchdog.events(min_severity=min_severity,
                                            since=since)

    # -- node failure hooks --------------------------------------------------

    def register_node_failure_hook(self,
                                   hook: Callable[[int, bool], None]) -> None:
        """``hook(node_id, down)`` runs when the failure detector
        declares a peer dead (True) or rehabilitates it (False), on van
        threads: keep it fast."""
        with self._node_failure_mu:
            self._node_failure_hooks.append(hook)

    def unregister_node_failure_hook(self, hook) -> None:
        with self._node_failure_mu:
            if hook in self._node_failure_hooks:
                self._node_failure_hooks.remove(hook)

    def notify_node_failure(self, node_id: int, down: bool = True) -> None:
        with self._node_failure_mu:
            hooks = list(self._node_failure_hooks)
        for hook in hooks:
            try:
                hook(node_id, down)
            except Exception as exc:  # noqa: BLE001 - isolate hooks
                log.warning(f"node failure hook failed: {exc!r}")

    # -- coordinated snapshots ----------------------------------------------

    def register_snapshot_hook(self, hook: Callable[[Message], bool]) -> None:
        """``hook(msg)`` receives SNAPSHOT control requests on the van
        pump and returns True when it took over the reply (KVServer
        posts the fence through its request queue and answers from
        there).  Keep hooks fast: never block on the van."""
        with self._snapshot_mu:
            self._snapshot_hooks.append(hook)

    def unregister_snapshot_hook(self, hook) -> None:
        with self._snapshot_mu:
            if hook in self._snapshot_hooks:
                self._snapshot_hooks.remove(hook)

    def notify_snapshot(self, msg: Message) -> bool:
        """Run the snapshot hooks; True when one took the request."""
        with self._snapshot_mu:
            hooks = list(self._snapshot_hooks)
        for hook in hooks:
            try:
                if hook(msg):
                    return True
            except Exception as exc:  # noqa: BLE001 - isolate hooks
                log.warning(f"snapshot hook failed: {exc!r}")
        return False

    def absorb_snapshot_reply(self, msg: Message) -> None:
        """Van hook: a server's SNAPSHOT reply arrived (scheduler)."""
        try:
            rep = json.loads(msg.meta.body.decode())
        except Exception as exc:  # noqa: BLE001 - one corrupt reply
            rep = {"error": f"bad reply: {exc!r}"}
        with self._snapshot_cv:
            if msg.meta.timestamp != self._snapshot_token:
                return  # a stale reply of an earlier (timed-out) op
            self._snapshot_replies[msg.meta.sender] = rep
            self._snapshot_cv.notify_all()

    def _snapshot_gather(self, body: bytes, timeout_s: float,
                         what: str):
        """Broadcast one SNAPSHOT-channel request to every live server
        and gather their replies: ``(replies, live peers)``."""
        peers = [i for i in self.get_node_ids(SERVER_GROUP)
                 if not self.van.is_peer_down(i)]
        log.check(bool(peers), f"{what}: no live servers")
        with self._snapshot_cv:
            self._snapshot_token += 1
            token = self._snapshot_token
            self._snapshot_replies = {}
        reached = []
        for peer in peers:
            msg = Message()
            msg.meta.recver = peer
            msg.meta.sender = self.van.my_node.id
            msg.meta.request = True
            msg.meta.timestamp = token
            msg.meta.body = body
            msg.meta.control = Control(cmd=Command.SNAPSHOT)
            try:
                self.van.send(msg)
                reached.append(peer)
            except Exception as exc:  # noqa: BLE001 - a dead peer vetoes
                log.warning(f"{what} to {peer} failed: {exc!r}")
        deadline = time.monotonic() + timeout_s
        with self._snapshot_cv:
            while len(self._snapshot_replies) < len(reached):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._snapshot_cv.wait(remaining)
            replies = dict(self._snapshot_replies)
        return replies, peers

    def snapshot(self, directory: Optional[str] = None,
                 timeout_s: float = 60.0,
                 settle_timeout_s: float = 10.0) -> dict:
        """Coordinate one consistent-cut cluster snapshot: broadcast
        ``Command.SNAPSHOT`` to every live server, gather their
        per-range digests, and commit the cut by writing the cluster
        manifest.  Scheduler only.  Raises when any server errored or
        did not answer: a partial snapshot is never committed (the old
        manifest, if any, stays the restore point).  A cut waits while
        range migrations are in flight (at most ``settle_timeout_s``,
        then it is vetoed): it would cut a range whose state is split
        across its old and new owner."""
        log.check(self.is_scheduler, "snapshot runs on the scheduler")
        directory = directory or self.snapshot_dir
        log.check(bool(directory),
                  "snapshot needs a directory (PS_SNAPSHOT_DIR or the "
                  "directory= argument)")
        settle_by = time.monotonic() + settle_timeout_s
        deferred = False
        while True:
            pending = self.migrations_in_flight()
            if not pending:
                break
            if not deferred:
                deferred = True
                self.flight.record("snapshot_deferred", severity="warn",
                                   pending=[list(p) for p in pending[:4]],
                                   count=len(pending))
            if time.monotonic() >= settle_by:
                log.check(False, f"snapshot vetoed: {len(pending)} range "
                                 f"migration(s) still in flight after "
                                 f"{settle_timeout_s:g}s (epochs "
                                 f"{sorted({e for e, _ in pending})})")
            time.sleep(0.05)
        from .kv import snapshot as snap_mod

        t0 = time.monotonic()
        rt = self.current_routing()
        epoch = rt.epoch if rt is not None else -1
        self.flight.record("snapshot_begin", severity="info",
                           dir=directory, epoch=epoch)
        # A per-attempt uid in every segment's name: a vetoed attempt
        # never overwrites the committed snapshot's files.
        uid = f"{os.getpid():x}-{int(time.time() * 1000):x}"
        body = json.dumps({"dir": directory, "epoch": epoch,
                           "uid": uid}).encode()
        replies, peers = self._snapshot_gather(body, timeout_s, "SNAPSHOT")
        entries, errors = snap_mod.snapshot_summary(replies)
        silent = [p for p in peers if p not in replies]
        if silent:
            errors.append(f"no reply from node(s) {silent} within "
                          f"{timeout_s}s")
        if errors:
            self.flight.record("snapshot_end", severity="warn",
                               ok=False, errors=errors[:4])
            log.check(False, "snapshot NOT committed: "
                             + "; ".join(errors))
        manifest = snap_mod.write_manifest(
            directory, epoch, entries,
            extra={"servers": len(replies), "uid": uid})
        # The new manifest is durable: the previous snapshot's (and any
        # vetoed attempt's) segment files are garbage now.
        snap_mod.prune_segments(directory, {"ranges": entries})
        dur = time.monotonic() - t0
        self.metrics.histogram("snapshot.duration_s").observe(dur)
        self.flight.record("snapshot_end", severity="info", ok=True,
                           keys=sum(e["keys"] for e in entries),
                           bytes=sum(e["nbytes"] for e in entries),
                           duration_s=round(dur, 3))
        return {"manifest": manifest, "epoch": epoch, "ranges": entries,
                "servers": len(replies), "duration_s": dur}

    def retune_apply(self, task_bytes: int,
                     timeout_s: float = 30.0) -> dict:
        """Live-retune the apply task quantum on every server: one
        ``retune`` op on the SNAPSHOT channel, serialized behind every
        earlier queued request as a namespace flip is.  The autopilot's
        apply_wait actuator, and an operator's lever."""
        task_bytes = int(task_bytes)
        log.check(task_bytes > 0, "retune_apply needs task_bytes > 0")
        replies = self._model_ctl(
            {"op": "retune", "apply_task_bytes": task_bytes}, timeout_s)
        applied = sum(1 for r in replies.values()
                      if r.get("applied", {}).get("apply_task_bytes"))
        self.flight.record("apply_retune", severity="info",
                           task_bytes=task_bytes, servers=len(replies),
                           applied=applied)
        return {"task_bytes": task_bytes, "servers": len(replies),
                "applied": applied}

    def snapshot_status(self) -> dict:
        """Age and summary of the newest committed manifest."""
        from .kv import snapshot as snap_mod

        manifest = snap_mod.load_manifest(self.snapshot_dir)
        return {
            "dir": self.snapshot_dir,
            "age_s": snap_mod.manifest_age_s(self.snapshot_dir),
            "epoch": manifest.get("epoch") if manifest else None,
            "ranges": len(manifest.get("ranges", [])) if manifest else 0,
        }

    # -- model namespaces ----------------------------------------------------

    def _model_ctl(self, body: dict, timeout_s: float) -> Dict[int, dict]:
        """Broadcast one namespace op to every live server on the
        SNAPSHOT channel and gather the replies; raises when any server
        errors or stays silent (an op half-applied across the fleet must
        fail loudly)."""
        log.check(self.is_scheduler, "namespace ops run on the scheduler")
        replies, peers = self._snapshot_gather(
            json.dumps(body).encode(), timeout_s, "namespace op")
        errors = [f"node {n}: {r['error']}" for n, r in replies.items()
                  if r.get("error")]
        silent = [p for p in peers if p not in replies]
        if silent:
            errors.append(f"no reply from node(s) {silent} within "
                          f"{timeout_s}s")
        log.check(not errors, f"namespace op {body.get('op')!r} failed: "
                              + "; ".join(errors))
        return replies

    def publish_model(self, directory: Optional[str] = None,
                      namespace: str = "model", version: str = "",
                      timeout_s: float = 60.0) -> dict:
        """Publish a committed snapshot manifest as a model version:
        every live server stages the manifest into an off-line store
        while serving continues, then, once every stage succeeded,
        flips to it.  The displaced store stays for
        :meth:`rollback_model`."""
        directory = directory or self.snapshot_dir
        log.check(bool(directory),
                  "publish_model needs a snapshot directory "
                  "(PS_SNAPSHOT_DIR or the directory= argument)")
        if not version:
            from .kv import snapshot as snap_mod

            manifest = snap_mod.load_manifest(directory)
            log.check(manifest is not None,
                      f"no committed manifest in {directory!r}")
            version = str(manifest.get("uid") or manifest.get("epoch", 0))
        staged = self._model_ctl(
            {"op": "publish", "dir": directory, "namespace": namespace,
             "version": version}, timeout_s)
        flipped = self._model_ctl(
            {"op": "flip", "namespace": namespace, "version": version},
            timeout_s)
        self.flight.record("model_published", severity="info",
                           namespace=namespace, version=version,
                           servers=len(flipped))
        return {
            "namespace": namespace,
            "version": version,
            "servers": len(flipped),
            "keys": sum(int(r.get("keys", 0)) for r in staged.values()),
        }

    def rollback_model(self, timeout_s: float = 60.0) -> dict:
        """Every live server swaps the displaced store back in: one
        pointer swap each, no disk reads."""
        replies = self._model_ctl({"op": "rollback"}, timeout_s)
        first = next(iter(replies.values()), {})
        self.flight.record("model_rollback", severity="info",
                           namespace=first.get("namespace"),
                           version=first.get("version"))
        return {"namespace": first.get("namespace"),
                "version": first.get("version"),
                "servers": len(replies)}
