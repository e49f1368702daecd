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
and skips the startup barrier: ``is_recovery``).  Elastic membership
(``PS_ELASTIC=1``) and routing epochs are ROADMAP Queue 1 item 8(b) and
raise here; snapshots, model publish/rollback, telemetry history and
health are item 8(c) and absent.
"""

from __future__ import annotations

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
    server_rank_to_id,
    worker_rank_to_id,
)
from .message import Command, Message, Node, Role
from .range import Range
from .telemetry import FlightRecorder, Tracer
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
        if self.env.find_int("PS_ELASTIC", 0):
            raise NotImplementedError(
                "elastic membership (PS_ELASTIC=1: admission of new "
                "servers with routing epochs) is not yet ported to "
                "pslite_tpu_torch (ROADMAP Queue 1 item 8(b))")
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
        self._node_ids: Dict[int, List[int]] = {}
        self._build_node_id_table()
        self.tracer = Tracer()
        self.flight = FlightRecorder()
        self.van = vans.create(self.env.find("PS_VAN_TYPE") or "ici", self)

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
        postoffice.cc:115-137)."""
        worker_ids = [worker_rank_to_id(i)
                      for i in range(self.num_worker_instances)]
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
        """The uniform split of the key space over server groups
        (reference: postoffice.cc:257-268)."""
        with self._server_key_ranges_mu:
            if not self._server_key_ranges:
                log.check(self.num_servers > 0, "no servers configured")
                span = MAX_KEY // self.num_servers
                for i in range(self.num_servers):
                    end = (span * (i + 1) if i + 1 < self.num_servers
                           else MAX_KEY)
                    self._server_key_ranges.append(Range(span * i, end))
            return self._server_key_ranges

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
            self._heartbeats[node_id] = t

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
