"""Top-level lifecycle API: start_ps / finalize / postoffice.

Counterpart of ``pslite_tpu/ps.py`` (the reference's ``include/ps/
ps.h``): role parsing (worker, server, scheduler, joint), instance-group
fan-out with one Postoffice per instance, started on threads and joined
(each blocks in the startup barrier until the whole cluster has
registered), and finalize.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from . import environment
from .message import Role
from .postoffice import Postoffice, parse_role

_mu = threading.Lock()
_instances: Dict[Tuple[Role, int], Postoffice] = {}


def _role_list(role: Role, group_size: int):
    roles = [Role.SERVER, Role.WORKER] if role == Role.JOINT else [role]
    for r in roles:
        for idx in range(group_size if r != Role.SCHEDULER else 1):
            yield r, idx


def start_ps(customer_id: int = 0, role=None, rank: Optional[int] = None,
             do_barrier: bool = True,
             env: Optional[environment.Environment] = None) -> None:
    """Create and start every Postoffice instance this process hosts
    (the role from ``role=`` or ``DMLC_ROLE``).  If any instance fails
    to start, the error is raised and none of this call's instances is
    kept."""
    env = env or environment.get()
    role = parse_role(role if role is not None else env.find("DMLC_ROLE"))
    if rank is not None:
        env.set("DMLC_RANK", str(rank))
    group_size = max(env.find_int("DMLC_GROUP_SIZE", 1), 1)
    created = []
    with _mu:
        for key in _role_list(role, group_size):
            if key not in _instances:
                _instances[key] = Postoffice(key[0], instance_idx=key[1],
                                             env=env)
                created.append(_instances[key])
    errors = []

    def _start(po: Postoffice) -> None:
        try:
            po.start(customer_id, do_barrier=do_barrier)
        except Exception as exc:  # noqa: BLE001 - raised after the join
            errors.append(exc)

    threads = [threading.Thread(target=_start, args=(po,),
                                name=f"start-{po.role_str()}-"
                                     f"{po.instance_idx}")
               for po in created]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        with _mu:
            for key in [k for k, po in _instances.items() if po in created]:
                del _instances[key]
        raise errors[0]


def finalize(customer_id: int = 0, do_barrier: bool = True) -> None:
    """Finalize every instance this process hosts (reference:
    ps.h:183-192), concurrently: each waits in the finalize barrier."""
    with _mu:
        pos = list(_instances.values())
    threads = [threading.Thread(target=po.finalize,
                                args=(customer_id, do_barrier),
                                name=f"finalize-{po.role_str()}-"
                                     f"{po.instance_idx}")
               for po in pos]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if customer_id == 0:
        with _mu:
            _instances.clear()


def postoffice(role=None, instance_idx: int = 0) -> Postoffice:
    """A started Postoffice; without ``role`` the worker's, else the
    server's, else the scheduler's."""
    with _mu:
        if role is not None:
            key = (parse_role(role), instance_idx)
            if key in _instances:
                return _instances[key]
        else:
            for r in (Role.WORKER, Role.SERVER, Role.SCHEDULER):
                if (r, instance_idx) in _instances:
                    return _instances[(r, instance_idx)]
    raise KeyError("no Postoffice started in this process")
