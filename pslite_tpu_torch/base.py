"""Core constants and the node-id scheme.

Copy of ``pslite_tpu/base.py`` (the reference's ``include/ps/base.h:15-25``
and ``postoffice.h:144-193``): the scheduler has node id 1, group ids are
combinable bitmasks, and worker/server instance ranks map to odd/even
node ids from 8 on.  The scheme is part of the public contract (apps
address groups by these ids), so it stays bit for bit.
"""

from __future__ import annotations

# Maximum key.  Keys are unsigned 64-bit; the uniform server partition divides
# this space (reference: src/postoffice.cc:257-268).
MAX_KEY: int = 2**64 - 1

# Group ids — bitmask-combinable (reference: include/ps/base.h:17-25).
SCHEDULER_GROUP: int = 1
SERVER_GROUP: int = 2
WORKER_GROUP: int = 4
SERVER_WORKER_GROUP: int = SERVER_GROUP + WORKER_GROUP
ALL_GROUP: int = SCHEDULER_GROUP + SERVER_GROUP + WORKER_GROUP

#: The scheduler's node id.
SCHEDULER_ID: int = 1

#: Sentinel for "no id assigned yet".
EMPTY_ID: int = -1

#: First node id handed out to rank 0 (server rank 0 -> 8, worker rank 0 -> 9).
_ID_BASE: int = 8


def server_rank_to_id(rank: int) -> int:
    """Server instance rank ``r`` -> node id ``8 + 2r``."""
    return _ID_BASE + 2 * rank


def worker_rank_to_id(rank: int) -> int:
    """Worker instance rank ``r`` -> node id ``9 + 2r``."""
    return _ID_BASE + 1 + 2 * rank


def id_to_rank(node_id: int) -> int:
    """Inverse of the two mappings above (role-agnostic)."""
    return max((node_id - _ID_BASE) // 2, 0)


def is_scheduler_id(node_id: int) -> bool:
    return node_id == SCHEDULER_ID


def is_server_id(node_id: int) -> bool:
    return node_id >= _ID_BASE and node_id % 2 == 0


def is_worker_id(node_id: int) -> bool:
    return node_id > _ID_BASE and node_id % 2 == 1


def group_members(group: int) -> tuple[bool, bool, bool]:
    """Decompose a group bitmask -> (scheduler?, servers?, workers?)."""
    return (
        bool(group & SCHEDULER_GROUP),
        bool(group & SERVER_GROUP),
        bool(group & WORKER_GROUP),
    )
