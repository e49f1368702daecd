"""Multi-process bootstrap: ``torch.distributed`` from the PS environment.

Counterpart of ``pslite_tpu/parallel/distributed.py``, where each worker
process joins ``jax.distributed`` and the engines run on one global mesh
over every process's devices.  Here each worker process joins a
``torch.distributed`` process group over gloo, and :func:`global_group`
is one :class:`~pslite_tpu_torch.parallel.mesh.DeviceGroup` over every
process's ranks.  The topology comes from the same ``DMLC_*`` variables
the control plane reads, with the JAX package's arithmetic:

- coordinator = ``DMLC_PS_ROOT_URI : DMLC_PS_ROOT_PORT + 1`` (the port
  next to the scheduler's), as ``tcp://`` init method,
- world size = the worker count (one worker process per host),
- rank = ``DMLC_RANK``.

Gloo carries host traffic only: these options, barriers and the exchange
of the handles through which each process maps its peers' exchange
memory on the card (``parallel/peers.py``).  It carries rows only on a
CPU group, where there is no card to share.  NCCL is not used: it
refuses two ranks on one device.

Single-process use (tests, one process per card) never needs this.
"""

from __future__ import annotations

import threading
from datetime import timedelta
from typing import Dict, List, Optional

from .. import environment
from ..utils import logging as log
from .mesh import DeviceGroup, default_group

_mu = threading.Lock()
_leases = 0
_opts: Optional[Dict[str, object]] = None
_owned = False  # True only when THIS module created the process group

# How long a collective of the host plane waits for its peers.
TIMEOUT_S = 900.0


def distributed_options(env=None) -> Dict[str, object]:
    """Pure computation of the process group's options from env: the
    JAX package's ``jax.distributed.initialize`` kwargs, with its checks
    and their messages."""
    env = env or environment.get()
    uri = env.find("DMLC_PS_ROOT_URI")
    log.check(uri is not None, "DMLC_PS_ROOT_URI not set")
    port = env.find_int("DMLC_PS_ROOT_PORT", 0) + 1
    num = env.find_int("DMLC_NUM_WORKER", 0)
    log.check(num > 0, "DMLC_NUM_WORKER not set")
    rank = env.find_int("DMLC_RANK", -1)
    log.check(0 <= rank < num,
              "DMLC_RANK must be set per host for multi-host meshes")
    return {
        "coordinator_address": f"{uri}:{port}",
        "num_processes": num,
        "process_id": rank,
    }


def is_initialized() -> bool:
    """Whether this process has a default ``torch.distributed`` group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _initialize_or_unwind(opts) -> None:
    """``init_process_group("gloo")`` with half-init cleanup: a group
    left registered after a failed connect would make every later
    acquire believe the runtime is up, so it is destroyed before the
    error propagates and a retry initializes again."""
    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{opts['coordinator_address']}",
            world_size=int(opts["num_processes"]),
            rank=int(opts["process_id"]),
            timeout=timedelta(seconds=TIMEOUT_S))
    except Exception:
        try:
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # best-effort: leave no half-open group
            pass
        raise


def acquire(env=None) -> bool:
    """Join the process group (once per process) and take a lease on it.
    Several worker instances per process each acquire; the group is
    destroyed when the LAST lease is released, never under a sibling
    still using it, and never at all when someone else (the caller's own
    ``init_process_group``) created it.

    Returns True when a lease was taken (multi-process config), False
    for single-process configs (nothing to release)."""
    global _leases, _opts, _owned
    env = env or environment.get()
    if env.find_int("DMLC_NUM_WORKER", 1) <= 1:
        return False

    with _mu:
        if not is_initialized():
            opts = distributed_options(env)
            _initialize_or_unwind(opts)
            # Recorded only after a successful initialize.
            _opts = opts
            _owned = True
            log.vlog(1, f"torch.distributed initialized: {opts}")
        elif _opts is not None:
            # Reusing the group this process already joined: the caller
            # must describe the SAME cluster, or its collectives would
            # silently run over the wrong process set.
            want = distributed_options(env)
            log.check(
                want == _opts,
                f"torch.distributed already initialized with {_opts}; "
                f"refusing mismatched options {want}",
            )
        else:
            log.vlog(1, "torch.distributed externally initialized; reusing "
                        "(its owner destroys it)")
        _leases += 1
    return True


def release() -> None:
    """Release one lease; destroys the group when none remain AND this
    module created it (an external group is never torn down here)."""
    global _leases, _opts, _owned
    import torch.distributed as dist

    with _mu:
        if _leases == 0:
            return
        _leases -= 1
        if _leases > 0 or not _owned:
            return
        _opts = None
        _owned = False
        try:
            dist.destroy_process_group()
        except Exception as exc:  # best-effort: interpreter teardown
            log.vlog(1, f"torch.distributed.destroy_process_group: {exc!r}")


def init_distributed(env=None) -> Optional[Dict[str, object]]:
    """Initialize once, with NO lease accounting: callers of this wrapper
    own any teardown themselves.  Prefer acquire()/release().  Returns
    the options used when this call initialized, else None."""
    global _opts
    env = env or environment.get()
    if env.find_int("DMLC_NUM_WORKER", 1) <= 1:
        return None

    with _mu:
        if is_initialized():
            return None
        opts = distributed_options(env)
        _initialize_or_unwind(opts)
        _opts = opts  # mismatch guard for later acquire()s; not owned
        return opts


# -- the host plane's collectives -------------------------------------------

def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def barrier() -> None:
    """Every process of the group reaches this point (host only)."""
    import torch.distributed as dist

    if is_initialized():
        dist.barrier()


def allgather_object(obj) -> List[object]:
    """``obj`` of every process, in process order (host only)."""
    import torch.distributed as dist

    if not is_initialized():
        return [obj]
    out: List[object] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def global_group(axis_name="kv", local_ranks: Optional[int] = None,
                 device=None, shape=None) -> DeviceGroup:
    """One :class:`DeviceGroup` over every process's ranks, in process
    order (the counterpart of ``global_mesh``; call after :func:`acquire`
    or :func:`init_distributed`): 1-D along ``axis_name``, or with
    ``shape`` an N-D grid whose axes ``axis_name`` names (ranks row-major,
    so a process owns a block of rows of the grid).  A collective: every
    process calls it, each contributing ``local_ranks`` ranks or, by
    default, ``default_group()``'s, on ``device`` (default: the card,
    ``cuda:0``).  Every process's ranks must live on one card, whose
    memory each maps into the others (``parallel/peers.py``); ranks on
    several cards raise."""
    if local_ranks is None or device is None:
        base = default_group("kv")
        local_ranks = base.num_ranks if local_ranks is None else local_ranks
        device = base.device if device is None else device
    log.check(int(local_ranks) >= 1, "every process contributes >= 1 rank")
    got = allgather_object((int(local_ranks), str(device)))
    if len({dev for _, dev in got}) > 1:
        raise NotImplementedError(
            f"ranks on several cards ({sorted({d for _, d in got})}) are not "
            f"yet ported to pslite_tpu_torch (ROADMAP Queue 1 item 9)")
    owners = tuple(p for p, (c, _) in enumerate(got) for _ in range(c))
    return DeviceGroup(len(owners) if shape is None else tuple(shape),
                       device=device, axis_name=axis_name, owners=owners,
                       process_index=process_index())
