"""pslite_tpu_torch's process and transport knobs against the JAX
package's.

- ``PS_CHECK_FATAL``: a CHECK failure on a node's receive pump ends the
  process with 134 (the failed invariant printed first) unless
  ``PS_CHECK_FATAL=0``, which takes only that node dark; as
  ``tests/test_check_fatal.py`` runs JAX's, in a subprocess.
- The default van: with ``PS_VAN_TYPE`` unset both packages take
  ``DMLC_ENABLE_RDMA``, else ``tcp``.
- One test per knob that JAX honours on the Python plane, set in both
  packages: ``PS_RECV_PRIORITY=0`` (FIFO intake at the customer, the
  loopback, tcp and multi vans), ``PS_RECV_POOL=0``/``PS_RECV_POOL_MB``,
  ``PS_CPU_PIN`` (the launcher's CPU blocks), and the knobs the port
  refuses by name: the busy-poll intake (``DMLC_LOCKLESS_QUEUE``,
  ``DMLC_POLLING_IN_NANOSECOND``), inline dispatch (``PS_SEND_LANES=0``)
  and sid-ordered delivery (``PS_FORCE_REQ_ORDER``,
  ``BYTEPS_UCX_FORCE_REQ_ORDER``).
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import pslite_tpu as jps
import pslite_tpu_torch as tps
from pslite_tpu.environment import Environment as JEnv
from pslite_tpu.tracker import local as jlocal
from pslite_tpu.utils import queues as jqueues
from pslite_tpu_torch.environment import Environment as TEnv
from pslite_tpu_torch.tracker import local as tlocal
from pslite_tpu_torch.utils import queues as tqueues

from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    JAX,
    PORT,
    _port_loopback_isolation,
    assert_same,
    servers_with,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- PS_CHECK_FATAL ------------------------------------------------------------

_CHILD = textwrap.dedent(r"""
    import os, sys, time
    sys.path.insert(0, os.environ["PS_REPO"])
    sys.path.insert(0, os.path.join(os.environ["PS_REPO"], "tests"))
    os.environ["PS_LOOPBACK_NS"] = "check-fatal"
    import pslite_tpu_torch as tps
    from pslite_tpu_torch.message import Message
    # Overflow on the first parked message: a CHECK on the pump.
    tps.Postoffice._MAX_PENDING_PER_APP = 0
    from test_torch_msg_plane import PortCluster

    cluster = PortCluster(num_workers=1, num_servers=1)
    cluster.start()
    msg = Message()
    msg.meta.app_id = 99  # never registered: parks, overflows, CHECK
    msg.meta.customer_id = 99
    msg.meta.request = True
    msg.meta.recver = cluster.servers[0].van.my_node.id
    cluster.workers[0].van.send(msg)
    time.sleep(5)
    print("STILL_ALIVE", flush=True)
    os._exit(0)
""")


def _run_child(**env_extra):
    env = dict(os.environ, PS_REPO=REPO, **env_extra)
    return subprocess.run([sys.executable, "-c", _CHILD], env=env,
                          capture_output=True, text=True, timeout=120)


def test_pump_check_failure_aborts_process():
    """The default (``PS_CHECK_FATAL`` unset): the process exits 134,
    printing the failed invariant first."""
    env = {k: v for k, v in os.environ.items() if k != "PS_CHECK_FATAL"}
    out = subprocess.run([sys.executable, "-c", _CHILD],
                         env=dict(env, PS_REPO=REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 134, (out.returncode, out.stdout, out.stderr)
    assert "STILL_ALIVE" not in out.stdout
    assert "pending buffer overflow" in out.stdout + out.stderr


def test_check_fatal_0_keeps_the_process_alive():
    """``PS_CHECK_FATAL=0``: the node goes dark, the process lives on."""
    out = _run_child(PS_CHECK_FATAL="0")
    assert out.returncode == 0, (out.returncode, out.stdout, out.stderr)
    assert "STILL_ALIVE" in out.stdout
    assert "pending buffer overflow" in out.stdout + out.stderr


# -- the default van ---------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"DMLC_ENABLE_RDMA": "loopback"}],
                         ids=["tcp", "rdma_var"])
def test_default_van_matches_jax(monkeypatch, env):
    """``PS_VAN_TYPE`` unset: both packages build the same van class."""
    monkeypatch.delenv("PS_VAN_TYPE", raising=False)
    monkeypatch.delenv("DMLC_ENABLE_RDMA", raising=False)
    base = dict(env, PS_NATIVE="0")
    jpo = jps.Postoffice(jps.Role.SERVER, env=JEnv(base))
    tpo = tps.Postoffice("server", env=TEnv(base))
    assert type(tpo.van).__name__ == type(jpo.van).__name__
    assert type(tpo.van).__name__ == ("TcpVan" if not env
                                      else "LoopbackVan")


# -- PS_RECV_PRIORITY --------------------------------------------------------


def _pop_order(q, pkg):
    """Three messages pushed at levels 0, 3, 0 (a FIFO queue of JAX's
    takes no level); the order they pop in."""
    prio_cls = (jqueues if pkg is jps else tqueues).PriorityRecvQueue
    for tag, level in (("a", 0), ("b", 3), ("c", 0)):
        item = pkg.message.Message()
        item.meta.priority = level
        item.tag = tag
        if isinstance(q, (prio_cls, tqueues.FifoRecvQueue)):
            q.push(item, priority=level)
        else:
            q.push(item)
    return [q.wait_and_pop(1.0).tag for _ in range(3)]


@pytest.mark.parametrize("knob", ["1", "0"])
def test_recv_priority_intake(knob):
    """``PS_RECV_PRIORITY=0`` makes every intake of the Python plane a
    strict FIFO, in both packages: the customer's, and the loopback,
    tcp and multi vans'.  Default: a level-3 item passes level 0."""
    env = {"PS_RECV_PRIORITY": knob, "PS_NATIVE": "0",
           "DMLC_NUM_PORTS": "2"}
    want = ["a", "b", "c"] if knob == "0" else ["b", "a", "c"]
    for van in ("loopback", "tcp", "multi"):
        e = dict(env, PS_VAN_TYPE=van)
        jpo = jps.Postoffice(jps.Role.SERVER, env=JEnv(e))
        tpo = tps.Postoffice("server", env=TEnv(e))
        assert _pop_order(jpo.van._queue, jps) == want
        assert _pop_order(tpo.van._queue, tps) == want
    jc = jps.customer.Customer(7, 7, lambda m: None, jpo)
    tc = tps.customer.Customer(7, 7, lambda m: None, tpo)
    try:
        assert (isinstance(tc._queue, tqueues.PriorityRecvQueue)
                == isinstance(jc._queue, jqueues.PriorityRecvQueue)
                == (knob == "1"))
    finally:
        jc.stop()
        tc.stop()


# -- PS_RECV_POOL ------------------------------------------------------------


@pytest.mark.parametrize("env,budget", [
    ({}, 128 << 20), ({"PS_RECV_POOL_MB": "7"}, 7 << 20),
    ({"PS_RECV_POOL": "0"}, None)], ids=["default", "mb7", "off"])
def test_recv_pool_knobs(env, budget):
    """The tcp van's pooled receive blocks: on at 128 MiB, sized by
    ``PS_RECV_POOL_MB``, off with ``PS_RECV_POOL=0``, in both."""
    e = dict(env, PS_VAN_TYPE="tcp", PS_NATIVE="0")
    jpool = jps.Postoffice(jps.Role.SERVER, env=JEnv(e)).van._recv_pool
    tpool = tps.Postoffice("server", env=TEnv(e)).van._recv_pool
    if budget is None:
        assert jpool is None and tpool is None
    else:
        assert jpool._max_total == tpool._max_total == budget


def _round_trip(api, cluster):
    servers = servers_with(api, cluster, api.DefaultHandle)
    w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
    try:
        ranges = cluster.workers[0].get_server_key_ranges()
        keys = np.array(sorted(r.begin + 3 for r in ranges), np.uint64)
        vals = np.arange(len(keys) * 8, dtype=np.float32)
        for _ in range(3):
            w.wait(w.push(keys, vals))
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        return {"out": out,
                "store": {s.po.my_group_rank(): {
                    int(k): v.copy() for k, v in s._handle.store.items()}
                    for s in servers}}
    finally:
        w.stop()
        for s in servers:
            s.stop()


def test_recv_pool_off_cluster_bit_equal_to_jax():
    """A tcp push/pull round trip on the Python plane with
    ``PS_RECV_POOL=0``: stores and pulls bit-equal to JAX's."""
    from test_torch_elastic_membership import PKGS, MixedTcp

    def run(pkg):
        cluster = MixedTcp(pkg, [pkg, pkg], [pkg],
                           {"PS_RECV_POOL": "0", "PS_NATIVE": "0"})
        cluster.start()
        try:
            assert all(po.van._recv_pool is None
                       for po in cluster.all_nodes())
            return _round_trip(PKGS[pkg][2], cluster)
        finally:
            for po in cluster.all_nodes():
                po.van.stop()

    assert_same(run("port"), run("jax"))


# -- the busy-poll intake ----------------------------------------------------


@pytest.mark.parametrize("knob", ["DMLC_LOCKLESS_QUEUE",
                                  "DMLC_POLLING_IN_NANOSECOND"])
def test_busy_poll_intake_refused_by_name(knob):
    """JAX's tcp van takes the busy-poll FIFO; the port's refuses it by
    name instead of ignoring it."""
    e = {"PS_VAN_TYPE": "tcp", "PS_NATIVE": "0", knob: "1",
         "DMLC_LOCKLESS_QUEUE": "1"}
    jpo = jps.Postoffice(jps.Role.SERVER, env=JEnv(e))
    assert isinstance(jpo.van._queue, jqueues.ThreadsafeQueue)
    with pytest.raises(NotImplementedError, match=knob):
        tps.Postoffice("server", env=TEnv({k: v for k, v in e.items()
                                           if k in (knob, "PS_VAN_TYPE",
                                                    "PS_NATIVE")}))


# -- PS_SEND_LANES and PS_FORCE_REQ_ORDER ------------------------------------


@pytest.mark.parametrize("env,attr,want", [
    ({"PS_SEND_LANES": "0"}, "_send_async", False),
    ({"PS_FORCE_REQ_ORDER": "1"}, "_force_order", True),
    ({"BYTEPS_UCX_FORCE_REQ_ORDER": "1"}, "_force_order", True)],
    ids=["send_lanes_0", "force_order", "ucx_force_order"])
@pytest.mark.parametrize("van", ["loopback", "tcp"])
def test_send_knobs_refused_by_name(env, attr, want, van):
    """JAX's van takes inline dispatch and sid-ordered delivery; the
    port's refuses each knob by name instead of ignoring it, on every
    van (the base van reads them)."""
    e = dict(env, PS_VAN_TYPE=van, PS_NATIVE="0")
    jpo = jps.Postoffice(jps.Role.SERVER, env=JEnv(e))
    assert getattr(jpo.van, attr) is want
    knob = next(iter(env))
    with pytest.raises(NotImplementedError, match=knob):
        tps.Postoffice("server", env=TEnv(e))


# -- PS_CPU_PIN --------------------------------------------------------------


@pytest.mark.skipif(not hasattr(os, "sched_setaffinity"),
                    reason="no sched_setaffinity on this platform")
def test_cpu_pin_blocks_match_jax(tmp_path, monkeypatch):
    """``PS_CPU_PIN=1``: each node the launcher spawns runs on its own
    CPU, the same CPU per spawn order in both launchers."""
    monkeypatch.setenv("PS_CPU_PIN", "1")
    cmd = [sys.executable, "-c",
           "import os; open(os.environ['PIN_OUT'], 'a').write("
           "repr(sorted(os.sched_getaffinity(0))) + '\\n')"]

    def pins(mod, name):
        out = tmp_path / name
        monkeypatch.setenv("PIN_OUT", str(out))
        launcher = mod.LocalLauncher(1, 1, cmd)
        for role in ("scheduler", "server", "worker"):
            launcher._spawn(role)
            launcher._procs[-1][1].wait(timeout=60)
        return out.read_text().split("\n")[:3]

    got, want = pins(tlocal, "port"), pins(jlocal, "jax")
    assert got == want
    avail = sorted(os.sched_getaffinity(0))
    assert got == [repr([avail[i % len(avail)]]) for i in range(3)]
