"""pslite_tpu_torch's elastic membership against
``tests/test_elastic_membership.py``.

Each scenario runs on a JAX ``LoopbackCluster`` and on the port's
``PortCluster`` (loopback van) with the same seeded inputs, and the two
results are compared bit for bit (``assert_same``): routing tables and
their JSON, the epochs and active ranks every node reaches, the values
pulled, and every server's store after a join, a decommission or a
storm.  Stores are exact against completed pushes x payload (the
payloads are small integers, so any order of addition gives the same
bits; tolerance: none).  Beyond JAX's cases:

- the port's routing table JSON parsed by JAX's and JAX's by the port's;
- a mixed cluster over tcp in this process, in which a port joiner takes
  a range from a JAX donor and a JAX joiner from a port donor, with
  stores bit-equal to the all-JAX run's;
- a replication forward's tenant label read off the frame at the
  replica (JAX counts it in ``tenant.<name>.requests``, a registry
  counter of ROADMAP Queue 1 item 8(c)).

Every cluster start, wait and poll has a deadline; a storm that wedges
fails its join.
"""

import threading
import time
from dataclasses import astuple

import numpy as np
import pytest

import pslite_tpu as jps
import pslite_tpu_torch as tps
from pslite_tpu.environment import Environment as JEnv
from pslite_tpu.routing import RouteEntry as JRouteEntry
from pslite_tpu.routing import RoutingTable as JRoutingTable
from pslite_tpu_torch.base import server_rank_to_id
from pslite_tpu_torch.environment import Environment as TEnv
from pslite_tpu_torch.kv.replication import chain_ranks
from pslite_tpu_torch.message import OPT_REPLICA
from pslite_tpu_torch.routing import RouteEntry as TRouteEntry
from pslite_tpu_torch.routing import RoutingTable as TRoutingTable
from pslite_tpu_torch.utils.network import get_available_port

from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    JAX,
    PORT,
    _port_loopback_isolation,
    assert_same,
)

ELASTIC_ENV = {
    "PS_ELASTIC": "1",
    "PS_REQUEST_TIMEOUT": "2.0",
    "PS_REQUEST_RETRIES": "8",
}
DEADLINE = 30.0


def _spread_keys(n):
    span = (1 << 64) // n
    return (np.arange(n, dtype=np.uint64) * np.uint64(span)
            + np.uint64(3))


def _wait_epoch(po, epoch, timeout=DEADLINE):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rt = po.current_routing()
        if rt is not None and rt.epoch >= epoch:
            return rt
        time.sleep(0.02)
    raise TimeoutError(f"node never reached routing epoch {epoch}")


def _wait_for(pred, what, timeout=DEADLINE):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(f"{what} within {timeout}s")


def _wait_handoff(el, jsrv):
    """Wait until a join's handoff has finished: the joiner holds the
    migrated keys and no other server still does.  Both packages import
    at the joiner, acknowledge, and only then drop the donor's copy, so
    the joiner's store turns non-empty while the donor still holds the
    keys; a snapshot taken in that window differs between runs."""
    def done():
        moved = set(list(jsrv._handle.store))
        return moved and not any(moved & set(list(s._handle.store))
                                 for s in el.servers if s is not jsrv)

    _wait_for(done, "no completed handoff")


def _store(srv):
    return {int(k): np.array(v, copy=True)
            for k, v in srv._handle.store.items()}


def _by_rank(servers):
    """Server stores keyed by group rank (ranks are assigned by bind
    address, so creation order differs between the packages)."""
    return {s.po.my_group_rank(): _store(s) for s in servers}


def _server_of(servers, rank):
    return next(s for s in servers
                if s.po.van.my_node.id == server_rank_to_id(rank))


def _table_view(rt):
    return (rt.epoch, list(rt.active), list(rt.leaving),
            [(e.begin, e.end, e.owner, e.prev) for e in rt.entries])


class Elastic:
    """One started cluster of either package with a KVServer on each
    server (default handle) and a KVWorker on each worker; torn down
    by stopping every van (decommissioned nodes count in no finalize
    barrier)."""

    def __init__(self, api, **cluster_kw):
        self.api = api
        self.cluster = api.cluster(**cluster_kw)
        self.cluster.start()
        self.servers = []
        for po in self.cluster.servers:
            self._serve(po)
        self.workers = [api.KVWorker(0, 0, postoffice=po)
                        for po in self.cluster.workers]

    def _serve(self, po, handle=None):
        srv = self.api.KVServer(0, postoffice=po)
        srv.set_request_handle(handle or self.api.DefaultHandle())
        self.servers.append(srv)
        return srv

    def join(self, handle=None):
        po = self.cluster.join_server()
        return po, self._serve(po, handle)

    def bounces(self, worker):
        if self.api is JAX:
            return worker.po.metrics.counter("kv.wrong_owner_bounces").value
        return worker.stats["wrong_owner_bounces"]

    def server_bounces(self, srv):
        if self.api is JAX:
            return srv._c_wrong_owner.value
        return srv.stats["wrong_owner"]

    def close(self, skip=()):
        for w in self.workers:
            w.stop()
        for s in self.servers:
            if s.po not in skip:
                s.stop()
        for po in self.cluster.all_nodes():
            try:
                po.van.stop()
            except Exception:  # noqa: BLE001 - already stopped
                pass


PKGS = {"jax": (jps, JEnv, JAX), "port": (tps, TEnv, PORT)}


class MixedTcp:
    """A tcp cluster whose every node (scheduler, ``servers``,
    ``workers``: package names) is a Postoffice of either package in
    this process.  JAX's nodes run its Python plane (its native core
    does not build here); the port's run the native core."""

    def __init__(self, scheduler, servers, workers, env_extra=None):
        self.base = {
            "DMLC_NUM_WORKER": str(len(workers)),
            "DMLC_NUM_SERVER": str(len(servers)),
            "DMLC_PS_ROOT_URI": "127.0.0.1",
            "DMLC_PS_ROOT_PORT": str(get_available_port()),
            "DMLC_NODE_HOST": "127.0.0.1",
            "PS_VAN_TYPE": "tcp",
            **(env_extra or {}),
        }
        self.scheduler = self._make("scheduler", scheduler)
        self.servers = [self._make("server", p) for p in servers]
        self.workers = [self._make("worker", p) for p in workers]

    def _make(self, role, pkg):
        mod, env_cls, _api = PKGS[pkg]
        env = dict(self.base)
        if pkg == "jax":
            env["PS_NATIVE"] = "0"
        po = mod.Postoffice(mod.Role[role.upper()] if pkg == "jax"
                            else role, env=env_cls(env))
        po.pkg = pkg
        return po

    def all_nodes(self):
        return [self.scheduler] + self.servers + self.workers

    def start(self):
        errors = []

        def start(po):
            try:
                po.start(0)
            except Exception as exc:  # noqa: BLE001 - raised below
                errors.append(exc)

        threads = [threading.Thread(target=start, args=(po,), daemon=True)
                   for po in self.all_nodes()]
        for t in threads:
            t.start()
        end = time.monotonic() + DEADLINE
        for t in threads:
            t.join(max(0.0, end - time.monotonic()))
        assert not errors, errors
        assert not any(t.is_alive() for t in threads), "start timed out"

    def join_server(self, pkg):
        po = self._make("server", pkg)
        po.start(0)
        self.servers.append(po)
        return po


class MixedElastic(Elastic):
    """``Elastic`` over a ``MixedTcp`` cluster: each node's apps come
    from its own package."""

    def __init__(self, scheduler, servers, workers, joiner, env_extra):
        self.cluster = MixedTcp(scheduler, servers, workers, env_extra)
        self.cluster.start()
        self.joiner_pkg = joiner
        self.servers = []
        for po in self.cluster.servers:
            self._serve(po)
        self.workers = [PKGS[po.pkg][2].KVWorker(0, 0, postoffice=po)
                        for po in self.cluster.workers]

    def _serve(self, po, handle=None):
        api = PKGS[po.pkg][2]
        srv = api.KVServer(0, postoffice=po)
        srv.set_request_handle(handle or api.DefaultHandle())
        self.servers.append(srv)
        return srv

    def join(self, handle=None):
        po = self.cluster.join_server(self.joiner_pkg)
        return po, self._serve(po, handle)


def run_both_elastic(scenario, **cluster_kw):
    """``scenario(el)`` on a JAX and a port ``Elastic``; both results."""
    out = []
    for api in (JAX, PORT):
        el = Elastic(api, **cluster_kw)
        try:
            out.append(scenario(el))
        finally:
            el.close()
    return out


# -- the routing table -------------------------------------------------------


def test_routing_table_transitions():
    """JAX's sequence of joins (cold and load-weighted), a leave, a
    retirement and a rebalance gives equal tables and byte-equal JSON
    in both packages, and each package parses the other's JSON."""
    hot = {5: 100, 7: 90, 11: 80}

    def sequence(rt_cls):
        t0 = rt_cls.initial(2)
        t1 = t0.with_join(2)
        t2 = t1.with_join(3, hot=hot)
        t3 = t2.with_leave(2)
        t4 = t3.with_departed(2)
        t5 = t4.with_rebalance(0, 3, hot=hot)
        t6 = t5.with_rebalance(1, 0)
        return [t0, t1, t2, t3, t4, t5, t6]

    jax_seq, port_seq = sequence(JRoutingTable), sequence(TRoutingTable)
    for j, t in zip(jax_seq, port_seq):
        assert t.to_json() == j.to_json()
        assert _table_view(t) == _table_view(j)
        assert t.migrations() == [TRouteEntry(*(e.begin, e.end, e.owner,
                                                e.prev))
                                  for e in j.migrations()]
        assert TRoutingTable.from_json(j.to_json()) == t
        assert JRoutingTable.from_json(t.to_json().encode()) == j
        for key in (0, 6, 7, 2**63 + 1, 2**64 - 2):
            assert t.owner_of(key) == j.owner_of(key)
    t0, t1, t2, t3, t4, *_ = port_seq
    # JAX's own assertions, on the port's tables.
    assert t0.epoch == 0 and t0.active == (0, 1)
    assert [e.begin for e in t0.entries] == [0, (2**64 - 1) // 2]
    assert len(t1.migrations()) == 1 and t1.migrations()[0].owner == 2
    es = sorted(t1.entries, key=lambda e: e.begin)
    assert es[0].begin == 0 and es[-1].end == 2**64 - 1
    assert all(a.end == b.begin for a, b in zip(es, es[1:]))
    assert t2.migrations()[0].owner == 3 and t2.migrations()[0].begin == 7
    assert 2 in t3.leaving and all(e.owner != 2 for e in t3.entries)
    assert 2 not in t4.active and 2 not in t4.leaving
    for bad in (lambda: t4.with_leave(99), lambda: t0.with_join(1),
                lambda: t0.with_rebalance(0, 0)):
        with pytest.raises(Exception):
            bad()
    with pytest.raises(Exception):
        JRoutingTable.initial(2).with_join(1)
    assert JRouteEntry(1, 2, 3) == JRouteEntry(1, 2, 3, -1)


# -- live join / leave -------------------------------------------------------


def test_join_migrates_then_decommission_merges_back():
    """A server joins the running cluster: the widest range splits
    toward it and its donor migrates the upper half live, pulls stay
    exact throughout; a decommission migrates everything back and
    retires the rank.  Both packages reach the same tables and the same
    stores."""
    keys = _spread_keys(8)
    vals = np.ones(8 * 32, np.float32)

    def scenario(el):
        w = el.workers[0]
        for _ in range(4):
            w.wait(w.push(keys, vals))
        jpo, jsrv = el.join()
        assert jpo.elastic_join and jpo.is_recovery
        rt1 = _wait_epoch(el.cluster.workers[0], 1)
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        _wait_handoff(el, jsrv)
        joined = _by_rank(el.servers)
        for _ in range(3):
            w.wait(w.push(keys, vals))
        jsrv.decommission(timeout_s=DEADLINE)
        rt3 = _wait_epoch(el.cluster.workers[0], 3)
        left = _store(jsrv)
        w.wait(w.push(keys, vals))
        out2 = np.zeros_like(vals)
        w.wait(w.pull(keys, out2))
        return {"rt1": _table_view(rt1), "rt3": _table_view(rt3),
                "out": out, "out2": out2, "joined": joined,
                "left": left, "final": _by_rank(el.servers[:2]),
                "po_active": el.cluster.scheduler.active_server_ranks}

    want, got = run_both_elastic(scenario, num_workers=1, num_servers=2,
                                 env_extra=dict(ELASTIC_ENV))
    assert_same(got, want)
    np.testing.assert_array_equal(got["out"], vals * 4)
    np.testing.assert_array_equal(got["out2"], vals * 8)
    assert got["rt1"][1] == [0, 1, 2] and got["rt3"][1] == [0, 1]
    assert got["joined"][2] and got["left"] == {}
    assert got["po_active"] == [0, 1]


def _doctor_rank1_to_rank0(el, rt_mod):
    """JAX's doctored epoch: every rank-1 range flips to rank 0 with no
    migration marker (the state moved by hand), applied at the scheduler
    and the servers only, so the worker is stale."""
    base = el.cluster.scheduler.routing_table()
    doctored = rt_mod.RoutingTable(
        epoch=base.epoch + 1, num_servers=2, active=(0, 1),
        entries=tuple(rt_mod.RouteEntry(e.begin, e.end,
                                        0 if e.owner == 1 else e.owner)
                      for e in base.entries))
    r0, r1 = _server_of(el.servers, 0), _server_of(el.servers, 1)
    for k, v in list(r1._handle.store.items()):
        r0._handle.store[k] = v.copy()
    el.cluster.scheduler.apply_routing(doctored)
    for s in (r0, r1):
        s.po.apply_routing(doctored)
    return doctored, r0, r1


def _routing_module(api):
    import pslite_tpu.routing as jr
    import pslite_tpu_torch.routing as tr

    return jr if api is JAX else tr


def test_wrong_owner_bounce_reroutes_and_self_heals():
    """A worker with a stale table sends to the old owner, which bounces
    ``OPT_WRONG_OWNER`` with nothing applied; the worker pulls the
    current table and the sweeper re-routes: the wait completes and the
    write lands once, at the new owner."""
    key = np.array([2**63 + 77], dtype=np.uint64)  # rank 1's range
    vals = np.ones(16, np.float32)

    def scenario(el):
        w = el.workers[0]
        w.wait(w.push(key, vals))
        doctored, r0, r1 = _doctor_rank1_to_rank0(
            el, _routing_module(el.api))
        w.wait(w.push(key, vals))
        bounced = el.bounces(w)
        server_bounced = el.server_bounces(r1)
        rt = _wait_epoch(el.cluster.workers[0], doctored.epoch)
        out = np.zeros_like(vals)
        w.wait(w.pull(key, out))
        return {"out": out, "epoch": rt.epoch,
                "bounced": bounced >= 1, "server": server_bounced >= 1,
                "r0": _store(r0)}

    want, got = run_both_elastic(scenario, num_workers=1, num_servers=2,
                                 env_extra=dict(ELASTIC_ENV))
    assert_same(got, want)
    np.testing.assert_array_equal(got["out"], vals * 2)  # exactly once
    assert got["bounced"] and got["server"] and got["epoch"] == 1


def test_scale_2_4_2_mid_storm_bitexact():
    """The acceptance storm: 2 -> 4 -> 2 servers in the middle of a
    continuous push storm, with no restart.  Every wait completes, the
    final store is exact against completed pushes x payload, the
    cluster ends at epoch 6 with ranks [0, 1], and the joiners' stores
    are empty, in both packages (the push counts differ with timing;
    what is compared is each run against its own count)."""
    keys = _spread_keys(32)
    vals = (np.arange(32 * 64, dtype=np.float32) % 17) + 1.0

    def scenario(el):
        w = el.workers[0]
        pushes, errors, stop = [0], [], threading.Event()

        def storm():
            while not stop.is_set():
                try:
                    w.wait(w.push(keys, vals))
                    pushes[0] += 1
                except Exception as exc:  # noqa: BLE001
                    errors.append(repr(exc))
                    return

        t = threading.Thread(target=storm, daemon=True)
        t.start()
        try:
            time.sleep(0.2)
            joiners = []
            for _ in range(2):
                joiners.append(el.join()[1])
                time.sleep(0.3)
            _wait_epoch(el.cluster.workers[0], 2)
            time.sleep(0.3)
            for jsrv in joiners:
                jsrv.decommission(timeout_s=DEADLINE)
            rt = _wait_epoch(el.cluster.workers[0], 6)
            time.sleep(0.2)
        finally:
            stop.set()
            t.join(timeout=DEADLINE)
        assert not t.is_alive(), "storm wedged"
        assert not errors, errors
        n = pushes[0]
        assert n > 0
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        return {"exact": bool(np.array_equal(out, vals * n)),
                "epoch": rt.epoch, "active": sorted(rt.active),
                "joiners_empty": [not j._handle.store for j in joiners],
                "stores_exact": all(
                    np.array_equal(v, vals[i * 64:(i + 1) * 64] * n)
                    for s in el.servers for k, v in s._handle.store.items()
                    for i in [int(np.searchsorted(keys, k))])}

    want, got = run_both_elastic(scenario, num_workers=1, num_servers=2,
                                 env_extra=dict(ELASTIC_ENV))
    assert_same(got, want)
    assert got == {"exact": True, "epoch": 6, "active": [0, 1],
                   "joiners_empty": [True, True], "stores_exact": True}


# -- mixed clusters ----------------------------------------------------------


def _mixed_join_leave(el):
    """Pushes, a join mid-run, more pushes, a decommission: the tables,
    pulls and stores by rank at the join and after the leave."""
    keys = _spread_keys(16)
    vals = (np.arange(16 * 32, dtype=np.float32) % 7) + 1.0
    w = el.workers[0]
    for _ in range(3):
        w.wait(w.push(keys, vals))
    jpo, jsrv = el.join()
    rt1 = _wait_epoch(el.cluster.workers[0], 1)
    _wait_handoff(el, jsrv)
    for _ in range(2):
        w.wait(w.push(keys, vals))
    out = np.zeros_like(vals)
    w.wait(w.pull(keys, out))
    joined = _by_rank(el.servers)
    jsrv.decommission(timeout_s=DEADLINE)
    rt3 = _wait_epoch(el.cluster.workers[0], 3)
    w.wait(w.push(keys, vals))
    out2 = np.zeros_like(vals)
    w.wait(w.pull(keys, out2))
    assert np.array_equal(out, vals * 5) and np.array_equal(out2, vals * 6)
    return {"rt1": _table_view(rt1), "rt3": _table_view(rt3), "out": out,
            "out2": out2, "joined": joined, "final": _by_rank(el.servers)}


@pytest.fixture(scope="module")
def alljax_join_leave():
    el = MixedElastic("jax", ["jax", "jax"], ["jax"], "jax",
                      dict(ELASTIC_ENV))
    try:
        return _mixed_join_leave(el)
    finally:
        el.close()


@pytest.mark.parametrize("rest,joiner", [("jax", "port"), ("port", "jax")],
                         ids=["port_joiner_jax_donor",
                              "jax_joiner_port_donor"])
def test_mixed_join_bit_equal_to_jax(alljax_join_leave, rest, joiner):
    """Over tcp in one process: a port joiner takes a range from a JAX
    donor (JAX scheduler, servers and worker), and a JAX joiner from a
    port donor (the rest port); each then decommissions back.  Tables,
    pulls and every store are bit-equal to the all-JAX run's."""
    el = MixedElastic(rest, [rest, rest], [rest], joiner,
                      dict(ELASTIC_ENV))
    try:
        got = _mixed_join_leave(el)
    finally:
        el.close()
    assert_same(got, alljax_join_leave)


def test_key_beside_the_cut_stays_with_its_owner():
    """A join splits [0, MAX_KEY) at ``MAX_KEY // 2`` = 2**63 - 1.  NumPy
    searches a uint64 key array for a Python int through float64, so
    JAX's ``find_range`` puts the key 2**63 - 5 above that cut: its
    worker sends the key to the joiner, which never held it, and the
    pull fails server-side (a JAX hole).  The port searches in uint64:
    the key stays with rank 0 and every pull is exact."""
    from pslite_tpu.range import find_range as jfind
    from pslite_tpu_torch.range import find_range as tfind

    cut = ((1 << 64) - 1) // 2
    keys = np.array([3, cut - 4, cut + 4, (1 << 64) - 9], np.uint64)
    assert tuple(astuple(tfind(keys, 0, cut))) == (0, 2)
    assert tuple(astuple(jfind(keys, 0, cut))) == (0, 1)
    vals = np.arange(len(keys) * 4, dtype=np.float32)

    def scenario(el):
        w = el.workers[0]
        w.wait(w.push(keys, vals))
        _jpo, jsrv = el.join()
        rt = _wait_epoch(el.cluster.workers[0], 1)
        _wait_handoff(el, jsrv)
        out = np.zeros_like(vals)
        try:
            w.wait(w.pull(keys, out))
        except Exception as exc:  # noqa: BLE001 - JAX's hole, checked below
            out = repr(exc)
        return {"rt": _table_view(rt), "out": out,
                "joiner": sorted(_store(jsrv))}

    want, got = run_both_elastic(scenario, num_workers=1, num_servers=1,
                                 env_extra=dict(ELASTIC_ENV))
    assert got["rt"] == want["rt"]
    assert got["rt"][3][0][1] == cut
    np.testing.assert_array_equal(got["out"], vals)
    assert got["joiner"] == want["joiner"] == [cut + 4, (1 << 64) - 9]
    assert isinstance(want["out"], str) and "failed" in want["out"]


# -- satellites --------------------------------------------------------------


def test_hot_cache_invalidated_when_owner_changes_epoch():
    """A migrated key is never served from a fill stamped by its old
    owner: the worker's routing hook drops the cached entries of every
    range that changed hands."""
    env = dict(ELASTIC_ENV, PS_HOT_CACHE="1", PS_HOT_CACHE_TTL_S="60")
    keys = _spread_keys(8)
    vals = np.ones(8 * 4, np.float32)

    def scenario(el):
        w1, w2 = el.workers
        w1.wait(w1.push(keys, vals))
        out = np.zeros_like(vals)
        w1.wait(w1.pull(keys, out))
        w1.wait(w1.pull(keys, out))
        before = len(w1.hot_cache)
        _jpo, jsrv = el.join()
        rt = _wait_epoch(el.cluster.workers[0], 1)
        moved = rt.migrations()[0]
        _wait_for(lambda: jsrv._handle.store, "no keys migrated")
        # The hook runs just after the table is adopted.
        _wait_for(lambda: len(w1.hot_cache) < before,
                  "no cache entry dropped")
        in_moved = [int(k) for k in keys if moved.begin <= int(k) < moved.end]
        after = len(w1.hot_cache)
        w2.wait(w2.push(keys, vals))
        got = np.zeros(4, np.float32)
        w1.wait(w1.pull(np.array(in_moved[:1], dtype=np.uint64), got))
        return {"before": before, "dropped": before - after,
                "in_moved": in_moved, "got": got}

    want, got = run_both_elastic(scenario, num_workers=2, num_servers=2,
                                 env_extra=env)
    assert_same(got, want)
    assert got["in_moved"] and got["dropped"] == len(got["in_moved"])
    np.testing.assert_array_equal(got["got"], np.full(4, 2.0, np.float32))


def test_hot_keys_fetched_from_owners_across_a_rank_hole():
    """After rank 0 of 3 decommissions, the routing table's entries are
    no longer indexed by owner rank: ``seed_hot_cache`` sends one
    request per entry to its owner, never to the departed rank, and
    returns within its deadline the same hot keys in both packages."""
    env = dict(ELASTIC_ENV, PS_HOT_CACHE="1")
    keys = _spread_keys(9)
    vals = np.ones(9 * 4, np.float32)

    def scenario(el):
        w = el.workers[0]
        w.wait(w.push(keys, vals))
        _server_of(el.servers, 0).decommission(timeout_s=DEADLINE)
        rt = _wait_epoch(el.cluster.workers[0], 2)
        w.wait(w.push(keys, vals))
        entries = w._route_entries() if el.api is PORT else None
        done = {}
        t = threading.Thread(
            target=lambda: done.setdefault("keys", w.seed_hot_cache(k=16)),
            daemon=True)
        t.start()
        t.join(DEADLINE)
        assert "keys" in done, "seed_hot_cache hung past its deadline"
        return {"rt": _table_view(rt), "entries": entries,
                "hot": sorted(int(k) for k in done["keys"])}

    want, got = run_both_elastic(scenario, num_workers=1, num_servers=3,
                                 env_extra=env)
    ents = got.pop("entries")
    want.pop("entries")
    assert_same(got, want)
    assert got["rt"][1] == [1, 2]
    # The hole: some entry's index is not its owner's rank.
    assert any(i != owner for i, (_rng, owner) in enumerate(ents))
    assert got["hot"] == sorted(int(k) for k in keys)


def test_replication_forward_carries_tenant_label():
    """A chain forward carries its origin's tenant on the frame
    (``EXT_QOS``): the replica reads the true tenant.  JAX counts it in
    ``tenant.serve.requests``, a registry counter (item 8(c)), so both
    packages' replicas are read here at intake, off the frame."""
    key = np.array([5], dtype=np.uint64)  # rank 0's range

    def scenario(el):
        replica = _server_of(el.servers, 1)
        seen = []
        inner = replica._process_request

        def spy(msg):
            if msg.meta.option == OPT_REPLICA and msg.meta.push:
                seen.append(int(msg.meta.tenant))
            return inner(msg)

        replica._process_request = spy
        w = el.workers[0]
        w.wait(w.push(key, np.ones(8, np.float32), tenant="serve"))
        _wait_for(lambda: seen, "no forward reached the replica")
        return {"tenants": seen,
                "serve": w.tenants.resolve("serve")}

    want, got = run_both_elastic(
        scenario, num_workers=1, num_servers=2,
        env_extra={"PS_KV_REPLICATION": "2",
                   "PS_TENANTS": "serve:8,train:1"})
    assert_same(got, want)
    assert got["tenants"] == [got["serve"]] and got["serve"] != 0


def test_mutual_backfill_after_join_completes():
    """A hole of JAX's that the port closes: at ``PS_KV_REPLICATION=3``
    a join puts every server in a chain it was not in, so each backfills
    from another while the joiner backfills from all of them.  JAX parks
    range fetches behind its own backfill, so the fetches wait each
    other out (every one times out after 30 s and the ranges stay
    empty); the port serves fetches during a backfill, and every new
    replica of a range that did not move this epoch holds exact copies
    within seconds.  (A range that moved is backfilled from its new
    owner before the migration lands there, so its new replicas fill
    with later pushes, as in JAX: ROADMAP records it.)"""
    env = dict(ELASTIC_ENV, PS_KV_REPLICATION="3")
    el = Elastic(PORT, num_workers=1, num_servers=3, env_extra=env)
    keys = _spread_keys(12)
    vals = (np.arange(12 * 8, dtype=np.float32) % 11) + 1.0
    try:
        w = el.workers[0]
        w.wait(w.push(keys, vals))
        t0 = time.monotonic()
        _po, joiner = el.join()
        rt = _wait_epoch(el.cluster.workers[0], 1)

        def replicas_whole():
            for srv in el.servers:
                my = srv.po.my_group_rank()
                for e in rt.entries:
                    if e.prev != -1 or e.owner == my or my not in (
                            chain_ranks(e.owner, 3, srv.po.num_servers,
                                        active=list(rt.active))):
                        continue
                    for i, k in enumerate(keys.tolist()):
                        if not e.begin <= k < e.end:
                            continue
                        v = srv._handle.store.get(k)
                        if v is None or not np.array_equal(
                                v, vals[i * 8:(i + 1) * 8]):
                            return False
            return True

        _wait_for(replicas_whole, "new replicas not backfilled", timeout=10)
        assert time.monotonic() - t0 < 10
        assert joiner.stats["replica_backfill_keys"] > 0
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        np.testing.assert_array_equal(out, vals)
    finally:
        el.close()


@pytest.mark.slow
def test_chaos_migration_with_crash_bitexact():
    """JAX's chaos acceptance on the port: drop, delay and duplication on
    the wire plus a server crash while a live migration is in flight.
    Every wait completes or raises, the pump never wedges, and the
    surviving stores serve values exact against completed pushes."""
    chaos = "seed=11,drop=0.03,dup=0.02,delay=1:5"
    env = {
        "PS_ELASTIC": "1", "PS_KV_REPLICATION": "3", "PS_RESEND": "1",
        "PS_RESEND_TIMEOUT": "100", "PS_HEARTBEAT_INTERVAL": "0.2",
        "PS_HEARTBEAT_TIMEOUT": "1.0", "PS_REQUEST_TIMEOUT": "1.0",
        "PS_REQUEST_RETRIES": "8", "PS_VAN_TYPE": "chaos+loopback",
        "PS_CHAOS": chaos,
    }
    el = Elastic(PORT, num_workers=1, num_servers=3, env_extra=env,
                 per_node_env={"server1": {
                     "PS_CHAOS": f"{chaos},crash=recv:200"}})
    keys = _spread_keys(24)
    vals = (np.arange(24 * 32, dtype=np.float32) % 13) + 1.0
    w = el.workers[0]
    pushes, errors, stop = [0], [], threading.Event()

    def storm():
        while not stop.is_set():
            try:
                w.wait(w.push(keys, vals))
                pushes[0] += 1
                time.sleep(0.001)
            except Exception as exc:  # noqa: BLE001
                errors.append(repr(exc))
                return

    victim = next(po for po in el.cluster.servers
                  if po.van.my_node.id == server_rank_to_id(1))
    t = threading.Thread(target=storm, daemon=True)
    try:
        t.start()
        time.sleep(0.3)
        el.join()
        dead_id = server_rank_to_id(1)
        _wait_for(lambda: dead_id in w._down_servers, "detector never fired")
        assert victim.van.chaos_crashed.is_set()
        time.sleep(0.5)
        stop.set()
        t.join(timeout=DEADLINE)
        assert not t.is_alive(), "storm wedged"
        assert not errors, errors
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        np.testing.assert_array_equal(out, vals * pushes[0])
    finally:
        stop.set()
        el.close(skip=(victim,))
