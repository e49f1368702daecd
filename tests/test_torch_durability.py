"""pslite_tpu_torch's coordinated snapshots and restore on boot against
``tests/test_durability.py``.

Mirrored on the port's in-process cluster (``PortCluster``): a whole
cluster killed and booted again with ``PS_SNAPSHOT_RESTORE=1`` restores
bit-exact, adam slots included (the restored server's next update
equals an uninterrupted handle's); a snapshot racing a push storm is a
consistent cut; a corrupt manifest fails the restore; a server that
errors vetoes the commit; a vetoed attempt never overwrites the
committed segments and the next commit prunes them; the optimizer
records' sign tag and kind code; a pool that does not quiesce vetoes
the cut; two tiered stores share a directory; the manifest's age.  The
flight-recorder and SLO assertions of JAX's tests wait for the
telemetry plane (ROADMAP Queue 1 item 8(c)).

Beyond JAX's cases: a snapshot written by a JAX cluster restores
bit-exact in a port cluster and the reverse, with equal manifests
(ranges, file names but for the attempt uid, key counts, digests); and
the decline matrix (instance groups, a second snapshot while one runs,
``PS_SNAPSHOT_FORMAT=orbax``).  Tolerance: none.
"""

import json
import os
import threading

import numpy as np
import pytest

import pslite_tpu as jps
import pslite_tpu_torch as tps
from pslite_tpu_torch.kv import replication as repl
from pslite_tpu_torch.kv import snapshot as snap_mod
from pslite_tpu_torch.kv.kv_app import (KVMeta, KVServer,
                                        KVServerDefaultHandle,
                                        KVServerOptimizerHandle, KVWorker,
                                        _push_segs)
from pslite_tpu_torch.utils import logging as log

from helpers import LoopbackCluster
from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    PortCluster,
    _port_loopback_isolation,
)


def _boot(snapdir, num_servers=1, extra=None, handle_factory=None,
          api=None):
    """A started cluster (the port's, or JAX's with ``api="jax"``) with
    its servers' handles set and one worker."""
    env = {"PS_SNAPSHOT_DIR": snapdir}
    env.update(extra or {})
    if api == "jax":
        cl = LoopbackCluster(num_workers=1, num_servers=num_servers,
                             env_extra=env)
        mod = jps
    else:
        cl = PortCluster(num_workers=1, num_servers=num_servers,
                         env_extra=env)
        mod = tps
    cl.start()
    servers = []
    for po in cl.servers:
        s = mod.KVServer(0, postoffice=po)
        s.set_request_handle(handle_factory() if handle_factory
                             else mod.KVServerDefaultHandle())
        servers.append(s)
    w = mod.KVWorker(0, 0, postoffice=cl.workers[0])
    return cl, servers, w


def _kill(cl, servers, w=None):
    if w is not None:
        w.stop()
    cl.finalize()
    for s in servers:
        s.stop()


def test_full_cluster_kill_restore_bit_exact(tmp_path):
    snapdir = str(tmp_path / "snap")
    cl, servers, w = _boot(snapdir, num_servers=2)
    keys = np.array([1, 5, 9, 2**62, 2**63 + 7], dtype=np.uint64)
    vals = np.random.default_rng(0).normal(
        size=len(keys) * 32).astype(np.float32)
    try:
        w.wait(w.push(keys, vals))
        res = cl.scheduler.snapshot()
        assert res["servers"] == 2
        assert os.path.exists(res["manifest"])
        expect = np.zeros_like(vals)
        w.wait(w.pull(keys, expect))
    finally:
        _kill(cl, servers, w)

    cl2, servers2, w2 = _boot(snapdir, num_servers=2,
                              extra={"PS_SNAPSHOT_RESTORE": "1"})
    try:
        out = np.zeros_like(vals)
        w2.wait(w2.pull(keys, out))
        assert np.array_equal(out, expect)
        assert cl2.scheduler.snapshot_status()["age_s"] >= 0
    finally:
        _kill(cl2, servers2, w2)


def test_restore_includes_optimizer_slots(tmp_path):
    """Adam slots (m, v, step) ride the snapshot: the restored server's
    next update is bit-exact with an uninterrupted handle's."""
    snapdir = str(tmp_path / "snap")
    def factory():
        return KVServerOptimizerHandle(kind="adam", lr=0.05)
    keys = np.array([2, 7, 11], dtype=np.uint64)
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=len(keys) * 16).astype(np.float32)
             for _ in range(6)]
    reference = factory()
    for g in grads:
        meta = KVMeta(push=True)
        reference.apply_shard(meta, keys, _push_segs(meta, keys, g))

    cl, servers, w = _boot(snapdir, handle_factory=factory)
    try:
        for g in grads[:5]:
            w.wait(w.push(keys, g))
        cl.scheduler.snapshot()
    finally:
        _kill(cl, servers, w)

    cl2, servers2, w2 = _boot(snapdir, handle_factory=factory,
                              extra={"PS_SNAPSHOT_RESTORE": "1"})
    try:
        w2.wait(w2.push(keys, grads[5]))
        out = np.zeros(len(keys) * 16, np.float32)
        w2.wait(w2.pull(keys, out))
        want = np.concatenate([reference.store[int(k)] for k in keys])
        assert np.array_equal(out, want)
        assert servers2[0]._handle._t == {int(k): 6 for k in keys}
    finally:
        _kill(cl2, servers2, w2)


def test_snapshot_racing_push_storm_is_consistent_cut(tmp_path):
    """A snapshot mid push storm holds every request whole: each push
    adds 1 to every key, so a consistent cut restores one count on all
    keys."""
    snapdir = str(tmp_path / "snap")
    cl, servers, w = _boot(snapdir, extra={"PS_APPLY_SHARDS": "4"})
    keys = np.arange(8, dtype=np.uint64)
    ones = np.ones(8 * 64, np.float32)
    n_pushes = 120
    try:
        w.wait(w.push(keys, ones))
        done = threading.Event()

        def storm():
            pending = []
            for _ in range(n_pushes):
                pending.append(w.push(keys, ones))
                if len(pending) >= 16:
                    w.wait(pending.pop(0))
            for ts in pending:
                w.wait(ts)
            done.set()

        t = threading.Thread(target=storm, daemon=True)
        t.start()
        cl.scheduler.snapshot()
        t.join(timeout=60)
        assert done.is_set()
    finally:
        _kill(cl, servers, w)

    cl2, servers2, w2 = _boot(snapdir, extra={"PS_SNAPSHOT_RESTORE": "1"})
    try:
        out = np.zeros(8 * 64, np.float32)
        w2.wait(w2.pull(keys, out))
        per_key = out.reshape(8, 64)
        count = per_key[0, 0]
        assert np.all(per_key == count), per_key[:, 0]
        assert 1.0 <= count <= n_pushes + 1
    finally:
        _kill(cl2, servers2, w2)


def test_digest_mismatch_fails_restore_loudly(tmp_path):
    snapdir = str(tmp_path / "snap")
    cl, servers, w = _boot(snapdir)
    keys = np.array([4, 8], dtype=np.uint64)
    try:
        w.wait(w.push(keys, np.ones(2 * 16, np.float32)))
        cl.scheduler.snapshot()
    finally:
        _kill(cl, servers, w)
    mpath = os.path.join(snapdir, snap_mod.MANIFEST_NAME)
    doc = json.load(open(mpath))
    doc["ranges"][0]["digest"] = "00000000"
    json.dump(doc, open(mpath, "w"))

    cl2 = PortCluster(num_workers=1, num_servers=1, env_extra={
        "PS_SNAPSHOT_DIR": snapdir, "PS_SNAPSHOT_RESTORE": "1"})
    cl2.start()
    s = KVServer(0, postoffice=cl2.servers[0])
    try:
        with pytest.raises(log.CheckError, match="digest mismatch"):
            s.set_request_handle(KVServerDefaultHandle())
    finally:
        s.stop()
        cl2.finalize()


def test_partial_snapshot_never_commits(tmp_path):
    """A server without a handle errors, which vetoes the commit: no
    manifest, and the scheduler raises."""
    snapdir = str(tmp_path / "snap")
    cl = PortCluster(num_workers=1, num_servers=1,
                     env_extra={"PS_SNAPSHOT_DIR": snapdir})
    cl.start()
    s = KVServer(0, postoffice=cl.servers[0])  # handle never set
    try:
        with pytest.raises(log.CheckError, match="NOT committed"):
            cl.scheduler.snapshot(timeout_s=20.0)
        assert snap_mod.load_manifest(snapdir) is None
    finally:
        s.stop()
        cl.finalize()


def test_vetoed_attempt_never_clobbers_committed_snapshot(tmp_path):
    """Segment names carry the attempt uid: a vetoed attempt's file
    leaves the committed snapshot restorable, and the next commit prunes
    both the old segment and the orphan."""
    snapdir = str(tmp_path / "snap")
    keys = np.array([3, 6], dtype=np.uint64)
    vals = np.arange(2 * 16, dtype=np.float32)
    cl, servers, w = _boot(snapdir)
    try:
        w.wait(w.push(keys, vals))
        cl.scheduler.snapshot()
    finally:
        _kill(cl, servers, w)
    committed = snap_mod.load_manifest(snapdir)
    entry = committed["ranges"][0]
    orphan = snap_mod.write_range_segment(
        snapdir, entry["begin"], entry["end"], np.array([3], np.uint64),
        np.full(16, 99.0, np.float32), None, uid="vetoedattempt")
    assert orphan["file"] != entry["file"]
    snap_mod.read_range_segment(snapdir, entry)  # digest still good

    cl2, servers2, w2 = _boot(snapdir, extra={"PS_SNAPSHOT_RESTORE": "1"})
    try:
        out = np.zeros_like(vals)
        w2.wait(w2.pull(keys, out))
        assert np.array_equal(out, vals)
        res2 = cl2.scheduler.snapshot()
        names = set(os.listdir(snapdir))
        for e in res2["ranges"]:
            assert f"{e['file']}.npz" in names
        assert f"{entry['file']}.npz" not in names
        assert f"{orphan['file']}.npz" not in names
    finally:
        _kill(cl2, servers2, w2)


def test_params_only_source_imports_with_fresh_slots():
    """An even-length params-only record imports as whole params with
    fresh slots, never split into [p, m]."""
    src = KVServerDefaultHandle()
    src.store[5] = np.arange(4, dtype=np.float32)
    keys, vals, lens = repl.export_range(src, 0, 2**64)
    assert lens[0] == 4
    dst = KVServerOptimizerHandle(kind="sgd_momentum")
    dst.import_range(keys, vals, lens)
    assert np.array_equal(dst.store[5], np.arange(4, dtype=np.float32))
    assert 5 not in dst._m


def test_slot_packed_records_tagged_and_kind_mismatch_is_loud():
    h = KVServerOptimizerHandle(kind="sgd_momentum", lr=0.1)
    keys = np.array([9], dtype=np.uint64)
    meta = KVMeta(push=True)
    h.apply_shard(meta, keys, _push_segs(meta, keys, np.ones(9, np.float32)))
    k, v, lens = h.export_range(0, 2**64)
    assert lens[0] == -19  # [p, m, kind_bits], tagged by the sign
    twin = KVServerOptimizerHandle(kind="sgd_momentum", lr=0.1)
    twin.import_range(k, v, lens)
    assert np.array_equal(twin.store[9], h.store[9])
    assert np.array_equal(twin._m[9], h._m[9])
    with pytest.raises(log.CheckError, match="different optimizer"):
        KVServerOptimizerHandle(kind="adam").import_range(k, v, lens)
    with pytest.raises(log.CheckError, match="sgd"):
        KVServerOptimizerHandle(kind="sgd").import_range(k, v, lens)
    # The records are JAX's: the JAX handle restores them whole.
    jh = jps.KVServerOptimizerHandle(kind="sgd_momentum", lr=0.1)
    jh.import_range(k, v, lens)
    assert np.array_equal(jh._m[9], h._m[9])


def test_plain_store_refuses_slot_packed_records():
    h = KVServerOptimizerHandle(kind="sgd_momentum", lr=0.1)
    keys = np.array([4], dtype=np.uint64)
    meta = KVMeta(push=True)
    h.apply_shard(meta, keys, _push_segs(meta, keys, np.ones(4, np.float32)))
    k, v, lens = h.export_range(0, 2**64)
    with pytest.raises(log.CheckError, match="plain store"):
        repl.import_range(KVServerDefaultHandle(), k, v, lens)


def test_quiesce_timeout_vetoes_the_commit(tmp_path):
    """A fence that cannot drain the pool vetoes the cut."""
    snapdir = str(tmp_path / "snap")
    cl, servers, w = _boot(snapdir, extra={"PS_APPLY_SHARDS": "2"})
    try:
        w.wait(w.push(np.array([1], np.uint64), np.ones(16, np.float32)))
        assert servers[0]._apply_pool is not None
        servers[0]._apply_pool.quiesce = (
            lambda tok, timeout_s=0.0: False)  # a wedged shard
        with pytest.raises(log.CheckError, match="NOT committed"):
            cl.scheduler.snapshot(timeout_s=20.0)
        assert snap_mod.load_manifest(snapdir) is None
    finally:
        _kill(cl, servers, w)


def test_two_stores_share_directory_without_collision(tmp_path):
    """Two TieredStores of one process on one directory keep their own
    segment files."""
    from pslite_tpu_torch.kv.tiered import TieredStore

    a = TieredStore(512, directory=str(tmp_path), shards=1)
    b = TieredStore(512, directory=str(tmp_path), shards=1)
    try:
        for st, base in ((a, 10.0), (b, 20.0)):
            for k in range(8):
                st[k] = np.full(128, base + k, np.float32)
                st.get(k)
        for st, base in ((a, 10.0), (b, 20.0)):
            for k in range(8):
                assert np.array_equal(st.get(k),
                                      np.full(128, base + k, np.float32))
        a.close()
        for k in range(8):
            assert np.array_equal(b.get(k),
                                  np.full(128, 20.0 + k, np.float32))
    finally:
        a.close()
        b.close()


def test_manifest_age():
    """``manifest_age_s`` reads -1 for a never-snapshotted directory
    (JAX's SLO rule over it is the telemetry plane, item 8(c))."""
    assert snap_mod.manifest_age_s("/nonexistent/nowhere") == -1.0
    assert snap_mod.manifest_age_s(None) == -1.0


# -- beyond JAX's cases -------------------------------------------------------

def _manifest_view(snapdir):
    """A manifest with the attempt uid taken out of the file names."""
    doc = snap_mod.load_manifest(snapdir)
    ranges = []
    for e in doc["ranges"]:
        e = dict(e)
        e["file"] = e["file"].rsplit(".", 1)[0]
        ranges.append(e)
    return {"version": doc["version"], "epoch": doc["epoch"],
            "servers": doc["servers"], "ranges": ranges}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_snapshot_restores_in_the_other_package(tmp_path, writer, reader):
    """A snapshot committed by one package's cluster (2 servers, a
    default and an adam handle's records in two directories) restores
    bit-exact in the other's, and both packages write the same manifest:
    ranges, file names but for the attempt uid, key counts, digests."""
    keys = np.array([1, 5, 9, 2**62, 2**63 + 7], dtype=np.uint64)
    rng = np.random.default_rng(4)
    vals = rng.normal(size=len(keys) * 32).astype(np.float32)
    grads = [rng.normal(size=len(keys) * 32).astype(np.float32)
             for _ in range(3)]
    adam = {"jax": lambda: jps.KVServerOptimizerHandle(kind="adam", lr=0.05),
            "port": lambda: tps.KVServerOptimizerHandle(kind="adam",
                                                        lr=0.05)}
    views, expects = {}, {}
    for pkg in ("jax", "port"):
        for kind in ("default", "adam"):
            d = str(tmp_path / f"{pkg}_{kind}")
            factory = adam[pkg] if kind == "adam" else None
            cl, servers, w = _boot(d, num_servers=2, api=pkg,
                                   handle_factory=factory)
            try:
                for g in ([vals] if kind == "default" else grads):
                    w.wait(w.push(keys, g))
                cl.scheduler.snapshot()
                out = np.zeros_like(vals)
                w.wait(w.pull(keys, out))
                expects[(pkg, kind)] = out
            finally:
                _kill(cl, servers, w)
            views[(pkg, kind)] = _manifest_view(d)
    for kind in ("default", "adam"):
        assert views[("jax", kind)] == views[("port", kind)]
        assert (expects[("jax", kind)].tobytes()
                == expects[("port", kind)].tobytes())
        d = str(tmp_path / f"{writer}_{kind}")
        cl, servers, w = _boot(d, num_servers=2, api=reader,
                               extra={"PS_SNAPSHOT_RESTORE": "1"},
                               handle_factory=(adam[reader]
                                               if kind == "adam" else None))
        try:
            out = np.zeros_like(vals)
            w.wait(w.pull(keys, out))
            assert out.tobytes() == expects[(writer, kind)].tobytes()
            if kind == "adam":
                steps = {}
                for s in servers:
                    steps.update(s._handle._t)
                assert steps == {int(k): 3 for k in keys}
        finally:
            _kill(cl, servers, w)


def test_snapshot_decline_matrix(tmp_path, monkeypatch):
    """Loud refusals, as in JAX: instance groups (every instance owns
    the same range), a second snapshot while one is running, and
    ``PS_SNAPSHOT_FORMAT=orbax`` writing npz with a warning."""
    snapdir = str(tmp_path / "snap")
    cl = PortCluster(num_workers=1, num_servers=1, group_size=2,
                     env_extra={"PS_SNAPSHOT_DIR": snapdir})
    cl.start()
    servers = []
    try:
        for po in cl.servers:
            s = KVServer(0, postoffice=po)
            s.set_request_handle(KVServerDefaultHandle())
            servers.append(s)
        with pytest.raises(log.CheckError, match="instance groups"):
            cl.scheduler.snapshot(timeout_s=20.0)
        assert snap_mod.load_manifest(snapdir) is None
    finally:
        for s in servers:
            s.stop()
        cl.finalize()

    cl, servers, w = _boot(snapdir, extra={"PS_SNAPSHOT_FORMAT": "orbax"})
    try:
        w.wait(w.push(np.array([3], np.uint64), np.ones(8, np.float32)))
        servers[0]._snapshotting = True  # one already running
        with pytest.raises(log.CheckError, match="already in progress"):
            cl.scheduler.snapshot(timeout_s=20.0)
        servers[0]._snapshotting = False
        warned = []
        monkeypatch.setattr(log, "warning", warned.append)
        res = cl.scheduler.snapshot()
        assert all(e["format"] == "npz" for e in res["ranges"])
        assert any("PS_SNAPSHOT_FORMAT=orbax" in m for m in warned)
    finally:
        _kill(cl, servers, w)
