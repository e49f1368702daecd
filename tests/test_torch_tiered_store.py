"""pslite_tpu_torch's tiered store against ``tests/test_tiered_store.py``.

The unit behaviour of the two-tier mapping (the counters JAX reads from
its registry are the store's ``stats`` here), and the bit-identity
matrix: a server whose store is ~16x over its RAM budget ends bit-exact
with the all-RAM twin under the same traffic, across
``PS_APPLY_SHARDS`` x replication x codec and the optimizer handle, on
the port's in-process cluster; each leg also equals the JAX package's
all-RAM run.  Beyond JAX's cases: one access sequence puts every key in
the same tier in both packages (placement is deterministic and the
same).  Tolerance: none.
"""

import os

import numpy as np
import pytest

import pslite_tpu as jps
from pslite_tpu.kv.tiered import TieredStore as JaxTieredStore
from pslite_tpu.telemetry.metrics import Registry
from pslite_tpu_torch.kv.kv_app import (KVServer, KVServerDefaultHandle,
                                        KVServerOptimizerHandle, KVWorker)
from pslite_tpu_torch.kv.tiered import TieredStore

from helpers import LoopbackCluster
from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    PortCluster,
    _port_loopback_isolation,
)


def _store(ram_bytes=4096, shards=1, **kw):
    st = TieredStore(ram_bytes=ram_bytes, shards=shards, **kw)
    return st, st.stats


def test_mapping_protocol_roundtrip():
    st, _ = _store()
    try:
        a = np.arange(8, dtype=np.float32)
        st[3] = a
        assert 3 in st and 4 not in st
        assert len(st) == 1
        assert np.array_equal(st[3], a)
        assert st.get(4) is None
        with pytest.raises(KeyError):
            st[4]
        got = st.pop(3)
        assert np.array_equal(got, a)
        assert len(st) == 0 and not st
    finally:
        st.close()


def test_eviction_and_promotion_across_tiers():
    st, stats = _store(ram_bytes=4096)
    try:
        vals = {k: np.full(256, float(k), np.float32) for k in range(32)}
        for k, v in vals.items():
            st[k] = v.copy()
            st.get(k)  # setitem never evicts; get enforces the budget
        assert stats["evictions"] > 0
        assert st.ram_bytes <= 4096
        assert any(st.tier_of(k) == "cold" for k in vals)
        for k, v in vals.items():
            assert np.array_equal(st.get(k), v), k
        assert stats["cold_hits"] > 0
        assert stats["promotions"] > 0
        snap = dict(st.items())
        assert set(snap) == set(vals)
        for k, v in vals.items():
            assert np.array_equal(snap[k], v)
    finally:
        st.close()


def test_promoted_key_mutates_in_place():
    st, _ = _store(ram_bytes=1024)
    try:
        for k in range(8):
            st[k] = np.full(128, float(k), np.float32)
            st.get(k)
        cold = [k for k in range(8) if st.tier_of(k) == "cold"]
        assert cold
        k = cold[0]
        arr = st.get(k)  # promotes
        arr += 1.0       # in place, as the default handle's push adds
        assert np.array_equal(st.get(k), np.full(128, k + 1.0, np.float32))
    finally:
        st.close()


def test_overwrite_drops_stale_cold_entry():
    st, _ = _store(ram_bytes=512)
    try:
        st[1] = np.full(128, 1.0, np.float32)
        st[2] = np.full(128, 2.0, np.float32)
        st.get(2)  # evicts key 1 past the 512 B budget
        assert st.tier_of(1) == "cold"
        st[1] = np.full(128, 9.0, np.float32)
        assert st.tier_of(1) == "ram"
        assert np.array_equal(st.get(1), np.full(128, 9.0, np.float32))
    finally:
        st.close()


def test_hot_set_preferred_for_ram():
    st, _ = _store(ram_bytes=2048, hot_fn=lambda: [7])
    try:
        st._refresh_hot()
        for k in range(16):
            st[k] = np.full(128, float(k), np.float32)
        for _ in range(4):
            for k in range(16):
                st.get(k)
        assert st.tier_of(7) == "ram"
    finally:
        st.close()


def test_transient_cold_read_failure_keeps_key_retryable():
    st, _ = _store(ram_bytes=512)
    try:
        st[1] = np.full(128, 1.0, np.float32)
        st[2] = np.full(128, 2.0, np.float32)
        st.get(2)
        assert st.tier_of(1) == "cold"
        orig = st._read
        state = {"failed": False}

        def flaky(ent):
            if not state["failed"]:
                state["failed"] = True
                raise OSError("transient mmap failure")
            return orig(ent)

        st._read = flaky
        with pytest.raises(OSError):
            st.get(1)
        assert st.tier_of(1) == "cold"
        assert np.array_equal(st.get(1), np.full(128, 1.0, np.float32))
    finally:
        st.close()


def test_evict_on_insert_bounds_boot_restore():
    st, _ = _store(ram_bytes=4096)
    try:
        st.set_evict_on_insert(True)
        vals = {k: np.full(256, float(k), np.float32) for k in range(32)}
        for k, v in vals.items():
            st[k] = v.copy()
        assert st.ram_bytes <= 4096 + 1024
        st.set_evict_on_insert(False)
        for k, v in vals.items():
            assert np.array_equal(st.get(k), v), k
    finally:
        st.close()


def test_discard_drops_cold_key_without_reading():
    st, _ = _store(ram_bytes=512)
    try:
        st[1] = np.full(128, 1.0, np.float32)
        st[2] = np.full(128, 2.0, np.float32)
        st.get(2)
        assert st.tier_of(1) == "cold"

        def boom(ent):
            raise AssertionError("discard must not read the segment")

        st._read = boom
        assert st.discard(1) is True
        assert st.tier_of(1) is None
        assert st.discard(1) is False
        assert st.discard(2) is True
        assert len(st) == 0
    finally:
        st.close()


def test_close_removes_owned_segment_dir():
    st, _ = _store(ram_bytes=256)
    try:
        for k in range(8):
            st[k] = np.full(128, float(k), np.float32)
            st.get(k)
        d = st.directory
        assert os.path.isdir(d)
    finally:
        st.close()
    assert not os.path.isdir(d)


# -- beyond JAX's cases: placement equal to JAX's ----------------------------

def test_same_access_sequence_same_tiers_as_jax():
    """A seeded sequence of inserts, gets (which evict and promote), pops
    and discards over 4 eviction classes, with a hot set, puts every key
    in the same tier in both packages, and every value equal."""
    rng = np.random.default_rng(21)
    ops = []
    for _ in range(600):
        k = int(rng.integers(0, 48))
        r = rng.random()
        if r < 0.35:
            ops.append(("set", k, float(rng.integers(-9, 9))))
        elif r < 0.9:
            ops.append(("get", k, 0.0))
        elif r < 0.95:
            ops.append(("pop", k, 0.0))
        else:
            ops.append(("discard", k, 0.0))
    stores = [TieredStore(3000, shards=4, hot_fn=lambda: [3, 17]),
              JaxTieredStore(3000, shards=4, hot_fn=lambda: [3, 17],
                             metrics=Registry())]
    try:
        for st in stores:
            st._refresh_hot()
            for op, k, v in ops:
                if op == "set":
                    st[k] = np.full(64, v, np.float32)
                elif op == "get":
                    arr = st.get(k)
                    if arr is not None:
                        arr += 1.0
                elif op == "pop":
                    st.pop(k)
                else:
                    st.discard(k)
        port, jax = stores
        tiers = [port.tier_of(k) for k in range(48)]
        assert tiers == [jax.tier_of(k) for k in range(48)]
        assert "cold" in tiers and "ram" in tiers
        assert port.ram_bytes == jax.ram_bytes
        assert port.cold_bytes == jax.cold_bytes
        for k in range(48):
            a, b = port.get(k), jax.get(k)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.tobytes() == b.tobytes()
    finally:
        for st in stores:
            st.close()


# -- bit-identity matrix (tiered vs all-RAM) ---------------------------------

def _run_cluster(ram_mb, shards, replication, codec, handle_kind,
                 api="port"):
    """One leg: boot, storm (bulk push, incremental subset pushes and
    pulls), return the final pulled table."""
    env = {"PS_APPLY_SHARDS": str(shards),
           "PS_KV_REPLICATION": str(replication)}
    if ram_mb:
        env["PS_STORE_RAM_MB"] = str(ram_mb)
    n_servers = 2 if replication > 1 else 1
    if api == "jax":
        cl = LoopbackCluster(num_workers=1, num_servers=n_servers,
                             env_extra=env)
        server_cls, worker_cls = jps.KVServer, jps.KVWorker
        opt_cls, def_cls = (jps.KVServerOptimizerHandle,
                            jps.KVServerDefaultHandle)
    else:
        cl = PortCluster(num_workers=1, num_servers=n_servers, env_extra=env)
        server_cls, worker_cls = KVServer, KVWorker
        opt_cls, def_cls = KVServerOptimizerHandle, KVServerDefaultHandle
    cl.start()
    servers = []
    w = None
    try:
        for po in cl.servers:
            s = server_cls(0, postoffice=po)
            s.set_request_handle(opt_cls(kind="sgd_momentum", lr=0.1)
                                 if handle_kind == "opt" else def_cls())
            servers.append(s)
        w = worker_cls(0, 0, postoffice=cl.workers[0])
        rng = np.random.default_rng(42)
        nk, vl = 64, 256
        keys = np.arange(nk, dtype=np.uint64)
        base = rng.normal(size=nk * vl).astype(np.float32)
        w.wait(w.push(keys, base, codec=codec))
        for _ in range(10):
            sub = np.unique(rng.integers(0, nk, 16)).astype(np.uint64)
            dv = rng.normal(size=len(sub) * vl).astype(np.float32)
            w.wait(w.push(sub, dv, codec=codec))
            probe = np.zeros(len(sub) * vl, np.float32)
            w.wait(w.pull(sub, probe))
        out = np.zeros(nk * vl, np.float32)
        w.wait(w.pull(keys, out))
        if ram_mb and api == "port":
            store = servers[0]._handle.store
            assert isinstance(store, TieredStore)
            assert store.stats["evictions"] > 0
        return out
    finally:
        if w is not None:
            w.stop()
        cl.finalize()
        for s in servers:
            s.stop()


@pytest.mark.parametrize("shards,replication,codec", [
    (0, 1, None),    # serial apply path
    (4, 1, None),    # sharded
    (4, 2, None),    # sharded + chain replication
    (4, 1, "int8"),  # sharded + quantized wire
])
def test_tiered_bit_identity_matrix(shards, replication, codec):
    """A ~16x over-budget tiered store ends bit-exact with the all-RAM
    twin, and with JAX's all-RAM run of the same traffic."""
    ram = _run_cluster(0, shards, replication, codec, "default")
    tiered = _run_cluster(0.004, shards, replication, codec, "default")
    jax_ram = _run_cluster(0, shards, replication, codec, "default",
                           api="jax")
    assert ram.tobytes() == tiered.tobytes()
    assert ram.tobytes() == jax_ram.tobytes()


def test_tiered_bit_identity_optimizer_handle():
    ram = _run_cluster(0, 4, 1, None, "opt")
    tiered = _run_cluster(0.004, 4, 1, None, "opt")
    assert ram.tobytes() == tiered.tobytes()
