"""The int8 ring kernel's region table and launch plan, on the CPU.

``csrc/ring_int8.cu`` walks each region (shard, sub-chunk, direction) of
each bucket of a launch with one thread block cluster; the regions' bounds
come from ``int8_regions`` (one bucket) and ``int8_group_regions`` (the
launch's table over all its buckets, longest first), the shared-memory/
scratch split from ``int8_plan`` and the cluster size from
``int8_cost``/``int8_pick_cluster``.  All of it is index arithmetic, so it
is checked here at every geometry the gpu tests run, at full width too:
every element of ``[padded]`` lies in exactly one region, the regions are
those of the plain version (``_to_regions``) and of ``ring_geometry.cuh``'s
``ring_pos``, the main path's shapes spill nothing at 16 CTAs per cluster,
and the ResNet-50 trace's group holds its regions on chip from 2 CTAs up.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from pslite_tpu_torch.models import resnet_trace as rt
from pslite_tpu_torch.ops import ring_collective as ring

P = 10_240_000

# (n, padded, bidir, kv_shards): the gpu tests' int8 cases (the main path,
# 8 ranks and dp=4 x kv=2; n = 2 in one direction; a bucket smaller than
# the int8 tile; a chunk that is not a multiple of 4; 2-D sub-rings with a
# short last sub-chunk, the whole shard in one region, an odd shard
# length), the spilling shapes (n = 2 at P, 1-D and 2-D), and n = 3 at P.
_GEOMS = [(8, P, True, None), (4, P, True, 2),
          (2, 2 * 8192, False, None), (8, 8 * 100, True, None),
          (3, 3 * 1001, True, None), (4, 2 * 24676, True, 2),
          (2, 8192, True, 4), (4, 2100, True, 2),
          (2, P, True, None), (2, P, True, 2), (3, 3 * 1_000_000, True, None),
          (8, P, False, None), (4, 2 * 6196, False, 2)]


def _geo(n, padded, bidir, kv):
    return ring.ring_geometry(n, padded, torch.float32, bidir, True, kv)


def _one(n, padded, bidir=True, kv=None):
    """The layout of a launch over one bucket."""
    return ((_geo(n, padded, bidir, kv), padded),)


@pytest.mark.parametrize("n,padded,bidir,kv", _GEOMS)
def test_regions_tile_the_bucket_as_the_plain_version(n, padded, bidir, kv):
    geo = _geo(n, padded, bidir, kv)
    table, ids = ring.int8_regions(geo, padded)
    start, length, chunk, step = table.T
    # Every element exactly once, in order: the regions are contiguous and
    # follow each other.
    order = np.argsort(start)
    assert start[order][0] == 0
    np.testing.assert_array_equal(start[order][1:],
                                  (start + length)[order][:-1])
    assert int(length.sum()) == padded and np.all(length > 0)
    # The plain version's regions: [shards, n, ndir, h] with zero padding.
    idx = torch.arange(1, padded + 1, dtype=torch.float64)
    plain = ring._to_regions(idx, geo)
    nb, _, ndir, h = plain.shape
    flat = plain.reshape(nb * n, ndir, h)
    for (s, ln, c, stp), rid in zip(table, ids):
        b, c_, d = int(rid) // (2 * n), (int(rid) // 2) % n, int(rid) % 2
        assert c_ == c
        assert stp == (1 if d == 0 else n - 1)
        assert d < ndir
        vals = flat[b * n + int(c), d]
        got = vals[vals > 0].numpy().astype(np.int64) - 1
        np.testing.assert_array_equal(got, np.arange(s, s + ln))
    # No element of the plain version's regions is left out of the table.
    assert int((plain > 0).sum()) == padded
    assert len(ids) == len(np.unique(ids))


@pytest.mark.parametrize("n,padded,bidir,kv", [g for g in _GEOMS
                                                if g[1] < 100_000])
def test_regions_agree_with_ring_pos(n, padded, bidir, kv):
    """Element by element, the shard, chunk and direction that
    ring_geometry.cuh's ring_pos gives, numbered (shard * n + chunk) * 2
    + direction."""
    geo = _geo(n, padded, bidir, kv)
    i = np.arange(padded, dtype=np.int64)
    b = i // geo.period if geo.kv else np.zeros_like(i)
    j = i - b * geo.period
    c = j // geo.sub
    want = (b * n + c) * 2 + ((j - c * geo.sub) >= geo.split)
    table, ids = ring.int8_regions(geo, padded)
    got = np.full(padded, -1, dtype=np.int64)
    for (start, length, _, _), rid in zip(table, ids):
        got[start:start + length] = rid
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,padded,bidir,kv,cluster,scratch", [
    (8, P, True, None, 16, 0),  # the main path: 643,072-value regions
    (4, P, True, 2, 16, 0),  # 2-D main path
    (2, P, True, None, 16, P),  # 2,560,000-value regions spill
    (2, P, True, None, 8, P),
    (2, P, True, 2, 16, P),  # 2-D n = 2: 1,282,048-value regions
    (8, P, True, None, 8, P),  # 8 CTAs cannot hold 643,072 values
    (8, 8 * 100, True, None, 16, 0),
])
def test_scratch_only_where_a_region_spills(n, padded, bidir, kv, cluster,
                                            scratch):
    geo = _geo(n, padded, bidir, kv)
    plan = ring.int8_plan(_one(n, padded, bidir, kv), cluster)
    assert plan.scratch == scratch and plan.spills == (scratch > 0,)
    longest = int(ring.int8_regions(geo, padded)[0][:, 1].max())
    assert plan.slice % 4 == 0 and plan.slice * cluster >= longest
    assert plan.smem_floats == min(plan.slice, ring.INT8_SMEM_FLOATS)
    assert (plan.slice > plan.smem_floats) == (scratch > 0)


def test_main_path_plan():
    """At n = 8 over P: 16 regions of 643,072 values; 16 CTAs hold one in
    40,192 values (157 KiB) each, with float4 accesses."""
    plan = ring.int8_plan(_one(8, P), 16)
    assert plan == ring.Int8Plan(16, 16, 40_192, 40_192, 0, True, (False,),
                                 (True,))
    assert not ring.int8_plan(_one(3, 3 * 1001), 16).vec


@pytest.mark.parametrize("active,want", [
    ({16: 8, 8: 16}, 16),  # 2 waves of 16 beat 1 wave of 8 that spills
    ({16: 7, 8: 16}, 8),  # 3 waves of 16 do not
    ({16: 7, 14: 8, 8: 15}, 14),  # the H100's counts: 2 waves of 14
    ({16: 0, 8: 16}, 8),
    ({16: 8, 8: 0}, 16),
])
def test_launcher_cost_picks_cluster(active, want):
    full = {c: active.get(c, 0) for c in ring.INT8_CLUSTERS}
    assert ring.int8_pick_cluster(_one(8, P), full) == (want, 1)


def test_launcher_raises_without_a_cluster():
    with pytest.raises(RuntimeError, match="no cluster"):
        ring.int8_pick_cluster(_one(8, P),
                               {c: 0 for c in ring.INT8_CLUSTERS})


# -- one launch over many buckets -------------------------------------------

def _trace_layout(n=8, kv=None):
    shards = kv or n
    return ring.int8_layout(n, [-(-m // shards) * shards
                                for _, m in rt.make_buckets()], kv)


_GROUPS = [("trace", _trace_layout()), ("trace-2d", _trace_layout(4, 2)),
           ("odd", ring.int8_layout(3, [3 * 1001, 3 * 5, 3 * 4096, 3 * 77])),
           ("mixed-2d", ring.int8_layout(4, [2 * 700, 2 * 9, 2 * 24676], 2))]


@pytest.mark.parametrize("name,layout", _GROUPS)
def test_group_region_table(name, layout):
    """The launch's table holds each bucket's own regions, tagged with its
    bucket index, longest first (ties in bucket, then region order)."""
    table = ring.int8_group_regions(layout)
    assert table.shape[1] == 5 and table.dtype == np.int64
    assert np.all(np.diff(table[:, 1]) <= 0)
    for b, (geo, padded) in enumerate(layout):
        own = table[table[:, 4] == b, :4]
        want = ring.int8_regions(geo, padded)[0]
        order = np.argsort(-want[:, 1], kind="stable")
        np.testing.assert_array_equal(own, want[order])
    assert len(table) == sum(len(ring.int8_regions(g, p)[0])
                             for g, p in layout)
    # Ties keep bucket order, then region order.
    key = table[:, 1] * (1 << 20) - table[:, 4]
    assert np.all(np.diff(key) <= 0)


def test_trace_group_plan():
    """The trace's 36 buckets at 8 ranks: 528 regions, the longest of
    65,536 values.  From 2 CTAs per region up every region stays in
    shared memory; at 1 CTA the 65,536-value regions spill 8,192 values
    each, in the 16 buckets that hold one, and the odd-length last bucket
    takes the scalar walk."""
    layout = _trace_layout()
    table = ring.int8_group_regions(layout)
    assert len(layout) == 36 and len(table) == 528
    assert int(table[0, 1]) == 65_536 and int(table[-1, 1]) == 128
    for c in ring.INT8_CLUSTERS[:-1]:
        plan = ring.int8_plan(layout, c)
        assert plan.scratch == 0 and not any(plan.spills), c
        assert plan.slice * c >= 65_536 and plan.smem_floats == plan.slice
    plan = ring.int8_plan(layout, 1)
    assert (plan.slice, plan.smem_floats) == (65_536, ring.INT8_SMEM_FLOATS)
    assert sum(plan.spills) == 16
    assert plan.scratch == sum(p for (_, p), s in zip(layout, plan.spills)
                               if s)
    assert plan.vecs.count(False) == 1 and not plan.vecs[-1]
    assert not plan.vec and ring._mode(plan) == 0


_H100_LIKE = {1: 132, 2: 66, 3: 44, 4: 32, 5: 24, 6: 22, 7: 16, 8: 15,
              9: 9, **{c: 7 for c in range(10, 17)}}


@pytest.mark.parametrize("active,want", [
    (_H100_LIKE, 2),  # one wave of short walks beats 16-CTA clusters
    ({**_H100_LIKE, 2: 0}, 1),  # without pairs, one CTA (spilling) next
    ({16: 7}, 16),  # the only size the card runs
    ({16: 7, 8: 15}, 8),  # 15 slots of 8 beat 7 of 16 on 528 regions
])
def test_group_cost_picks_cluster(active, want):
    layout = _trace_layout()
    full = {c: active.get(c, 0) for c in ring.INT8_CLUSTERS}
    assert ring.int8_pick_cluster(layout, full) == (want, 1)


def test_group_cost_is_the_longest_first_makespan():
    """Two buckets by hand at n = 2, one direction each: regions of 4,096
    (x2) and 2,048 (x2) values on 2 slots of one CTA: each slot takes one
    long and one short row."""
    layout = ring.int8_layout(2, [8192, 4096])
    table = ring.int8_group_regions(layout)
    lens = table[:, 1].tolist()
    assert lens == [4096, 4096, 2048, 2048]
    per = [ln * 5 * 4 + 3 * ring.INT8_HOP_BYTES for ln in lens]
    slots = [0, 0]
    for c in per:
        slots[slots.index(min(slots))] += c
    assert ring.int8_cost(layout, 1, 2) == max(slots)
    assert ring.int8_cost(layout, 1, len(lens)) == max(per)
    assert ring.int8_cost(layout, 1, 0) is None


def test_int8_wrapper_on_cpu_runs_the_plain_version():
    ring.reset_launches()
    g = torch.randn(4, 8192, generator=torch.Generator().manual_seed(0))
    s = torch.randn(8192, generator=torch.Generator().manual_seed(1))
    s1, s2 = s.clone(), s.clone()
    out = ring.ring_push_pull(g, s1, compress=True, kv_shards=2)
    ref = ring.ring_push_pull_reference(g, s2, compress=True, kv_shards=2)
    assert torch.equal(out, ref) and torch.equal(s1, s2)
    assert sum(ring.launches.values()) == 0


def _slice_scale(v, cluster, groups):
    """The scale a region group reaches for the values ``v`` of one
    region: each CTA's max |v| over its slice (``int8_slices``), the
    cluster's max over its CTAs, the region's over the group's clusters;
    then ``max(amax * f32(1/127), 1e-30)``, as the kernel's
    ``scale_of``."""
    cta = [float(v[a:a + m].abs().max()) if m else 0.0
           for a, m in ring.int8_slices(len(v), cluster, groups)]
    per_cluster = [max(cta[g * cluster:(g + 1) * cluster])
                   for g in range(groups)]
    amax = torch.tensor(max(per_cluster), dtype=torch.float32)
    return torch.clamp_min(amax * torch.tensor(ring._INV127),
                           ring._MIN_RING_SCALE)


def _quantize_slices(v, cluster, groups):
    scale = _slice_scale(v, cluster, groups)
    return torch.clamp(torch.round(v / scale), -127, 127), scale


def walk_region(read, store, pulled, n, chunk, step, code, lr, gather, stp,
                cluster, groups):
    """One region row walked as the kernel walks it: ``read(rank)`` the
    rank's values of the region, every hop's scale from the slices'
    maxima of a group of ``groups`` clusters of ``cluster`` CTAs.
    Updates ``store`` (and ``pulled``) in place."""
    acc = read((chunk + step) % n).clone()
    for k in range(2, n + 1):
        q, sc = _quantize_slices(acc, cluster, groups)
        acc = ring._fma_f32(q, sc.expand_as(q), read((chunk + k * step) % n))
    up = ring._apply_handle(store, acc, code, lr)
    if gather:
        q, sc = _quantize_slices(up, cluster, groups)
        pv = q * sc
        if pulled is not None:
            pulled.copy_(pv)
        store.copy_(pv if stp else up)
    else:
        store.copy_(up)


def check_exchange(xchg, nregions, groups, tensors_at):
    """A region group's launch gets zeroed exchange words, 2 * groups + 1
    per region row; one cluster per region gets none."""
    if groups == 1:
        assert not xchg
        return
    words = tensors_at(xchg)
    assert words.dtype == torch.int64
    assert words.numel() == nregions * (2 * groups + 1)
    assert not bool(words.any())


def _emulated_kernel(tensors):
    """A stand-in for ``pstt_ring_int8`` that walks each row of the
    launch's region table with the plain version's arithmetic and the
    kernel's slices of each region (``walk_region``), reading the bucket
    table the wrapper passes (pointers resolved through ``tensors``)."""
    calls = []

    def call(name, desc_ptr, count, regions_ptr, nregions, cluster, groups,
             xchg, smem, code, lr, gather, stp, stream):
        assert name == "pstt_ring_int8"
        calls.append((count, nregions, cluster, groups, smem))
        check_exchange(xchg, nregions, groups, tensors.__getitem__)
        desc = np.ctypeslib.as_array(
            (ctypes.c_longlong * (7 * count)).from_address(desc_ptr))
        desc = desc.reshape(count, 7)
        rows = tensors[regions_ptr].numpy()
        assert rows.shape == (nregions, 5)
        for start, length, chunk, step, b in rows.tolist():
            gp, sp, pp, scp, padded, n, _ = desc[b].tolist()
            g, st = tensors[gp].view(n, padded), tensors[sp]
            idx = slice(start, start + length)
            walk_region(lambda r: g[r, idx], st[idx],
                        tensors[pp][idx] if pp else None, n, chunk, step,
                        code, lr, gather, stp, cluster, groups)
    return call, calls


@pytest.mark.parametrize("length", [1, 7, 1001, 643_072, 2_560_000])
@pytest.mark.parametrize("cluster,groups", [(16, 1), (1, 32), (4, 4),
                                            (3, 11), (5, 3)])
def test_group_slices_cover_each_region_once(length, cluster, groups):
    """The G * C slices of a region (slice ``member * C + rank``) follow
    one another, tile it exactly once and are multiples of 4 values but
    the last non-empty one."""
    sl = ring.int8_slices(length, cluster, groups)
    assert len(sl) == cluster * groups
    ends = np.cumsum([m for _, m in sl])
    assert [a for a, _ in sl] == [0] + ends[:-1].tolist()
    assert int(ends[-1]) == length
    width = int(ring._slices(np.int64(length), cluster * groups))
    assert width % 4 == 0 and width * cluster * groups >= length
    assert all(m == width for a, m in sl if a + m < length)


def _drive(monkeypatch, tensors):
    """``_native.call`` replaced by the emulated kernel, with the launch's
    region table and exchange words remembered in ``tensors``; returns
    the list of the emulated calls."""
    from pslite_tpu_torch.ops import _native

    def remember(t):
        if t is not None and t.numel():
            tensors[t.data_ptr()] = t
        return t

    real_table, real_exchange = ring._region_table, ring._exchange
    call, calls = _emulated_kernel(tensors)
    monkeypatch.setattr(_native, "call", call)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(ring, "_region_table",
                        lambda *a: remember(real_table(*a)))
    monkeypatch.setattr(ring, "_exchange",
                        lambda *a: remember(real_exchange(*a)))
    return calls


@pytest.mark.parametrize("n,pads,kv,cluster,with_ag", [
    (4, [4 * 1001, 4 * 5, 0, 4 * 4096, 4 * 77], None, 2, True),
    (3, [3 * 1001, 3 * 8192], None, 1, False),
    (4, [2 * 700, 2 * 9, 2 * 24676], 2, 4, True),
    (4, [4 * (37 + i) for i in range(50)], None, 16, True),
    (4, [4 * 1001, 4 * 5, 0, 4 * 4096, 4 * 77], None, (2, 3), True),
    (3, [3 * 1001, 3 * 8192], None, (1, 2), False),
    (4, [2 * 700, 2 * 9, 2 * 24676], 2, (3, 2), True),
])
def test_launcher_tables_drive_the_kernel(monkeypatch, n, pads, kv, cluster,
                                          with_ag):
    """``_launch_int8``'s bucket and region tables, run by an emulated
    kernel (each hop's scale met from the slices' maxima of G clusters of
    C CTAs), give the plain version's bits: one launch per 48 buckets, an
    empty bucket skipped, a region group's exchange words zeroed."""
    gen = torch.Generator().manual_seed(7)
    grads = [torch.randn(n, p, generator=gen) for p in pads]
    stores = [torch.randn(p, generator=gen) for p in pads]
    pulled = [torch.empty(p) if with_ag else None for p in pads]
    geos = [ring.ring_geometry(n, p, torch.float32, True, True, kv)
            for p in pads]
    tensors = {t.data_ptr(): t for t in grads + stores + pulled
               if t is not None and t.numel()}
    calls = _drive(monkeypatch, tensors)
    want = [s.clone() for s in stores]
    outs = [ring._ring_reference(g, w, "sum", True, with_ag, True, kv)
            for g, w in zip(grads, want)]
    made = ring._launch_int8(grads, stores, pulled, geos, 0, 0.0, with_ag,
                             cluster)
    live = sum(1 for p in pads if p)
    assert made == len(calls) == -(-live // ring.INT8_MAX_GROUP)
    shape = (cluster, 1) if isinstance(cluster, int) else cluster
    assert all(c[2:4] == shape for c in calls)
    for s, w in zip(stores, want):
        assert torch.equal(s, w)
    if with_ag:
        for p, o in zip(pulled, outs):
            assert torch.equal(p, o)


@functools.lru_cache(maxsize=None)
def _jax_compressed(n, bidir, with_ag):
    """``pslite_tpu.ops.ring_collective``'s compressed ring on n devices
    of the virtual CPU mesh (interpret mode, as tests/test_ring_collective
    runs it), over seeded inputs: ``(grads, store, [store, pulled])``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as PS

    from pslite_tpu.ops import ring_collective as jring
    from pslite_tpu.parallel.mesh import shard_map_compat as shard_map

    chunk = jring.ring_chunk_len(n * 1024, n, bidir=bidir, compress=True)
    rng = np.random.RandomState(22)
    grads = rng.randn(n, n * chunk).astype(np.float32)
    store = rng.randn(n * chunk).astype(np.float32)
    fn = jring.ring_push_pull if with_ag else jring.ring_push

    def body(s, g):
        return fn(g[0].reshape(n, chunk), s, lambda s, a: s + a, "kv", n,
                  bidir=bidir, compress=True)

    f = jax.jit(shard_map(
        body, mesh=Mesh(np.array(jax.devices()[:n]), ("kv",)),
        in_specs=(PS("kv"), PS("kv", None)),
        out_specs=(PS("kv"), PS(None)) if with_ag else PS("kv")))
    outs = f(jnp.asarray(store), jnp.asarray(grads))
    return grads, store, [np.asarray(o)
                          for o in (outs if with_ag else (outs,))]


@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("n,bidir,with_ag", [(4, True, True),
                                             (2, False, False)])
def test_region_groups_match_jax(monkeypatch, groups, n, bidir, with_ag):
    """One bucket through ``_launch_int8`` at G = 1, 2, 3 clusters of 2
    CTAs per region, the emulated kernel meeting each hop's scale from
    the slices' maxima, against the JAX package's compressed ring: the
    store and the pulled values bit-equal."""
    grads, store, want = _jax_compressed(n, bidir, with_ag)
    g, st = torch.from_numpy(grads.copy()), torch.from_numpy(store.copy())
    pulled = torch.empty_like(st) if with_ag else None
    geo = ring.ring_geometry(n, st.numel(), torch.float32, bidir, True)
    tensors = {t.data_ptr(): t for t in (g, st, pulled) if t is not None}
    calls = _drive(monkeypatch, tensors)
    ring._launch_int8([g], [st], [pulled], [geo], 0, 0.0, with_ag,
                      (2, groups))
    assert [c[2:4] for c in calls] == [(2, groups)]
    np.testing.assert_array_equal(st.numpy(), want[0])
    if with_ag:
        np.testing.assert_array_equal(pulled.numpy(), want[1])


# The co-resident clusters an H100 80GB HBM3 runs at each cluster size
# for the single-process launch of one float4 bucket
# (``cudaOccupancyMaxActiveClusters`` on the card, PERF.md section 6).
H100 = {**{c: 7 for c in range(10, 17)}, 9: 9, 8: 15, 7: 15, 6: 17, 5: 22,
        4: 30, 3: 39, 2: 66, 1: 132}


@pytest.mark.parametrize("n,kv,want", [
    (2, None, (2, 16)),  # 4 regions: one wave of 128 CTAs, 28 % spilled
    (8, None, (16, 1)),  # 16 regions: a one-wave split spills; 3 waves
    (4, 2, (16, 1)),  # the dp sub-rings' 16 regions, likewise
])
def test_h100_planner_splits_regions_only_where_it_pays(n, kv, want):
    """On the H100's occupancies the planner walks n = 2's 4 regions
    with 16 clusters of 2 CTAs each, all 64 clusters at once; the main
    path's 16 regions keep one cluster of 16 CTAs each, where a one-wave
    group would spill 29 % of every slice."""
    layout = _one(n, P, True, kv)
    c, g = ring.int8_pick_cluster(layout, H100)
    assert (c, g) == want
    plan = ring.int8_plan(layout, c, g)
    if g > 1:
        assert plan.nregions * g <= H100[c]  # one wave
        assert ring._waves(plan.nregions, g, H100[c]) == 1
        assert plan.slice * c * g >= P // (2 * n)
    assert ring.int8_cost(layout, c, H100[c], g) == min(
        v for v in (ring.int8_cost(layout, cc, H100[cc], gg)
                    for cc, gg in ring.int8_shapes(plan.nregions, H100))
        if v is not None)


def test_region_groups_only_where_the_launch_fits_at_once():
    """A region group is priced only where every region's G clusters are
    resident together; one cluster per region is priced at any count."""
    shapes = ring.int8_shapes(4, H100)
    assert (1, 32) in shapes and (2, 16) in shapes and (16, 1) in shapes
    assert (2, 17) not in shapes and (16, 2) not in shapes
    assert all(g == 1 or 4 * g <= H100[c] for c, g in shapes)
    layout = _one(2, P)
    assert ring.int8_cost(layout, 2, H100[2], 17) is None
    assert ring.int8_cost(layout, 16, 7, 2) is None
