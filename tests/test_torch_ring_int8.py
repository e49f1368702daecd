"""The int8 ring kernel's region table and launch plan, on the CPU.

``csrc/ring_int8.cu`` walks each region (shard, sub-chunk, direction) of
the bucket with one thread block cluster; the regions' bounds come from
``int8_regions`` and the shared-memory/scratch split from ``int8_plan``.
Both are index arithmetic, so they are checked here at every geometry the
gpu tests run, at full width too: every element of ``[padded]`` lies in
exactly one region, the regions are those of the plain version
(``_to_regions``) and of ``ring_geometry.cuh``'s ``ring_pos``, and the
main path's shapes spill nothing at 16 CTAs per cluster.
"""

import numpy as np
import pytest
import torch

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
    plan = ring.int8_plan(geo, padded, cluster)
    assert plan.scratch == scratch
    longest = int(ring.int8_regions(geo, padded)[0][:, 1].max())
    assert plan.slice % 4 == 0 and plan.slice * cluster >= longest
    assert plan.smem_floats == min(plan.slice, ring.INT8_SMEM_FLOATS)
    assert (plan.slice > plan.smem_floats) == (scratch > 0)


def test_main_path_plan():
    """At n = 8 over P: 16 regions of 643,072 values; 16 CTAs hold one in
    40,192 values (157 KiB) each, with float4 accesses."""
    geo = _geo(8, P, True, None)
    plan = ring.int8_plan(geo, P, 16)
    assert plan == ring.Int8Plan(16, 16, 40_192, 40_192, 0, True)
    assert not ring.int8_plan(_geo(3, 3 * 1001, True, None), 3003, 16).vec


@pytest.mark.parametrize("active,want", [
    ({16: 8, 8: 16}, 16),  # 2 waves of 16 beat 1 wave of 8 that spills
    ({16: 7, 8: 16}, 8),  # 3 waves of 16 do not
    ({16: 7, 14: 8, 8: 15}, 14),  # the H100's counts: 2 waves of 14
    ({16: 0, 8: 16}, 8),
    ({16: 8, 8: 0}, 16),
])
def test_launcher_cost_picks_cluster(active, want):
    geo = _geo(8, P, True, None)
    full = {c: active.get(c, 0) for c in ring.INT8_CLUSTERS}
    assert ring.int8_pick_cluster(geo, P, full) == want


def test_launcher_raises_without_a_cluster():
    with pytest.raises(RuntimeError, match="no cluster"):
        ring.int8_pick_cluster(_geo(8, P, True, None), P,
                               {c: 0 for c in ring.INT8_CLUSTERS})


def test_int8_wrapper_on_cpu_runs_the_plain_version():
    ring.reset_launches()
    g = torch.randn(4, 8192, generator=torch.Generator().manual_seed(0))
    s = torch.randn(8192, generator=torch.Generator().manual_seed(1))
    s1, s2 = s.clone(), s.clone()
    out = ring.ring_push_pull(g, s1, compress=True, kv_shards=2)
    ref = ring.ring_push_pull_reference(g, s2, compress=True, kv_shards=2)
    assert torch.equal(out, ref) and torch.equal(s1, s2)
    assert sum(ring.launches.values()) == 0
