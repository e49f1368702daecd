"""CUDA kernels of pslite_tpu_torch against their plain PyTorch versions.

These need a CUDA card and nvcc (the kernels are built from csrc/ at
first use), so they carry the ``gpu`` marker and skip elsewhere; the
decision is made inside a fixture, never at import or collection.  Run
them on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_chip.py``
(``--noconftest`` where JAX is not installed: tests/conftest.py imports
the JAX package).

Tolerances: the ring ``sum``/``assign`` are bit-exact (same order of
addition, same rounding per hop), on the 1-D ring and on the 2-D
sub-rings; the int8 ring and quantize/dequantize are bit-exact (the plain
versions round ``fmaf`` once, as the kernels do); ``sgd:lr`` and the
f32 fused updates differ in the last bits because nvcc contracts a*b + c
into one FMA and eager PyTorch does not: rtol/atol 1e-6 (adam rtol 1e-5).
The bf16 fused updates are bit-exact: kernel and plain version round to
bf16 after every operation, so no FMA can form.  D1 (the reduce with an
elementwise handle) is bit-exact with its plain version on every dtype;
D2 (the reduce fused with K1-K3) is bit-exact with the plain reduction
followed by the K1-K3 launch (``reduce_update_reference(..., fused=True)``)
and within K1-K3's tolerances of the all-PyTorch plain version.  The message-plane tests
at the end start a cluster in this process (loopback, and ici on this
card) under 60 s deadlines.
"""

import numpy as np
import pytest
import torch

from pslite_tpu_torch import CollectiveEngine, DeviceGroup, make_group
from pslite_tpu_torch.models import resnet_trace as rt
from pslite_tpu_torch.ops import fused_update as fu
from pslite_tpu_torch.ops import quantize as qz
from pslite_tpu_torch.ops import reduce_update as ru
from pslite_tpu_torch.ops import ring_collective as ring

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _randn(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


# (n, padded): full width (40 x 256,000 over 8 ranks), small, a bucket
# whose chunk is shorter than the tile (direction 0 only), and one whose
# chunk is not a multiple of the vector width (the scalar kernel).
_SHAPES = [(8, 10_240_000), (4, 4 * 4096), (8, 400), (3, 3 * 1001)]


@pytest.mark.parametrize("n,padded", _SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("with_ag", [True, False])
@pytest.mark.parametrize("bidir", [True, False])
def test_ring_kernel_bit_exact(dev, n, padded, dtype, with_ag, bidir):
    grads = _randn((n, padded), 1, dev).to(dtype)
    store = _randn((padded,), 2, dev).to(dtype)
    for handle in ("sum", "assign"):
        sk, sp = store.clone(), store.clone()
        if with_ag:
            outk = ring.ring_push_pull(grads, sk, handle, bidir=bidir)
            outp = ring.ring_push_pull_reference(grads, sp, handle,
                                                 bidir=bidir)
            assert torch.equal(outk, outp)
        else:
            ring.ring_push(grads, sk, handle, bidir=bidir)
            ring.ring_push_reference(grads, sp, handle, bidir=bidir)
        torch.cuda.synchronize()
        assert torch.equal(sk, sp), handle


@pytest.mark.parametrize("n,padded", _SHAPES)
def test_ring_kernel_sgd(dev, n, padded):
    grads = _randn((n, padded), 3, dev)
    store = _randn((padded,), 4, dev)
    sk, sp = store.clone(), store.clone()
    outk = ring.ring_push_pull(grads, sk, "sgd:0.05")
    outp = ring.ring_push_pull_reference(grads, sp, "sgd:0.05")
    torch.testing.assert_close(outk, outp, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=1e-6)


def test_ring_kernel_counts_launches(dev):
    ring.reset_launches()
    g = _randn((4, 4096), 5, dev)
    s = torch.zeros(4096, device=dev)
    ring.ring_push_pull(g, s)
    ring.ring_push(g.bfloat16(), s.bfloat16())
    assert ring.launches["ring_push_pull[float32]"] == 1
    assert ring.launches["ring_push[bfloat16]"] == 1
    assert sum(ring.launches.values()) == 2


@pytest.mark.parametrize("n", [10_240_000, 4096, 1001])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_updates_match_plain(dev, n, offset):
    """Aligned and (offset 1) unaligned views, ragged lengths."""
    agg = _randn((n + offset,), 6, dev)[offset:]
    store = _randn((n + offset,), 7, dev)[offset:]
    mom = _randn((n + offset,), 8, dev)[offset:]
    pos = torch.rand(n + offset, device=dev)[offset:]
    alpha = fu.adam_alpha(torch.full((1,), 3.0, device=dev), 1e-3)
    cases = [
        (lambda s: fu.sgd_update(*s, agg, 0.05, 0.9),
         lambda s: fu.sgd_update_reference(*s, agg, 0.05, 0.9),
         (store, mom), 1e-6),
        (lambda s: fu.adagrad_update(*s, agg, 0.05),
         lambda s: fu.adagrad_update_reference(*s, agg, 0.05),
         (store, pos), 1e-6),
        (lambda s: fu.adam_update(*s, agg, torch.full((1,), 3.0,
                                                      device=dev)),
         lambda s: fu.adam_update_reference(*s, agg, alpha),
         (store, 0.1 * mom, 0.01 * pos), 1e-5),
    ]
    for kfn, pfn, state, rtol in cases:
        sk = tuple(t.clone() for t in state)
        sp = tuple(t.clone() for t in state)
        kfn(sk)
        pfn(sp)
        torch.cuda.synchronize()
        for a, b in zip(sk, sp):
            torch.testing.assert_close(a, b, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("handle", ["sum", "sgd:0.05", "adam:1e-3"])
def test_cuda_engine_matches_cpu_engine(dev, handle):
    keys = np.arange(16, dtype=np.uint64)
    engines = [CollectiveEngine(DeviceGroup(8, device=d),
                                server_handle=handle, impl="ring")
               for d in (dev, "cpu")]
    for e in engines:
        e.register_dense("b", keys, 1000)
    for step in range(3):
        g = np.random.RandomState(step).randn(8, 16_000).astype(np.float32)
        got, want = (e.push_pull("b", g) for e in engines)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def test_readme_snippet_on_the_card(dev, monkeypatch):
    """README's snippet: start_ps() with DMLC_ROLE=worker and
    PS_VAN_TYPE=ici takes default_group() (one rank per visible card)
    and a broadcast bucket."""
    import pslite_tpu_torch as ps

    monkeypatch.setenv("DMLC_ROLE", "worker")
    monkeypatch.setenv("PS_VAN_TYPE", "ici")
    ps.start_ps()
    try:
        worker = ps.KVWorker(0, 0)
        assert worker.engine.device.type == "cuda"
        ranks = worker.engine.num_shards
        assert ranks == torch.cuda.device_count()
        keys = np.arange(40, dtype=np.uint64)
        worker.register_dense("grads", keys, val_len=256_000)
        grads = np.ones(40 * 256_000, np.float32)
        outs = np.zeros_like(grads)
        worker.wait(worker.push_pull(keys, grads, outs))
        np.testing.assert_array_equal(outs, np.full_like(grads, ranks))
        worker.stop()
    finally:
        ps.finalize()


def _fixed_ring_sum(grads, store, split):
    """The 1-D ring sum's plain formula from before the kv-shard
    geometry existed (per chunk, direction 0 sums ranks c+1..c, direction
    1 sums c-1..c), kept here as a fixed oracle for the generalized
    kernel."""
    n, padded = grads.shape
    chunk0 = padded // n
    g = grads.view(n, n, chunk0)
    ar = torch.arange(n, device=grads.device)
    summed = torch.empty((n, chunk0), dtype=store.dtype, device=store.device)
    for lo, hi, step in ((0, min(split, chunk0), 1), (split, chunk0, n - 1)):
        if lo >= hi:
            continue
        acc = g[(ar + step) % n, ar, lo:hi]
        for k in range(2, n + 1):
            acc += g[(ar + k * step) % n, ar, lo:hi]
        summed[:, lo:hi] = acc
    return store + summed.view(-1)


@pytest.mark.parametrize("n,padded", _SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_1d_ring_bits_unchanged_by_the_geometry(dev, n, padded, dtype):
    grads = _randn((n, padded), 11, dev).to(dtype)
    store = _randn((padded,), 12, dev).to(dtype)
    split = ring.ring_geometry(n, padded, dtype).split
    want = _fixed_ring_sum(grads, store, split)
    got = ring.ring_push_pull(grads, store.clone(), "sum")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (A, padded, kv_shards): the main path's (dp=4, kv=2) layout; shards of
# 6,196 over sub-chunks of 2,048 (the last one short, the padding at the
# shard's end); 3 x 700 values over kv 2 (one short sub-chunk per shard,
# odd shard length: the scalar kernel); shards that are not a multiple of
# the vector width.
_SHAPES_2D = [(4, 10_240_000, 2), (4, 2 * 6196, 2), (4, 2100, 2),
              (2, 8 * 1001, 4)]


@pytest.mark.parametrize("a,padded,kv", _SHAPES_2D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ag", [True, False])
def test_2d_ring_kernel_bit_exact(dev, a, padded, kv, dtype, with_ag):
    grads = _randn((a, padded), 13, dev).to(dtype)
    store = _randn((padded,), 14, dev).to(dtype)
    for handle in ("sum", "assign"):
        sk, sp = store.clone(), store.clone()
        if with_ag:
            outk = ring.ring_push_pull(grads, sk, handle, kv_shards=kv)
            outp = ring.ring_push_pull_reference(grads, sp, handle,
                                                 kv_shards=kv)
            assert torch.equal(outk, outp)
        else:
            ring.ring_push(grads, sk, handle, kv_shards=kv)
            ring.ring_push_reference(grads, sp, handle, kv_shards=kv)
        torch.cuda.synchronize()
        assert torch.equal(sk, sp), handle


# (n, padded, bidir, kv_shards): the main path (8 ranks, and dp=4 x kv=2),
# the one-direction ring at n = 2, a bucket smaller than the int8 tile, a
# chunk that is not a multiple of the vector width (the scalar kernel),
# 2-D sub-rings with a short last sub-chunk, with the whole shard in one
# region, and with an odd shard length; and n = 2 over the main path's
# bucket, 1-D and 2-D, whose regions spill out of a cluster's shared
# memory into scratch.
_INT8_CASES = [(8, 10_240_000, True, None), (4, 10_240_000, True, 2),
               (2, 2 * 8192, False, None), (8, 8 * 100, True, None),
               (3, 3 * 1001, True, None), (4, 2 * 24676, True, 2),
               (2, 8192, True, 4), (4, 2100, True, 2),
               (2, 10_240_000, True, None), (2, 10_240_000, True, 2)]


def _int8_check(grads, store, kw, with_ag, run):
    """``run(grads, store, pulled)`` against the plain version: 0
    elements may differ, for the sum and assign handles."""
    for handle in ("sum", "assign"):
        sk, sp = store.clone(), store.clone()
        outk = torch.empty_like(store) if with_ag else None
        run(grads, sk, outk, handle)
        if with_ag:
            outp = ring.ring_push_pull_reference(grads, sp, handle, **kw)
        else:
            ring.ring_push_reference(grads, sp, handle, **kw)
        torch.cuda.synchronize()
        assert int((sk != sp).sum()) == 0, handle
        if with_ag:
            assert int((outk != outp).sum()) == 0, handle
            if kw["kv_shards"] is not None:
                assert torch.equal(sk, outk)  # 2-D: the store takes pulled


@pytest.mark.parametrize("n,padded,bidir,kv", _INT8_CASES)
@pytest.mark.parametrize("with_ag", [True, False])
def test_int8_ring_kernel_bit_exact(dev, n, padded, bidir, kv, with_ag):
    kw = dict(bidir=bidir, compress=True, kv_shards=kv)

    def run(g, s, out, handle):
        if with_ag:
            out.copy_(ring.ring_push_pull(g, s, handle, **kw))
        else:
            ring.ring_push(g, s, handle, **kw)

    _int8_check(_randn((n, padded), 15, dev), _randn((padded,), 16, dev),
                kw, with_ag, run)


@pytest.mark.parametrize("n,padded,bidir,kv", _INT8_CASES)
@pytest.mark.parametrize("with_ag", [True, False])
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_int8_ring_cluster_sizes(dev, n, padded, bidir, kv, with_ag,
                                 cluster):
    """Both ends of the launcher's range and the sizes the grouped launch
    takes, through the C entry, whichever size the launcher picks for the
    shape."""
    geo = ring.ring_geometry(n, padded, torch.float32, bidir, True, kv)
    _, active = ring._launch_shape(((geo, padded),), dev.index or 0)
    assert active[cluster] > 0, f"the card runs no cluster of {cluster}"
    kw = dict(bidir=bidir, compress=True, kv_shards=kv)

    def run(g, s, out, handle):
        code, lr = ring.ring_handle(handle)
        ring._launch_int8([g], [s], [out], [geo], code, lr, with_ag, cluster)

    _int8_check(_randn((n, padded), 21, dev), _randn((padded,), 22, dev),
                kw, with_ag, run)


@pytest.mark.parametrize("n,padded,bidir,kv", [
    (2, 10_240_000, True, None),  # n = 2: 4 regions of 2,560,000 (spill)
    (3, 3 * 1001, True, None),  # odd regions: the scalar walk
    (4, 2 * 24676, True, 2),  # 2-D, a short last sub-chunk
])
@pytest.mark.parametrize("with_ag", [True, False])
def test_int8_every_launch_shape(dev, n, padded, bidir, kv, with_ag):
    """Every ``(cluster, groups)`` the card runs for the bucket, forced
    through the C entry: region groups (G clusters meeting each hop's
    scale in global memory) and one cluster per region, each with 0
    elements off the plain version."""
    geo = ring.ring_geometry(n, padded, torch.float32, bidir, True, kv)
    layout = ((geo, padded),)
    _, active = ring._launch_shape(layout, dev.index or 0)
    shapes = ring.int8_shapes(len(ring.int8_group_regions(layout)), active)
    assert any(g > 1 for _, g in shapes), active
    grads, store = _randn((n, padded), 23, dev), _randn((padded,), 24, dev)
    kw = dict(bidir=bidir, compress=True, kv_shards=kv)
    sp = store.clone()
    outp = (ring.ring_push_pull_reference if with_ag
            else ring.ring_push_reference)(grads, sp, "sum", **kw)
    for shape in shapes:
        sk = store.clone()
        outk = torch.empty_like(sk) if with_ag else None
        ring._launch_int8([grads], [sk], [outk], [geo], 0, 0.0, with_ag,
                          shape)
        torch.cuda.synchronize()
        assert int((sk != sp).sum()) == 0, shape
        if with_ag:
            assert int((outk != outp).sum()) == 0, shape


def test_int8_region_group_graph_replays_alike(dev):
    """A CUDA graph of 20 region-group launches, replayed twice from the
    same store, gives the same bits both times, and those of 20 launches
    of one cluster per region: each launch leaves its exchange words
    zeroed for the next (a captured launch keeps its parameters)."""
    n, padded = 4, 4 * 4096
    grads, store = _randn((n, padded), 25, dev), _randn((padded,), 26, dev)
    geo = ring.ring_geometry(n, padded, torch.float32, True, True)
    sk, out = store.clone(), torch.empty_like(store)
    for shape in ((2, 4), (1, 8)):
        def step():
            ring._launch_int8([grads], [sk], [out], [geo], 0, 0.0, True,
                              shape)

        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            step()  # the stream's exchange words exist before the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(20):
                step()
        got = []
        for _ in range(2):
            sk.copy_(store)
            graph.replay()
            torch.cuda.synchronize()
            got.append((sk.clone(), out.clone()))
        sk.copy_(store)
        for _ in range(20):
            ring._launch_int8([grads], [sk], [out], [geo], 0, 0.0, True, 1)
        torch.cuda.synchronize()
        for a, b in got:
            assert torch.equal(a, sk) and torch.equal(b, out), shape
        del graph


def test_int8_region_groups_on_two_streams_at_once(dev):
    """Region-group launches of one shape on two streams at once: each
    stream has exchange words of its own, so neither reads the other's
    slots or counts, and both give the bits of one cluster per region."""
    n, padded = 4, 4 * 4096
    geo = ring.ring_geometry(n, padded, torch.float32, True, True)
    grads = [_randn((n, padded), 41 + i, dev) for i in range(2)]
    stores = [_randn((padded,), 43 + i, dev) for i in range(2)]
    want = []
    for g, s in zip(grads, stores):
        sk, out = s.clone(), torch.empty_like(s)
        for _ in range(10):
            ring._launch_int8([g], [sk], [out], [geo], 0, 0.0, True, 1)
        want.append((sk, out))
    got = [(s.clone(), torch.empty_like(s)) for s in stores]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(10):
        for st, g, (sk, out) in zip(streams, grads, got):
            with torch.cuda.stream(st):
                ring._launch_int8([g], [sk], [out], [geo], 0, 0.0, True,
                                  (2, 2))
    torch.cuda.synchronize()
    used = {k[2] for k in ring._EXCHANGE}
    assert {st.cuda_stream for st in streams} <= used
    for (a, b), (c, d) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, d)


def test_a_region_group_too_large_for_the_card_is_refused(dev):
    """A group whose clusters would not all be resident at once is
    refused by the C entry (the clusters would wait for one another
    forever), and nothing runs."""
    n, padded = 8, 10_240_000
    geo = ring.ring_geometry(n, padded, torch.float32, True, True)
    _, active = ring._launch_shape(((geo, padded),), dev.index or 0)
    grads, store = _randn((n, padded), 27, dev), _randn((padded,), 28, dev)
    sk = store.clone()
    too_many = active[2] // 16 + 1  # 16 regions
    with pytest.raises(RuntimeError):
        ring._launch_int8([grads], [sk], [None], [geo], 0, 0.0, False,
                          (2, too_many))
    torch.cuda.synchronize()
    assert torch.equal(sk, store)


def test_int8_ring_main_path_launch_shape(dev):
    """At the main path's shapes the launcher allocates no scratch and
    needs no more waves than 16-CTA clusters would."""
    for n, kv in ((8, None), (4, 2)):
        shape = ring.int8_launch_shape(n, 10_240_000, kv_shards=kv,
                                       device=dev)
        waves16 = -(-shape["nregions"] // shape["max_active_clusters"][16])
        assert shape["scratch"] == 0 and shape["waves"] <= waves16, shape


def test_int8_ring_kernel_sgd(dev):
    grads = _randn((4, 4 * 8192), 17, dev)
    store = _randn((4 * 8192,), 18, dev)
    sk, sp = store.clone(), store.clone()
    outk = ring.ring_push_pull(grads, sk, "sgd:0.05", compress=True)
    outp = ring.ring_push_pull_reference(grads, sp, "sgd:0.05",
                                         compress=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=1e-6)
    # A last-bit difference in the store can move a region's scale, so
    # the pulled values agree to within one quantization step.
    step = store.abs().max() / 127 * 2
    assert float((outk - outp).abs().max()) <= float(step)


def test_ring_variants_count_launches(dev):
    ring.reset_launches()
    g = _randn((4, 8192), 19, dev)
    s = torch.zeros(8192, device=dev)
    ring.ring_push_pull(g, s, compress=True)
    ring.ring_push(g, s, compress=True)
    ring.ring_push_pull(g, s, kv_shards=2)
    ring.ring_push_pull(g, s, compress=True, kv_shards=2)
    assert ring.launches["ring_push_pull_int8[float32]"] == 1
    assert ring.launches["ring_push_int8[float32]"] == 1
    assert ring.launches["ring_push_pull_2d[float32]"] == 1
    assert ring.launches["ring_push_pull_2d_int8[float32]"] == 1
    assert sum(ring.launches.values()) == 4


@pytest.mark.parametrize("n", [10_240_000, 100_003, 1001])
@pytest.mark.parametrize("offset", [0, 1])
def test_quantize_kernels_bit_exact(dev, n, offset):
    """Aligned and (offset 1) unaligned inputs, ragged lengths, all three
    scale forms; unaligned codes and scales too."""
    x = (_randn((n + offset,), 20, dev) * 10)[offset:]
    qk, sk = qz.quantize_int8(x)
    qp, sp = qz.quantize_int8_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(qk, qp) and torch.equal(sk, sp)
    for scales in (sk, sk[:, 0].contiguous(), sk[:, :1]):
        outk = qz.dequantize_int8(qk, scales, n)
        outp = qz.dequantize_int8_reference(qk, scales, n)
        torch.cuda.synchronize()
        assert torch.equal(outk, outp)
    if offset:  # codes and scales starting inside a row
        qu = torch.cat([qk.view(-1)[:1], qk.view(-1)])[1:].view_as(qk)
        su = torch.cat([sk.view(-1)[:1], sk.view(-1)])[1:].view_as(sk)
        assert qu.data_ptr() % 4 and su.data_ptr() % 16
        assert torch.equal(qz.dequantize_int8(qu, su, n),
                           qz.dequantize_int8_reference(qk, sk, n))


def test_quantize_counts_launches(dev):
    qz.reset_launches()
    q, s = qz.quantize_int8(torch.ones(5000, device=dev))
    qz.dequantize_int8(q, s, 5000)
    qz.dequantize_int8(q, s[:, 0], 5000)
    assert qz.launches == {"quantize_int8": 1, "dequantize_int8": 1,
                           "dequantize_int8[compact]": 1}


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("shape", [None, (4, 2)])
def test_cuda_engine_matches_cpu_engine_2d_and_int8(dev, compress, shape):
    keys = np.arange(16, dtype=np.uint64)
    engines = []
    for d in (dev, "cpu"):
        if shape is None:
            grp, waxis = DeviceGroup(8, device=d), None
        else:
            grp, waxis = make_group(shape, ("dp", "kv"), device=d), "dp"
        engines.append(CollectiveEngine(grp, impl="ring", worker_axis=waxis,
                                        wire_compress=compress))
    for e in engines:
        e.register_dense("b", keys, 1000)
    rows = engines[0].num_workers
    for step in range(3):
        g = np.random.RandomState(step).randn(rows, 16_000).astype(
            np.float32)
        got, want = (e.push_pull("b", g) for e in engines)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    torch.testing.assert_close(engines[0].pull("b").cpu(),
                               engines[1].pull("b"), rtol=0, atol=0)


# -- grouped launch, replay and streams -------------------------------------------

def _group_case(dev, n, pads, dtype, seed, offset=0):
    """Grads and stores of a group; ``offset`` 1 places every tensor one
    element past a 16-byte boundary (the scalar path)."""
    def place(t):
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        return buf[offset:].view(t.shape).copy_(t)

    grads = [place(_randn((n, p), seed + i, dev).to(dtype))
             for i, p in enumerate(pads)]
    stores = [place(_randn((p,), seed + 100 + i, dev).to(dtype))
              for i, p in enumerate(pads)]
    return grads, stores


# (n, pads, kv, compress): the ResNet-50 trace's 36 buckets (8 ranks;
# dp=4 x kv=2 with its padding to 2), odd and tiny buckets, and 60 buckets,
# more than one launch's table of 48.
_TRACE = [1024 * (1 + i % 7) + 8 * i for i in range(36)]
_GROUP_CASES = [(8, _TRACE, None, False), (4, [2 * -(-p // 2) for p in
                                                _TRACE], 2, False),
                (3, [3 * 1001, 3 * 5, 3 * 4096, 3 * 77], None, False),
                (4, [4 * (37 + i) for i in range(60)], None, False),
                (4, [2 * (37 + i) for i in range(60)], 2, False),
                (8, _TRACE[:6], None, True), (4, [2 * 700, 2 * 9], 2, True)]


@pytest.mark.parametrize("n,pads,kv,compress,dtype", [
    (*case, dt) for case in _GROUP_CASES
    for dt in (torch.float32, torch.bfloat16, torch.float16)
    if not case[3] or dt == torch.float32])  # int8 takes float32 only
@pytest.mark.parametrize("offset", [0, 1])
def test_group_kernel_bit_exact(dev, n, pads, kv, compress, dtype, offset):
    """The grouped launch against its plain version and against single
    launches: 0 differing elements (sum and assign)."""
    grads, stores = _group_case(dev, n, pads, dtype, 30, offset)
    kw = dict(compress=compress, kv_shards=kv)
    for handle in ("sum", "assign"):
        sk, sp, s1 = ([s.clone() for s in stores] for _ in range(3))
        ring.reset_launches()
        outk = ring.ring_push_pull_group(grads, sk, handle, **kw)
        made = sum(ring.launches.values())
        outp = ring.ring_push_pull_group_reference(grads, sp, handle, **kw)
        out1 = [ring.ring_push_pull(g, s, handle, **kw)
                for g, s in zip(grads, s1)]
        torch.cuda.synchronize()
        for a, b, c in zip(outk, outp, out1):
            assert torch.equal(a, b) and torch.equal(a, c), handle
        for a, b, c in zip(sk, sp, s1):
            assert torch.equal(a, b) and torch.equal(a, c), handle
        assert made == -(-len(pads) // 48)


def test_group_kernel_sgd_matches_single_launches(dev):
    """sgd:lr: bit-identical to the single launches (the same FMA), and
    within rtol/atol 1e-6 of the plain version."""
    grads, stores = _group_case(dev, 8, _TRACE[:8], torch.float32, 40)
    sk, sp, s1 = ([s.clone() for s in stores] for _ in range(3))
    outk = ring.ring_push_pull_group(grads, sk, "sgd:0.05")
    outp = ring.ring_push_pull_group_reference(grads, sp, "sgd:0.05")
    out1 = [ring.ring_push_pull(g, s, "sgd:0.05") for g, s in zip(grads, s1)]
    torch.cuda.synchronize()
    for a, b, c in zip(outk, outp, out1):
        assert torch.equal(a, c)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# -- the grouped int8 launch ----------------------------------------------------

def _trace_pads(shards):
    return [-(-m // shards) * shards for _, m in rt.make_buckets()]


def _int8_group_check(grads, stores, kv, handle="sum", cluster=None):
    """The grouped int8 launch against its plain version and against the
    buckets' single launches: 0 differing elements.  ``cluster`` forces
    the launch's cluster size (through the launcher).  Returns the
    launches made."""
    kw = dict(compress=True, kv_shards=kv)
    sk, sp, s1 = ([s.clone() for s in stores] for _ in range(3))
    ring.reset_launches()
    if cluster is None:
        outk = ring.ring_push_pull_group(grads, sk, handle, **kw)
    else:
        geos = [ring.ring_geometry(g.shape[0], s.numel(), torch.float32,
                                   True, True, kv) for g, s in zip(grads, sk)]
        outk = [torch.empty_like(s) for s in sk]
        code, lr = ring.ring_handle(handle)
        ring.launches["ring_push_pull_group_int8[float32]"] += (
            ring._launch_int8(grads, sk, outk, geos, code, lr, True,
                              cluster))
    made = sum(ring.launches.values())
    outp = ring.ring_push_pull_group_reference(grads, sp, handle, **kw)
    out1 = [ring.ring_push_pull(g, s, handle, **kw) if s.numel()
            else torch.empty_like(s) for g, s in zip(grads, s1)]
    torch.cuda.synchronize()
    for a, b, c in zip(outk, outp, out1):
        assert a.shape == b.shape
        assert int((a != b).sum()) == 0 and int((a != c).sum()) == 0
    for a, b, c in zip(sk, sp, s1):
        assert int((a != b).sum()) == 0 and int((a != c).sum()) == 0
    return made


@pytest.mark.parametrize("n,kv", [(8, None), (4, 2)])
def test_int8_group_trace_one_launch(dev, n, kv):
    """The ResNet-50 trace's 36 buckets (1-D at 8 ranks; the dp=4 x kv=2
    sub-rings): one launch, bit-identical to the plain version and to 36
    single launches."""
    grads, stores = _group_case(dev, n, _trace_pads(kv or n),
                                torch.float32, 60)
    assert _int8_group_check(grads, stores, kv) == 1
    key = "ring_push_pull_group_2d_int8[float32]" if kv else \
        "ring_push_pull_group_int8[float32]"
    assert ring.launches[key] == 1


def test_int8_group_every_cluster_size(dev):
    """Every candidate cluster size the card runs, forced on the trace's
    group (C = 1 spills its 65,536-value regions)."""
    pads = _trace_pads(8)
    grads, stores = _group_case(dev, 8, pads, torch.float32, 61)
    layout = ring.int8_layout(8, pads)
    _, active = ring._launch_shape(layout, dev.index or 0)
    sizes = [c for c in ring.INT8_CLUSTERS if active[c] > 0]
    assert 1 in sizes and 16 in sizes, active
    for c in sizes:
        assert _int8_group_check(grads, stores, None, cluster=c) == 1, c


@pytest.mark.parametrize("n,pads,kv", [
    (3, [3 * 1001, 3 * 5, 0, 3 * 4096, 3 * 77], None),  # odd, tiny, empty
    (2, [2 * 4_000_000, 2 * 1000, 2 * 4096], None),  # the longest spills
    (4, [2 * 700, 2 * 9, 2 * 24676, 0], 2),  # 2-D odd shard lengths
])
def test_int8_group_odd_shapes(dev, n, pads, kv):
    grads, stores = _group_case(dev, n, pads, torch.float32, 62)
    assert _int8_group_check(grads, stores, kv) == 1


def test_int8_group_misaligned_bucket_in_an_aligned_group(dev):
    """One bucket one element past a 16-byte boundary takes the scalar
    walk inside the launch; the others keep float4."""
    pads = _trace_pads(8)[:8]
    grads, stores = _group_case(dev, 8, pads, torch.float32, 63)
    bad_g, bad_s = _group_case(dev, 8, pads[3:4], torch.float32, 64,
                               offset=1)
    grads[3], stores[3] = bad_g[0], bad_s[0]
    assert stores[3].data_ptr() % 16 and grads[3].data_ptr() % 16
    assert _int8_group_check(grads, stores, None) == 1


def test_int8_group_longer_than_one_table(dev):
    """60 buckets: two launches (48 + 12), one count per launch."""
    pads = [4 * (37 + 64 * i) for i in range(60)]
    grads, stores = _group_case(dev, 4, pads, torch.float32, 65)
    assert _int8_group_check(grads, stores, None) == 2
    assert ring.launches["ring_push_pull_group_int8[float32]"] == 2


def test_int8_group_sgd(dev):
    """sgd:lr: bit-identical to the single launches (the same FMA); the
    store within rtol/atol 1e-6 of the plain version and the pulled
    values within one quantization step."""
    pads = _trace_pads(8)[:6]
    grads, stores = _group_case(dev, 8, pads, torch.float32, 66)
    kw = dict(compress=True)
    sk, sp, s1 = ([s.clone() for s in stores] for _ in range(3))
    outk = ring.ring_push_pull_group(grads, sk, "sgd:0.05", **kw)
    outp = ring.ring_push_pull_group_reference(grads, sp, "sgd:0.05", **kw)
    out1 = [ring.ring_push_pull(g, s, "sgd:0.05", **kw)
            for g, s in zip(grads, s1)]
    torch.cuda.synchronize()
    for a, b, c, s in zip(outk, outp, out1, stores):
        assert torch.equal(a, c)
        assert float((a - b).abs().max()) <= float(s.abs().max() / 127 * 2)
    for a, b, c in zip(sk, sp, s1):
        assert torch.equal(a, c)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("keep", ["all", "last"])
@pytest.mark.parametrize("n,padded,kv", [(8, 10_240_000, None),
                                         (3, 3 * 1001, None),
                                         (4, 2 * 6196, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_kernel_equals_single_launches(dev, keep, n, padded, kv,
                                              dtype):
    grads = _randn((4, n, padded), 50, dev).to(dtype)
    store = _randn((padded,), 51, dev).to(dtype)
    sk, s1 = store.clone(), store.clone()
    ring.reset_launches()
    out = ring.ring_replay(grads, sk, "sum", kv_shards=kv, keep=keep)
    assert sum(ring.launches.values()) == 1
    single = ring.ring_push_pull if keep == "all" else ring.ring_push
    seq = [single(grads[t], s1, "sum", kv_shards=kv) for t in range(4)]
    torch.cuda.synchronize()
    assert torch.equal(sk, s1)
    if keep == "all":
        assert torch.equal(out, torch.stack(seq))


@pytest.mark.parametrize("impl,handle", [("ring", "sum"), ("torch", "sum"),
                                         ("ring", "adam:1e-3")])
def test_engine_replay_equals_sequential_on_the_card(dev, impl, handle):
    engines = [CollectiveEngine(DeviceGroup(8, device=dev), impl=impl,
                                server_handle=handle) for _ in range(2)]
    for e in engines:
        e.register_dense("b", np.arange(16, dtype=np.uint64), 1000)
    seq = np.random.RandomState(9).randn(3, 8, 16_000).astype(np.float32)
    got = engines[0].replay("b", seq)
    want = torch.stack([engines[1].push_pull("b", g) for g in seq])
    assert torch.equal(got, want)


def test_stream_on_the_card(dev):
    """Host grads staged through pinned buffers on the copy stream: the
    results equal sequential push_pulls, a tensor already on the card
    passes through, and the pinned ring holds depth + 2 buffers."""
    from pslite_tpu_torch.parallel.engine import _HostStager

    engines = [CollectiveEngine(DeviceGroup(8, device=dev), impl="ring")
               for _ in range(2)]
    for e in engines:
        e.register_dense("s", np.arange(40, dtype=np.uint64), 25_600)
    host = [np.random.RandomState(i).randn(8, 1_024_000).astype(np.float32)
            for i in range(6)]
    host[3] = torch.from_numpy(host[3]).to(dev)
    got = [o.clone() for o in engines[0].push_pull_stream("s", iter(host),
                                                          depth=2)]
    want = [engines[1].push_pull("s", h) for h in host]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    stager = _HostStager(dev, 2)
    staged, event = stager.stage(host[0], torch.float32)
    event.synchronize()
    assert torch.equal(staged.cpu(), torch.from_numpy(host[0]))
    assert len(stager._slots) == 4 and stager._slots[0][0].is_pinned()


def test_zero_copy_and_pinned_pulls_on_the_card(dev):
    """Live handles alias the store (the registered buffer) on the card;
    the bucket's next op (next pull) makes them stale."""
    eng = CollectiveEngine(DeviceGroup(1, device=dev))
    eng.register_dense("z", np.arange(2, dtype=np.uint64), 64)
    out = eng.push_pull("z", np.ones((1, 128), np.float32), zero_copy=True)
    assert out.data_ptr() == eng._stores["z"].data_ptr()
    assert torch.equal(out.cpu(), torch.ones(128))
    eng.push("z", np.ones((1, 128), np.float32))
    assert out.is_deleted()
    with pytest.raises(RuntimeError, match="stale"):
        out.cpu()
    eng8 = CollectiveEngine(DeviceGroup(8, device=dev), impl="ring")
    eng8.register_dense("p", np.arange(3, dtype=np.uint64), 33)
    addr = eng8.register_pull_buffer("p").data_ptr()
    prev = None
    for k in (1, 2):
        eng8.push("p", np.ones(99, np.float32))
        p = eng8.pull("p")
        assert p.data_ptr() == addr
        assert torch.equal(p[:99].cpu(), torch.full((99,), 8.0 * k))
        if prev is not None:
            assert prev.is_deleted()
        prev = p


# -- sparse tables: S1-S3 (csrc/sparse_rows.cu) -------------------------------
# Sum push and pull equal their plain versions with 0 differing elements
# (one order of addition, one rounding per add); row_adagrad within rtol
# 1e-5 / atol 1e-6 (the order of the row's sum of squares).

# (S, rps, dim, W, n): config 5 (1,048,576 rows x 64 over 8 shards, 8 x
# 4,096 Zipf rows), small, pack-64 and ragged widths, column tiles; 80,000
# updates, above the 65,536 the sort's cluster holds in shared memory (its
# tile loop in device memory); and 2^22 rows, keys of 23 bits (three radix
# digits).
_SPARSE = [(8, 131_072, 64, 8, 4096), (8, 64, 2, 8, 40), (8, 16, 8, 8, 50),
           (4, 10, 300, 4, 30), (1, 50, 33, 1, 80), (8, 5, 256, 8, 12),
           (8, 4096, 16, 8, 10_000), (8, 524_288, 4, 8, 512)]


def _sparse_case(dev, S, rps, dim, W, n, dtype=torch.float32, seed=0):
    from pslite_tpu_torch.models.embedding import skewed_indices

    rng = np.random.default_rng(seed)
    idx = skewed_indices(S * rps, W, n, seed=seed).reshape(-1)
    idx[rng.choice(idx.size, 4, replace=False)] = [-1, S * rps,
                                                   S * rps + 9, -5]
    idx = torch.from_numpy(idx.reshape(W, n)).to(dev)
    rows = _randn((W, n, dim), seed + 1, dev).to(dtype)
    store = _randn((S * rps, dim), seed + 2, dev).to(dtype)
    return store, idx, rows


@pytest.mark.parametrize("S,rps,dim,W,n", _SPARSE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_kernels_match_plain(dev, S, rps, dim, W, n, dtype):
    from pslite_tpu_torch.ops import sparse_rows as sr

    store, idx, rows = _sparse_case(dev, S, rps, dim, W, n, dtype)
    sr.reset_launches()
    got = sr.scatter_add(store.clone(), idx, rows, S, rps)
    want = sr.scatter_add_reference(store.clone(), idx, rows, S, rps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    out = sr.gather_rows(got, idx, S, rps)
    assert torch.equal(out, sr.gather_rows_reference(got, idx, S, rps))
    acc = torch.rand(S * rps, device=dev)
    gs, ga = sr.row_adagrad(store.clone(), acc.clone(), idx, rows, S, rps,
                            0.05, 1e-8)
    ws, wa = sr.row_adagrad_reference(store.clone(), acc.clone(), idx, rows,
                                      S, rps, 0.05, 1e-8)
    torch.cuda.synchronize()
    torch.testing.assert_close(ga, wa, rtol=1e-5, atol=1e-6)
    if dtype == torch.float32:
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-6)
    else:  # a step one f32 ulp apart may round to another bf16 value
        torch.testing.assert_close(gs.float(), ws.float(), rtol=1e-2,
                                   atol=1e-2)
    assert {k: sr.launches[k] for k in ("sparse_scatter_add",
                                        "sparse_row_adagrad",
                                        "sparse_gather_rows")} == {
        "sparse_scatter_add": 1, "sparse_row_adagrad": 1,
        "sparse_gather_rows": 1}


def test_sparse_kernels_are_deterministic(dev):
    """Config 5's hot row (6,029 updates) adds in one fixed order: two
    pushes from one store agree bit for bit."""
    from pslite_tpu_torch.ops import sparse_rows as sr

    store, idx, rows = _sparse_case(dev, *_SPARSE[0])
    a = sr.scatter_add(store.clone(), idx, rows, 8, 131_072)
    b = sr.scatter_add(store.clone(), idx, rows, 8, 131_072)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_sparse_engine_on_the_card_matches_the_cpu(dev):
    """SparseEngine on the card and on a CPU group: sum push and pull
    bit-exact, row_adagrad and groups within the Adagrad bar."""
    from pslite_tpu_torch import SparseEngine

    engines = [SparseEngine(DeviceGroup(8, device=d)) for d in (dev, "cpu")]
    rng = np.random.default_rng(3)
    for e in engines:
        e.register_sparse("a", 1000, 64)
        e.register_sparse("b", 77, 4)
    for step in range(3):
        ia = rng.integers(0, 1000, size=(8, 300)).astype(np.int32)
        ia[:, :40] = 7
        ga = rng.normal(size=(8, 300, 64)).astype(np.float32)
        ib = rng.integers(0, 77, size=(8, 9)).astype(np.int32)
        gb = rng.normal(size=(8, 9, 4)).astype(np.float32)
        handle = None if step < 2 else "row_adagrad:0.01,1e-8"
        for e in engines:
            e.push("a", ia, ga, handle=handle)
            e.push_group(["b", "a"], [ib, ia], [gb, ga], handle=handle)
        got, want = (e.pull("a", ia) for e in engines)
        if handle is None:
            assert torch.equal(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                       atol=1e-6)
    gb_, wb_ = (e.pull_group(["b"], [ib])[0] for e in engines)
    torch.testing.assert_close(gb_.cpu(), wb_, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_push_takes_unaligned_rows(dev, dtype):
    """Update rows in a contiguous view that starts one element into its
    allocation: the push reads them one value at a time, same bits."""
    from pslite_tpu_torch.ops import sparse_rows as sr

    store, idx, _ = _sparse_case(dev, 8, 64, 64, 8, 300, dtype)
    rows = _randn((8 * 300 * 64 + 1,), 9, dev).to(dtype)[1:].view(8, 300, 64)
    assert rows.data_ptr() % 16
    got = sr.scatter_add(store.clone(), idx, rows, 8, 64)
    want = sr.scatter_add_reference(store.clone(), idx, rows, 8, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_sparse_push_is_three_launches_without_a_library_sort(dev,
                                                             monkeypatch):
    """Each push calls the sort's C entry once and then its own (the long
    runs and, beside them, the short runs): three kernels on the card, and
    no torch.sort or argsort on the way."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pslite_tpu_torch.ops import _native
    from pslite_tpu_torch.ops import sparse_rows as sr

    store, idx, rows = _sparse_case(dev, *_SPARSE[0])
    acc = torch.rand(store.shape[0], device=dev)
    calls = []
    real = _native.call
    monkeypatch.setattr(_native, "call",
                        lambda name, *a: (calls.append(name),
                                          real(name, *a))[1])

    def refuse(*args, **kwargs):
        raise AssertionError("a library sort on the kernel path")

    for owner in (torch, torch.Tensor):
        monkeypatch.setattr(owner, "sort", refuse)
        monkeypatch.setattr(owner, "argsort", refuse)
    sr.scatter_add(store, idx, rows, 8, 131_072)
    sr.row_adagrad(store, acc, idx, rows, 8, 131_072, 0.01, 1e-8)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert calls == ["pstt_sparse_sort", "pstt_sparse_scatter_add",
                     "pstt_sparse_sort", "pstt_sparse_row_adagrad"]
    # The profiler now and then returns a window without device events:
    # such a window is taken again.  It may also place a kernel's start
    # before its launch and drop a kernel that starts outside the window,
    # so the window opens and closes on idle host time (chip_smoke.py's
    # PROFILE_PADS).
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            sr.scatter_add(store, idx, rows, 8, 131_072)
            torch.cuda.synchronize()
            time.sleep(0.05)
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA]
        if names:
            break
    assert len(names) == 3, names
    for k in ("sort_kernel", "long_runs_kernel", "scatter_short_kernel"):
        assert sum(k in n for n in names) == 1, names


# -- sparse groups: every table of a push_group/pull_group in one chain ---------
# The group kernels against the per-table kernels (0 differing elements,
# row_adagrad too: each table's sum of squares adds its own CTAs' parts in
# the per-table order) and against the plain group versions (sum and pull
# 0 differing, row_adagrad rtol 1e-5 / atol 1e-6).

# (rows, dim, W, n) per table: different rows, dims 1, 3, 16, 48, 64 and
# 300 (column tiles; the long runs' clusters of 16 CTAs take 16 runs of a
# narrow table at once, 4 of dim 64, 5 of dim 48 with one CTA idle), a
# table without updates, one of 8 updates beside one of 32,768 (the sort's
# cluster of 16 CTAs, most of them without entries for the small table),
# 3-row and 10-row tables whose runs are all long.
_SPARSE_GROUP = [(1000, 64, 8, 4096), (3, 16, 8, 1024), (77, 1, 8, 9),
          (500, 3, 8, 0), (10, 300, 8, 40), (1, 16, 8, 1),
          (65_536, 16, 8, 1024), (200, 48, 8, 300)]


def _sparse_group_case(dev, spec, dtypes, seed=0):
    from pslite_tpu_torch.models.embedding import skewed_indices

    S, out = 8, []
    for t, ((rows, dim, W, n), dt) in enumerate(zip(spec, dtypes)):
        rps = -(-rows // S)
        idx = skewed_indices(rows, W, n, seed=seed + t).reshape(-1)
        if idx.size >= 8:
            idx[:4] = [-1, S * rps, S * rps + 9, -5]
        idx = torch.from_numpy(idx.reshape(W, n)).to(dev)
        g = _randn((W, n, dim), seed + 100 + t, dev).to(dt)
        store = _randn((S * rps, dim), seed + 200 + t, dev).to(dt)
        acc = torch.rand(S * rps, device=dev)
        out.append((store, acc, idx, g, rps))
    return S, out


def _sparse_group_push_pull(sr, S, tables, handle, group: bool):
    stores = [t[0].clone() for t in tables]
    accs = [t[1].clone() for t in tables]
    idxs = [t[2] for t in tables]
    gs = [t[3] for t in tables]
    rps = [t[4] for t in tables]
    if group == "plain":
        if handle:
            sr.row_adagrad_group_reference(stores, accs, idxs, gs, S, rps,
                                           0.05, 1e-8)
        else:
            sr.scatter_add_group_reference(stores, idxs, gs, S, rps)
        outs = sr.gather_rows_group_reference(stores, idxs, S, rps)
    elif group:
        if handle:
            sr.row_adagrad_group(stores, accs, idxs, gs, S, rps, 0.05, 1e-8)
        else:
            sr.scatter_add_group(stores, idxs, gs, S, rps)
        outs = sr.gather_rows_group(stores, idxs, S, rps)
    else:
        for s, a, ix, g, r in zip(stores, accs, idxs, gs, rps):
            if handle:
                sr.row_adagrad(s, a, ix, g, S, r, 0.05, 1e-8)
            else:
                sr.scatter_add(s, ix, g, S, r)
        outs = [sr.gather_rows(s, ix, S, r)
                for s, ix, r in zip(stores, idxs, rps)]
    torch.cuda.synchronize()
    return stores, accs, outs


def _assert_sparse_group(got, want, exact: bool):
    for a, b in zip(*(x[0] + x[1] + x[2] for x in (got, want))):
        if exact:
            assert torch.equal(a, b)
        elif a.dtype == torch.bfloat16:
            torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                       atol=1e-2)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("handle", [None, "row_adagrad"])
def test_sparse_group_kernels_match_per_table(dev, dtype, handle):
    """One chain for seven tables: three launches for the push and one
    for the pull, equal to the per-table kernels bit for bit and to the
    plain group versions."""
    from pslite_tpu_torch.ops import sparse_rows as sr

    S, tables = _sparse_group_case(dev, _SPARSE_GROUP, [dtype] * len(_SPARSE_GROUP))
    sr.reset_launches()
    got = _sparse_group_push_pull(sr, S, tables, handle, True)
    counter = ("sparse_row_adagrad_group" if handle
               else "sparse_scatter_add_group")
    assert sr.launches[counter] == 3
    assert sr.launches["sparse_gather_rows_group"] == 1
    _assert_sparse_group(got, _sparse_group_push_pull(sr, S, tables, handle, False), True)
    _assert_sparse_group(got, _sparse_group_push_pull(sr, S, tables, handle, "plain"),
                  handle is None)


@pytest.mark.parametrize("handle", [None, "row_adagrad"])
def test_sparse_group_mixed_dims(dev, handle):
    """Group (b) of chip_smoke.py: config 5's table (1,048,576 x 64) and
    the DLRM table (1,048,576 x 16) in one group, 8 x 4,096 Zipf rows
    each: the long runs' clusters sized for dim 64, the dim-16 runs on
    their first CTA."""
    from pslite_tpu_torch.ops import sparse_rows as sr

    spec = [(1 << 20, 64, 8, 4096), (1 << 20, 16, 8, 4096)]
    S, tables = _sparse_group_case(dev, spec, [torch.float32] * 2, seed=5)
    got = _sparse_group_push_pull(sr, S, tables, handle, True)
    _assert_sparse_group(got, _sparse_group_push_pull(sr, S, tables, handle, False), True)
    _assert_sparse_group(got, _sparse_group_push_pull(sr, S, tables, handle, "plain"),
                  handle is None)


@pytest.mark.parametrize("handle", [None, "row_adagrad"])
def test_sparse_group_dtype_split(dev, handle):
    """An f32 and a bf16 table: one chain per dtype (six launches for the
    push), one pull launch; 50 tables take two chains per dtype present
    (48 tables a launch)."""
    from pslite_tpu_torch.ops import sparse_rows as sr

    spec = [(4000, 32, 8, 512), (4000, 32, 8, 512)]
    S, tables = _sparse_group_case(dev, spec, [torch.float32, torch.bfloat16], 9)
    sr.reset_launches()
    got = _sparse_group_push_pull(sr, S, tables, handle, True)
    counter = ("sparse_row_adagrad_group" if handle
               else "sparse_scatter_add_group")
    assert sr.launches[counter] == 6
    assert sr.launches["sparse_gather_rows_group"] == 1
    _assert_sparse_group(got, _sparse_group_push_pull(sr, S, tables, handle, False), True)
    many = [(50 + 3 * t, 4 + t % 5, 8, 20 + t) for t in range(50)]
    S, tables = _sparse_group_case(dev, many, [torch.float32] * 50, 11)
    sr.reset_launches()
    got = _sparse_group_push_pull(sr, S, tables, handle, True)
    assert sr.launches[counter] == 6
    assert sr.launches["sparse_gather_rows_group"] == 2
    _assert_sparse_group(got, _sparse_group_push_pull(sr, S, tables, handle, False), True)


def test_sparse_group_engine_takes_one_chain(dev):
    """SparseEngine.push_group/pull_group on the card: one chain of three
    launches and one pull launch for four tables, equal to single pushes
    and pulls on twin tables."""
    from pslite_tpu_torch import SparseEngine
    from pslite_tpu_torch.ops import sparse_rows as sr

    e = SparseEngine(DeviceGroup(8, device=dev))
    rng = np.random.default_rng(4)
    spec = [("a", 1000, 64), ("b", 3, 16), ("c", 77, 4), ("d", 20_000, 8)]
    for name, rows, dim in spec:
        for pre in ("g_", "t_"):
            e.register_sparse(pre + name, rows, dim)
    for handle in (None, "row_adagrad:0.01,1e-8"):
        idx = [rng.integers(0, r, size=(8, 300)).astype(np.int32)
               for _, r, _ in spec]
        gs = [rng.normal(size=(8, 300, d)).astype(np.float32)
              for _, _, d in spec]
        sr.reset_launches()
        e.push_group(["g_" + n for n, _, _ in spec], idx, gs, handle=handle)
        outs = e.pull_group(["g_" + n for n, _, _ in spec], idx)
        counter = ("sparse_row_adagrad_group" if handle
                   else "sparse_scatter_add_group")
        assert sr.launches[counter] == 3
        assert sr.launches["sparse_gather_rows_group"] == 1
        for (n, _, _), ix, g, out in zip(spec, idx, gs, outs):
            e.push("t_" + n, ix, g, handle=handle)
            assert torch.equal(out, e.pull("t_" + n, ix))
            assert torch.equal(e.store_array("g_" + n),
                               e.store_array("t_" + n))


# -- bf16 stateful buckets and the message plane on the card ------------------

@pytest.mark.parametrize("n", [10_240_000, 4096, 1001])
@pytest.mark.parametrize("offset", [0, 1])
def test_bf16_fused_updates_bit_exact(dev, n, offset):
    """K1-K3 on bf16 (aligned and, offset 1, unaligned views; ragged
    lengths): one bf16 rounding per operation in kernel and plain version
    alike, so 0 differing elements; one launch each, counted under the
    ``_bf16`` names."""
    bf = torch.bfloat16
    agg = _randn((n + offset,), 16, dev).to(bf)[offset:]
    store = _randn((n + offset,), 17, dev).to(bf)[offset:]
    mom = _randn((n + offset,), 18, dev).to(bf)[offset:]
    pos = torch.rand(n + offset, device=dev).to(bf)[offset:]
    alpha = fu.adam_alpha(torch.full((1,), 3.0, device=dev), 1e-3)
    cases = [
        (lambda s: fu.sgd_update(*s, agg, 0.05, 0.9),
         lambda s: fu.sgd_update_reference(*s, agg, 0.05, 0.9),
         (store, mom)),
        (lambda s: fu.adagrad_update(*s, agg, 0.05),
         lambda s: fu.adagrad_update_reference(*s, agg, 0.05),
         (store, pos)),
        (lambda s: fu.adam_update_with_alpha(*s, agg, alpha),
         lambda s: fu.adam_update_reference(*s, agg, alpha),
         (store, (0.1 * mom).to(bf), (0.01 * pos).to(bf))),
    ]
    fu.reset_launches()
    for kfn, pfn, state in cases:
        sk = tuple(t.clone() for t in state)
        sp = tuple(t.clone() for t in state)
        kfn(sk)
        pfn(sp)
        torch.cuda.synchronize()
        for a, b in zip(sk, sp):
            assert a.dtype == bf
            assert torch.equal(a, b)
    assert fu.launches == {"sgd_update": 0, "adagrad_update": 0,
                           "adam_update": 0, "sgd_update_bf16": 1,
                           "adagrad_update_bf16": 1, "adam_update_bf16": 1}


@pytest.mark.parametrize("handle", ["sgd_momentum:0.05,0.9", "adagrad:0.02",
                                    "adam:1e-3"])
def test_bf16_stateful_engine_cuda_matches_cpu(dev, handle):
    """A bf16 stateful bucket on the card equals the CPU engine's (the
    plain versions) bit for bit, step by step."""
    keys = np.arange(16, dtype=np.uint64)
    engines = [CollectiveEngine(DeviceGroup(8, device=d), server_handle=handle)
               for d in (dev, "cpu")]
    for e in engines:
        e.register_dense("b", keys, 1000, dtype=torch.bfloat16)
    for step in range(3):
        g = torch.from_numpy(np.random.RandomState(step).randn(
            8, 16_000).astype(np.float32)).to(torch.bfloat16)
        got, want = (e.push_pull("b", g) for e in engines)
        assert torch.equal(got.cpu(), want)


def _card_cluster(van, workers, servers):
    """Scheduler + servers + workers over ``van`` in this process,
    started within 60 s (workers on ``ici`` get this card's 8 ranks)."""
    import os
    import threading

    import pslite_tpu_torch as ps
    from pslite_tpu_torch.environment import Environment

    base = {"DMLC_NUM_WORKER": str(workers), "DMLC_NUM_SERVER": str(servers),
            "DMLC_PS_ROOT_URI": "lo", "DMLC_PS_ROOT_PORT": "48500",
            "DMLC_NODE_HOST": "lo", "PS_VAN_TYPE": van,
            "PS_LOOPBACK_NS": f"chip-test-{os.getpid()}-{van}",
            "PS_ICI_IMPL": "pallas"}
    nodes = ([ps.Postoffice("scheduler", env=Environment(base))]
             + [ps.Postoffice(r, env=Environment(base))
                for r in ["server"] * servers + ["worker"] * workers])
    for po in nodes[1 + servers:]:
        if van == "ici":
            po.van.set_mesh(DeviceGroup(8))
    threads = [threading.Thread(target=po.start, daemon=True) for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "cluster start hung"
    return nodes


def _card_finalize(nodes):
    import threading

    threads = [threading.Thread(target=po.finalize, daemon=True)
               for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "cluster finalize hung"


def test_msg_ici_mixed_on_the_card(dev):
    """One KVWorker on an ici cluster: the registered bucket through K4,
    unregistered keys over messages to the server."""
    import pslite_tpu_torch as ps

    nodes = _card_cluster("ici", 1, 1)
    srv = ps.KVServer(0, postoffice=nodes[1])
    handle = ps.KVServerDefaultHandle()
    srv.set_request_handle(handle)
    try:
        w = ps.KVWorker(0, 0, postoffice=nodes[2])
        bucket = np.arange(40, dtype=np.uint64)
        w.register_dense("grads", bucket, 256_000)
        ring.reset_launches()
        outs = np.zeros(40 * 256_000, np.float32)
        w.wait(w.push_pull(bucket, np.ones(40 * 256_000, np.float32), outs))
        assert ring.launches["ring_push_pull[float32]"] == 1
        np.testing.assert_array_equal(outs, np.full_like(outs, 8.0))
        loose = np.array([7777, 9999], np.uint64)
        vals = np.arange(2 * 1000, dtype=np.float32)
        w.wait(w.push(loose, vals))
        got = np.zeros_like(vals)
        w.wait(w.pull(loose, got))
        np.testing.assert_array_equal(got, vals)
        assert sorted(handle.store) == [7777, 9999]
        w.stop()
    finally:
        srv.stop()
        _card_finalize(nodes)


def test_msg_config2_topology_on_the_card(dev):
    """BASELINE config 2's topology over the loopback van on the card's
    host: 2 workers push, meet at a barrier, pull the sum."""
    import threading

    import pslite_tpu_torch as ps

    nodes = _card_cluster("loopback", 2, 2)
    servers = []
    for po in nodes[1:3]:
        servers.append(ps.KVServer(0, postoffice=po))
        servers[-1].set_request_handle(ps.KVServerDefaultHandle())
    try:
        workers = [ps.KVWorker(0, 0, postoffice=po) for po in nodes[3:]]
        keys = np.array([r.begin + i for r in nodes[3].get_server_key_ranges()
                         for i in range(40)], np.uint64)
        outs = [np.zeros(80 * 1000, np.float32) for _ in workers]

        def work(i):
            workers[i].wait(workers[i].push(keys, np.full(80_000, i + 1.0,
                                                          np.float32)))
            nodes[3 + i].barrier(0, ps.WORKER_GROUP)
            workers[i].wait(workers[i].pull(keys, outs[i]))

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        for out in outs:
            np.testing.assert_array_equal(out, np.full_like(out, 3.0))
        for w in workers:
            w.stop()
    finally:
        for s in servers:
            s.stop()
        _card_finalize(nodes)


def _elastic_engines(device, n):
    """On ``n`` ranks of ``device``: bucket ``a`` (the default handle,
    adam), bucket ``s`` (pushed with ``sum``: the ring) and a table."""
    from pslite_tpu_torch import SparseEngine

    eng = CollectiveEngine(DeviceGroup(n, device=device),
                           server_handle="adam:1e-3", impl="ring")
    keys = np.arange(8, dtype=np.uint64)
    eng.register_dense("a", keys, 1001)  # total 8,008: padded per n
    eng.register_dense("s", keys[:3], 333)
    se = SparseEngine(eng.group)
    se.register_sparse("emb", 5000, 64)
    return eng, se


def _elastic_state(eng, se):
    out = [eng.store_array("a"), eng.store_array("s"), se.store_array("emb"),
           se.acc_array("emb")]
    return [t.cpu() for t in out + list(eng.opt_state("a")[1])]


def test_restore_and_reshard_on_the_card_match_the_cpu(dev, tmp_path):
    """A v2 file written on the CPU restores onto 4 ranks of the card
    bit for bit; 8 -> 4 reshards of the same state on the card and on the
    CPU are bit-equal, and the steps after them too (K4 1-D at n = 4,
    the sparse sum push); then the composite (dp 2, kv1 2, kv2 2) ring on
    the card equals the CPU's."""
    from pslite_tpu_torch import checkpoint as ckpt

    rng = np.random.default_rng(41)
    cpu8, cse8 = _elastic_engines("cpu", 8)
    for _ in range(2):
        cpu8.push_pull("a", rng.normal(size=(8, 8008)).astype(np.float32))
        cse8.push("emb", rng.integers(0, 5000, size=(8, 256)).astype(
            np.int32), rng.normal(size=(8, 256, 64)).astype(np.float32),
            handle="row_adagrad:0.01,1e-8")
    cpu8.push_pull("s", rng.normal(size=(8, 999)).astype(np.float32),
                   handle="sum")
    path = str(tmp_path / "ck.npz")
    ckpt.save_engine(cpu8, path, sparse_engine=cse8)
    card4, sse4 = _elastic_engines(dev, 4)
    ckpt.restore_engine(card4, path, sparse_engine=sse4)
    card8, sse8 = _elastic_engines(dev, 8)
    ckpt.restore_engine(card8, path, sparse_engine=sse8)
    for x, y in zip(_elastic_state(card8, sse8), _elastic_state(cpu8, cse8)):
        assert torch.equal(x, y)
    for e in (card8, sse8):
        e.reshard(DeviceGroup(4, device=dev))
    for e in (cpu8, cse8):
        e.reshard(DeviceGroup(4, device="cpu"))
    want = _elastic_state(cpu8, cse8)
    for got in (_elastic_state(card4, sse4), _elastic_state(card8, sse8)):
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    g = rng.normal(size=(4, 999)).astype(np.float32)
    idx = rng.integers(0, 5000, size=(4, 300)).astype(np.int32)
    rows = rng.normal(size=(4, 300, 64)).astype(np.float32)
    for eng, se in ((card8, sse8), (cpu8, cse8)):
        eng.push_pull("s", g, handle="sum")
        se.push("emb", idx, rows)
    assert torch.equal(card8.store_array("s").cpu(), cpu8.store_array("s"))
    assert torch.equal(sse8.store_array("emb").cpu(), cse8.store_array("emb"))
    g3 = rng.normal(size=(2, 303)).astype(np.float32)
    outs = []
    for d in (dev, "cpu"):
        c3 = CollectiveEngine(make_group((2, 2, 2), ("dp", "kv1", "kv2"),
                                         device=d),
                              axis_name=("kv1", "kv2"), worker_axis="dp",
                              impl="ring")
        c3.register_dense("t3", np.arange(3, dtype=np.uint64), 101)
        outs.append(c3.push_pull("t3", g3).cpu())
    assert torch.equal(outs[0], outs[1])


def test_async_checkpoint_on_the_card(dev, tmp_path):
    """An async save followed at once by in-place pushes on the card: the
    file holds the state of the save() call, bit for bit."""
    from pslite_tpu_torch import checkpoint as ckpt

    eng, se = _elastic_engines(dev, 8)
    rng = np.random.default_rng(42)
    g = torch.from_numpy(rng.normal(size=(8, 8008)).astype(np.float32)).to(dev)
    eng.push_pull("a", g)
    want = _elastic_state_v1(eng, se)
    ck = ckpt.AsyncEngineCheckpointer()
    path = str(tmp_path / "async")
    ck.save(eng, path, sparse_engine=se)
    for _ in range(3):
        eng.push_pull("a", g)
        eng.push_pull("s", g[:, :999], handle="sum")
    ck.close()
    with np.load(path + ".npz") as data:
        got = [data[k] for k in ("dense/a", "dense/s", "sparse/emb",
                                 "opt/a/0", "opt/a/1", "opt/a/2")]
    for x, y in zip(got, want):
        assert np.array_equal(x, y)


def _elastic_state_v1(eng, se):
    return [t.cpu().numpy() for t in
            [eng.store_array("a"), eng.store_array("s"), se.store_array("emb")]
            + list(eng.opt_state("a")[1])]


# -- the model zoo on the card -----------------------------------------------
#
# Each step runs from the same initial params on the card and on the CPU
# (the plain versions).  bfloat16 products accumulate in other orders on
# cuBLAS/cuDNN and on the CPU: the PSFormer and pp stores within 2**-8 of
# the largest update, the CNN's within 2**-4 (six bfloat16 products along
# its backward chain, as tests/test_torch_model_zoo.py states); DLRM is
# float32 throughout: rtol 1e-5 / atol 1e-6.

def _zoo_models():
    from pslite_tpu_torch.models import cnn, dlrm, train, transformer

    return cnn, dlrm, train, transformer


@pytest.mark.parametrize("strategy,moe", [("ring", 0), ("ulysses", 4)])
def test_psformer_step_on_the_card_matches_the_cpu(dev, strategy, moe):
    _, _, train, transformer = _zoo_models()
    cfg = transformer.ModelConfig(vocab=32, dim=32, heads=2, layers=1,
                                  moe_experts=moe)
    inputs, targets = train.toy_batch(cfg, batch=8, seq=16)
    out = {}
    for d in (dev, torch.device("cpu")):
        step, store = train.make_ps_train_step(
            cfg, make_group((4, 2), ("dp", "sp"), device=d), lr=0.5,
            sp_strategy=strategy)
        flat0 = store.array().cpu()
        ring.reset_launches()
        loss = float(step(inputs, targets))
        launched = ring.launches["ring_push[float32]"]
        out[d.type] = (loss, store.array().cpu(), launched)
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0
    upd = float((out["cpu"][1] - flat0).abs().max())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-3 * out["cpu"][0]
    assert float((out["cuda"][1] - out["cpu"][1]).abs().max()) <= (
        2.0 ** -8 * upd)


def test_pp_and_cnn_steps_on_the_card_match_the_cpu(dev):
    cnn, _, train, transformer = _zoo_models()
    pcfg = transformer.ModelConfig(vocab=32, dim=16, heads=2, layers=4)
    rng = np.random.default_rng(2)
    inputs = rng.integers(0, 32, size=(2, 2, 2, 8)).astype(np.int32)
    ccfg = cnn.CNNConfig(num_classes=4, channels=(8, 16), image_size=8)
    images, labels = cnn.toy_batch(ccfg, batch=32)
    out = {}
    for d in (dev, torch.device("cpu")):
        step, state = train.make_pp_train_step(
            pcfg, make_group((2, 4), ("dp", "pp"), device=d), lr=0.15,
            num_micro=2)
        (stacked, _), loss = step(state, inputs, (inputs + 1) % 32)
        cstep, store = cnn.make_ps_train_step(
            ccfg, DeviceGroup(8, device=d, axis_name="dp"), lr=0.05)
        flat0 = store.array().cpu()
        closs = float(cstep(images, labels))
        out[d.type] = (float(loss), stacked["qkv"].cpu(),
                       state[0]["qkv"].cpu(), closs, store.array().cpu(),
                       flat0)
    g, c = out["cuda"], out["cpu"]
    assert abs(g[0] - c[0]) <= 1e-3 * c[0]
    upd = float((c[1] - c[2]).abs().max())
    assert float((g[1] - c[1]).abs().max()) <= 2.0 ** -8 * upd
    assert abs(g[3] - c[3]) <= 1e-3 * c[3]
    upd = float((c[4] - c[5]).abs().max())
    assert float((g[4] - c[4]).abs().max()) <= 2.0 ** -4 * upd


@pytest.mark.parametrize("opt", [None, "row_adagrad"])
def test_dlrm_steps_on_the_card_match_the_cpu(dev, opt):
    from pslite_tpu_torch import SparseEngine
    from pslite_tpu_torch.ops import sparse_rows as sr

    _, dlrm, _, _ = _zoo_models()
    cfg = dlrm.DLRMConfig(num_rows=4096, emb_dim=16, num_cat=4, num_dense=8,
                          hidden=64)
    data = dlrm.toy_batch(cfg, workers=8, batch=256, seed=1)
    out = {}
    for d in (dev, torch.device("cpu")):
        group = DeviceGroup(8, device=d)
        engine, sparse = CollectiveEngine(group, impl="ring"), SparseEngine(
            group)
        step = dlrm.make_train_step(cfg, engine, sparse, lr=0.1,
                                    emb_optimizer=opt)
        ring.reset_launches()
        sr.reset_launches()
        losses = [float(step(*data)) for _ in range(3)]
        launched = (ring.launches["ring_push[float32]"],
                    sr.launches["sparse_row_adagrad" if opt
                                else "sparse_scatter_add"],
                    sr.launches["sparse_gather_rows"])
        out[d.type] = (losses, engine.pull("dlrm_mlp").cpu(),
                       sparse.store_array("dlrm_emb").cpu(), launched)
    g, c = out["cuda"], out["cpu"]
    assert g[3] == (3, 3, 3) and c[3] == (0, 0, 0)
    np.testing.assert_allclose(g[0], c[0], rtol=1e-5)
    for a, b in ((g[1], c[1]), (g[2], c[2])):
        assert bool(((a - b).abs() <= 1e-6 + 1e-5 * b.abs()).all())


# -- K4 across processes (ring_reduce_peers, ring_gather_peers) ---------------

def _peer_split(n: int) -> list:
    """Rank ranges of two or three stand-in processes."""
    cut = [0, n // 2, n] if n < 6 else [0, 3, 5, n]
    return [range(a, b) for a, b in zip(cut, cut[1:])]


# The 40 x 1 MB bucket, a bucket whose chunk is shorter than the tile, and
# a ragged one (chunks of 1001 values: the scalar path).
@pytest.mark.parametrize("n,padded", [(8, 10_240_000), (8, 400),
                                      (3, 3 * 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("handle", ["sum", "assign", "sgd:0.05"])
def test_ring_peers_match_the_single_process_ring(dev, n, padded, dtype,
                                                   handle):
    """A peer table pointing into one ``[n, padded]`` tensor, the ranks
    split over stand-in processes each holding its own store shards:
    every shard and the gathered pull equal ``pstt_ring_push_pull`` on
    the same rows, with 0 differing elements (sgd's FMA included)."""
    grads = _randn((n, padded), 21, dev).to(dtype)
    store = _randn((padded,), 22, dev).to(dtype)
    chunk = padded // n
    addrs = [grads.data_ptr() + r * padded * grads.element_size()
             for r in range(n)]
    shards = [store[p[0] * chunk:(p[-1] + 1) * chunk].clone()
              for p in _peer_split(n)]
    for part, shard in zip(_peer_split(n), shards):
        ring.ring_reduce_peers(addrs, shard, part[0] * chunk, padded, handle)
    pulled = torch.empty_like(store)
    ring.ring_gather_peers([(s.data_ptr(), p[0] * chunk, s.numel())
                            for p, s in zip(_peer_split(n), shards)], pulled)
    want = ring.ring_push_pull(grads, store, handle)
    torch.cuda.synchronize()
    assert torch.equal(pulled, want)
    assert torch.equal(torch.cat(shards), store)


# Segments that end inside a block's words, a segment shorter than one
# word row, one 16-byte aligned (the vector path) and some not.
@pytest.mark.parametrize("lens", [(5_120_000, 5_120_000), (4099, 1, 8193),
                                  (1001, 1001, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_peers_equals_torch_cat(dev, lens, dtype):
    """``ring_gather_peers`` of separate shards gives the bits of one
    ``torch.cat`` of them."""
    shards = [_randn((n,), 23 + i, dev).to(dtype) for i, n in enumerate(lens)]
    offs = [sum(lens[:i]) for i in range(len(lens))]
    pulled = torch.full((sum(lens),), float("nan"), device=dev, dtype=dtype)
    ring.ring_gather_peers([(s.data_ptr(), o, s.numel())
                            for s, o in zip(shards, offs)], pulled)
    torch.cuda.synchronize()
    assert torch.equal(pulled, torch.cat(shards))


def _kv_pieces(A: int, B: int, padded: int, dtype):
    """The (kv shard, dp sub-chunk) pieces of a 2-D bucket, rank (d, k) =
    d * B + k, split over two stand-in processes: per process its
    ``(start, length, offset)`` segments, back to back in its store."""
    geo = ring.ring_geometry(A, padded, dtype, True, False, B)
    procs = [[], []]
    for r in range(A * B):
        d, k = divmod(r, B)
        lo = min(d * geo.sub, geo.period)
        procs[r * 2 // (A * B)].append((k * geo.period + lo,
                                        min(geo.sub, geo.period - lo)))
    out = []
    for pieces in procs:
        segs, off = [], 0
        for start, n in pieces:
            segs.append((start, n, off))
            off += n
        out.append(segs)
    return out


# The 40 x 1 MB bucket on (dp 4, kv 2), 3 x 700 values (sub-chunks that
# are not tile-aligned: a shard that is not a whole sub-chunk, short and
# empty last pieces) and an odd length on (dp 2, kv 4) (the scalar path).
@pytest.mark.parametrize("A,B,padded", [(4, 2, 10_240_000), (4, 2, 2100),
                                        (2, 4, 4 * 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("handle", ["sum", "sgd:0.05"])
def test_dp_sub_ring_peers_match_the_single_process_ring(dev, A, B, padded,
                                                         dtype, handle):
    """``ring_reduce_peers`` with ``kv_shards`` over A dp rows, each
    stand-in process reducing only its (kv shard, dp sub-chunk) pieces,
    then ``ring_gather_peers``: every piece and the pull equal the 2-D
    ``pstt_ring_push_pull`` on the same rows with 0 differing elements,
    and the plain version too (``sgd`` within rtol/atol 1e-6: the kernels
    contract its multiply-add into an FMA)."""
    grads = _randn((A, padded), 31, dev).to(dtype)
    store = _randn((padded,), 32, dev).to(dtype)
    addrs = [grads.data_ptr() + a * padded * grads.element_size()
             for a in range(A)]
    procs = _kv_pieces(A, B, padded, dtype)
    stores = [torch.cat([store[a:a + n] for a, n, _ in segs])
              for segs in procs]
    plain = [s.clone() for s in stores]
    for segs, st, pl in zip(procs, stores, plain):
        ring.ring_reduce_peers(addrs, st, segs, padded, handle, kv_shards=B)
        ring.ring_peers_reference([(grads, a, n, o) for a, n, o in segs],
                                  pl, None, padded, handle, kv_shards=B)
    pulled = torch.empty_like(store)
    ring.ring_gather_peers([(st.data_ptr() + o * st.element_size(), a, n)
                            for segs, st in zip(procs, stores)
                            for a, n, o in segs if n], pulled)
    want = ring.ring_push_pull(grads, store, handle, kv_shards=B)
    torch.cuda.synchronize()
    assert torch.equal(pulled, want)
    for st, pl in zip(stores, plain):
        if handle == "sum":
            assert torch.equal(st, pl)
        else:
            torch.testing.assert_close(st, pl, rtol=1e-6, atol=1e-6)


# 1-D: the bucket on 8 ranks, and chunks of 1001 values (odd regions: the
# scalar walk); 2-D: (dp 4, kv 2) at the bucket and at 3 x 700 values.
@pytest.mark.parametrize("n,B,padded", [(8, None, 10_240_000),
                                        (8, None, 8 * 1001),
                                        (4, 2, 10_240_000), (4, 2, 2100)])
@pytest.mark.parametrize("handle", ["sum", "sgd:0.05"])
@pytest.mark.parametrize("with_ag", [True, False])
def test_int8_peers_match_the_single_process_int8_ring(dev, n, B, padded,
                                                       handle, with_ag):
    """``ring_int8_peers`` over each stand-in process's pieces (a rank's
    chunk, or a (kv shard, dp sub-chunk)) equals ``ring_push_pull(...,
    compress=True)`` on the same rows bit for bit: the per-hop absmax
    scales and the quantizer's exact division near ties included; the
    1-D store keeps full precision and the pulled area takes the
    dequantized chunks, the 2-D store the dequantized values.  Then at
    1 and 16 CTAs a cluster, the launcher's shape and a region group of
    clusters of 2 CTAs (as many as fit at once), ``sum`` against the
    plain version (``sgd``'s FMA is the kernels' own, which the
    single-process launch shares)."""
    grads = _randn((n, padded), 33, dev)
    store = _randn((padded,), 34, dev)
    addrs = [grads.data_ptr() + r * padded * 4 for r in range(n)]
    if B is None:
        chunk = padded // n
        procs = [[(r * chunk, chunk, (r - 4 * p) * chunk)
                  for r in range(4 * p, 4 * p + 4)] for p in (0, 1)]
    else:
        geo = ring.ring_geometry(n, padded, torch.float32, True, True, B)
        procs = [[], []]
        for r in range(n * B):
            d, k = divmod(r, B)
            lo = min(d * geo.sub, geo.period)
            procs[r * 2 // (n * B)].append(
                [k * geo.period + lo, min(geo.sub, geo.period - lo)])
        for segs in procs:
            off = 0
            for seg in segs:
                seg.append(off)
                off += seg[1]
    stores = [torch.cat([store[a:a + m] for a, m, _ in segs])
              for segs in procs]
    before = [s.clone() for s in stores]
    pulls = [torch.full_like(s, float("nan")) if B is None else None
             for s in stores]
    for segs, st, pl in zip(procs, stores, pulls):
        if st.numel():  # short shards leave a process empty pieces only
            ring.ring_int8_peers([(addrs, a, m, o) for a, m, o in segs if m],
                                 st, pl, padded, handle, with_ag=with_ag,
                                 kv_shards=B)
    single = store.clone()
    want = (ring.ring_push_pull if with_ag else ring.ring_push)(
        grads, single, handle, compress=True, kv_shards=B)
    torch.cuda.synchronize()
    for segs, st, pl in zip(procs, stores, pulls):
        for a, m, o in segs:
            assert torch.equal(st[o:o + m], single[a:a + m])
            if pl is not None and with_ag:
                assert torch.equal(pl[o:o + m], want[a:a + m])
    shapes = {1, 16}
    for segs, st in zip(procs, stores):
        if st.numel():
            pieces = [(addrs, a, m, o) for a, m, o in segs if m]
            shape = ring.int8_peer_launch_shape(pieces, padded, B,
                                                device=dev)
            regions = shape["regions"]
            shapes |= {(shape["cluster"], shape["groups"]),
                       (2, max(1, min(32, shape["max_active_clusters"][2]
                                      // regions)))}
    assert any(not isinstance(c, int) and c[1] > 1 for c in shapes)
    for cluster in sorted(shapes, key=str):
        for segs, st, b in zip(procs, stores, before):
            if not st.numel():
                continue
            st.copy_(b)
            pl = torch.empty_like(st) if B is None else None
            ring.ring_int8_peers([(addrs, a, m, o) for a, m, o in segs if m],
                                 st, pl, padded, "sum", with_ag=True,
                                 kv_shards=B, cluster=cluster)
            ref, rpl = b.clone(), (torch.empty_like(b) if B is None
                                   else None)
            ring.ring_peers_reference([(grads, a, m, o) for a, m, o in segs],
                                      ref, rpl, padded, "sum",
                                      compress=True, kv_shards=B)
            torch.cuda.synchronize()
            assert torch.equal(st, ref)
            if pl is not None:
                assert torch.equal(pl, rpl)


@pytest.mark.parametrize("B", [None, 2])
def test_int8_peers_every_launch_shape(dev, B):
    """One stand-in process's pieces at the main path's width (8 ranks
    1-D: 4 chunks; dp 4 x kv 2: 4 pieces; 8 regions either way) through
    ``ring_int8_peers`` at every ``(cluster, groups)`` the card runs,
    each with 0 elements off the plain version."""
    n, padded = (8, 10_240_000) if B is None else (4, 10_240_000)
    grads = _randn((n, padded), 35, dev)
    store = _randn((padded,), 36, dev)
    addrs = [grads.data_ptr() + r * padded * 4 for r in range(n)]
    if B is None:
        chunk = padded // n
        segs = [(r * chunk, chunk, r * chunk) for r in range(n // 2)]
    else:
        geo = ring.ring_geometry(n, padded, torch.float32, True, True, B)
        segs, off = [], 0
        for r in range(n * B // 2):
            d, k = divmod(r, B)
            lo = min(d * geo.sub, geo.period)
            m = min(geo.sub, geo.period - lo)
            segs.append((k * geo.period + lo, m, off))
            off += m
    st = torch.cat([store[a:a + m] for a, m, _ in segs])
    pieces = [(addrs, a, m, o) for a, m, o in segs]
    ref = st.clone()
    rpl = torch.empty_like(st) if B is None else None
    ring.ring_peers_reference([(grads, a, m, o) for a, m, o in segs], ref,
                              rpl, padded, "sum", compress=True, kv_shards=B)
    shape = ring.int8_peer_launch_shape(pieces, padded, B, device=dev)
    assert shape["regions"] == 8 and shape["groups"] > 1, shape
    assert shape["waves"] == 1
    for key in shape["cost"]:
        c, g = (int(x) for x in key.split("x"))
        got = st.clone()
        pl = torch.empty_like(st) if B is None else None
        assert ring.ring_int8_peers(pieces, got, pl, padded, "sum",
                                    kv_shards=B, cluster=(c, g)) == (c, g)
        torch.cuda.synchronize()
        assert int((got != ref).sum()) == 0, key
        if pl is not None:
            assert int((pl != rpl).sum()) == 0, key


_IPC_CHILD = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from pslite_tpu_torch.ops import ring_collective as ring
dev = torch.device("cuda:0")
addr = ring.ipc_alloc(4096 * 4, dev)
view = ring.device_view(addr, (4096,), torch.float32, dev)
view.copy_(torch.arange(4096, dtype=torch.float32, device=dev))
torch.cuda.synchronize()
print(ring.ipc_export(addr, dev).hex(), flush=True)
sys.stdin.readline()  # the parent has written into the slab
torch.cuda.synchronize()
print("SUM", float(view.sum()), flush=True)
sys.stdin.readline()  # the parent has closed its mapping
ring.ipc_free(addr, dev)
print("FREED", flush=True)
"""


def test_ipc_round_trip_between_two_processes(dev):
    """A slab allocated and exported in a child process, mapped here:
    the child's values read here, this process's writes read there."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen([sys.executable, "-c", _IPC_CHILD, repo],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         text=True)
    try:
        handle = bytes.fromhex(p.stdout.readline().strip())
        addr = ring.ipc_open(handle, dev)
        view = ring.device_view(addr, (4096,), torch.float32, dev)
        assert torch.equal(view, torch.arange(4096, dtype=torch.float32,
                                              device=dev))
        view.fill_(2.0)
        torch.cuda.synchronize()
        p.stdin.write("written\n")
        p.stdin.flush()
        assert p.stdout.readline().split() == ["SUM", "8192.0"]
        ring.ipc_close(addr, dev)
        p.stdin.write("closed\n")
        p.stdin.flush()
        assert p.stdout.readline().strip() == "FREED"
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()


def test_refused_ipc_open_raises(dev):
    """A handle the card refuses (a stranger's bytes, or this process's
    own slab, which CUDA does not map twice) raises with the CUDA error;
    nothing falls back."""
    with pytest.raises(RuntimeError, match="pstt_ipc_open: CUDA error"):
        ring.ipc_open(bytes(64), dev)
    addr = ring.ipc_alloc(1 << 16, dev)
    try:
        with pytest.raises(RuntimeError, match="pstt_ipc_open: CUDA error"):
            ring.ipc_open(ring.ipc_export(addr, dev), dev)
    finally:
        ring.ipc_free(addr, dev)


def test_a_refused_call_leaves_no_error_for_the_next_launch(dev):
    """After a refused IPC open (its runtime error raised), the next
    kernel launch runs and reports nothing: the failed call's error does
    not linger in the runtime's last-error slot."""
    with pytest.raises(RuntimeError, match="pstt_ipc_open: CUDA error"):
        ring.ipc_open(bytes(64), dev)
    grads = _randn((8, 4096), 11, dev)
    store = torch.zeros(4096, device=dev)
    out = ring.ring_push_pull(grads, store, "sum")
    torch.cuda.synchronize()
    assert torch.equal(out, ring.ring_push_pull_reference(
        grads, torch.zeros(4096, device=dev), "sum"))


def test_refused_peer_launch_raises(dev):
    """A launch the C entry refuses (here a table of 0 ranks) raises with
    the CUDA error before anything runs."""
    import numpy as np

    from pslite_tpu_torch.ops import _native

    store = torch.zeros(8, device=dev)
    table = np.zeros(1, dtype=np.int64)
    segs = np.array([0, 8, 0], dtype=np.int64)
    with pytest.raises(RuntimeError, match="pstt_ring_reduce_peers_segs: "
                                           "CUDA error"):
        _native.call("pstt_ring_reduce_peers_segs", table.ctypes.data, 0,
                     store.data_ptr(), segs.ctypes.data, 1, 0, 8, 8, 8, 0,
                     8, 0, 0.0, _native.stream_ptr(dev))


# -- the stress patterns and the device-timeline reader (harnesses) ---------

_STRESS_LEN = 30_720_000  # the stress default: 7,680,000 f32 per tensor


def _stress_model(pattern, calls, idx=None, rows=0):
    """float64 result of ``calls`` ops of a stress pattern on fresh
    state (ones from 8 ranks)."""
    if pattern == "datascatter":
        table = np.zeros((rows, 128), np.float64)
        for _ in range(calls):
            np.add.at(table, idx.reshape(-1), 1.0)
        return table
    return np.full(_STRESS_LEN // 4, 8.0 * calls)


@pytest.mark.parametrize("pattern, wrapper, plain", [
    ("dense", "ring_push_pull", "ring_push_pull_reference"),
    ("scatter", "ring_push", "ring_push_reference"),
    ("datascatter", "scatter_add", "scatter_add_reference")])
def test_stress_pattern_kernel_matches_plain(dev, pattern, wrapper, plain,
                                             monkeypatch):
    """One stress pattern per kernel at the stress shape (K4 on a
    30,720,000 B bucket over 8 ranks, S1 on 8 x 7,500 rows into 60,000
    x 128): its first launch against the plain version on clones of the
    same inputs (bit-exact, ``sum``), a launch per call, and the store or
    table exact against float64."""
    from pslite_tpu_torch import stress
    from pslite_tpu_torch.ops import sparse_rows as sr
    from pslite_tpu_torch.parallel.sparse import SparseEngine

    mod = sr if pattern == "datascatter" else ring
    real, held = getattr(mod, wrapper), []

    def first(*args, **kw):
        if not held:
            held.append(([a.clone() if torch.is_tensor(a) else a
                          for a in args], kw))
        return real(*args, **kw)

    monkeypatch.setattr(mod, wrapper, first)
    eng = CollectiveEngine(DeviceGroup(8, device=dev), impl="pallas")
    sp = SparseEngine(eng.group)
    ring.reset_launches()
    sr.reset_launches()
    gbps = stress.run_pattern(eng, sp, pattern, _STRESS_LEN, 3)
    torch.cuda.synchronize()
    assert gbps > 0
    counter = {"ring_push_pull": "ring_push_pull[float32]",
               "ring_push": "ring_push[float32]",
               "scatter_add": "sparse_scatter_add"}[wrapper]
    assert mod.launches[counter] == 4
    # The first launch again on clones of its inputs, kernel and plain
    # version side by side: the pulled values and the store written in
    # place are bit-equal.
    args, kw = held[0]
    kern = [a.clone() if torch.is_tensor(a) else a for a in args]
    flat = [a.clone() if torch.is_tensor(a) else a for a in args]
    out_k = real(*kern, **kw)
    out_p = getattr(mod, plain)(*flat, **kw)
    torch.cuda.synchronize()
    written = 0 if pattern == "datascatter" else 1
    assert torch.equal(kern[written], flat[written])
    if pattern == "dense":
        assert torch.equal(out_k, out_p)
    name = f"stress_{pattern}_{_STRESS_LEN}"
    if pattern == "datascatter":
        t = sp.table(f"{name}_tbl")
        rows = torch.arange(t.num_rows, dtype=torch.int32,
                            device=dev).expand(8, -1)
        got = sp.pull(f"{name}_tbl", rows)[0].double().cpu().numpy()
        idx = np.random.default_rng(0).integers(
            0, t.num_rows, size=(8, t.num_rows // 8))
        np.testing.assert_array_equal(
            got, _stress_model(pattern, 4, idx, t.num_rows))
    else:
        np.testing.assert_array_equal(
            eng.pull(name).double().cpu().numpy(), _stress_model(pattern, 4))


_READER_CHILD = """
import json, sys
import torch
from torch.autograd import DeviceType
from pslite_tpu_torch.ops import ring_collective as ring
from pslite_tpu_torch.utils import xplane
from pslite_tpu_torch.utils.profiling import device_trace
dev = torch.device("cuda:0")
g = torch.randn((8, 7_680_000), device=dev)
store = torch.zeros(7_680_000, device=dev)
ring.ring_push_pull(g, store, "sum")
torch.cuda.synchronize()
with device_trace(sys.argv[1]) as t:
    for _ in range(5):
        ring.ring_push_pull(g, store, "sum")
    torch.cuda.synchronize()
print(json.dumps({
    "kernels": [(e.key, e.count, e.self_device_time_total / 1e6)
                for e in t.events if e.device_type == DeviceType.CUDA],
    "busy": xplane.device_busy_seconds(sys.argv[1]),
    "ops": xplane.device_op_seconds(sys.argv[1])}))
"""


def test_xplane_reader_matches_key_averages(dev, tmp_path):
    """The device-timeline reader's busy seconds on a K4 trace against
    the profiler's own ``key_averages()`` device time (its kernel events;
    within 2 %), and its top op is the ring kernel.  In a fresh process:
    a short profiler window late in a process's life loses its device
    events on the card's machine (PERF.md §6, the harnesses)."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _READER_CHILD,
                          str(tmp_path / "k4")], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    [(key, count, ka)] = got["kernels"]
    assert count == 5 and "ring_kernel" in key
    assert list(got["busy"]) == ["/device:GPU:0"]
    assert abs(got["busy"]["/device:GPU:0"] - ka) <= 0.02 * ka, got
    assert list(got["ops"]) == [key]
    assert abs(got["ops"][key] - ka) <= 0.02 * ka


# -- D1 and D2: the dense engine's reduce programs ------------------------------

def _rows(W, n, offset, dtype, seed, dev, as_list):
    """W rows of n values, each ``offset`` elements into its own storage
    (offset 1: every row unaligned), as a [W, n] view or a list."""
    g = _randn((W, n + offset), seed, dev).to(dtype)[:, offset:]
    return list(g) if as_list else g


_D_LENS = [10_240_000, 4099, 1001]


@pytest.mark.parametrize("W", [2, 3, 8, 16])
@pytest.mark.parametrize("n", _D_LENS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("offset", [0, 1])
def test_d1_matches_plain(dev, W, n, dtype, offset):
    """Every mode, pulled and not, rows as a [W, n] view and by address:
    0 differing elements."""
    rows = _rows(W, n, offset, dtype, 30 + W, dev, as_list=offset == 1)
    store = _randn((n + offset,), 31, dev).to(dtype)[offset:]
    for handle in ("sum", "assign", "sgd:0.05"):
        for with_pull in (True, False):
            sk, sp = store.clone(), store.clone()
            pk = torch.empty_like(store) if with_pull else None
            pp = torch.empty_like(store) if with_pull else None
            ru.reduce_apply(rows, sk, handle, pk)
            ru.reduce_apply_reference(rows, sp, handle, pp)
            torch.cuda.synchronize()
            assert torch.equal(sk, sp), (handle, with_pull)
            if with_pull:
                assert torch.equal(pk, pp)
    assert torch.equal(ru.rank_order_sum(rows),
                       ru.rank_order_sum_reference(rows))


def _d2_state(kind, n, offset, dtype, dev):
    mom = _randn((n + offset,), 32, dev).to(dtype)[offset:]
    pos = torch.rand(n + offset, device=dev).to(dtype)[offset:]
    if kind == "sgd_momentum":
        return (mom,), (0.05, 0.9), 1e-6
    if kind == "adagrad":
        return (pos,), (0.05, 1e-8), 1e-6
    return ((0.1 * mom).to(dtype), (0.01 * pos).to(dtype)), \
        (0.9, 0.999, 1e-8), 1e-5


@pytest.mark.parametrize("W", [2, 3, 8, 16])
@pytest.mark.parametrize("n", _D_LENS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_d2_matches_plain(dev, W, n, dtype, offset):
    """Each optimizer: 0 differing elements against the plain reduction
    followed by the K1-K3 launch, and within K1-K3's tolerances of the
    all-PyTorch plain version (bf16: 0 differing there too)."""
    rows = _rows(W, n, offset, dtype, 40 + W, dev, as_list=offset == 1)
    store = _randn((n + offset,), 41, dev).to(dtype)[offset:]
    alpha = fu.adam_alpha(torch.full((1,), 3.0, device=dev), 1e-3)
    for kind in ru.OPTIMIZERS:
        state, params, rtol = _d2_state(kind, n, offset, dtype, dev)
        outs = []
        for run, fused in ((ru.reduce_update, None), (
                ru.reduce_update_reference, True), (
                ru.reduce_update_reference, False)):
            s = store.clone()
            st = tuple(t.clone() for t in state)
            pulled = torch.empty_like(store)
            kw = {} if fused is None else {"fused": fused}
            run(rows, s, st, kind, params, alpha, pulled, **kw)
            outs.append((s, pulled) + st)
        torch.cuda.synchronize()
        for a, b, c in zip(*outs):
            assert torch.equal(a, b), kind
            if dtype == torch.bfloat16:
                assert torch.equal(a, c), kind
            else:
                torch.testing.assert_close(a, c, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d1_d2_take_a_grads_row_that_is_the_store(dev, dtype):
    """W = 1 with the row the store itself (a stale zero-copy handle
    passed back as grads): each thread reads before it writes."""
    store = _randn((1001,), 50, dev).to(dtype)
    want = store.clone()
    ru.reduce_apply_reference(want.unsqueeze(0).clone(), want, "sum")
    ru.reduce_apply(store.unsqueeze(0), store, "sum")
    torch.cuda.synchronize()
    assert torch.equal(store, want)
    state = (torch.zeros_like(store),)
    want, wstate = store.clone(), (torch.zeros_like(store),)
    ru.reduce_update_reference(want.unsqueeze(0).clone(), want, wstate,
                               "sgd_momentum", (0.05, 0.9), fused=True)
    ru.reduce_update(store.unsqueeze(0), store, state, "sgd_momentum",
                     (0.05, 0.9))
    torch.cuda.synchronize()
    assert torch.equal(store, want) and torch.equal(state[0], wstate[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d1_group_of_the_trace_is_one_launch(dev, dtype):
    """The 36 ResNet-50 trace buckets at 8 rows: one launch, each bucket
    0 elements off its own plain push_pull."""
    sizes = [n for _, n in rt.make_buckets()]
    rows = [_randn((8, n), 60 + i, dev).to(dtype) for i, n in
            enumerate(sizes)]
    stores = [_randn((n,), 100 + i, dev).to(dtype) for i, n in
              enumerate(sizes)]
    wants = [s.clone() for s in stores]
    for r, w in zip(rows, wants):
        ru.reduce_apply_reference(r, w, "sum")
    ru.reset_launches()
    pulled = ru.reduce_group(rows, stores, "sum")
    torch.cuda.synchronize()
    name = str(dtype).replace("torch.", "")
    assert {k: v for k, v in ru.launches.items() if v} == {
        f"reduce_push_pull_group[{name}]": 1}
    for p, s, w in zip(pulled, stores, wants):
        assert torch.equal(s, w) and torch.equal(p, w)


@pytest.mark.parametrize("kind", ["sum", "sgd:0.05", "adam"])
def test_d1_d2_peer_rows_by_address(dev, kind):
    """Pieces of a store whose 8 rows come by address from one slab, at
    odd offsets (the scalar path), 20 pieces (two launches)."""
    n_piece, pieces_n = 50_001, 20
    slab = _randn((8, pieces_n * n_piece + 3), 70, dev)
    store = _randn((pieces_n * n_piece,), 71, dev)
    state = (_randn((store.numel(),), 72, dev) * 0.1,
             torch.rand(store.numel(), device=dev) * 0.01)
    alpha = fu.adam_alpha(torch.full((1,), 2.0, device=dev), 1e-3)
    pieces = [([slab[w, 3 + k * n_piece:].data_ptr() for w in range(8)],
               k * n_piece, n_piece) for k in range(pieces_n)]
    kw = ({"params": (0.9, 0.999, 1e-8), "alpha": alpha}
          if kind == "adam" else {})
    got, gstate = store.clone(), tuple(t.clone() for t in state)
    want, wstate = store.clone(), tuple(t.clone() for t in state)
    ru.reset_launches()
    ru.reduce_peers(pieces, got, kind,
                    state=gstate if kind == "adam" else (), **kw)
    ru.reduce_peers_reference(pieces, want, kind,
                              state=wstate if kind == "adam" else (), **kw)
    torch.cuda.synchronize()
    if kind == "adam":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert sum(ru.launches.values()) == 2


def test_d1_d2_graph_replays_alike(dev):
    """20 launches (D1 sum with its pull, D2 adam) captured in one CUDA
    graph, replayed twice from the same state: alike, and equal to 20
    eager launches (the tables are kernel parameters)."""
    rows = _randn((8, 1_000_003), 80, dev)
    store0 = _randn((1_000_003,), 81, dev)
    alpha = fu.adam_alpha(torch.full((1,), 2.0, device=dev), 1e-3)
    store, pulled = store0.clone(), torch.empty_like(store0)
    m, v = torch.zeros_like(store0), torch.zeros_like(store0)

    def launches():
        for _ in range(10):
            ru.reduce_apply(rows, store, "sum", pulled)
            ru.reduce_update(rows, store, (m, v), "adam", (0.9, 0.999, 1e-8),
                             alpha)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        launches()
    torch.cuda.synchronize()
    eager = store.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        launches()
    results = []
    for _ in range(2):
        store.copy_(store0)
        m.zero_()
        v.zero_()
        graph.replay()
        torch.cuda.synchronize()
        results.append(store.clone())
    assert torch.equal(results[0], results[1])
    assert torch.equal(results[0], eager)


@pytest.mark.parametrize("impl", ["torch", "ring"])
def test_engine_paths_launch_d1_d2(dev, impl):
    """The counts on the engine's paths: the torch impl's push_pull,
    push, group and replay launch D1, every stateful handle D2, and no
    path launches K1-K3 or a PyTorch reduction of its own."""
    keys = np.arange(4, dtype=np.uint64)
    eng = CollectiveEngine(DeviceGroup(8, device=dev), impl=impl)
    for name in ("a", "b"):
        eng.register_dense(name, keys, 4096)
    g = _randn((8, 4 * 4096), 90, dev)
    ru.reset_launches()
    fu.reset_launches()
    eng.push_pull("a", g, handle="adam:1e-3")
    eng.push_pull("b", g, handle="sgd_momentum:0.01,0.9")
    made = {k: v for k, v in ru.launches.items() if v}
    assert made == {"reduce_adam[float32]": 1,
                    "reduce_sgd_momentum[float32]": 1}
    assert not any(fu.launches.values())
    if impl == "torch":
        eng.register_dense("c", keys, 4096)
        eng.register_dense("d", keys, 4096)
        ru.reset_launches()
        eng.push_pull("c", g)
        eng.push("c", g)
        eng.push_pull_group(["c", "d"], [g, g])
        eng.replay("d", g.view(1, 8, -1).expand(3, 8, -1), keep="all")
        assert {k: v for k, v in ru.launches.items() if v} == {
            "reduce_push_pull[float32]": 4, "reduce_push[float32]": 1,
            "reduce_push_pull_group[float32]": 1}
