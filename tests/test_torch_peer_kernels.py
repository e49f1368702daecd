"""The wrappers of K4's cross-process variants for the group shapes
beyond the 1-D ring (``ops/ring_collective.py``): the dp sub-rings'
``ring_reduce_peers`` (``kv_shards``) and ``ring_int8_peers``, their
plain version ``ring_peers_reference`` and their launch tables.

On the CPU no kernel runs: the tables each wrapper hands its C entry
(``pstt_ring_reduce_peers_segs``, ``pstt_ring_int8_peers``) drive an
emulated kernel behind a monkeypatched ``_native.call``, which walks the
ring from the addresses, geometry, segments, region rows and piece
offsets it is given, as the CUDA kernels do.  Each result is held
against the single-process plain ring on the same rows, bit for bit;
the card runs the kernels themselves (``tests/test_torch_chip.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from pslite_tpu_torch.ops import _native
from pslite_tpu_torch.ops import ring_collective as ring
from pslite_tpu_torch.utils.logging import CheckError

from test_torch_ring_int8 import _jax_compressed, check_exchange, walk_region


class _Memory:
    """Tensors by address: resolves a pointer to (tensor, element
    offset)."""

    def __init__(self):
        self.tensors = []

    def add(self, t):
        if t is not None and t.numel():
            self.tensors.append(t)
        return t

    def at(self, ptr: int):
        for t in self.tensors:
            lo = t.data_ptr()
            if lo <= ptr < lo + t.numel() * t.element_size():
                return t.view(-1), (ptr - lo) // t.element_size()
        raise AssertionError(f"no tensor at {ptr:#x}")


def _host_words(ptr: int, count: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        (ctypes.c_longlong * count).from_address(ptr)).copy()


def _emulate(mem: _Memory, calls: list):
    def call(name, *args):
        calls.append(name)
        if name == "pstt_ring_reduce_peers_segs":
            (rows_p, n, store_p, segs_p, nseg, dtype, period, sub, split, kv,
             padded, code, lr, _stream) = args
            rows = [mem.at(a) for a in _host_words(rows_p, n)]
            store, base = mem.at(store_p)
            for lo, count, off in _host_words(segs_p, 3 * nseg).reshape(
                    -1, 3).tolist():
                i = torch.arange(lo, lo + count)
                j = i % period if kv else i
                c = j // sub
                step = torch.where(j - c * sub >= split, n - 1, 1)
                acc = None
                for k in range(1, n + 1):
                    r = (c + k * step) % n
                    vals = torch.stack([t[o + i] for t, o in rows])
                    g = vals.gather(0, r[None])[0]
                    acc = g.clone() if acc is None else \
                        (acc.float() + g.float()).to(g.dtype)
                dst = store[base + off:base + off + count]
                dst.copy_(ring._apply_handle(dst, acc, code, lr))
            return
        assert name == "pstt_ring_int8_peers"
        (desc_p, count, regions_p, nregions, cluster, groups, xchg, smem,
         code, lr, gather, stp, _stream) = args
        check_exchange(xchg, nregions, groups,
                       lambda p: mem.at(p)[0])
        desc = _host_words(desc_p, 9 * count).reshape(count, 9)
        regions, roff = mem.at(regions_p)
        regions = regions[roff:roff + 5 * nregions].view(nregions, 5)
        for start, length, chunk, step, b in regions.tolist():
            rows_p, sp, pp, _scp, padded, n, _vec, off, _ = desc[b].tolist()
            table, toff = mem.at(rows_p)
            rows = [mem.at(a) for a in table[toff:toff + n].tolist()]
            st, so = mem.at(sp)
            idx = slice(so + start - off, so + start - off + length)
            pulled = None
            if pp:
                pl, po = mem.at(pp)
                pulled = pl[po + start - off:po + start - off + length]

            def read(r):
                t, o = rows[r]
                return t[o + start:o + start + length]

            walk_region(read, st[idx], pulled, n, chunk, step, code, lr,
                        gather, stp, cluster, groups)
    return call


def _pieces(n, B, padded, dtype, compress):
    """Two stand-in processes' ``(start, length, offset)`` pieces: the
    1-D chunks of ranks 0-3 and 4-7, or the (kv shard, dp sub-chunk) of
    rank (d, k) = d * B + k."""
    if B is None:
        chunk = padded // n
        half = n // 2
        return [[(r * chunk, chunk, (r - half * p) * chunk)
                 for r in range(half * p, half * (p + 1))] for p in (0, 1)]
    geo = ring.ring_geometry(n, padded, dtype, True, compress, B)
    procs = [[], []]
    for r in range(n * B):
        d, k = divmod(r, B)
        lo = min(d * geo.sub, geo.period)
        procs[r * 2 // (n * B)].append(
            (k * geo.period + lo, min(geo.sub, geo.period - lo)))
    out = []
    for pcs in procs:
        off, segs = 0, []
        for a, m in pcs:
            segs.append((a, m, off))
            off += m
        out.append(segs)
    return out


@pytest.fixture
def emulated(monkeypatch):
    mem, calls = _Memory(), []
    monkeypatch.setattr(_native, "call", _emulate(mem, calls))
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    real = ring._device_table.__wrapped__

    def table(values, device):
        return mem.add(real(values, device))

    monkeypatch.setattr(ring, "_device_table", table)
    real_exchange = ring._exchange
    monkeypatch.setattr(ring, "_exchange",
                        lambda *a: mem.add(real_exchange(*a)))
    return mem, calls


@pytest.mark.parametrize("n,B,padded,dtype", [
    (4, 2, 2100, torch.float32), (4, 2, 2100, torch.bfloat16),
    (2, 4, 4 * 1001, torch.float32), (8, None, 8 * 1001, torch.float32)])
@pytest.mark.parametrize("handle", ["sum", "sgd:0.05"])
def test_reduce_peers_tables_drive_the_kernel(emulated, n, B, padded, dtype,
                                              handle):
    """The segments and geometry ``ring_reduce_peers`` passes (the dp
    sub-rings with ``kv_shards``) walk every owned piece in the ring's
    order: each stand-in process's pieces equal the single-process plain
    ring's, and the plain peers version agrees."""
    mem, calls = emulated
    gen = torch.Generator().manual_seed(5)
    rows = [mem.add(torch.randn(padded, generator=gen).to(dtype))
            for _ in range(n)]
    store = torch.randn(padded, generator=gen).to(dtype)
    single = store.clone()
    ring.ring_push_pull_reference(torch.stack(rows), single, handle,
                                  kv_shards=B)
    geo = ring.ring_geometry(n, padded, dtype, True, False, B)
    launched = 0
    for segs in _pieces(n, B, padded, dtype, False):
        segs = [seg for seg in segs if seg[1]]
        if not segs:  # short shards: this process holds empty pieces
            continue
        launched += 1
        st = mem.add(torch.cat([store[a:a + m] for a, m, _ in segs]))
        plain = st.clone()
        ring._launch_reduce_peers([t.data_ptr() for t in rows], st, segs,
                                  geo, padded, *ring.ring_handle(handle))
        ring.ring_peers_reference([(torch.stack(rows), a, m, o)
                                   for a, m, o in segs], plain, None, padded,
                                  handle, kv_shards=B)
        for a, m, o in segs:
            assert torch.equal(st[o:o + m], single[a:a + m])
        assert torch.equal(st, plain)
    assert calls == ["pstt_ring_reduce_peers_segs"] * launched


@pytest.mark.parametrize("n,B,padded", [(8, None, 8 * 1001), (4, 2, 2100),
                                        (2, 4, 4 * 700), (4, 2, 3 * 8192)])
@pytest.mark.parametrize("handle,with_ag", [("sum", True), ("sgd:0.05", True),
                                            ("sum", False)])
@pytest.mark.parametrize("cluster", [1, 16, (2, 2), (1, 3)])
def test_int8_peers_tables_drive_the_kernel(emulated, n, B, padded, handle,
                                            with_ag, cluster):
    """The region rows, row tables and piece offsets ``ring_int8_peers``
    builds, walked as the cluster kernel walks them (one cluster, or a
    region group of G clusters meeting each hop's scale), give the single-
    process compressed ring's bits: the 1-D store at full precision and
    its dequantized pulled chunks, the 2-D store the dequantized values."""
    mem, calls = emulated
    gen = torch.Generator().manual_seed(6)
    rows = [mem.add(torch.randn(padded, generator=gen)) for _ in range(n)]
    store = torch.randn(padded, generator=gen)
    single = store.clone()
    want = ring._ring_reference(torch.stack(rows), single, handle, True,
                                with_ag, True, B)
    code, lr = ring.ring_handle(handle)
    launched = 0
    for segs in _pieces(n, B, padded, torch.float32, True):
        segs = [seg for seg in segs if seg[1]]
        if not segs:
            continue
        launched += 1
        st = mem.add(torch.cat([store[a:a + m] for a, m, _ in segs]))
        pl = mem.add(torch.full_like(st, float("nan"))) if B is None else None
        pieces = [([t.data_ptr() for t in rows], a, m, o)
                  for a, m, o in segs if m]
        ring._launch_int8_peers(pieces, st, pl, padded, n, code, lr,
                                with_ag, B, True, cluster)
        for a, m, o in segs:
            assert torch.equal(st[o:o + m], single[a:a + m])
            if pl is not None and with_ag:
                assert torch.equal(pl[o:o + m], want[a:a + m])
    assert calls == ["pstt_ring_int8_peers"] * launched


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_int8_peer_groups_match_jax(emulated, groups):
    """Two stand-in processes' pieces of a 4-rank compressed ring through
    ``ring_int8_peers``' tables at G = 1, 2, 3 clusters of 2 CTAs per
    region, against the JAX package's compressed ring on the same rows:
    each piece of the store and of the pulled values bit-equal."""
    mem, calls = emulated
    grads, store, want = _jax_compressed(4, True, True)
    padded = store.size
    rows = [mem.add(torch.from_numpy(grads[r].copy())) for r in range(4)]
    for segs in _pieces(4, None, padded, torch.float32, True):
        st = mem.add(torch.from_numpy(np.concatenate(
            [store[a:a + m] for a, m, _ in segs])))
        pl = mem.add(torch.full_like(st, float("nan")))
        pieces = [([t.data_ptr() for t in rows], a, m, o) for a, m, o in segs]
        ring._launch_int8_peers(pieces, st, pl, padded, 4, 0, 0.0, True,
                                None, True, (2, groups))
        for a, m, o in segs:
            np.testing.assert_array_equal(st[o:o + m].numpy(),
                                          want[0][a:a + m])
            np.testing.assert_array_equal(pl[o:o + m].numpy(),
                                          want[1][a:a + m])
    assert calls == ["pstt_ring_int8_peers"] * 2


def test_int8_peer_regions_cover_whole_pieces():
    """A piece must be whole regions of the compressed ring; each piece's
    regions tile it, longest first across the launch."""
    plan = ring.int8_peer_regions(4, 2100, 2, True,
                                  ((0, 1050, 0, True),))
    assert int(plan.table[:, 1].sum()) == 1050
    assert list(plan.table[:, 1]) == sorted(plan.table[:, 1], reverse=True)
    with pytest.raises(CheckError, match="not whole regions"):
        ring.int8_peer_regions(8, 8 * 1001, None, True,
                               ((0, 1500, 0, True),))


def test_new_peer_kernels_refuse_the_cpu():
    """On CPU tensors the cross-process kernels raise: a CPU group's rows
    take ``ring_push_pull_peers_reference``, never a silent substitute,
    and no launch is counted."""
    ring.reset_launches()
    store = torch.zeros(2100)
    with pytest.raises(CheckError, match="runs on the card"):
        ring.ring_reduce_peers([0] * 4, store, [(0, 2100, 0)], 2100,
                               kv_shards=2)
    with pytest.raises(CheckError, match="runs on the card"):
        ring.ring_int8_peers([([0] * 4, 0, 2100, 0)], store, None, 2100,
                             kv_shards=2)
    assert sum(ring.launches.values()) == 0


# The co-resident clusters an H100 80GB HBM3 runs at each cluster size
# for the launch across processes (``cudaOccupancyMaxActiveClusters`` on
# the card, PERF.md section 6).
H100_PEERS = {**{c: 7 for c in range(10, 17)}, 9: 9, 8: 15, 7: 15, 6: 17,
              5: 22, 4: 30, 3: 39, 2: 66, 1: 132}


@pytest.mark.parametrize("B", [None, 2])
def test_h100_planner_walks_each_peer_region_with_a_group(B):
    """One process's pieces at the main path's width (8 ranks 1-D: 4
    chunks, 8 regions of 643,072 values; dp 4 x kv 2: 4 pieces, 8
    regions) take 8 clusters of 2 CTAs per region: 64 clusters, 128
    CTAs, one wave, no spill (one cluster of 16 CTAs per region took 2
    waves)."""
    P = 10_240_000
    n = 8 if B is None else 4
    segs = _pieces(n, B, P, torch.float32, True)[0]
    pieces = [([16 * r for r in range(n)], a, m, o) for a, m, o in segs]
    key, lengths, n_ = ring._peer_key(pieces, P, B, True)
    c, g = ring._pick(ring._peer_costs(key, lengths, n_, H100_PEERS))
    assert (c, g) == (2, 8)
    table = ring.int8_peer_regions(*key).table
    assert len(table) * g <= H100_PEERS[c]
    plan = ring._plan_rows(table, lengths, c, g)
    assert plan.scratch == 0 and plan.slice <= ring.INT8_SMEM_FLOATS
