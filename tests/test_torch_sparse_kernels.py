"""The sparse row kernels' index arithmetic, emulated on the CPU.

``csrc/sparse_rows.cu`` runs only on the card.  Here ``_native.call`` is
replaced by a numpy emulation of each C entry that follows the kernels
step by step.  ``sort_kernel`` (``pstt_sparse_sort``): the cluster's size
and each CTA's share of the list, the radix passes over only the key's
bits, each CTA tile ranked warp by warp in rounds of 32 lanes
(``__match_any_sync`` and a popcount of the lower lanes, the warp's
histogram carried from round to round, then prefixed over the warps), the
prefix across the cluster by digit slices, the scatter to the owner CTA,
the tile loop in device memory above one cluster's capacity, and the run
listing (heads listed per CTA, each run's length from the next head's
position, a CTA's last run's from the first heads the CTAs send each
other, the lists in the sorted order).  ``long_runs_kernel``: one cluster
per long run, a CTA per ``kGroup`` columns of each ``kTile`` tile, each
row's 16-byte pieces copied by the producer threads from its list
position (every piece once, at most 8 rows a thread and stage) into a
ring of ``kStages`` slots of ``rb`` rows (a slot refilled only after its
release), and the pipelined walk: each row's add followed by the load of
the row ``kAhead`` on, the next slot waited for before the current
slot's last adds.  The short runs' kernels read their rows through the
sorted positions (the sum: one thread per run and 4 columns; row-wise
Adagrad: one warp per run), the fixed-order reductions of row-wise
Adagrad (a long run's per CTA of its cluster, in CTA order), and the
gather.  The constants are read from the source, so the emulation keeps
the compiled shapes.  The wrappers in ``ops/sparse_rows.py`` run their
CUDA branch on CPU tensors, so their glue (the scratch, the arguments) is
exercised too.  Bars: the sum push and the pull equal the plain versions
bit for bit; row-wise Adagrad within rtol 1e-5 / atol 1e-6 (the order of
the row's sum of squares); the emulated sort equals a stable
``np.argsort``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pslite_tpu_torch.models.embedding import skewed_indices
from pslite_tpu_torch.ops import _native
from pslite_tpu_torch.ops import sparse_rows as sr

_SRC = (Path(sr.__file__).resolve().parent.parent / "csrc"
        / "sparse_rows.cu").read_text()


def _const(name):
    expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", _SRC).group(1)
    return int(np.prod([int(x) for x in expr.split("*")]))


K_LONG = _const("kLong")
K_STAGES = _const("kStages")
RING_BYTES = _const("kRingBytes")
K_TILE = _const("kTile")
RING_ROWS = _const("kRingRows")
LONG_THREADS = _const("kLongThreads")
GROUP = _const("kGroup")
AHEAD = _const("kAhead")
SORT_THREADS = _const("kSortThreads")
SORT_WARPS = _const("kSortWarps")
SORT_TILE = _const("kSortTile")
SORT_CLUSTER = _const("kSortCluster")
SORT_GROW = _const("kSortGrow")
DIGIT_BITS = _const("kDigitBits")
assert SORT_WARPS * 32 == SORT_THREADS
assert _const("kDigits") == 1 << DIGIT_BITS
CAPACITY = SORT_CLUSTER * SORT_TILE  # entries one cluster holds on chip
_DTYPES = {0: torch.float32, 1: torch.bfloat16}
# Kernels each C entry launches (csrc/sparse_rows.cu).
_KERNELS = {"pstt_sparse_sort": 1, "pstt_sparse_scatter_add": 2,
            "pstt_sparse_row_adagrad": 2, "pstt_sparse_gather_rows": 1}


def _view(ptr, n, dtype):
    """The ``n`` elements of ``dtype`` at host address ``ptr``, shared."""
    if n == 0:
        return torch.empty(0, dtype=dtype)
    size = n * torch.empty(0, dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_byte * size).from_address(ptr),
                            dtype=dtype, count=n)


def _round(x, dtype):
    """float32 values rounded to the table's dtype, kept as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype).float(
    ).numpy()


def _flat_row(x, S, rps):
    if x < 0 or x // S >= rps:
        return -1
    return (x % S) * rps + x // S


# -- sort_kernel ------------------------------------------------------------------

_LOWER = np.tri(32, k=-1, dtype=bool)  # _LOWER[l, j]: lane j below lane l


def _sort_cluster(m):
    return min(SORT_CLUSTER, max(1, -(-m // SORT_GROW)))


def _rank_tile(keys, R, shift, nd):
    """rank_tile: warp w holds tile entries [w*32R, (w+1)*32R) in R rounds
    of 32 lanes.  Returns each entry's rank in its warp, the warps'
    histograms exclusive over the warps, and the tile's digit counts."""
    tn = keys.size
    assert tn <= SORT_WARPS * 32 * R
    whist = np.zeros((SORT_WARPS, nd), np.int64)
    lr = np.zeros(tn, np.int64)
    for w in range(SORT_WARPS):
        for r in range(R):
            i = (w * R + r) * 32 + np.arange(32)
            ok = i < tn
            if not ok.any():
                continue
            d = np.full(32, -1, np.int64)
            d[ok] = (keys[i[ok]] >> shift) & (nd - 1)
            peers = d[:, None] == d[None, :]  # __match_any_sync
            below = (peers & _LOWER).sum(1)
            before = np.where(ok, whist[w, np.maximum(d, 0)], 0)
            lr[i[ok]] = (before + below)[ok]
            lead = ok & (below == 0)
            whist[w, d[lead]] = before[lead] + peers[lead].sum(1)
    pre = np.cumsum(whist, 0) - whist
    assert pre.max(initial=0) < 1 << 16  # 16-bit histograms
    return lr, pre, whist.sum(0)


def _cluster_offsets(cnt):
    """cluster_offsets: CTA c takes digits [c*slice, (c+1)*slice), reads
    the (digit, CTA) counts of its slice at once, prefixes them over the
    CTAs, and over the digits by a block scan of consecutive digits per
    thread; each CTA's offsets are written back into that CTA, the
    slices' totals prefixed.  Returns (base[c, d], s_off[slice], slice)."""
    C, nd = cnt.shape
    sl = -(-nd // C)
    base = np.full((C, nd), -1, np.int64)
    tot = np.zeros(C, np.int64)
    for c in range(C):
        d0 = c * sl
        ns = max(0, min(sl, nd - d0))
        assert ns * C <= (1 << DIGIT_BITS) + SORT_CLUSTER  # pair[]
        pair = cnt[:, d0:d0 + ns].T.copy()  # pair[dl, k]
        qd = -(-ns // SORT_THREADS)
        assert qd <= 4
        e0 = np.minimum(np.arange(SORT_THREADS) * qd, ns)
        e1 = np.minimum(e0 + qd, ns)
        sums = np.array([pair[a:b].sum() for a, b in zip(e0, e1)])
        x = np.cumsum(sums) - sums  # block_scan
        dpre = np.zeros(ns, np.int64)
        for t in np.nonzero(e1 > e0)[0]:
            for dl in range(e0[t], e1[t]):
                dpre[dl] = x[t]
                x[t] += pair[dl].sum()
        over_ctas = np.cumsum(pair, 1) - pair
        base[:, d0:d0 + ns] = (dpre[:, None] + over_ctas).T
        tot[c] = sums.sum()
    assert (base >= 0).all()
    return base, np.cumsum(tot) - tot, sl


def _work(work_p, m):
    """The scratch's parts (the Work struct): two entry buffers [m, 2],
    the sorted positions, the heads' positions and the run lists."""
    w = _view(work_p, 9 * m + 3, torch.int32).numpy()
    return (w[:2 * m].reshape(m, 2), w[2 * m:4 * m].reshape(m, 2),
            w[4 * m:5 * m], w[5 * m:6 * m + 1], w[6 * m + 1:])


def _emulate_sort(idx, work_p, m, S, rps):
    nrows = S * rps
    bits = nrows.bit_length()
    C = _sort_cluster(m)
    L = -(-m // C)
    big = L > SORT_TILE
    assert big == (m > CAPACITY)
    lo = [c * L for c in range(C)]
    n = [max(0, min(L, m - c * L)) for c in range(C)]
    # Rounds per warp of a tile, per CTA.
    R = [SORT_TILE // SORT_THREADS if big else -(-k // SORT_THREADS)
         for k in n]
    buf0, buf1, spos, hp, runs = _work(work_p, m)
    f = np.array([_flat_row(int(x), S, rps) for x in idx], np.int64)
    keys = np.where(f < 0, nrows, f)
    pos = np.arange(m, dtype=np.int64)
    for p in range(-(-bits // DIGIT_BITS)):
        shift = p * DIGIT_BITS
        nd = 1 << min(DIGIT_BITS, bits - shift)
        tiles = [[(t0, min(SORT_TILE if big else L, lo[c] + n[c] - t0))
                  for t0 in range(lo[c], lo[c] + n[c],
                                  SORT_TILE if big else L)]
                 for c in range(C)]
        ranked = {}
        cnt = np.zeros((C, nd), np.int64)
        for c in range(C):  # the counts (in device memory: a first sweep)
            for t0, tn in tiles[c]:
                ranked[t0] = _rank_tile(keys[t0:t0 + tn], R[c], shift,
                                        nd)
                cnt[c] += ranked[t0][2]
        base, off, sl = _cluster_offsets(cnt)
        out_k = np.full(m, -1, np.int64)
        out_p = np.full(m, -1, np.int64)
        for c in range(C):  # the scatter, the running count carried
            running = np.zeros(nd, np.int64)
            for t0, tn in tiles[c]:
                lr, pre, tot = ranked[t0]
                k = keys[t0:t0 + tn]
                d = (k >> shift) & (nd - 1)
                w = np.arange(tn) // (32 * R[c])
                at = off[d // sl] + base[c, d] + running[d] + pre[w, d] + lr
                if not big:  # the owner CTA's shared memory
                    o = at // L
                    assert (at - o * L < np.array(n)[o]).all()
                assert (out_k[at] == -1).all()
                out_k[at], out_p[at] = k, pos[t0:t0 + tn]
                running += tot
        assert (out_k >= 0).all()
        keys, pos = out_k, out_p
        if big:
            dst = buf1 if p & 1 else buf0
            dst[:, 0], dst[:, 1] = keys, pos
    spos[:] = pos

    # The runs: each CTA lists its heads (where the key changes) in order;
    # a run's length runs to the next head, the CTA's last one to the
    # first head of the next CTA that has one (or m), which every CTA
    # learns from the (first head, last run's head, short and long runs
    # but the last) each CTA sends to all.  The lists hold the CTAs' runs
    # in CTA order, each CTA's in head order.
    head = np.ones(m, bool)
    head[1:] = keys[1:] != keys[:-1]
    lhp = [lo[c] + np.nonzero(head[lo[c]:lo[c] + n[c]])[0]
           for c in range(C)]
    if big:  # the heads' positions in device memory
        for c in range(C):
            hp[lo[c]:lo[c] + lhp[c].size] = lhp[c]
    first = [h[0] if h.size else m for h in lhp]
    k_short = k_long = 0
    for c in range(C):
        nxt = min(first[c + 1:], default=m)
        g = lhp[c]
        length = np.diff(np.r_[g, nxt])
        keep = keys[g] < nrows
        for lg in (False, True):
            pick = keep & ((length > K_LONG) == lg)
            for st, ln, kk in zip(g[pick], length[pick], keys[g[pick]]):
                if lg:
                    at, k_long = 2 + 3 * (m - 1 - k_long), k_long + 1
                else:
                    at, k_short = 2 + 3 * k_short, k_short + 1
                runs[at:at + 3] = (st, ln, kk)
    runs[:2] = k_short, k_long


# -- the push kernels --------------------------------------------------------------

def _walk(x, fill, length, rb, ldt, tw, it, ring, free, dtype):
    """A tile's pipelined walk through the ring: stage b (rb rows, written
    into its slot by `fill`) in slot it % K_STAGES, filled when the
    consumers wait on it (a slot only after its release); each row's add
    followed by the load of the row AHEAD on, from the next slot (after
    its wait) for a slot's last AHEAD rows; rows past a slot's last are
    loaded but never added.  Returns (x, it)."""
    assert rb % AHEAD == 0

    def wait(stage, b):
        s = stage % K_STAGES
        assert free[s]  # its previous stage was released
        free[s] = False
        cnt = min(rb, length - b * rb)
        slot = ring[s * rb * ldt:(s + 1) * rb * ldt]
        slot[:] = np.nan
        fill(slot, b, cnt)
        return s, cnt

    def load(s, r):  # row r of slot s; rows past the slot read on
        at = (s * rb + r) * ldt
        assert at + tw <= ring.size  # inside the padded ring
        return ring[at:at + tw]

    nb = -(-length // rb)
    s, cnt = wait(it, 0)
    v = [load(s, i) for i in range(AHEAD)]
    for b in range(nb):
        s1, cnt1 = s, 0
        for r0 in range(0, cnt, AHEAD):
            ahead = (s, r0 + AHEAD)
            if r0 + AHEAD >= cnt and b + 1 < nb:
                s1, cnt1 = wait(it + 1, b + 1)
                ahead = (s1, 0)
            n = min(AHEAD, cnt - r0)
            for i in range(n):
                assert not np.isnan(v[i]).any()
                x = _round(x + v[i], dtype)
            if n == AHEAD:
                v = [load(ahead[0], ahead[1] + i) for i in range(AHEAD)]
        free[s] = True  # each warp's lane 0 arrives on empty[s]
        it, s, cnt = it + 1, s1, cnt1
    return x, it


def _producers(rows, spos, start, rb, gc, gw, size, by16):
    """A long-run CTA's producer threads: `fill(slot, b, cnt)` copies the
    group's columns [gc, gc + gw) of stage b's rows from their list
    positions into a ring slot (rows GROUP values apart), 16 bytes per
    thread and row (each thread at most 8 rows a stage, its positions
    loaded a stage ahead), or row by row over the producer warps."""
    np_ = LONG_THREADS - 32
    vals = 16 // size  # values per 16-byte chunk

    def fill(slot, b, cnt):
        pos = spos[start + b * rb:start + b * rb + cnt]
        if not by16:
            for pw in range(np_ // 32):
                for r in range(pw, cnt, np_ // 32):
                    slot[r * GROUP:r * GROUP + gw] = rows[pos[r], gc:gc + gw]
            return
        cpr = gw * size // 16
        per = np_ // cpr
        seen = np.zeros((cnt, cpr), int)
        for pt in range(per * cpr):
            rr, k = divmod(pt, cpr)
            for i in range(8):
                r = rr + i * per
                if r < cnt:
                    at = r * GROUP + k * vals
                    slot[at:at + vals] = rows[pos[r], gc + k * vals:
                                              gc + (k + 1) * vals]
                    seen[r, k] += 1
        assert (seen == 1).all()  # every chunk of every row, once

    return fill


def _butterfly_lane0(sq):
    """The xor butterfly over a warp's 32 values: lane 0's sum."""
    v = sq.astype(np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return np.float32(v[0])


def _adagrad_step(store, acc, row, g, total, dim, lr, eps, dtype):
    a = np.float32(np.float32(acc[row].item())
                   + np.float32(np.float32(total) / np.float32(dim)))
    denom = np.float32(np.sqrt(a) + np.float32(eps))
    step = _round((np.float32(lr) * g) / denom, dtype)
    store[row] = torch.from_numpy(store[row].float().numpy() - step).to(dtype)
    acc[row] = float(a)


def _emulate_push(store_p, acc_p, rows_p, work_p, m, dim, lr, eps, code):
    dtype = _DTYPES[code]
    size = torch.empty(0, dtype=dtype).element_size()
    rows = _view(rows_p, m * dim, dtype).view(m, dim).float().numpy()
    _, _, spos, _, runs = _work(work_p, m)
    short = [tuple(int(v) for v in runs[2 + 3 * k:5 + 3 * k])
             for k in range(runs[0])]
    long_ = [tuple(int(v) for v in runs[3 * (m - k) - 1:3 * (m - k) + 2])
             for k in range(runs[1])]
    assert all(0 < ln <= K_LONG for _, ln, _ in short)
    assert all(ln > K_LONG for _, ln, _ in long_)
    nrows = max(r for _, _, r in short + long_) + 1 if short or long_ else 0
    store = _view(store_p, nrows * dim, dtype).view(nrows, dim)
    acc = None if acc_p is None else _view(acc_p, nrows, torch.float32)
    # long_runs_kernel: one cluster of G CTAs per run, CTA g on columns
    # [c0 + GROUP g, c0 + GROUP (g + 1)) of each tile, its adding warp's
    # lane l on one of them; each CTA's ring (rows of GROUP values) and
    # stage count carry over the runs it takes (here every run, CTA by CTA).
    G = -(-min(dim, K_TILE) // GROUP)
    per = (LONG_THREADS - 32) // (GROUP * size // 16)  # rows per sweep
    rb = min(RING_ROWS, (RING_BYTES // K_STAGES) // (GROUP * size), 8 * per)
    rb -= rb % AHEAD
    by16 = rows_p % 16 == 0 and dim * size % 16 == 0
    result = {}  # (run, group) -> the group's columns' sums
    for grp in range(G):
        ring = np.full((K_STAGES * rb + AHEAD) * GROUP, np.nan,
                       np.float32)
        free = [True] * K_STAGES
        it = 0
        for h, (start, length, row) in enumerate(long_):
            g = np.zeros(dim, np.float32)
            sq = np.zeros(32, np.float32)  # per lane, tile order
            for c0 in range(0, dim, K_TILE):
                gc = c0 + GROUP * grp
                gw = min(GROUP, min(K_TILE, dim - c0) - GROUP * grp)
                if gw <= 0:
                    continue
                x0 = (store[row, gc:gc + gw].float().numpy() if acc is None
                      else np.zeros(gw, np.float32))
                fill = _producers(rows, spos, start, rb, gc, gw, size, by16)
                x, it = _walk(x0, fill, length, rb, GROUP, gw, it, ring,
                              free, dtype)
                g[gc:gc + gw] = x
                sq[:gw] = sq[:gw] + x * x
            result[h, grp] = (g, _butterfly_lane0(sq))
    for h, (start, length, row) in enumerate(long_):
        g = sum(result[h, grp][0] for grp in range(G))  # disjoint columns
        if acc is None:
            store[row] = torch.from_numpy(g).to(dtype)
            continue
        total = result[h, 0][1]
        for grp in range(1, G):  # the CTAs in turn
            total = np.float32(total + result[h, grp][1])
        _adagrad_step(store, acc, row, g, total, dim, lr, eps, dtype)

    # the short runs, rows read through the sorted positions: the sum per
    # (run, 4 columns), row-wise Adagrad one warp per run, lane l on
    # columns l, l + 32, ...
    for start, length, row in short:
        src = rows[spos[start:start + length]]
        if acc is None:
            for c0 in range(0, dim, 4):
                cols = np.arange(c0, min(dim, c0 + 4))
                x = store[row, cols].float().numpy()
                for r in range(length):
                    x = _round(x + src[r, cols], dtype)
                store[row, cols] = torch.from_numpy(x).to(dtype)
            continue
        g = np.zeros(dim, np.float32)
        for r in range(length):
            g = _round(g + src[r], dtype)
        sq = np.zeros(32, np.float32)  # per lane, chunk order
        for c0 in range(0, dim, 32):
            n = min(32, dim - c0)
            sq[:n] = sq[:n] + g[c0:c0 + n] * g[c0:c0 + n]
        _adagrad_step(store, acc, row, g, _butterfly_lane0(sq), dim, lr,
                      eps, dtype)


def _emulator():
    calls = []

    def call(name, *args):
        calls.append(name)
        if name == "pstt_sparse_sort":
            idx_p, work_p, m, S, rps, _ = args
            idx = _view(idx_p, m, torch.int32).numpy()
            _emulate_sort(idx, work_p, m, S, rps)
        elif name == "pstt_sparse_scatter_add":
            store, rows, work, m, dim, code, _ = args
            _emulate_push(store, None, rows, work, m, dim, 0, 0, code)
        elif name == "pstt_sparse_row_adagrad":
            store, acc, rows, work, m, dim, lr, eps, code, _ = args
            _emulate_push(store, acc, rows, work, m, dim, lr, eps, code)
        elif name == "pstt_sparse_gather_rows":
            store_p, idx_p, out_p, m, row_bytes, S, rps, _ = args
            idx = _view(idx_p, m, torch.int32).tolist()
            store = _view(store_p, S * rps * row_bytes, torch.uint8).view(
                S * rps, row_bytes)
            out = _view(out_p, m * row_bytes, torch.uint8).view(m, row_bytes)
            for j, x in enumerate(idx):
                r = _flat_row(x, S, rps)
                out[j] = store[r] if r >= 0 else 0
        else:
            raise AssertionError(name)

    return call, calls


@pytest.fixture()
def emulated(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, over the emulation."""
    check = sr._on_cuda
    monkeypatch.setattr(sr, "_on_cuda", lambda *a: (check(*a), True)[1])
    call, calls = _emulator()
    monkeypatch.setattr(_native, "call", call)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    sr.reset_launches()
    return calls


def _case(seed, S, rps, dim, W, n, dtype, runs=()):
    """Zipf indices (long runs) plus forced runs of given lengths, some
    out of range, and update rows."""
    rng = np.random.default_rng(seed)
    idx = skewed_indices(S * rps, W, n, seed=seed).reshape(-1)
    pos = 0
    for row, length in runs:  # runs of exactly `length` in the list
        idx[idx == row] = (row + 1) % (S * rps)
        idx[pos:pos + length] = row
        pos += length
    idx[rng.choice(idx.size, 5, replace=False)] = [-1, -7, S * rps,
                                                   S * rps + 3, 2 ** 30]
    idx = torch.from_numpy(idx.reshape(W, n).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(W, n, dim)).astype(
        np.float32)).to(dtype)
    store = torch.from_numpy(rng.normal(size=(S * rps, dim)).astype(
        np.float32)).to(dtype)
    return store, idx, rows


# (S, rps, dim, W, n, dtype, forced runs).  Runs on both sides of kLong,
# long runs that wrap the ring (4 slots of 128 rows at dim 64, of 32 at
# dim 300 in two column tiles), widths whose rows are not 16 bytes, and
# lists of 1,280 and 960 updates that take a cluster of one CTA.
CASES = [
    (8, 64, 64, 8, 160, torch.float32, ((5, 1100), (9, 65), (13, 33),
                                        (17, 32), (21, 31))),
    (8, 16, 2, 8, 120, torch.float32, ((3, 31), (6, 800))),
    (4, 10, 300, 4, 60, torch.float32, ((2, 200),)),
    (8, 20, 8, 8, 50, torch.bfloat16, ((4, 130),)),
    (1, 50, 33, 1, 80, torch.float32, ((0, 66),)),
]


@pytest.mark.parametrize("S,rps,dim,W,n,dtype,runs", CASES)
def test_emulated_push_kernels_match_the_plain_versions(
        emulated, S, rps, dim, W, n, dtype, runs):
    store, idx, rows = _case(S * dim, S, rps, dim, W, n, dtype, runs)
    want = sr.scatter_add_reference(store.clone(), idx, rows, S, rps)
    got = sr.scatter_add(store.clone(), idx, rows, S, rps)
    assert torch.equal(got, want)

    acc0 = torch.rand(S * rps, generator=torch.Generator().manual_seed(1))
    ws, wa = sr.row_adagrad_reference(store.clone(), acc0.clone(), idx, rows,
                                      S, rps, 0.05, 1e-8)
    gs, ga = sr.row_adagrad(store.clone(), acc0.clone(), idx, rows, S, rps,
                            0.05, 1e-8)
    torch.testing.assert_close(ga, wa, rtol=1e-5, atol=1e-6)
    if dtype == torch.float32:
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-6)
    else:  # a step one bf16 ulp apart may round the row differently
        torch.testing.assert_close(gs.float(), ws.float(), rtol=1e-2,
                                   atol=1e-2)
    assert sr.launches["sparse_scatter_add"] == 1
    assert sr.launches["sparse_row_adagrad"] == 1
    assert emulated == ["pstt_sparse_sort", "pstt_sparse_scatter_add",
                        "pstt_sparse_sort", "pstt_sparse_row_adagrad"]
    # Three kernels per push: the sort, the long runs, the short runs.
    assert sum(_KERNELS[c] for c in emulated) == 2 * 3


@pytest.mark.parametrize("S,rps,dim,W,n,dtype,runs", CASES)
def test_emulated_gather_matches_the_plain_version(
        emulated, S, rps, dim, W, n, dtype, runs):
    store, idx, _ = _case(S + dim, S, rps, dim, W, n, dtype, runs)
    got = sr.gather_rows(store, idx, S, rps)
    assert tuple(got.shape) == (W, n, dim)
    assert torch.equal(got, sr.gather_rows_reference(store, idx, S, rps))
    assert sr.launches["sparse_gather_rows"] == 1


def test_emulated_push_reaches_no_library_sort(emulated, monkeypatch):
    """On the kernel path neither push calls torch.sort or argsort: the
    order comes from the sort kernel."""
    store, idx, rows = _case(7, 8, 64, 64, 8, 160, torch.float32,
                             ((5, 700),))
    want = sr.scatter_add_reference(store.clone(), idx, rows, 8, 64)
    acc = torch.rand(8 * 64, generator=torch.Generator().manual_seed(2))
    ws, wa = sr.row_adagrad_reference(store.clone(), acc.clone(), idx, rows,
                                      8, 64, 0.05, 1e-8)

    def refuse(*args, **kwargs):
        raise AssertionError("a library sort on the kernel path")

    for owner in (torch, torch.Tensor):
        monkeypatch.setattr(owner, "sort", refuse)
        monkeypatch.setattr(owner, "argsort", refuse)
    got = sr.scatter_add(store.clone(), idx, rows, 8, 64)
    gs, ga = sr.row_adagrad(store.clone(), acc.clone(), idx, rows, 8, 64,
                            0.05, 1e-8)
    monkeypatch.undo()
    assert torch.equal(got, want)
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ga, wa, rtol=1e-5, atol=1e-6)


def _sort_input(kind):
    """(indices, S, rps) of one sort case."""
    rng = np.random.default_rng(len(kind))
    if kind == "all equal":
        return np.full(5000, 17), 8, 64
    if kind == "all distinct":
        return rng.permutation(6000), 8, 1000
    if kind == "all the sentinel":
        return np.concatenate([np.full(300, -3), np.full(300, 8 * 64)]), 8, 64
    if kind == "m of 1":
        return np.array([5]), 8, 64
    if kind == "m not a multiple of a tile":
        return rng.integers(-5, 3000, 2048 * 3 + 777), 4, 700
    if kind == "above one cluster":
        return skewed_indices(5000, 1, CAPACITY + 1000, seed=3)[0], 8, 625
    assert kind == "three digits"  # 2**22 rows: keys of 23 bits
    return rng.integers(0, 1 << 22, 3000), 1, 1 << 22


@pytest.mark.parametrize("kind", [
    "all equal", "all distinct", "all the sentinel", "m of 1",
    "m not a multiple of a tile", "above one cluster", "three digits"])
def test_emulated_sort_equals_a_stable_argsort(kind):
    """sort_kernel's passes, cluster prefix and run lists, emulated, give
    np.argsort(kind="stable")'s order and the runs of equal keys."""
    idx, S, rps = _sort_input(kind)
    idx = torch.from_numpy(idx.astype(np.int32))
    m, nrows = idx.numel(), S * rps
    work = torch.empty(9 * m + 3, dtype=torch.int32)
    _emulate_sort(idx.numpy(), work.data_ptr(), m, S, rps)
    keys = np.array([_flat_row(int(x), S, rps) for x in idx.numpy()])
    keys = np.where(keys < 0, nrows, keys)
    order = np.argsort(keys, kind="stable")
    _, _, spos, _, runs = _work(work.data_ptr(), m)
    assert np.array_equal(spos, order)
    sk = keys[order]
    heads = np.nonzero(np.r_[True, sk[1:] != sk[:-1]])[0]
    lengths = np.diff(np.r_[heads, m])
    want = [(int(h), int(ln), int(sk[h]))
            for h, ln in zip(heads, lengths) if sk[h] < nrows]
    # Each list in the order of the sorted list.
    assert [tuple(runs[2 + 3 * k:5 + 3 * k]) for k in range(runs[0])] == [
        w for w in want if w[1] <= K_LONG]
    assert [tuple(runs[2 + 3 * (m - 1 - k):5 + 3 * (m - 1 - k)])
            for k in range(runs[1])] == [w for w in want if w[1] > K_LONG]
