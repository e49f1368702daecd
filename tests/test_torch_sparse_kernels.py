"""The sparse row kernels' index arithmetic, emulated on the CPU.

``csrc/sparse_rows.cu`` runs only on the card.  Here ``_native.call`` is
replaced by a numpy emulation of each C entry that follows the kernels
step by step: the flat-row keys (and the zeroed run counters);
``prepare_kernel``'s copy of the update
rows into sorted order and its run lists (each appended in a shuffled
order, as the atomics may; a short run with the length its binary search
finds); ``long_runs_kernel``, one CTA per long run, with the warp's
32-lane search for the run's end, column tiles of ``kTile``, and the
ring of ``kStages`` slots of ``rb`` rows that its producer warp fills
with bulk copies, slot and phase counted over every stage the CTA takes;
the short runs' kernels (the sum: one thread per run and 4 columns;
row-wise Adagrad: one warp per run); the fixed-order reductions of
row-wise Adagrad; and the gather.  The constants are read from the source, so the emulation keeps
the compiled shapes.  The wrappers in ``ops/sparse_rows.py`` run their
CUDA branch on CPU tensors, so their glue (the sort, the scratch, the
arguments) is exercised too.  Bars: the sum push and the pull equal the
plain versions bit for bit; row-wise Adagrad within rtol 1e-5 / atol 1e-6
(the order of the row's sum of squares).
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
_DTYPES = {0: torch.float32, 1: torch.bfloat16}


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


def _run_length(skeys, i, m):
    """run_length: 32 probes per round, strides 1, 32, 1024, ..., then
    the bracket narrowed 32-fold per round."""
    lanes = np.arange(32)
    k = skeys[i]

    def count(p, limit):
        inside = [bool(q < limit and skeys[q] == k) for q in p]
        assert inside == sorted(inside, reverse=True)  # a prefix of lanes
        return sum(inside)

    a, s = i + 1, 1
    while True:
        t = count(a + lanes * s, m)
        if t < 32:
            b = a + t * s
            if t > 0:
                a += (t - 1) * s + 1
            break
        a += 31 * s + 1
        s *= 32
    b = min(b, m)
    while b > a:
        s = (b - a + 31) // 32
        t = count(a + lanes * s, b)
        b = min(b, a + t * s)
        if t > 0:
            a += (t - 1) * s + 1
    return a - i


def _walk_ring(x, srows, start, c0, length, tw, dtype, rb, ring, it):
    """A tile's walk through the ring: stage b (rb rows of tw columns from
    c0) goes to slot it % K_STAGES, it counting the CTA's stages; the
    column threads add each stage in order.  Returns (x, it)."""
    for b in range(-(-length // rb)):
        s = it % K_STAGES
        cnt = min(rb, length - b * rb)
        ring[s, :cnt, :tw] = srows[start + b * rb:start + b * rb + cnt,
                                   c0:c0 + tw]
        for r in range(cnt):
            x = _round(x + ring[s, r, :tw], dtype)
        it += 1
    return x, it


def _add_rows(x, srows, start, length, cols, dtype):
    """Columns ``cols`` of a short run's sorted rows added to x in order."""
    for r in range(length):
        x = _round(x + srows[start + r, cols], dtype)
    return x


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


def _emulator(rng):
    calls = []

    def prepare(rows, skeys, perm, srows, runs, m, dim, nrows):
        """prepare_kernel: the sorted f32 rows and the two run lists."""
        short, long_ = [], []
        for j in range(m):
            k = skeys[j]
            if k >= nrows:
                continue
            srows[j, :dim] = rows[perm[j]]
            if j > 0 and skeys[j - 1] == k:
                continue
            if j + K_LONG < m and skeys[j + K_LONG] == k:
                long_.append(j)
                continue
            lo, hi = j + 1, min(m, j + K_LONG)  # binary search for the end
            while lo < hi:
                mid = (lo + hi) // 2
                lo, hi = (mid + 1, hi) if skeys[mid] == k else (lo, mid)
            short.append((j, lo - j, k))
        short = [short[i] for i in rng.permutation(len(short))]
        long_ = [long_[i] for i in rng.permutation(len(long_))]
        assert runs[0] == runs[1] == 0  # zeroed with the keys
        runs[0], runs[1] = len(short), len(long_)
        for i, e in enumerate(short):
            runs[2 + 3 * i:5 + 3 * i] = e
        for i, j in enumerate(long_):
            runs[2 + 3 * m - 1 - i] = j

    def push(store_p, acc_p, rows_p, skeys_p, perm_p, srows_p, runs_p, m,
             dim, nrows, lr, eps, code):
        dtype = _DTYPES[code]
        store = _view(store_p, nrows * dim, dtype).view(nrows, dim)
        rows = _view(rows_p, m * dim, dtype).view(m, dim).float().numpy()
        skeys = _view(skeys_p, m, torch.int32).numpy()
        perm = _view(perm_p, m, torch.int64).numpy()
        ld = -(-dim // 4) * 4  # the sorted rows' padded stride
        srows = _view(srows_p, m * ld, torch.float32).view(m, ld).numpy()
        runs = _view(runs_p, 3 * m + 2, torch.int32).numpy()
        acc = None if acc_p is None else _view(acc_p, nrows, torch.float32)
        prepare(rows, skeys, perm, srows, runs, m, dim, nrows)
        ldt0 = -(-min(dim, K_TILE) // 4) * 4
        rb = RING_BYTES // (K_STAGES * ldt0 * 4)
        ring = np.full((K_STAGES, rb, ldt0), np.nan, np.float32)
        cw = -(-min(dim, K_TILE) // 32)  # consumer warps

        # long_runs_kernel: one CTA per run (all on one CTA here: the ring
        # and its stage count carry over), tiles of K_TILE columns, thread t
        # on column c0 + t.
        it = 0
        for h in range(runs[1]):
            start = int(runs[2 + 3 * m - 1 - h])
            row, length = int(skeys[start]), _run_length(skeys, start, m)
            g = np.zeros(dim, np.float32)
            sq = np.zeros(32 * cw, np.float32)  # per thread, tile order
            for c0 in range(0, dim, K_TILE):
                tw = min(K_TILE, dim - c0)
                x0 = (store[row, c0:c0 + tw].float().numpy() if acc is None
                      else np.zeros(tw, np.float32))
                x, it = _walk_ring(x0, srows, start, c0, length, tw, dtype,
                                   rb, ring, it)
                if acc is None:
                    store[row, c0:c0 + tw] = torch.from_numpy(x).to(dtype)
                else:
                    g[c0:c0 + tw] = x
                    sq[:tw] = sq[:tw] + x * x
            if acc is not None:
                parts = [_butterfly_lane0(sq[32 * w:32 * w + 32])
                         for w in range(cw)]
                total = parts[0]
                for p in parts[1:]:
                    total = np.float32(total + p)
                _adagrad_step(store, acc, row, g, total, dim, lr, eps, dtype)

        # the short runs: the sum per (run, 4 columns), row-wise Adagrad
        # one warp per run, lane l on columns l, l + 32, ...
        for h in range(runs[0]):
            start, length, row = (int(v) for v in runs[2 + 3 * h:5 + 3 * h])
            if acc is None:
                for c0 in range(0, dim, 4):
                    cols = np.arange(c0, min(dim, c0 + 4))
                    x = _add_rows(store[row, cols].float().numpy(), srows,
                                  start, length, cols, dtype)
                    store[row, cols] = torch.from_numpy(x).to(dtype)
                continue
            g = _add_rows(np.zeros(dim, np.float32), srows, start, length,
                          np.arange(dim), dtype)
            sq = np.zeros(32, np.float32)  # per lane, chunk order
            for c0 in range(0, dim, 32):
                n = min(32, dim - c0)
                sq[:n] = sq[:n] + g[c0:c0 + n] * g[c0:c0 + n]
            _adagrad_step(store, acc, row, g, _butterfly_lane0(sq), dim, lr,
                          eps, dtype)

    def call(name, *args):
        calls.append(name)
        if name == "pstt_sparse_keys":
            idx_p, keys_p, m, S, rps, runs_p, _ = args
            _view(runs_p, 2, torch.int32)[:] = 0  # the run counters
            idx = _view(idx_p, m, torch.int32).tolist()
            keys = _view(keys_p, m, torch.int32)
            for j, x in enumerate(idx):
                r = _flat_row(x, S, rps)
                keys[j] = S * rps if r < 0 else r
        elif name == "pstt_sparse_scatter_add":
            (store, rows, skeys, perm, srows, runs, m, dim, nrows, code,
             _) = args
            push(store, None, rows, skeys, perm, srows, runs, m, dim, nrows,
                 0, 0, code)
        elif name == "pstt_sparse_row_adagrad":
            (store, acc, rows, skeys, perm, srows, runs, m, dim, nrows, lr,
             eps, code, _) = args
            push(store, acc, rows, skeys, perm, srows, runs, m, dim, nrows,
                 lr, eps, code)
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
    call, calls = _emulator(np.random.default_rng(0))
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
# dim 300 in two column tiles), and widths that pad the sorted rows.
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
    assert emulated.count("pstt_sparse_keys") == 2


@pytest.mark.parametrize("S,rps,dim,W,n,dtype,runs", CASES)
def test_emulated_gather_matches_the_plain_version(
        emulated, S, rps, dim, W, n, dtype, runs):
    store, idx, _ = _case(S + dim, S, rps, dim, W, n, dtype, runs)
    got = sr.gather_rows(store, idx, S, rps)
    assert tuple(got.shape) == (W, n, dim)
    assert torch.equal(got, sr.gather_rows_reference(store, idx, S, rps))
    assert sr.launches["sparse_gather_rows"] == 1


def test_run_length_search_on_every_run():
    """The 32-lane search finds every run's end, runs of 1 to 40,000."""
    lengths = [1, 2, 31, 32, 33, 63, 64, 65, 1023, 1024, 1025, 1057, 6029,
               33 * 1024 + 5, 40_000]
    skeys = np.repeat(np.arange(len(lengths)), lengths)
    m = skeys.size
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    for start, length in zip(starts, lengths):
        assert _run_length(skeys, int(start), m) == length
