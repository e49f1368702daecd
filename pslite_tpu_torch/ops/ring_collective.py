"""Fused ring push_pull: reduce-scatter + server update + all-gather.

Counterpart of the Pallas kernel in ``pslite_tpu/ops/ring_collective.py``
(``ring_push_pull`` :468 and ``ring_push`` :497, one kernel
``_ring_call`` :389 with an all-gather flag).  The JAX functions run per
device inside ``shard_map``; here one call covers the whole group of n
virtual ranks on one device: ``grads`` is ``[n, padded]`` (row w is rank
w's whole bucket) and ``store`` is the ``[padded]`` store of all shards.

Two layouts (:func:`ring_geometry`):

- the 1-D ring (``kv_shards=None``): chunk c of ``padded / n`` elements
  is owned by rank c;
- the (dp, kv) sub-rings of the 2-D data plane (``kv_shards=B``, the
  kernel's ``mesh_axes`` as ``pslite_tpu/parallel/engine.py:713-752``
  calls it): the store is B kv shards, and each shard runs its own ring
  over the n worker ranks, with sub-chunks of ``ring_chunk_len(shard,
  n)`` elements and the tile padding at the end of the shard.  The new
  store is the pulled value, as that engine keeps it.

``compress=True`` is the int8 wire-compressed ring (f32 only): every
reduce-scatter hop re-quantizes its partial sum with one absmax scale per
half-chunk ("region"), and the all-gather quantizes the updated region
once at its owner, so every rank pulls the same dequantized values.  The
1-D store keeps full precision; the 2-D store takes the pulled values.

Kernels: ``csrc/ring_push_pull.cu`` and ``csrc/ring_int8.cu``, one launch
per call each; their headers say how they reproduce the TPU ring's order
of arithmetic and what bounds them.  The int8 kernel walks each region
on chip with G thread block clusters of C CTAs (C in 1..16; G > 1, a
"region group", only where the whole launch fits the card at once), the
shape with the least makespan of the regions' bytes per CTA over the
clusters the card runs at once (:func:`int8_cost`,
:func:`int8_launch_shape`; ``cluster=`` forces C or ``(C, G)``).  One launch
takes a table of buckets and a table of their regions, computed here
once per layout (:func:`int8_group_regions`, longest first) and kept as
a small device tensor.  A region's G * C CTAs keep ``G * C * 57,344`` of
its values in shared memory; a longer region spills the rest of each CTA's
slice to its bucket's ``[padded]`` scratch tensor, which the wrapper
allocates only then (:func:`int8_plan`).  The store is updated IN PLACE
(the JAX programs donate it); ``pulled`` is a fresh tensor.  On a CPU
tensor the plain PyTorch version runs; on a CUDA tensor the kernel
launches, or the call raises.  ``launches`` counts
wrapper calls that launched their kernel, by variant
(``ring_push_pull``/``ring_push``, ``_2d``, ``_int8``) and dtype, and
nothing else.

K4 across processes (:func:`ring_reduce_peers`, :func:`ring_gather_peers`)
runs the 1-D ring of a group whose ranks belong to several worker
processes on one card: each process holds its own ranks' grads rows and
store shards in exchange memory that the others map through CUDA IPC
(:func:`ipc_alloc`, :func:`ipc_export`, :func:`ipc_open`;
``parallel/peers.py`` manages it, ``parallel/engine.py`` drives the op
with its barriers).  Its plain version,
:func:`ring_push_pull_peers_reference`, gathers the rows and store shards
of a CPU group over gloo and runs the single-process plain ring.  They
count under ``ring_reduce_peers[...]`` and ``ring_gather_peers[...]``.

Two wrappers run many rings per call, for the engine's groups and
replays: :func:`ring_push_pull_group` (k buckets in one launch of the
grouped kernel per dtype and one int8 cluster launch over every int8
bucket's regions, bit-identical to k single launches) and
:func:`ring_replay` (T steps on one store from one C call).  They count
under ``ring_push_pull_group...`` (one per launch) and
``ring_replay...`` (one per call).
"""

from __future__ import annotations

import ctypes
import functools
import heapq
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import logging as log
from . import _native

_LANES = 128
_SUBLANES = 8
_TILE = _LANES * _SUBLANES  # minimum chunk granularity (fp32 elements)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INV127 = np.float32(1) / np.float32(127)  # XLA's f32 form of x / 127
_MIN_RING_SCALE = 1e-30


def _variant(with_ag: bool, kv: bool, compress: bool, dtype) -> str:
    op = "ring_push_pull" if with_ag else "ring_push"
    return (f"{op}{'_2d' if kv else ''}{'_int8' if compress else ''}"
            f"[{str(dtype).replace('torch.', '')}]")


def _group_variant(kv: bool, compress: bool, dtype) -> str:
    return (f"ring_push_pull_group{'_2d' if kv else ''}"
            f"{'_int8' if compress else ''}"
            f"[{str(dtype).replace('torch.', '')}]")


def _replay_variant(with_ag: bool, kv: bool, dtype) -> str:
    return (f"ring_replay_{'push_pull' if with_ag else 'push'}"
            f"{'_2d' if kv else ''}[{str(dtype).replace('torch.', '')}]")


launches: Dict[str, int] = {
    **{_variant(ag, kv, cp, dt): 0
       for ag in (True, False) for kv in (False, True)
       for cp in (False, True) for dt in _DTYPE_CODES
       if not cp or dt == torch.float32},
    **{_group_variant(kv, cp, dt): 0
       for kv in (False, True) for cp in (False, True) for dt in _DTYPE_CODES
       if not cp or dt == torch.float32},
    **{_replay_variant(ag, kv, dt): 0
       for ag in (True, False) for kv in (False, True) for dt in _DTYPE_CODES},
    **{f"ring_{part}_peers[{str(dt).replace('torch.', '')}]": 0
       for part in ("reduce", "gather") for dt in _DTYPE_CODES},
    **{f"ring_reduce_peers_2d[{str(dt).replace('torch.', '')}]": 0
       for dt in _DTYPE_CODES},
    "ring_int8_peers[float32]": 0,
    "ring_int8_peers_2d[float32]": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def ring_chunk_len(total_len: int, num_devices: int, dtype=None,
                   bidir: bool = True, compress: bool = False) -> int:
    """Per-rank chunk length (elements) of the TPU ring for a bucket of
    ``total_len`` elements — identical to the JAX function: ceil to the
    (8, 128) tile for 4-byte dtypes, (16, 128) for 2-byte ones, (32, 128)
    for int8 payloads, doubled in bidirectional mode.  The port keeps it
    because the bidirectional split point is half of this length."""
    tile = _TILE
    if compress:
        tile = 4 * _TILE
    elif dtype is not None and _itemsize(dtype) == 2:
        tile = 2 * _TILE
    if bidir:
        tile = 2 * tile
    chunk = -(-total_len // num_devices)
    return -(-chunk // tile) * tile


def ring_handle(handle: str) -> Tuple[int, float]:
    """(kernel code, lr) of an elementwise ring handle: 0 = sum,
    1 = assign, 2 = ``sgd[:lr]`` (lr defaults to 0.01, as the engine's)."""
    if handle == "sum":
        return 0, 0.0
    if handle == "assign":
        return 1, 0.0
    if isinstance(handle, str) and (handle == "sgd"
                                    or handle.startswith("sgd:")):
        return 2, float(handle.split(":", 1)[1]) if ":" in handle else 0.01
    raise ValueError(f"not an elementwise server handle: {handle!r}")


class RingGeometry(NamedTuple):
    """Where each element sits on the ring (``csrc/ring_geometry.cuh``):
    kv shards of ``period`` elements, sub-chunks of ``sub`` elements
    (sub-chunk c owned by rank c), direction 1 from ``split`` on within
    a sub-chunk.  ``padded_sub`` is the TPU kernel's tile-padded chunk
    and ``ndir`` its number of directions: the regions that share one
    int8 scale are the ``padded_sub / ndir`` halves of padded chunks."""

    n: int
    period: int
    sub: int
    split: int
    kv: bool
    padded_sub: int
    ndir: int


@functools.lru_cache(maxsize=1024)
def ring_geometry(n: int, padded: int, dtype, bidir: bool = True,
                  compress: bool = False,
                  kv_shards: Optional[int] = None) -> RingGeometry:
    """The ring layout of an n-rank ring over a ``[padded]`` store: the
    1-D ring (``kv_shards=None``: chunks of ``padded / n``, the split at
    half the tile-padded chunk, computed with ``compress`` since int8
    payloads tile coarser), or ``kv_shards`` independent sub-rings."""
    ndir = 2 if bidir else 1
    if kv_shards is None:
        log.check(padded % n == 0, f"padded length {padded} not a multiple "
                                   f"of the rank count {n}")
        sub = padded // n
        kchunk = ring_chunk_len(padded, n, dtype, bidir=bidir,
                                compress=compress)
        split = kchunk // 2 if bidir else sub
        return RingGeometry(n, padded, sub, split, False,
                            kchunk if bidir else sub, ndir)
    log.check(kv_shards >= 1 and padded % kv_shards == 0,
              f"padded length {padded} not a multiple of the kv shard "
              f"count {kv_shards}")
    period = padded // kv_shards
    sub = ring_chunk_len(period, n, dtype, bidir=bidir, compress=compress)
    return RingGeometry(n, period, sub, sub // 2 if bidir else sub, True,
                        sub, ndir)


def _geometry(grads, store, bidir: bool, compress: bool,
              kv_shards: Optional[int]) -> RingGeometry:
    """Validate the operands and return their ring geometry."""
    log.check(grads.dim() == 2, "grads must be [n, padded]")
    log.check(store.dim() == 1, "store must be [padded]")
    n, padded = int(grads.shape[0]), int(grads.shape[1])
    log.check_eq(int(store.shape[0]), padded, "grads/store length")
    log.check(grads.dtype == store.dtype, "grads/store dtype differ")
    log.check(store.dtype in _DTYPE_CODES, f"unsupported dtype {store.dtype}")
    if compress:
        if store.dtype != torch.float32:
            raise ValueError("int8 wire compression requires float32 stores")
        log.check(n >= 2, "the compressed ring needs at least 2 ranks")
    log.check(grads.device == store.device, "grads/store on different devices")
    log.check(grads.is_contiguous() and store.is_contiguous(),
              "grads and store must be contiguous")
    return ring_geometry(n, padded, store.dtype, bidir, compress, kv_shards)


# -- the int8 kernel's regions and launch shape -------------------------------

INT8_SMEM_FLOATS = 57_344  # csrc/ring_int8.cu kMaxSmemFloats (224 KiB)
# CTAs per cluster the launcher chooses from: 1 (no DSMEM traffic) up to
# 16; 8 is the largest portable cluster size, 9-16 are non-portable ones.
INT8_CLUSTERS = tuple(range(16, 0, -1))
# Clusters per region (a region group): 1 up to csrc/ring_int8.cu
# kMaxGroups, taken only where the whole launch fits the card at once.
INT8_GROUPS = tuple(range(1, 33))
INT8_MAX_GROUP = 48  # csrc/ring_int8.cu kMaxGroup: buckets per launch
# The fixed cost of one sweep of a region (a hop's barrier, its first loads
# in flight), counted in the bytes a CTA streams meanwhile (about 1.3 us at
# 25 GB/s, an H100 SM's share of HBM when every SM streams).
INT8_HOP_BYTES = 32 << 10
# What a region group adds to each sweep, in the same bytes: the clusters'
# maxima meeting in global memory (a slot written, the group's slots polled
# from L2) and a one-wave launch's SMs sharing HBM.  Fitted on an H100 to
# the host-free times of every launch shape of the n = 2 bucket, the
# 8-rank and dp 4 x kv 2 buckets and both cross-process int8 launches
# (PERF.md section 6): it picks the fastest shape of each within 0.3 %.
INT8_GROUP_HOP_BYTES = 160 << 10
# Bytes per spilled value per hop: 8 written and read back, and the
# premium the same fit puts on them.
INT8_SPILL_BYTES = 12


def int8_regions(geo: RingGeometry, padded: int):
    """The non-empty regions of a ``[padded]`` bucket, in the order of
    their number ``(shard * n + chunk) * 2 + direction``:
    ``(table, ids)``, with ``table`` int64 ``[R, 4]`` rows (start,
    length, chunk c, walk step: 1 in direction 0, n-1 in direction 1)
    and ``ids`` the region numbers.  Each region is a contiguous range:
    in shard b, sub-chunk c covers ``[c*sub, min((c+1)*sub, period))``,
    direction 0 its first ``split`` values and direction 1 the rest."""
    n = geo.n
    b = np.arange(padded // geo.period, dtype=np.int64)[:, None, None]
    c = np.arange(n, dtype=np.int64)[None, :, None]
    d = np.arange(2, dtype=np.int64)[None, None, :]
    clen = np.clip(geo.period - c * geo.sub, 0, geo.sub)
    mid = np.minimum(geo.split, clen)
    lo = np.where(d == 0, 0, mid)
    hi = np.where(d == 0, mid, clen)
    shape = np.broadcast_shapes(b.shape, c.shape, d.shape)
    cols = [b * geo.period + c * geo.sub + lo, hi - lo, c,
            np.where(d == 0, 1, n - 1)]
    table = np.stack([np.broadcast_to(x, shape).reshape(-1) for x in cols],
                     axis=1)
    keep = table[:, 1] > 0
    return (np.ascontiguousarray(table[keep]),
            np.flatnonzero(keep).astype(np.int64))


# A launch's layout: ((geometry, padded length), ...) of its buckets, in
# the order of its bucket table.  Everything below depends on it alone.
Int8Layout = Tuple[Tuple[RingGeometry, int], ...]


@functools.lru_cache(maxsize=64)
def int8_group_regions(layout: Int8Layout) -> np.ndarray:
    """The launch's region table: int64 ``[R, 5]`` rows (start, length,
    chunk, step, bucket index) of every bucket's :func:`int8_regions`,
    longest first (ties in bucket and region order), the order in which
    the kernel's clusters are launched."""
    parts = []
    for b, (geo, padded) in enumerate(layout):
        rows = int8_regions(geo, padded)[0]
        parts.append(np.column_stack(
            [rows, np.full(len(rows), b, dtype=np.int64)]))
    table = (np.concatenate(parts) if parts
             else np.empty((0, 5), dtype=np.int64))
    order = np.argsort(-table[:, 1], kind="stable")
    return np.ascontiguousarray(table[order])


class Int8Plan(NamedTuple):
    """How the int8 kernel lays a launch onto ``groups`` clusters of
    ``cluster`` CTAs per region: ``slice`` values per CTA of the longest
    region, the first ``smem_floats`` of them in shared memory;
    ``scratch`` the values of scratch the spilling buckets take (each its
    ``[padded]``; 0 when nothing spills); ``vec`` whether every bucket's
    regions take float4.  Per bucket: ``spills`` and ``vecs``."""

    cluster: int
    nregions: int
    slice: int
    smem_floats: int
    scratch: int
    vec: bool
    spills: Tuple[bool, ...]
    vecs: Tuple[bool, ...]
    groups: int = 1


def _slices(lengths: np.ndarray, parts: int) -> np.ndarray:
    """Values per CTA: ``round4(ceil(len / parts))``, as the kernel cuts a
    region into ``parts`` = clusters x CTAs slices."""
    return -(-(-(-lengths // parts)) // 4) * 4


def int8_slices(length: int, cluster: int, groups: int = 1):
    """The ``(first value, count)`` of each CTA's slice of a region of
    ``length`` values, in the kernel's order (slice ``member * cluster +
    rank``): the slices tile the region, the last ones may be empty."""
    parts = cluster * groups
    width = int(_slices(np.int64(length), parts))
    out = []
    for j in range(parts):
        lo = min(j * width, length)
        out.append((lo, min(lo + width, length) - lo))
    return out


def _plan_rows(table: np.ndarray, lengths, cluster: int,
               groups: int = 1) -> Int8Plan:
    """The :class:`Int8Plan` of a region table over buckets whose scratch
    takes ``lengths[b]`` values each."""
    slices = _slices(table[:, 1], cluster * groups)
    longest = int(slices.max()) if len(table) else 0
    smem = max(min(longest, INT8_SMEM_FLOATS), 4)
    spills = [False] * len(lengths)
    vecs = [True] * len(lengths)
    for row, sl in zip(table, slices):
        b = int(row[4])
        spills[b] |= bool(sl > smem)
        vecs[b] &= bool(row[0] % 4 == 0 and row[1] % 4 == 0)
    scratch = sum(p for p, sp in zip(lengths, spills) if sp)
    return Int8Plan(cluster, len(table), longest, smem, scratch, all(vecs),
                    tuple(spills), tuple(vecs), groups)


@functools.lru_cache(maxsize=256)
def int8_plan(layout: Int8Layout, cluster: int, groups: int = 1) -> Int8Plan:
    """The :class:`Int8Plan` of a launch's buckets at ``groups`` clusters
    of ``cluster`` CTAs per region."""
    return _plan_rows(int8_group_regions(layout), [p for _, p in layout],
                      cluster, groups)


def _cost_rows(table: np.ndarray, ns: np.ndarray, plan: Int8Plan,
               active: int) -> Optional[int]:
    """:func:`int8_cost` of a region table whose rows walk rings of
    ``ns[row]`` ranks."""
    if active <= 0 or (plan.groups > 1 and len(table) * plan.groups > active):
        return None
    if not len(table):
        return 0
    slices = _slices(table[:, 1], plan.cluster * plan.groups)
    spilled = slices - np.minimum(slices, plan.smem_floats)
    cost = (slices * (ns + 3) * 4 + spilled * INT8_SPILL_BYTES * (ns - 1)
            + (ns + 1) * INT8_HOP_BYTES)
    if plan.groups > 1:
        return int((cost + (ns + 1) * INT8_GROUP_HOP_BYTES).max())
    if len(cost) <= active:
        return int(cost.max())
    slots = [0] * active
    for c in cost.tolist():
        heapq.heapreplace(slots, slots[0] + c)
    return max(slots)


def int8_cost(layout: Int8Layout, cluster: int, active: int,
              groups: int = 1) -> Optional[int]:
    """The launch's makespan in bytes per CTA at ``groups`` clusters of
    ``cluster`` CTAs per region with ``active`` co-resident clusters (None
    when none fit, or when a region group's launch would not fit at once):
    the launcher's measure for choosing a launch shape.  Each cluster of a
    region row costs what one of its CTAs moves, ``slice * (n+3) * 4``
    bytes, plus :data:`INT8_SPILL_BYTES` per spilled value on each of the
    n-1 hops that carry it, plus :data:`INT8_HOP_BYTES` for each of its
    n+1 sweeps (and :data:`INT8_GROUP_HOP_BYTES` more in a group).  One
    cluster per region: the rows, longest first, each go to the least
    loaded of the ``active`` cluster slots, as the block scheduler hands
    out clusters; a group's launch runs in one wave, so its makespan is
    its longest row."""
    if active <= 0:
        return None
    table = int8_group_regions(layout)
    n = np.array([geo.n for geo, _ in layout], dtype=np.int64)[table[:, 4]]
    return _cost_rows(table, n, int8_plan(layout, cluster, groups), active)


def _occupancy(cluster: int, smem_floats: int, mode: int,
               count: int, peers: bool = False) -> int:
    out = ctypes.c_int(0)
    _native.call("pstt_ring_int8_peers_occupancy" if peers
                 else "pstt_ring_int8_occupancy", cluster, smem_floats, mode,
                 count, ctypes.byref(out))
    return out.value


def _mode(plan: Int8Plan) -> int:
    """The kernel instantiation a launch runs: 4 (every bucket float4), 1
    (none) or 0 (mixed), as far as the geometry tells."""
    return 4 if plan.vec else (0 if any(plan.vecs) else 1)


def int8_shapes(nregions: int, active: Dict[int, int]):
    """The ``(cluster, groups)`` launch shapes the card runs for
    ``nregions`` regions: every cluster size with a co-resident cluster
    at one cluster per region, and a region group wherever every region's
    clusters fit the card at once; fewer groups first."""
    return [(c, g) for g in INT8_GROUPS for c in INT8_CLUSTERS
            if active.get(c, 0) > 0
            and (g == 1 or nregions * g <= active[c])]


def _pick(costs: Dict[tuple, Optional[int]]) -> Tuple[int, int]:
    """The least costly shape of ``costs`` (ties: fewer groups, then the
    larger cluster, as :func:`int8_shapes` orders them)."""
    fits = [k for k, v in costs.items() if v is not None]
    if not fits:
        raise RuntimeError(f"the card runs no cluster of {INT8_CLUSTERS} "
                           f"CTAs for the int8 ring")
    return min(fits, key=lambda k: costs[k])


def int8_pick_cluster(layout: Int8Layout,
                      active: Dict[int, int]) -> Tuple[int, int]:
    """The ``(cluster, groups)`` of :func:`int8_shapes` with the least
    :func:`int8_cost`, given the co-resident clusters ``active`` the card
    allows at each cluster size.  On an H100 (7 clusters of 10-16 CTAs
    at once, 9 of 9, 15 of 8 and 7, 17 of 6, 22 of 5, 30 of 4, 39 of 3,
    66 of 2, 132 of 1) the main path's 16 regions take 3 waves of 16
    CTAs, and the 4 regions at n = 2 16 clusters of 2 CTAs each, in one
    wave."""
    nregions = len(int8_group_regions(layout))
    return _pick({(c, g): int8_cost(layout, c, active[c], g)
                  for c, g in int8_shapes(nregions, active)})


@functools.lru_cache(maxsize=64)
def _launch_shape(layout: Int8Layout, device_index: int):
    """``((cluster, groups), co-resident clusters per cluster size)``: the
    occupancy at a size is asked at its one-cluster plan's shared memory,
    the most any group count of that size takes."""
    active = {}
    with torch.cuda.device(device_index):
        for c in INT8_CLUSTERS:
            plan = int8_plan(layout, c)
            active[c] = _occupancy(c, plan.smem_floats, _mode(plan),
                                   len(layout))
    return int8_pick_cluster(layout, active), active


def int8_layout(n: int, padded, kv_shards: Optional[int] = None,
                bidir: bool = True) -> Int8Layout:
    """The layout of one bucket of ``padded`` values, or of a group when
    ``padded`` is a sequence of bucket lengths, on an n-rank ring."""
    pads = [padded] if isinstance(padded, int) else list(padded)
    return tuple((ring_geometry(n, p, torch.float32, bidir, True, kv_shards),
                  p) for p in pads)


def int8_launch_shape(n: int, padded, kv_shards: Optional[int] = None,
                      bidir: bool = True, device="cuda") -> dict:
    """The int8 kernel's launch shape on the card of ``device`` for one
    bucket of ``padded`` values, or for the group of bucket lengths
    ``padded`` (at most :data:`INT8_MAX_GROUP`): the chosen cluster size
    and group count, its plan, the co-resident clusters the card allows
    at each cluster size, the waves of clusters and the cost of each
    shape the card runs (keys ``"CxG"``)."""
    layout = int8_layout(n, padded, kv_shards, bidir)
    log.check(len(layout) <= INT8_MAX_GROUP, "more buckets than one launch")
    (cluster, groups), active = _launch_shape(
        layout, _device_index(torch.device(device)))
    plan = int8_plan(layout, cluster, groups)
    shape = plan._asdict()
    del shape["spills"], shape["vecs"]
    return dict(shape, max_active_clusters=active,
                waves=_waves(plan.nregions, groups, active[cluster]),
                cost={f"{c}x{g}": int8_cost(layout, c, active[c], g)
                      for c, g in int8_shapes(plan.nregions, active)})


def _waves(nregions: int, groups: int, active: int) -> int:
    """Waves of clusters: a region group's launch runs in one."""
    return 1 if groups > 1 else -(-nregions // active)


def _shape_arg(cluster) -> Optional[Tuple[int, int]]:
    """A forced launch shape: ``cluster`` CTAs (one cluster per region),
    ``(cluster, groups)``, or None for the launcher's choice."""
    if cluster is None:
        return None
    c, g = (cluster, 1) if isinstance(cluster, int) else cluster
    log.check(c in INT8_CLUSTERS and g in INT8_GROUPS,
              f"no int8 launch shape {cluster!r}")
    return int(c), int(g)


_EXCHANGE: Dict[tuple, torch.Tensor] = {}


def _exchange(nregions: int, groups: int, device: torch.device,
              stream: int):
    """The zeroed exchange words of a region group's launch on ``stream``
    (``csrc/ring_int8.cu``: 2 * groups slots and a count per region row),
    or None for one cluster per region.  Each launch leaves them zeroed,
    so one allocation per size and stream serves every launch of that
    size there (launches on one stream run in order; two streams never
    share words), and none is ever freed: a captured graph keeps its
    address."""
    if groups == 1:
        return None
    key = (nregions * (2 * groups + 1), device, stream)
    buf = _EXCHANGE.get(key)
    if buf is None:
        log.check(device.type != "cuda"
                  or not torch.cuda.is_current_stream_capturing(),
                  "a region group's first launch of a shape on a stream "
                  "must come before that stream's capture")
        buf = _EXCHANGE[key] = torch.zeros(key[0], dtype=torch.int64,
                                           device=device)
    return buf


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=64)
def _region_table(layout: Int8Layout, device: torch.device):
    """:func:`int8_group_regions` on ``device``, copied there once."""
    return torch.from_numpy(int8_group_regions(layout)).to(device)


def _launch_int8(grads_list, stores, pulled, geos, code: int, lr: float,
                 with_ag: bool, cluster=None) -> int:
    """Launches of ``pstt_ring_int8`` over non-empty buckets, at most
    :data:`INT8_MAX_GROUP` per launch, each at the forced ``cluster``
    (CTAs, or ``(CTAs, groups)``) or at the shape its layout's plan
    picks.  ``pulled`` holds a ``[padded]`` tensor or None per bucket.
    Returns the launch count."""
    dev = stores[0].device
    stream = _native.stream_ptr(dev)
    live = [i for i, s in enumerate(stores) if s.numel()]
    forced = _shape_arg(cluster)
    made = 0
    for lo in range(0, len(live), INT8_MAX_GROUP):
        part = live[lo:lo + INT8_MAX_GROUP]
        layout = tuple((geos[i], stores[i].numel()) for i in part)
        size, groups = forced or _launch_shape(layout, _device_index(dev))[0]
        plan = int8_plan(layout, size, groups)
        spill_slots = _slots([stores[i] for i in part], plan.spills,
                             torch.float32, dev)
        desc = np.empty((len(part), 7), dtype=np.int64)
        for row, i in enumerate(part):
            p, sc = pulled[i], spill_slots[row]
            desc[row] = (grads_list[i].data_ptr(), stores[i].data_ptr(),
                         p.data_ptr() if p is not None else 0,
                         sc.data_ptr() if sc is not None else 0,
                         stores[i].numel(), geos[i].n, int(plan.vecs[row]))
        xchg = _exchange(plan.nregions, groups, dev, stream)
        kv = geos[part[0]].kv
        _native.call(
            "pstt_ring_int8", desc.ctypes.data, len(part),
            _region_table(layout, dev).data_ptr(), plan.nregions, size,
            groups, xchg.data_ptr() if xchg is not None else None,
            plan.smem_floats, code, lr, int(with_ag or kv), int(kv), stream,
        )
        made += 1
    return made


def _slots(stores, wanted, dtype, dev):
    """One allocation holding a ``[padded]`` slot of ``dtype`` for each
    store whose ``wanted`` flag is set (None for the others), each slot
    starting 16-byte aligned so its bucket can take vectors."""
    step = _GROUP_ALIGN // dtype.itemsize
    offs, total = [], 0
    for s, w in zip(stores, wanted):
        offs.append(total if w else None)
        if w:
            total += -(-s.numel() // step) * step
    if not total:
        return [None] * len(stores)
    buf = torch.empty(total, dtype=dtype, device=dev)
    return [buf.narrow(0, off, s.numel()) if off is not None else None
            for s, off in zip(stores, offs)]


# -- plain version ---------------------------------------------------------------

def _to_regions(x: torch.Tensor, geo: RingGeometry) -> torch.Tensor:
    """``[..., padded]`` -> ``[..., shards, n, ndir, h]``: each kv shard
    padded at its end to n sub-chunks, each sub-chunk padded at its end
    to the tile-padded chunk, cut into its ndir halves (zeros fill)."""
    lead = x.shape[:-1]
    nb = x.shape[-1] // geo.period
    x = x.reshape(*lead, nb, geo.period)
    x = torch.nn.functional.pad(x, (0, geo.n * geo.sub - geo.period))
    x = x.reshape(*lead, nb, geo.n, geo.sub)
    x = torch.nn.functional.pad(x, (0, geo.padded_sub - geo.sub))
    return x.reshape(*lead, nb, geo.n, geo.ndir, geo.padded_sub // geo.ndir)


def _from_regions(r: torch.Tensor, geo: RingGeometry) -> torch.Tensor:
    """Inverse of :func:`_to_regions` (drops the padding)."""
    nb = r.shape[0]
    x = r.reshape(nb, geo.n, geo.padded_sub)[:, :, :geo.sub]
    return x.reshape(nb, geo.n * geo.sub)[:, :geo.period].reshape(-1)


def _walk(g: torch.Tensor, geo: RingGeometry, k: int) -> torch.Tensor:
    """``[shards, n, ndir, h]``: for every region (shard, chunk c,
    direction d), the grads of the k-th rank of its walk — c+k in
    direction 0, c-k in direction 1 (mod n)."""
    n = geo.n
    c = torch.arange(n, device=g.device)
    parts = [g[(c + k * step) % n, :, c, d]  # [n(c), shards, h]
             for d, step in enumerate((1, n - 1)[:geo.ndir])]
    return torch.stack(parts, dim=2).transpose(0, 1)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """``fmaf(a, b, c)`` of f32 tensors, rounded once: the product of two
    f32 values is exact in float64, the sum is rounded to odd in float64
    (TwoSum error, then the odd neighbour), and float64 -> f32 rounding
    of a round-to-odd value is the single rounding (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _quantize_regions(v: torch.Tensor):
    """(q, scale) of f32 regions ``[..., h]``: one absmax scale per
    region, ``max(amax * f32(1/127), 1e-30)``, q = clip(rint(v / scale),
    ±127) as f32 integers."""
    inv = torch.tensor(_INV127, device=v.device)
    scale = torch.clamp_min(v.abs().amax(dim=-1, keepdim=True) * inv,
                            _MIN_RING_SCALE)
    return torch.clamp(torch.round(v / scale), -127, 127), scale


def _apply_handle(store_r, summed, code: int, lr: float):
    if code == 0:
        return store_r + summed
    if code == 1:
        return summed.clone()
    return store_r - lr * summed


def _ring_reference(grads, store, handle: str, bidir: bool, with_ag: bool,
                    compress: bool = False, kv_shards: Optional[int] = None):
    """Plain PyTorch version of the ring (both layouts, both wire
    formats), in the TPU kernel's order of arithmetic: per region,
    direction 0 sums ranks c+1, ..., c and direction 1 sums c-1, ..., c,
    each add in the dtype; compressed hops re-quantize as the kernel
    does, with ``fmaf`` emulated exactly (:func:`_fma_f32`)."""
    geo = _geometry(grads, store, bidir, compress, kv_shards)
    code, lr = ring_handle(handle)
    if not store.numel():  # an empty bucket has no regions
        return store.clone() if with_ag else store
    g = _to_regions(grads, geo)  # [n(rank), shards, n(c), ndir, h]
    s = _to_regions(store, geo)  # [shards, n, ndir, h]
    acc = _walk(g, geo, 1).clone()
    for k in range(2, geo.n + 1):
        gk = _walk(g, geo, k)
        if compress:
            q, scale = _quantize_regions(acc)
            acc = _fma_f32(q, scale.expand_as(q), gk)
        else:
            acc += gk
    up = _apply_handle(s, acc, code, lr)
    pulled_r = up
    if compress and (with_ag or geo.kv):
        q, scale = _quantize_regions(up)
        pulled_r = q * scale
    new_store = pulled_r if geo.kv else up
    store.copy_(_from_regions(new_store, geo))
    if not with_ag:
        return store
    return _from_regions(pulled_r, geo).clone()


# -- kernels -----------------------------------------------------------------------

def _ring(grads, store, handle: str, bidir: bool, with_ag: bool,
          compress: bool, kv_shards: Optional[int]):
    if store.device.type == "cpu":
        return _ring_reference(grads, store, handle, bidir, with_ag,
                               compress, kv_shards)
    log.check(store.device.type == "cuda",
              f"unsupported device {store.device}")
    geo = _geometry(grads, store, bidir, compress, kv_shards)
    code, lr = ring_handle(handle)
    pulled = torch.empty_like(store) if with_ag else None
    if compress:
        _launch_int8([grads], [store], [pulled], [geo], code, lr, with_ag)
    else:
        _native.call(
            "pstt_ring_push_pull", grads.data_ptr(), store.data_ptr(),
            pulled.data_ptr() if with_ag else None,
            _DTYPE_CODES[store.dtype], geo.n, geo.period, geo.sub, geo.split,
            int(geo.kv), store.numel(), code, lr,
            _native.stream_ptr(store.device),
        )
    launches[_variant(with_ag, geo.kv, compress, store.dtype)] += 1
    return pulled if with_ag else store


def ring_push_pull(grads, store, handle: str = "sum", bidir: bool = True,
                   compress: bool = False, kv_shards: Optional[int] = None):
    """Fused RS + update + AG over n virtual ranks.

    ``grads`` ``[n, padded]`` (rank w's bucket in row w), ``store``
    ``[padded]`` (updated in place); ``handle`` is ``"sum"``,
    ``"assign"`` or ``"sgd[:lr]"``; ``compress`` runs the int8 ring;
    ``kv_shards`` runs that many sub-rings (the 2-D layout).  Returns
    the pulled ``[padded]`` tensor (a new tensor)."""
    return _ring(grads, store, handle, bidir, True, compress, kv_shards)


def ring_push(grads, store, handle: str = "sum", bidir: bool = True,
              compress: bool = False, kv_shards: Optional[int] = None):
    """Push-only ring: RS + update, no pulled output.  Returns ``store``,
    which holds what :func:`ring_push_pull` would leave in it (on the
    compressed sub-rings, the dequantized all-gather values)."""
    return _ring(grads, store, handle, bidir, False, compress, kv_shards)


def ring_push_pull_reference(grads, store, handle: str = "sum",
                             bidir: bool = True, compress: bool = False,
                             kv_shards: Optional[int] = None):
    """Plain version of :func:`ring_push_pull` on any device."""
    return _ring_reference(grads, store, handle, bidir, True, compress,
                           kv_shards)


def ring_push_reference(grads, store, handle: str = "sum",
                        bidir: bool = True, compress: bool = False,
                        kv_shards: Optional[int] = None):
    """Plain version of :func:`ring_push` on any device."""
    return _ring_reference(grads, store, handle, bidir, False, compress,
                           kv_shards)


# -- grouped launch: push_pull over many buckets -------------------------------

_GROUP_ALIGN = 16  # bytes: each pulled slot of a group starts 16-byte aligned


def _group_geometries(grads_list, stores, bidir, compress, kv_shards):
    """Validate a group's operands; returns ``(geometries, compress flags)``.
    The checks of :func:`_geometry`, once per bucket."""
    log.check(len(grads_list) == len(stores), "grads/stores count differ")
    flags = ([bool(compress)] * len(stores)
             if isinstance(compress, (bool, int)) else
             [bool(c) for c in compress])
    log.check(len(flags) == len(stores), "compress flags count differ")
    geos = [_geometry(g, s, bidir, c, kv_shards)
            for g, s, c in zip(grads_list, stores, flags)]
    return geos, flags


def ring_push_pull_group_reference(grads_list, stores, handle: str = "sum",
                                   bidir: bool = True, compress=False,
                                   kv_shards: Optional[int] = None):
    """Plain version of :func:`ring_push_pull_group`: the plain ring of
    each bucket, one after another."""
    _, flags = _group_geometries(grads_list, stores, bidir, compress,
                                 kv_shards)
    return [_ring_reference(g, s, handle, bidir, True, c, kv_shards)
            for g, s, c in zip(grads_list, stores, flags)]


def ring_push_pull_group(grads_list, stores, handle: str = "sum",
                         bidir: bool = True, compress=False,
                         kv_shards: Optional[int] = None):
    """:func:`ring_push_pull` over k buckets in one call: ``grads_list[i]``
    ``[n, padded_i]`` and ``stores[i]`` ``[padded_i]`` (updated in place);
    ``compress`` is one flag for every bucket or one per bucket.  Returns
    the k pulled tensors (fresh).

    On CUDA the uncompressed buckets of each dtype run in one launch of
    ``ring_group_kernel`` per 48 buckets (``csrc/ring_push_pull.cu``),
    and the int8 buckets in one launch of the cluster kernel per 48
    buckets over all their regions (``csrc/ring_int8.cu``), each
    bit-identical to its single launches.  ``launches`` counts each
    launch under ``ring_push_pull_group[...]`` (``_2d``, ``_int8``
    variants)."""
    if not stores:
        return []
    dev = stores[0].device
    if dev.type == "cpu":
        return ring_push_pull_group_reference(grads_list, stores, handle,
                                              bidir, compress, kv_shards)
    log.check(dev.type == "cuda", f"unsupported device {dev}")
    geos, flags = _group_geometries(grads_list, stores, bidir, compress,
                                    kv_shards)
    log.check(all(s.device == dev for s in stores),
              "group buckets on different devices")
    code, lr = ring_handle(handle)
    pulled = [None] * len(stores)
    kv = kv_shards is not None
    by_kind: Dict[tuple, list] = {}  # (compress, dtype) -> bucket indices
    for i, (s, c) in enumerate(zip(stores, flags)):
        if s.numel():
            by_kind.setdefault((c, s.dtype), []).append(i)
        else:
            pulled[i] = torch.empty_like(s)
    stream = _native.stream_ptr(dev)
    for (compress_, dtype), idx in by_kind.items():
        # One allocation holds every pulled slot of the kind.
        for i, p in zip(idx, _slots([stores[i] for i in idx],
                                    [True] * len(idx), dtype, dev)):
            pulled[i] = p
        if compress_:
            launches[_group_variant(kv, True, dtype)] += _launch_int8(
                [grads_list[i] for i in idx], [stores[i] for i in idx],
                [pulled[i] for i in idx], [geos[i] for i in idx], code, lr,
                True)
            continue
        desc = np.empty((len(idx), 9), dtype=np.int64)
        for row, i in enumerate(idx):
            s, geo = stores[i], geos[i]
            desc[row] = (grads_list[i].data_ptr(), s.data_ptr(),
                         pulled[i].data_ptr(), s.numel(), geo.period,
                         geo.sub, geo.split, geo.n, int(geo.kv))
        made = ctypes.c_int(0)
        _native.call("pstt_ring_group", desc.ctypes.data, len(idx),
                     _DTYPE_CODES[dtype], code, lr, stream, ctypes.byref(made))
        launches[_group_variant(kv, False, dtype)] += made.value
    return pulled


# -- replay: T steps of the ring on one store, one call ------------------------

def ring_replay_reference(grads_seq, store, handle: str = "sum",
                          bidir: bool = True,
                          kv_shards: Optional[int] = None,
                          keep: str = "all"):
    """Plain version of :func:`ring_replay`: the plain ring, T times."""
    log.check(grads_seq.dim() == 3, "grads_seq must be [T, n, padded]")
    outs = (torch.empty((grads_seq.shape[0], store.numel()),
                        dtype=store.dtype, device=store.device)
            if keep == "all" else None)
    for t in range(grads_seq.shape[0]):
        out = _ring_reference(grads_seq[t], store, handle, bidir,
                              keep == "all", False, kv_shards)
        if outs is not None:
            outs[t] = out
    return outs if outs is not None else store


def ring_replay(grads_seq, store, handle: str = "sum", bidir: bool = True,
                kv_shards: Optional[int] = None, keep: str = "all"):
    """T consecutive ring steps on one store (the engine's replay):
    ``grads_seq`` ``[T, n, padded]``, ``store`` ``[padded]`` (updated in
    place).  ``keep="all"`` runs :func:`ring_push_pull` each step and
    returns the ``[T, padded]`` pulled rows (fresh); ``keep="last"`` runs
    :func:`ring_push` each step and returns ``store``.

    On CUDA one C call (``pstt_ring_replay``) launches the T steps, so the
    wrapper's host cost is paid once per replay; ``launches`` counts that
    call once under ``ring_replay_push_pull[...]`` / ``ring_replay_push``
    (``_2d`` on sub-rings).  Uncompressed rings only: the engine replays
    int8 configurations on the torch path, as the JAX engine does."""
    log.check(keep in ("all", "last"), f"bad keep {keep!r}")
    if store.device.type == "cpu":
        return ring_replay_reference(grads_seq, store, handle, bidir,
                                     kv_shards, keep)
    log.check(store.device.type == "cuda", f"unsupported device {store.device}")
    log.check(grads_seq.dim() == 3 and grads_seq.is_contiguous(),
              "grads_seq must be a contiguous [T, n, padded] tensor")
    steps = int(grads_seq.shape[0])
    outs = (torch.empty((steps, store.numel()), dtype=store.dtype,
                        device=store.device) if keep == "all" else None)
    if steps == 0:
        return outs if outs is not None else store
    geo = _geometry(grads_seq[0], store, bidir, False, kv_shards)
    code, lr = ring_handle(handle)
    _native.call(
        "pstt_ring_replay", grads_seq.data_ptr(), store.data_ptr(),
        outs.data_ptr() if outs is not None else None,
        _DTYPE_CODES[store.dtype], geo.n, geo.period, geo.sub, geo.split,
        int(geo.kv), store.numel(), code, lr, steps,
        _native.stream_ptr(store.device),
    )
    launches[_replay_variant(keep == "all", geo.kv, store.dtype)] += 1
    return outs if outs is not None else store


# -- K4 across processes -----------------------------------------------------

class _CudaMemory:
    """``__cuda_array_interface__`` of ``nbytes`` bytes at a device
    address, for ``torch.as_tensor``: a tensor on memory PyTorch did not
    allocate (an IPC slab, or a peer's slab mapped into this process)."""

    def __init__(self, addr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (int(nbytes),), "typestr": "|u1",
            "data": (int(addr), False), "version": 3, "strides": None}


def device_view(addr: int, shape, dtype: torch.dtype,
                device) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the device memory at
    ``addr`` (no copy; the caller keeps the memory alive)."""
    shape = tuple(int(x) for x in shape)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    raw = torch.as_tensor(_CudaMemory(addr, nbytes), device=device)
    return raw.view(dtype).view(shape)


def ipc_alloc(nbytes: int, device) -> int:
    """``nbytes`` of zeroed device memory from ``cudaMalloc``, outside
    PyTorch's caching allocator (an IPC handle maps an allocation's base,
    which the caching allocator's blocks do not start at)."""
    out = ctypes.c_void_p()
    _native.call("pstt_ipc_alloc", _device_index(torch.device(device)),
                 int(nbytes), ctypes.byref(out))
    return int(out.value)


def ipc_free(addr: int, device) -> None:
    _native.call("pstt_ipc_free", _device_index(torch.device(device)), addr)


def ipc_export(addr: int, device) -> bytes:
    """The 64-byte IPC handle of an :func:`ipc_alloc` allocation."""
    buf = ctypes.create_string_buffer(64)
    _native.call("pstt_ipc_export", _device_index(torch.device(device)),
                 addr, buf)
    return buf.raw


def ipc_open(handle: bytes, device) -> int:
    """Map another process's allocation into this one; its address here.
    Raises with the CUDA error when the card refuses."""
    log.check(len(handle) == 64, "an IPC handle is 64 bytes")
    buf = ctypes.create_string_buffer(bytes(handle), 64)
    out = ctypes.c_void_p()
    _native.call("pstt_ipc_open", _device_index(torch.device(device)), buf,
                 ctypes.byref(out))
    return int(out.value)


def ipc_close(addr: int, device) -> None:
    _native.call("pstt_ipc_close", _device_index(torch.device(device)), addr)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _segments(lo, count: int) -> list:
    """``(first element, length, store offset)`` rows: ``lo`` is one
    first element (the store's ``count`` values from it) or the rows."""
    if isinstance(lo, (int, np.integer)):
        return [(int(lo), int(count), 0)]
    return [tuple(int(x) for x in seg) for seg in lo]


def ring_reduce_peers(rows, store: torch.Tensor, lo, padded: int,
                      handle: str = "sum", bidir: bool = True,
                      kv_shards: Optional[int] = None) -> None:
    """The reduce of K4 across processes: ``rows`` holds the device
    address of every ring rank's ``[padded]`` grads row (n of them, in
    rank order; a peer's row mapped through :func:`ipc_open`), ``store``
    this process's store values.  ``lo`` is the first element of the
    bucket that ``store[0]`` holds (its values one contiguous range), or
    a list of ``(first element, length, store offset)`` segments.  Those
    elements are summed over the n rows in the TPU ring's order and the
    handle updates ``store`` in place: the bits of :func:`ring_push_pull`
    on the same n rows.  ``kv_shards=B`` runs the 2-D layout's dp
    sub-rings (the rows are then the A dp rows, and the segments this
    process's (kv shard, sub-chunk) pieces).  One launch of
    ``pstt_ring_reduce_peers_segs``; CUDA only."""
    log.check(store.device.type == "cuda",
              "ring_reduce_peers runs on the card (a CPU group takes "
              "ring_push_pull_peers_reference)")
    log.check(store.dim() == 1 and store.is_contiguous(),
              "store must be a contiguous [count] tensor")
    log.check(store.dtype in _DTYPE_CODES, f"unsupported dtype {store.dtype}")
    n = len(rows)
    geo = ring_geometry(n, int(padded), store.dtype, bidir, False, kv_shards)
    segs = _segments(lo, store.numel())
    for start, count, off in segs:
        log.check(0 <= start and start + count <= padded and 0 <= off
                  and off + count <= store.numel(),
                  "a segment falls outside the bucket or the store")
        if not geo.kv:
            log.check(start % geo.sub == 0 and count % geo.sub == 0,
                      "the store shards must be whole chunks of the ring")
    _launch_reduce_peers(rows, store, segs, geo, int(padded),
                         *ring_handle(handle))
    part = "reduce_peers_2d" if geo.kv else "reduce_peers"
    launches[f"ring_{part}[{_dtype_name(store.dtype)}]"] += 1


def _launch_reduce_peers(rows, store, segs, geo: RingGeometry, padded: int,
                         code: int, lr: float) -> None:
    """The launch of :func:`ring_reduce_peers` (its checks done)."""
    table = np.asarray(rows, dtype=np.int64)
    seg_table = np.asarray(segs, dtype=np.int64).reshape(-1, 3)
    _native.call("pstt_ring_reduce_peers_segs", table.ctypes.data,
                 len(table), store.data_ptr(), seg_table.ctypes.data,
                 len(seg_table), _DTYPE_CODES[store.dtype], geo.period,
                 geo.sub, geo.split, int(geo.kv), padded, code, lr,
                 _native.stream_ptr(store.device))


def ring_gather_peers(segments, pulled: torch.Tensor) -> torch.Tensor:
    """The all-gather of K4 across processes: each of ``segments``
    ``(address, offset, length)`` (elements) copies an owner's store
    shards into ``pulled`` at ``offset``.  One launch of
    ``pstt_ring_gather_peers``; CUDA only.  Returns ``pulled``."""
    log.check(pulled.device.type == "cuda",
              "ring_gather_peers runs on the card")
    log.check(pulled.is_contiguous(), "pulled must be contiguous")
    table = np.asarray([tuple(int(x) for x in seg) for seg in segments],
                       dtype=np.int64).reshape(-1, 3)
    log.check(bool(((table[:, 1] >= 0)
                    & (table[:, 1] + table[:, 2] <= pulled.numel())).all()),
              "a segment falls outside pulled")
    _native.call("pstt_ring_gather_peers", table.ctypes.data, len(table),
                 pulled.data_ptr(), pulled.element_size(),
                 _native.stream_ptr(pulled.device))
    launches[f"ring_gather_peers[{_dtype_name(pulled.dtype)}]"] += 1
    return pulled


# -- the int8 ring across processes ------------------------------------------

class Int8PeerPlan(NamedTuple):
    """The regions of an int8 launch across processes: ``table`` int64
    ``[R, 5]`` rows (start, length, chunk, step, piece), longest first,
    and per piece whether its regions, offsets and rows take float4."""

    table: np.ndarray
    vecs: Tuple[bool, ...]


@functools.lru_cache(maxsize=64)
def int8_peer_regions(n: int, padded: int, kv_shards: Optional[int],
                      bidir: bool, spans: tuple) -> Int8PeerPlan:
    """The regions of the pieces ``spans`` ``((start, length, local,
    rows aligned), ...)`` of an n-rank compressed ring over ``padded``
    values: each piece must be whole regions of the ring (a rank's chunk,
    or a (kv shard, dp sub-chunk))."""
    geo = ring_geometry(n, padded, torch.float32, bidir, True, kv_shards)
    regions = int8_regions(geo, padded)[0]
    parts, vecs = [], []
    for j, (start, length, local, rows_aligned) in enumerate(spans):
        sel = regions[(regions[:, 0] >= start)
                      & (regions[:, 0] + regions[:, 1] <= start + length)]
        log.check(int(sel[:, 1].sum()) == length,
                  f"piece [{start}, {start + length}) is not whole regions "
                  f"of the compressed ring")
        parts.append(np.column_stack(
            [sel, np.full(len(sel), j, dtype=np.int64)]))
        vecs.append(bool(rows_aligned and start % 4 == 0 and local % 4 == 0
                         and (sel[:, 0] % 4 == 0).all()
                         and (sel[:, 1] % 4 == 0).all()))
    table = (np.concatenate(parts) if parts
             else np.empty((0, 5), dtype=np.int64))
    order = np.argsort(-table[:, 1], kind="stable")
    return Int8PeerPlan(np.ascontiguousarray(table[order]), tuple(vecs))


def _peer_costs(key: tuple, lengths: tuple, n: int,
                active: Dict[int, int]) -> dict:
    """:func:`int8_cost`-style makespan of each ``(cluster, groups)`` the
    card runs for an int8 launch across processes (``key``:
    :func:`int8_peer_regions`' arguments)."""
    table = int8_peer_regions(*key).table
    ns = np.full(len(table), n, dtype=np.int64)
    return {(c, g): _cost_rows(table, ns, _plan_rows(table, lengths, c, g),
                               active[c])
            for c, g in int8_shapes(len(table), active)}


@functools.lru_cache(maxsize=64)
def _peer_launch_shape(key: tuple, lengths: tuple, n: int,
                       device_index: int) -> tuple:
    """``((cluster, groups), co-resident clusters per size, cost per
    shape)`` of an int8 launch across processes: the shape with the
    least makespan over the co-resident clusters the card allows."""
    plan = int8_peer_regions(*key)
    mode = 4 if all(plan.vecs) else (0 if any(plan.vecs) else 1)
    active = {}
    with torch.cuda.device(device_index):
        for c in INT8_CLUSTERS:
            p = _plan_rows(plan.table, lengths, c)
            active[c] = _occupancy(c, p.smem_floats, mode, len(lengths),
                                   peers=True)
    costs = _peer_costs(key, lengths, n, active)
    return _pick(costs), active, costs


def _peer_key(pieces, padded: int, kv_shards, bidir: bool):
    """``(int8_peer_regions' arguments, piece lengths, n)`` of pieces."""
    spans = tuple((int(start), int(length), int(local),
                   all(int(a) % 16 == 0 for a in addrs))
                  for addrs, start, length, local in pieces)
    return ((len(pieces[0][0]), int(padded), kv_shards, bidir, spans),
            tuple(sp[1] for sp in spans), len(pieces[0][0]))


def int8_peer_launch_shape(pieces, padded: int,
                           kv_shards: Optional[int] = None,
                           bidir: bool = True, device="cuda") -> dict:
    """The launch shape :func:`ring_int8_peers` picks for ``pieces`` on
    the card of ``device``: the cluster size and group count, its
    regions, the clusters the card runs at once at each size, the waves
    and the cost of each shape the card runs (keys ``"CxG"``)."""
    key, lengths, n = _peer_key(pieces, padded, kv_shards, bidir)
    (cluster, groups), active, costs = _peer_launch_shape(
        key, lengths, n, _device_index(torch.device(device)))
    regions = len(int8_peer_regions(*key).table)
    return {"cluster": cluster, "groups": groups, "regions": regions,
            "max_active_clusters": active,
            "waves": _waves(regions, groups, active[cluster]),
            "cost": {f"{c}x{g}": v for (c, g), v in costs.items()}}


@functools.lru_cache(maxsize=256)
def _device_table(values: tuple, device: torch.device) -> torch.Tensor:
    """An int64 device tensor of ``values`` (addresses, region rows),
    copied there once."""
    return torch.tensor(values, dtype=torch.int64).to(device)


def ring_int8_peers(pieces, store: torch.Tensor,
                    pulled: Optional[torch.Tensor], padded: int,
                    handle: str = "sum", with_ag: bool = True,
                    kv_shards: Optional[int] = None, bidir: bool = True,
                    cluster=None) -> Tuple[int, int]:
    """The int8 wire-compressed K4 across processes: ``pieces`` lists
    this process's store pieces as ``(row addresses, first element,
    length, store offset)``, each piece's n rank rows (``[padded]`` f32;
    the dp rows on 2-D) given by their device addresses here, and each
    piece whole regions of the compressed ring (a rank's chunk, or a (kv
    shard, dp sub-chunk)).  The regions of those pieces are walked as
    :func:`ring_push_pull` with ``compress=True`` walks them on one
    process, bit for bit: the handle updates ``store`` in place (the
    1-D store at full precision; the 2-D store takes the dequantized
    all-gather) and, on the 1-D ring with ``with_ag``, ``pulled`` (laid
    out like ``store``) takes the dequantized values of the pieces.  One
    launch of ``pstt_ring_int8_peers`` (the shape :func:`int8_cost`
    picks, or ``cluster``: CTAs, or ``(CTAs, groups)``); CUDA only.
    Returns ``(cluster, groups)``."""
    log.check(store.device.type == "cuda",
              "ring_int8_peers runs on the card (a CPU group takes "
              "ring_push_pull_peers_reference)")
    log.check(store.dtype == torch.float32 and store.dim() == 1
              and store.is_contiguous(),
              "int8 wire compression requires a contiguous float32 store")
    log.check(pulled is None or (pulled.dtype == torch.float32
                                 and pulled.numel() == store.numel()),
              "pulled must be laid out like the store")
    log.check(0 < len(pieces) <= INT8_MAX_GROUP,
              f"1..{INT8_MAX_GROUP} pieces per launch")
    ns = {len(p[0]) for p in pieces}
    log.check(len(ns) == 1 and min(ns) >= 2,
              "every piece sums the same n >= 2 rows")
    n = ns.pop()
    for _, start, length, local in pieces:
        log.check(0 <= local and local + length <= store.numel(),
                  "a piece falls outside the store")
    code, lr = ring_handle(handle)
    size = _launch_int8_peers(pieces, store, pulled, int(padded), n, code,
                              lr, with_ag, kv_shards, bidir, cluster)
    launches["ring_int8_peers_2d[float32]" if kv_shards is not None
             else "ring_int8_peers[float32]"] += 1
    return size


def _launch_int8_peers(pieces, store, pulled, padded: int, n: int,
                       code: int, lr: float, with_ag: bool,
                       kv_shards: Optional[int], bidir: bool,
                       cluster) -> Tuple[int, int]:
    """The launch of :func:`ring_int8_peers` (its checks done): the
    pieces' region table, the row-address table of each piece, the bucket
    table with each piece's pointers; returns ``(cluster, groups)``."""
    kv = kv_shards is not None
    key, lengths, _ = _peer_key(pieces, padded, kv_shards, bidir)
    plan = int8_peer_regions(*key)
    dev = store.device
    size, groups = (_shape_arg(cluster)
                    or _peer_launch_shape(key, lengths, n,
                                          _device_index(dev))[0])
    p = _plan_rows(plan.table, lengths, size, groups)
    scratch = _slots([store.narrow(0, 0, ln) for ln in lengths], p.spills,
                     torch.float32, dev)
    rows = _device_table(tuple(int(a) for addrs, *_ in pieces
                               for a in addrs), dev)
    regions = _device_table(tuple(plan.table.reshape(-1).tolist()), dev)
    stream = _native.stream_ptr(dev)
    xchg = _exchange(len(plan.table), groups, dev, stream)
    b = store.element_size()
    desc = np.zeros((len(pieces), 9), dtype=np.int64)
    for j, ((_, start, length, local), sc) in enumerate(zip(pieces,
                                                            scratch)):
        desc[j] = (rows.data_ptr() + j * n * 8, store.data_ptr() + local * b,
                   pulled.data_ptr() + local * b if pulled is not None
                   else 0, sc.data_ptr() if sc is not None else 0,
                   padded, n, int(plan.vecs[j]), int(start), 0)
    _native.call("pstt_ring_int8_peers", desc.ctypes.data, len(pieces),
                 regions.data_ptr(), len(plan.table), size, groups,
                 xchg.data_ptr() if xchg is not None else None,
                 p.smem_floats, code, lr, int(with_ag or kv), int(kv),
                 stream)
    return size, groups


def ring_peers_reference(pieces, store: torch.Tensor,
                         pulled: Optional[torch.Tensor], padded: int,
                         handle: str = "sum", with_ag: bool = True,
                         compress: bool = False,
                         kv_shards: Optional[int] = None,
                         bidir: bool = True) -> None:
    """Plain version of :func:`ring_reduce_peers` and
    :func:`ring_int8_peers` on any device: ``pieces`` lists ``(rows,
    first element, length, store offset)`` with ``rows`` an ``[n,
    padded]`` tensor of the piece's rank rows.  The single-process plain
    ring runs once per distinct rows tensor over a store holding those
    pieces (a region's values depend on its own values only), and each
    piece keeps its values: ``store`` in place, ``pulled`` (laid out like
    ``store``, or None) the pulled values."""
    groups: Dict[int, list] = {}
    for piece in pieces:
        groups.setdefault(id(piece[0]), []).append(piece)
    for part in groups.values():
        rows = part[0][0]
        full = torch.zeros(int(padded), dtype=store.dtype,
                           device=store.device)
        for _, start, length, local in part:
            full[start:start + length] = store[local:local + length]
        out = _ring_reference(rows.contiguous(), full, handle, bidir, True,
                              compress, kv_shards)
        for _, start, length, local in part:
            store[local:local + length] = full[start:start + length]
            if pulled is not None and with_ag:
                pulled[local:local + length] = out[start:start + length]


def ring_push_pull_peers_reference(grads, store, layout, handle: str = "sum",
                                   bidir: bool = True, with_ag: bool = True,
                                   compress: bool = False,
                                   kv_shards: Optional[int] = None):
    """Plain version of K4 across processes, for a CPU group: every
    process's grads rows (one per slot of ``layout``, a
    ``placement.DenseLayout``) and store pieces are gathered through gloo,
    the single-process plain ring (int8 with ``compress``, the dp
    sub-rings with ``kv_shards``) runs on each ring this process holds a
    piece of, and this process keeps its own pieces (``store`` updated in
    place).  Returns the pulled ``[padded]`` tensor of this process's
    replica (or ``store`` without ``with_ag``).  Every process of the
    group calls it."""
    from ..parallel import distributed

    log.check(store.device.type == "cpu",
              "the rows of a CUDA group never travel through gloo")
    group, me = layout.group, layout.group.process_index
    got = distributed.allgather_object(
        (list(layout.slots[me]), grads.contiguous(), store.clone()))
    rows = {r: torch.as_tensor(t) for slots, g, _ in got
            for r, t in zip(slots, g)}
    stores = {p: torch.as_tensor(got[p][2]) for p in group.processes}
    rings = {}
    for pc in layout.pieces[me]:
        key = layout.rows_of(pc)
        if key not in rings:
            rings[key] = torch.stack([rows[r] for r in key])
    pulled = None
    first = layout.rows_of(layout.pieces[me][0])
    for key, grads_n in rings.items():
        # The ring's whole store: the pieces of every rank on it.
        full = torch.zeros(layout.padded, dtype=store.dtype)
        for p, pcs in layout.pieces.items():
            for pc in pcs:
                if layout.rows_of(pc) == key:
                    full[pc.start:pc.start + pc.length] = \
                        stores[p][pc.local:pc.local + pc.length]
        out = _ring_reference(grads_n, full, handle, bidir, True, compress,
                              kv_shards)
        for pc in layout.pieces[me]:
            if layout.rows_of(pc) == key:
                store[pc.local:pc.local + pc.length] = \
                    full[pc.start:pc.start + pc.length]
        if key == first:
            pulled = out
    return pulled if with_ag else store
