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
on chip with one thread block cluster of 8 to 16 CTAs, the size with the
fewest bytes per CTA times waves on the card (:func:`int8_launch_shape`).
The regions' bounds are computed here once per geometry
(:func:`int8_regions`) and kept as a small device tensor.  A cluster
keeps ``cluster * 57,344`` values of its region in shared memory; a
longer region spills the rest of each CTA's slice to a ``[padded]`` scratch
tensor, which the wrapper allocates only then (:func:`int8_plan`).  The
store is updated IN PLACE (the JAX programs donate it); ``pulled`` is a
fresh tensor.  On a CPU tensor the plain PyTorch version runs; on a CUDA
tensor the kernel launches, or the call raises.  ``launches`` counts
wrapper calls that launched their kernel, by variant
(``ring_push_pull``/``ring_push``, ``_2d``, ``_int8``) and dtype, and
nothing else.

Two wrappers run many rings per call, for the engine's groups and
replays: :func:`ring_push_pull_group` (k buckets in one launch of the
grouped kernel per dtype, bit-identical to k single launches; int8
buckets in one cluster launch each) and :func:`ring_replay` (T steps on
one store from one C call).  They count under ``ring_push_pull_group...``
(one per launch) and ``ring_replay...`` (one per call).
"""

from __future__ import annotations

import ctypes
import functools
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
    raise ValueError(f"not a ring handle: {handle!r}")


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
# CTAs per region the launcher chooses from: 8 is the largest portable
# cluster size, 9-16 are non-portable ones.
INT8_CLUSTERS = tuple(range(16, 7, -1))


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


class Int8Plan(NamedTuple):
    """How the int8 kernel lays a geometry onto clusters of ``cluster``
    CTAs: ``slice`` values per CTA of the longest region, the first
    ``smem_floats`` of them in shared memory, and the length of the
    ``[padded]`` scratch the rest spills to (0 when nothing spills)."""

    cluster: int
    nregions: int
    slice: int
    smem_floats: int
    scratch: int
    vec: bool


@functools.lru_cache(maxsize=64)
def int8_plan(geo: RingGeometry, padded: int, cluster: int) -> Int8Plan:
    """The :class:`Int8Plan` of a geometry at a cluster size (as
    ``csrc/ring_int8.cu`` cuts regions: ``round4(ceil(len / cluster))``
    values per CTA)."""
    table, _ = int8_regions(geo, padded)
    longest = int(table[:, 1].max()) if len(table) else 0
    slice_ = -(-(-(-longest // cluster)) // 4) * 4
    smem = min(slice_, INT8_SMEM_FLOATS)
    vec = bool(np.all(table[:, :2] % 4 == 0))
    return Int8Plan(cluster, len(table), slice_, smem,
                    padded if slice_ > smem else 0, vec)


def int8_cost(plan: Int8Plan, n: int, active: int) -> Optional[float]:
    """Bytes one CTA moves in its walk times the waves the launch needs
    with ``active`` co-resident clusters (None when none fit): the
    launcher's measure for choosing a cluster size.  A spilled value
    costs 8 more bytes on each of the n-1 hops that carry it."""
    if active <= 0:
        return None
    spilled = plan.slice - plan.smem_floats
    per_cta = plan.slice * (n + 3) * 4 + spilled * 8 * (n - 1)
    return -(-plan.nregions // active) * per_cta


def _occupancy(cluster: int, smem_floats: int, vec: bool) -> int:
    out = ctypes.c_int(0)
    _native.call("pstt_ring_int8_occupancy", cluster, smem_floats, int(vec),
                 ctypes.byref(out))
    return out.value


def int8_pick_cluster(geo: RingGeometry, padded: int,
                      active: Dict[int, int]) -> int:
    """The cluster size of :data:`INT8_CLUSTERS` with the least
    :func:`int8_cost`, given the co-resident clusters ``active`` the card
    allows at each size (ties go to the larger cluster).  On an H100 at
    the main path's 16 regions, 7 clusters of 16 CTAs fit (3 waves) but 8
    of 14 do (2 waves)."""
    costs = {c: int8_cost(int8_plan(geo, padded, c), geo.n, active[c])
             for c in INT8_CLUSTERS}
    fits = [c for c in INT8_CLUSTERS if costs[c] is not None]
    if not fits:
        raise RuntimeError(f"the card runs no cluster of {INT8_CLUSTERS} "
                           f"CTAs for the int8 ring")
    return min(fits, key=lambda c: costs[c])


@functools.lru_cache(maxsize=64)
def _launch_shape(geo: RingGeometry, padded: int, device_index: int):
    active = {}
    with torch.cuda.device(device_index):
        for c in INT8_CLUSTERS:
            plan = int8_plan(geo, padded, c)
            active[c] = _occupancy(c, plan.smem_floats, plan.vec)
    return int8_pick_cluster(geo, padded, active), active


def int8_launch_shape(n: int, padded: int, kv_shards: Optional[int] = None,
                      bidir: bool = True, device="cuda") -> dict:
    """The int8 kernel's launch shape on the card of ``device``: the
    chosen cluster size, its plan, and the co-resident clusters the card
    allows at each candidate size."""
    geo = ring_geometry(n, padded, torch.float32, bidir, True, kv_shards)
    dev = torch.device(device)
    cluster, active = _launch_shape(geo, padded, _device_index(dev))
    plan = int8_plan(geo, padded, cluster)
    return dict(plan._asdict(), max_active_clusters=active,
                waves=-(-plan.nregions // active[cluster]))


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=64)
def _region_table(geo: RingGeometry, padded: int, device: torch.device):
    """:func:`int8_regions`' table on ``device``, copied there once."""
    return torch.from_numpy(int8_regions(geo, padded)[0]).to(device)


def _launch_int8(grads, store, pulled, geo: RingGeometry, code: int,
                 lr: float, with_ag: bool, cluster: int) -> None:
    """One launch of ``pstt_ring_int8`` at a given cluster size."""
    padded = store.numel()
    plan = int8_plan(geo, padded, cluster)
    if plan.nregions == 0:
        return
    scratch = torch.empty(plan.scratch, dtype=torch.float32,
                          device=store.device) if plan.scratch else None
    _native.call(
        "pstt_ring_int8", grads.data_ptr(), store.data_ptr(),
        pulled.data_ptr() if pulled is not None else None,
        scratch.data_ptr() if scratch is not None else None,
        _region_table(geo, padded, store.device).data_ptr(), plan.nregions,
        cluster, plan.smem_floats, int(plan.vec), geo.n, padded, code, lr,
        int(with_ag or geo.kv), int(geo.kv), _native.stream_ptr(store.device),
    )


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
        cluster, _ = _launch_shape(geo, store.numel(),
                                   _device_index(store.device))
        _launch_int8(grads, store, pulled, geo, code, lr, with_ag, cluster)
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
    bit-identical to their single launches; int8 buckets keep their own
    cluster launch each (:func:`_launch_int8`), issued from this call.
    ``launches`` counts each launch under ``ring_push_pull_group[...]``
    (``_2d``, ``_int8`` variants)."""
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
    plain: Dict[torch.dtype, list] = {}
    for i, (g, s, geo, c) in enumerate(zip(grads_list, stores, geos, flags)):
        if c:
            pulled[i] = torch.empty_like(s)
            cluster, _ = _launch_shape(geo, s.numel(), _device_index(dev))
            _launch_int8(g, s, pulled[i], geo, code, lr, True, cluster)
            launches[_group_variant(geo.kv, True, s.dtype)] += 1
        elif s.numel():
            plain.setdefault(s.dtype, []).append(i)
        else:
            pulled[i] = torch.empty_like(s)
    stream = _native.stream_ptr(dev)
    for dtype, idx in plain.items():
        # One allocation holds every pulled slot of the dtype, each slot
        # starting 16-byte aligned so the bucket can take vectors.
        step = _GROUP_ALIGN // dtype.itemsize
        offs, total = [], 0
        for i in idx:
            offs.append(total)
            total += -(-stores[i].numel() // step) * step
        buf = torch.empty(total, dtype=dtype, device=dev)
        desc = np.empty((len(idx), 9), dtype=np.int64)
        for row, (i, off) in enumerate(zip(idx, offs)):
            s, geo = stores[i], geos[i]
            pulled[i] = buf.narrow(0, off, s.numel())
            desc[row] = (grads_list[i].data_ptr(), s.data_ptr(),
                         pulled[i].data_ptr(), s.numel(), geo.period,
                         geo.sub, geo.split, geo.n, int(geo.kv))
        made = ctypes.c_int(0)
        _native.call("pstt_ring_group", desc.ctypes.data, len(idx),
                     _DTYPE_CODES[dtype], code, lr, stream, ctypes.byref(made))
        launches[_group_variant(kv_shards is not None, False, dtype)] += (
            made.value)
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
