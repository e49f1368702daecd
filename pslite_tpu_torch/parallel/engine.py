"""CollectiveEngine — the dense data plane on a device group.

Counterpart of ``pslite_tpu/parallel/engine.py``'s ``CollectiveEngine``
for the dense push_pull slice.  The JAX engine runs one SPMD program per
(op, bucket, dtype, handle) over a mesh whose ``kv`` axis is both the
worker fan-in and the server key-range sharding.  Here the n ranks of a
:class:`~pslite_tpu_torch.parallel.mesh.DeviceGroup` share one device:
a bucket's store is one ``[padded]`` tensor holding the n shards back to
back (shard d = elements ``[d*padded/n, (d+1)*padded/n)``), and grads are
``[W, padded]`` with one row per worker rank.

With ``worker_axis`` (a 2-D ``(dp, kv)`` group, ``make_group``), the
workers are the ``dp`` ranks and the shards the ``kv`` ranks: grads are
``[A, padded]`` with A = the ``dp`` size, and the store holds the B kv
shards once (the JAX engine replicates it over ``dp``).

Two implementations, chosen by ``impl`` (or ``PS_ICI_IMPL``, whose JAX
values carry over: ``xla`` means ``torch`` and ``pallas`` means
``ring``):

- ``torch``: the counterpart of psum_scatter (2-D: psum over ``dp``) ->
  handle -> all_gather, as the JAX engine's ``xla`` programs run it: one
  launch of D1 (``ops/reduce_update.py``), which adds the worker rows in
  rank order (the order the JAX CPU mesh's collectives use;
  ``torch.sum``'s order on CUDA is unspecified), applies the handle to
  the store and writes the pulled copy in one pass.  A group's buckets
  take one launch together; a callable handle runs on the reduction
  alone (D1 in its ``none`` mode, one launch a bucket).
- ``ring``: the fused ring kernel (``ops/ring_collective.py``) for the
  elementwise handles, with the TPU ring's order of addition: one ring
  over the kv ranks, or (2-D) one sub-ring over the ``dp`` ranks per kv
  shard, whose pulled value becomes the store, as in the JAX engine.

``wire_compress="int8"`` (or ``PS_ICI_COMPRESS=int8`` in the process
environment) runs the int8 wire-compressed ring for f32 buckets on the
``ring`` impl; the torch impl and the stateful handles ignore it, as in
the JAX engine.  A compressed 1-D store keeps full precision while the
pulled values are the dequantized all-gather; on 2-D the store takes the
pulled values.

Stateful handles (``sgd_momentum``, ``adam``, ``adagrad``) run D2 on
either impl, as the JAX engine runs its ``_stateful_program``: the
rank-order reduction fused with the optimizer arithmetic of the K1-K3
kernels (``ops/fused_update.py``), store, state and pulled copy in one
pass.

The store and optimizer state are updated IN PLACE, where the JAX
programs donate them.  Every result handed to a caller (``pull``,
``push_pull``, ``push``'s token, the group, replay and stream results) is
a fresh tensor, so a later push cannot change a result the caller holds;
the two exceptions are asked for by name: ``push_pull(zero_copy=True)``
(and ``replay(keep="last", zero_copy=True)``) where eligible, and the
``pull`` of a bucket with a registered pull buffer.  They return a
:class:`~pslite_tpu_torch.parallel.zero_copy.ZeroCopyHandle` on the
store's (the buffer's) memory, with no copy; the bucket's next mutating
op (``push``, ``push_pull``, ``replay``, a group holding it,
``set_store_array``; for a registered buffer, the next ``pull``) makes it
stale: any use raises and ``is_deleted()`` is True, as a donated JAX
array.

Many ops per call: ``push_pull_group`` (one grouped ring launch per dtype
for a list of buckets, ``ops/ring_collective.py``), ``coalescer`` (ops
issued one at a time, from any thread, batched into groups,
``parallel/coalesce.py``), ``replay`` (T steps of one bucket in one call)
and ``push_pull_stream``/``push_pull_multi_stream`` (host gradients staged
through pinned buffers on a copy stream while earlier buckets reduce).

A composite kv axis (``axis_name=("kv1", "kv2")`` on a ``make_group((2,
2, 2), ("dp", "kv1", "kv2"))`` group) shards the store over the product
of its axes, row-major, as ``P(("kv1", "kv2"))`` does: with
``worker_axis`` it is the 2-D layout with B = kv1 x kv2 shards, one dp
sub-ring per shard, bit for bit; without one the workers are the shards
and the ring gives way to the torch path (no single ring dimension), as
in the JAX engine.

``reshard``/``reshard_staged`` re-lay the live buckets onto another
group (the elastic tier; ``KVWorker.reshard`` coordinates it across a
cluster's workers, ``vans/ici_van.py``).

A group spanning worker processes (``distributed.global_group``; the
JAX engine on a ``PS_ICI_MULTIHOST=1`` mesh) holds in each process the
store pieces of that process's ranks (``placement.DenseLayout``): on a
1-D group the chunks of its ranks; on an N-D group or a composite kv
axis without ``worker_axis``, each rank's kv shard of its replica (the
other axes replicate the store, as ``P(kv)`` does); on a 2-D
``worker_axis`` group (composite kv axes too) sub-chunk d of kv shard k
at rank (d, k), as the dp sub-rings own them.  It takes that process's
grads rows (``[local, total]``, or ``[total]`` broadcast to them), or on
2-D the global ``[A, total]`` rows, the same on every process (JAX's
contract there).  Every process drives the same ops in the same order
(SPMD lockstep, as JAX's multi-host contract).  On the card each
bucket's rows and store pieces live in a
:class:`~pslite_tpu_torch.parallel.peers.PeerSlab` that every peer maps:
``sum``/``assign``/``sgd`` on the ring impl take K4 across processes
(``ring_reduce_peers`` over the rows of each piece's ring, 1-D or the dp
sub-rings, each process its own pieces; with int8 wire compression
``ring_int8_peers``, the cluster kernel over the regions of those
pieces; then ``ring_gather_peers``), and the torch impl and the stateful
handles run one D1/D2 launch over this process's pieces, each piece's
rows read through the peers' addresses (``reduce_update.reduce_peers``),
and the same gather; each
op syncs the stream and meets a host barrier after writing its rows,
after the reduce and after the gather.  A compressed 1-D store keeps full
precision, so its owners also write the dequantized values of their
pieces into their slab, and the pull gathers those.  On a CPU group the
rows travel through gloo (the plain versions).  ``pull`` gathers the
owners' pieces; ``store_array``, ``opt_state`` and recuts gather the
whole value with ``peers.gather_global`` (device to device on the card,
``placement.to_host_global`` on a CPU group).  Ranks on several cards
raise in ``distributed.global_group`` (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from ..ops import fused_update, reduce_update, ring_collective
from ..utils import logging as log
from . import distributed, placement
from .mesh import DeviceGroup, default_group
from .peers import PeerSlab, Retired, align, gather_global
from .placement import DenseLayout
from .zero_copy import Generation, ZeroCopyHandle, plain


@dataclass
class DenseBucket:
    """A registered dense key bucket: the unit of collective push/pull.

    ``keys[i]`` owns ``val_len`` consecutive values of the flat bucket
    vector (the reference benchmark's layout, test_benchmark.cc:407-414).
    """

    name: str
    keys: np.ndarray
    val_len: int
    dtype: torch.dtype
    total_len: int  # len(keys) * val_len
    padded_len: int  # rounded up to a multiple of the rank count


ServerHandle = Union[str, Callable]

_IMPL_ALIASES = {"torch": "torch", "xla": "torch", "ring": "ring",
                 "pallas": "ring"}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype (ml_dtypes'
    bfloat16 included) or a name; None means float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unsupported dtype {dtype!r}")
    return dt


def to_tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` (numpy array, tensor or sequence) as a tensor of
    ``dtype`` on ``device``.  Tensors already there are not copied;
    numpy bfloat16 arrays (and their raw 2-byte form in npz files) are
    reinterpreted bit for bit."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        t = torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)
        ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype)


class _HostStager:
    """Stages host gradients onto a card through pinned buffers, for
    :meth:`CollectiveEngine.push_pull_multi_stream`.

    Ownership: a ring of ``depth + 2`` pinned buffers, each refilled only
    after the event of its previous copy has completed; the device tensor
    of a staged item is allocated on the copy stream, and the consumer
    passes it to ``record_stream`` of the stream that reads it, so the
    caching allocator does not hand its memory out again before that
    stream is done with it."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._slots: List[list] = [[None, None] for _ in range(depth + 2)]
        self._next = 0

    def stage(self, grads, dtype: torch.dtype):
        """``(device tensor, event)``: ``grads`` on the card, its copy
        started on the copy stream and ``event`` recorded after it (None
        for a tensor already on the card)."""
        if isinstance(grads, torch.Tensor) and grads.device.type == "cuda":
            return grads.to(dtype), None
        host = to_tensor(grads, dtype, "cpu")
        nbytes = host.numel() * dtype.itemsize
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        buf, event = slot
        if event is not None:
            event.synchronize()  # the buffer's last copy has landed
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        pinned = buf[:nbytes].view(dtype).view(host.shape)
        pinned.copy_(host)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = torch.empty(host.shape, dtype=dtype, device=self.device)
            dev.copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot[0], slot[1] = buf, event
        return dev, event


class CollectiveEngine:
    """Dense KV push/pull over the ranks of one device group.

    ``grads`` arguments are ``[W, total_len]``, ``[W, padded_len]``, a
    broadcast ``[total_len]`` or a flat ``[W*padded_len]``, as numpy
    arrays or tensors.  Ops run on the group's device in stream order;
    :meth:`block` (or KVWorker's completion events) gives ZPush/Wait
    semantics."""

    def __init__(
        self,
        group: Optional[DeviceGroup] = None,
        axis_name: str = "kv",
        server_handle: ServerHandle = "sum",
        impl: Optional[str] = None,
        worker_axis: Optional[str] = None,
        wire_compress: Optional[str] = None,
        profiler=None,
    ):
        if isinstance(axis_name, (tuple, list)):
            # A composite kv axis (a 3-D torus with worker_axis): the
            # store shards over the product of these axes, row-major
            # (the first axis major), as P(("kv1", "kv2")) lays it out.
            axis_name = tuple(axis_name)
            log.check(len(axis_name) >= 1, "empty kv axis tuple")
            log.check(group is not None,
                      "tuple kv axes require an explicit device group")
        self.group = group if group is not None else default_group(axis_name)
        self.axis = axis_name
        self.worker_axis = worker_axis
        impl = impl or os.environ.get("PS_ICI_IMPL", "torch")
        log.check(impl in _IMPL_ALIASES, f"unknown engine impl {impl!r}")
        self.impl = _IMPL_ALIASES[impl]
        # Wire compression of the ring data plane, from the argument or
        # the process environment (as the JAX engine reads it).
        self.wire_compress = (
            wire_compress if wire_compress is not None
            else os.environ.get("PS_ICI_COMPRESS", "")
        ) or None
        log.check(self.wire_compress in (None, "int8"),
                  f"unknown wire_compress {self.wire_compress!r}")
        self.num_shards, self.num_workers = self._layout(self.group,
                                                         axis_name)
        self.device = self.group.device
        # Across processes: each bucket's exchange memory on the card, the
        # slabs out of use, and (when a caller sets it to a dict) the last
        # op's reduce/gather device ms, their host windows and the host
        # barriers' ms.
        self._mp = self.group.is_multiprocess
        self._slabs: Dict[str, PeerSlab] = {}
        self._layouts: Dict[str, DenseLayout] = {}
        self._retired = Retired()
        self._closed = False
        self.peer_timing: Optional[dict] = None
        self._server_handle = server_handle
        self._buckets: Dict[str, DenseBucket] = {}
        self._stores: Dict[str, torch.Tensor] = {}
        # Optimizer state of stateful handles (sgd_momentum / adagrad:
        # (state,); adam: (m, v, step[num_shards] f32)), laid out like the
        # store and updated in place each step.
        self._opt_states: Dict[str, tuple] = {}
        self._opt_kinds: Dict[str, str] = {}
        self._mu = threading.Lock()
        # Per-bucket locks: each op reads and updates a bucket's store in
        # place, so one bucket's ops must not interleave.
        self._bucket_mu: Dict[str, threading.Lock] = {}
        # Per-bucket count of mutating ops: a zero-copy handle of the
        # store is stale once it moves on.
        self._generations: Dict[str, Generation] = {}
        # Registered pull buffers (register_pull_buffer): bucket -> (the
        # [padded] tensor every pull of the bucket writes into, its count
        # of pulls, the handle of the last pull).
        self._pinned_pulls: Dict[str, tuple] = {}
        # Application-payload bytes through the data plane (the van's
        # send_bytes/recv_bytes counterpart).
        self.push_bytes = 0
        self.pull_bytes = 0
        # The van's event Profiler (ENABLE_PROFILING): one engine event
        # per data-plane op.
        self.profiler = profiler
        self._counter_mu = threading.Lock()

    def _layout(self, group: DeviceGroup, axis) -> tuple:
        """``(num_shards, num_workers)`` of this engine on ``group`` with
        kv axis ``axis`` (a name or a tuple of names): the shards are the
        product of the kv axes' sizes, the workers the worker axis's size
        (the shards on the 1-D colocated layout)."""
        kv_axes = axis if isinstance(axis, tuple) else (axis,)
        for a in kv_axes:
            log.check(a in group.axis_names,
                      f"kv axis {a!r} not in the device group")
        shards = int(np.prod([group.shape[a] for a in kv_axes]))
        if self.worker_axis is None:
            return shards, shards
        log.check(self.worker_axis in group.axis_names,
                  f"worker axis {self.worker_axis!r} not in the device "
                  f"group (a 2-D engine stays 2-D across reshards)")
        log.check(self.worker_axis not in kv_axes,
                  "worker_axis must differ from the kv axis (leave it "
                  "None for the 1-D colocated layout)")
        return shards, int(group.shape[self.worker_axis])

    # -- registration --------------------------------------------------------

    def register_dense(self, name: str, keys, val_len: int, dtype=None,
                       init: Optional[np.ndarray] = None) -> DenseBucket:
        """Register a dense bucket and allocate its store (zeros, or
        ``init`` in the first ``total_len`` values)."""
        dt = torch_dtype(dtype)
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        total = len(keys) * val_len
        padded = -(-total // self.num_shards) * self.num_shards
        bucket = DenseBucket(name=name, keys=keys, val_len=val_len, dtype=dt,
                             total_len=total, padded_len=padded)
        slab = layout = None
        if self._mp:
            # A collective: this process's pieces, in exchange memory on
            # the card.
            layout = self._new_layout(dt, self.group, self.axis, padded)
            me = self.group.process_index
            if self.device.type == "cuda":
                slab = self._new_slab(bucket, layout)
                store = self._slab_store(slab, bucket, layout, me)
            else:
                store = torch.zeros(layout.local_len(me), dtype=dt,
                                    device=self.device)
            if init is not None:
                full = torch.zeros(padded, dtype=dt)
                full[:total] = to_tensor(init, dt, "cpu").reshape(-1)
                store.copy_(layout.local_of(full, me))
        else:
            store = torch.zeros(padded, dtype=dt, device=self.device)
            if init is not None:
                store[:total] = to_tensor(init, dt, self.device).reshape(-1)
        with self._mu:
            self._buckets[name] = bucket
            self._stores[name] = store
            self._retired.retire(self._slabs.pop(name, None))
            if slab is not None:
                self._slabs[name] = slab
            if layout is not None:
                self._layouts[name] = layout
            self._bucket_mu.setdefault(name, threading.Lock())
            # Re-registering replaces the store: its handles go stale.
            self._generations.setdefault(name, Generation(name)).advance()
        return bucket

    def bucket(self, name: str) -> DenseBucket:
        return self._buckets[name]

    # -- across processes -----------------------------------------------------

    def _new_layout(self, dtype, group: DeviceGroup, axis,
                    padded: int) -> DenseLayout:
        """Where a bucket of ``padded`` values of ``dtype`` lives on
        ``group`` (spanning processes) with kv axis ``axis``.  On 2-D the
        pieces are the sub-chunks of the bucket's ring geometry (int8's
        when the engine compresses the dtype), whichever path an op
        takes."""
        kv_axes = axis if isinstance(axis, tuple) else (axis,)
        sub = None
        if self.worker_axis is not None:
            shards = int(np.prod([group.shape[a] for a in kv_axes]))
            sub = ring_collective.ring_geometry(
                int(group.shape[self.worker_axis]), padded, dtype, True,
                self._ring_compress(dtype), shards).sub
        return DenseLayout(group, kv_axes, self.worker_axis, padded, sub)

    def _pulled_area(self, bucket: DenseBucket) -> bool:
        """Whether the bucket's slabs hold a pulled area: the compressed
        1-D ring pulls dequantized values while its store keeps full
        precision."""
        return self.worker_axis is None and self._ring_compress(bucket.dtype)

    def _slab_layout(self, bucket: DenseBucket, layout: DenseLayout,
                     process: int) -> tuple:
        """``(row stride, store offset, pulled offset or None, bytes)`` of
        ``process``'s slab: one ``[padded]`` row per slot it writes, each
        starting aligned, then its store pieces back to back (then, for a
        compressed 1-D bucket, as many dequantized values)."""
        b = bucket.dtype.itemsize
        stride = align(layout.padded * b)
        store_off = len(layout.slots[process]) * stride
        shards = layout.local_len(process) * b
        if not self._pulled_area(bucket):
            return stride, store_off, None, store_off + shards
        pulled_off = align(store_off + shards)
        return stride, store_off, pulled_off, pulled_off + shards

    def _new_slab(self, bucket: DenseBucket, layout: DenseLayout) -> PeerSlab:
        return PeerSlab(layout.group, self._slab_layout(
            bucket, layout, layout.group.process_index)[3])

    def _slab_store(self, slab: PeerSlab, bucket: DenseBucket,
                    layout: DenseLayout, process: int,
                    pulled: bool = False) -> torch.Tensor:
        """``process``'s store pieces on its slab (zeros when fresh), or
        its pulled area."""
        _, store_off, pulled_off, _ = self._slab_layout(bucket, layout,
                                                        process)
        return slab.view(process, pulled_off if pulled else store_off,
                         (layout.local_len(process),), bucket.dtype)

    def _row_addr(self, name: str, row: int) -> int:
        """The address here of grads row ``row`` (a rank, or a dp index on
        2-D) in its writer's slab."""
        bucket, layout = self._buckets[name], self._layouts[name]
        p, slot = layout.slot_at[row]
        stride = self._slab_layout(bucket, layout, p)[0]
        return self._slabs[name].addr(p) + slot * stride

    def _store_segments(self, name: str, pulled: bool = False) -> list:
        """``(address, first element, length)`` of the owners' pieces
        that make the whole bucket (their pulled areas with ``pulled``):
        the all-gather's sources, neighbours merged."""
        bucket, layout = self._buckets[name], self._layouts[name]
        slab, g, b = self._slabs[name], self.group, bucket.dtype.itemsize
        segs: List[list] = []
        for pc in layout.full(g.process_index):
            p = g.process_of(pc.rank)
            _, store_off, pulled_off, _ = self._slab_layout(bucket, layout, p)
            addr = slab.addr(p) + (pulled_off if pulled else store_off) + \
                pc.local * b
            last = segs[-1] if segs else None
            if last and last[0] + last[2] * b == addr and \
                    last[1] + last[2] == pc.start:
                last[2] += pc.length
            else:
                segs.append([addr, pc.start, pc.length])
        return [tuple(seg) for seg in segs]

    def _assemble(self, layout: DenseLayout, local: torch.Tensor
                  ) -> torch.Tensor:
        """The whole ``[padded]`` value of a tensor laid out like the
        store pieces, from every process's (a collective through
        ``peers.gather_global``)."""
        joined = gather_global(local, self.group)
        parts, off = {}, 0
        for p in self.group.processes:
            n = layout.local_len(p)
            parts[p] = joined[off:off + n]
            off += n
        return layout.assemble(parts, self.group.process_index).to(
            self.device)

    def _peer_sync(self, key: Optional[str] = None,
                   done: Optional[str] = None) -> None:
        """Sync this process's stream, then a host barrier (freeing the
        slabs retired before it); its host ms go to ``peer_timing[key]``,
        and the sync ends the host window of the part ``done``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.monotonic()
        timing = self.peer_timing
        if timing is not None and done in timing:
            timing[done + "_window"] = (timing[done + "_window"][0], t0)
        self._retired.barrier()
        if timing is not None and key is not None:
            timing[key] = (time.monotonic() - t0) * 1e3

    def _timed(self, key: str, fn):
        """``fn()`` between two CUDA events when ``peer_timing`` is on; the
        events land in ``peer_timing[key]`` (read after the next sync),
        and ``peer_timing[key + "_window"]`` holds the host times
        (``time.monotonic``, one clock for every process of the host) of
        the launch and of the sync after it."""
        if self.peer_timing is None or self.device.type != "cuda":
            return fn()
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        self.peer_timing[key + "_window"] = (time.monotonic(), None)
        e0.record()
        out = fn()
        e1.record()
        self.peer_timing[key] = (e0, e1)
        return out

    def _gather_full(self, name: str) -> torch.Tensor:
        """The whole ``[padded]`` bucket from every process's shards: a
        collective.  On the card the owners' shards are copied out by
        ``ring_gather_peers`` between host barriers."""
        bucket, store = self._buckets[name], self._stores[name]
        if self.device.type != "cuda":
            return self._assemble(self._layouts[name], store)
        self._peer_sync()
        pulled = torch.empty(bucket.padded_len, dtype=bucket.dtype,
                             device=self.device)
        ring_collective.ring_gather_peers(self._store_segments(name), pulled)
        self._peer_sync()
        return pulled

    def _owned_sum(self, layout: DenseLayout, dtype: torch.dtype,
                   row) -> torch.Tensor:
        """The reduction of each of this process's pieces' rows, as one
        tensor laid out like the store; ``row(id, start, length)`` is a
        row's values there."""
        me = self.group.process_index
        sums = [(seg, reduce_update.rank_order_sum([row(r, seg[0], seg[1])
                                                    for r in rows]))
                for rows, segs in layout.runs(me) for seg in segs]
        n = layout.local_len(me)
        if len(sums) == 1 and sums[0][0][2] == 0 and sums[0][0][1] == n:
            return sums[0][1]
        agg = torch.zeros(n, dtype=dtype, device=self.device)
        for (_, length, local), part in sums:
            agg[local:local + length] = part
        return agg

    def _apply_peers(self, name: str, bucket: DenseBucket, resolved,
                     pieces) -> None:
        """D1 (an elementwise handle) or D2 (an optimizer) over this
        process's pieces, ``(row addresses, store offset, length)`` each."""
        store = self._stores[name]
        if self._is_stateful(resolved):
            kind, state, params, alpha = self._optimizer(name, bucket,
                                                         resolved)
            reduce_update.reduce_peers(pieces, store, kind, state, params,
                                       alpha)
            self._advance_step(name, kind)
        else:
            reduce_update.reduce_peers(pieces, store, resolved)

    def _mp_update(self, name: str, bucket: DenseBucket, g: torch.Tensor,
                   resolved, with_pull: bool):
        """One op of a group spanning processes (bucket lock held); the
        pulled ``[padded]`` tensor or None."""
        store, padded = self._stores[name], bucket.padded_len
        layout, me = self._layouts[name], self.group.process_index
        use_ring = (not self._is_stateful(resolved)
                    and self._effective_impl(bucket.dtype, resolved)
                    == "ring")
        compress = use_ring and self._ring_compress(bucket.dtype)
        kv = self._kv_shards()
        if self.worker_axis is not None:
            # The global dp rows: this process writes its slots' rows.
            g = g[layout.slots[me]]
        if self.device.type != "cuda":
            # The plain versions: the rows travel through gloo.
            if use_ring:
                out = ring_collective.ring_push_pull_peers_reference(
                    g, store, layout, resolved, compress=compress,
                    kv_shards=kv, with_ag=with_pull)
                return out if with_pull else None
            got = distributed.allgather_object(
                (list(layout.slots[me]), g.contiguous()))
            rows = {r: torch.as_tensor(t) for slots, rs in got
                    for r, t in zip(slots, rs)}
            self._apply(name, bucket, resolved, self._owned_sum(
                layout, bucket.dtype,
                lambda r, lo, n: rows[r][lo:lo + n]).unsqueeze(0))
            if not with_pull:
                return None
            return self._assemble(layout, store)
        slab = self._slabs[name]
        stride, _, pulled_off, _ = self._slab_layout(bucket, layout, me)
        b = bucket.dtype.itemsize
        if g.shape[0]:
            rows_here = slab.view(slab.me, 0, (g.shape[0], stride // b),
                                  bucket.dtype)
            rows_here[:, :padded].copy_(g)
        self._peer_sync("barrier_in_ms")
        if compress:
            # Neighbouring pieces of one ring are one bucket of the launch
            # (on 1-D, every chunk of this process).
            pieces = [([self._row_addr(name, r) for r in rows], *seg)
                      for rows, segs in layout.runs(me) for seg in segs]
            out = (self._slab_store(slab, bucket, layout, me, pulled=True)
                   if pulled_off is not None else None)
            self._timed("reduce", lambda: ring_collective.ring_int8_peers(
                pieces, store, out, padded, resolved, with_ag=with_pull,
                kv_shards=kv))
        elif use_ring:
            def reduce():
                for rows, segs in layout.runs(me):
                    ring_collective.ring_reduce_peers(
                        [self._row_addr(name, r) for r in rows], store,
                        segs, padded, resolved, kv_shards=kv)
            self._timed("reduce", reduce)
        elif callable(resolved):
            # The reduction of each piece, then the callable on the store.
            def view(r, lo, n):
                return ring_collective.device_view(
                    self._row_addr(name, r) + lo * b, (n,), bucket.dtype,
                    self.device)
            self._timed("reduce", lambda: self._apply(
                name, bucket, resolved, self._owned_sum(
                    layout, bucket.dtype, view).unsqueeze(0)))
        else:
            pieces = [([self._row_addr(name, r) + lo * b for r in rows],
                       local, length)
                      for rows, segs in layout.runs(me)
                      for lo, length, local in segs]
            self._timed("reduce", lambda: self._apply_peers(
                name, bucket, resolved, pieces))
        self._peer_sync("barrier_mid_ms", done="reduce")
        if not with_pull:
            return None
        pulled = torch.empty(padded, dtype=bucket.dtype, device=self.device)
        self._timed("gather", lambda: ring_collective.ring_gather_peers(
            self._store_segments(name, pulled=pulled_off is not None
                                 and compress), pulled))
        self._peer_sync("barrier_out_ms", done="gather")
        return pulled

    def close(self) -> None:
        """Release the exchange memory of a group spanning processes (a
        collective: every process closes its engine)."""
        if not (self._mp and self.device.type == "cuda") or self._closed:
            return
        self._closed = True
        with self._mu:
            slabs, self._slabs = list(self._slabs.values()), {}
        for slab in slabs:
            slab.close_peers()
        self._retired.barrier()
        for slab in slabs:
            slab.free()

    # -- handles -------------------------------------------------------------

    def _apply(self, name: str, bucket: DenseBucket, resolved, rows,
               pulled: Optional[torch.Tensor] = None) -> None:
        """Reduce the worker ``rows`` (``[W, n]``) into the bucket's store
        in place and write the new store into ``pulled`` when given (bucket
        lock held): D2 for an optimizer handle, D1 for an elementwise one,
        and for a callable D1's reduction, then the callable."""
        store = self._stores[name]
        if self._is_stateful(resolved):
            kind, state, params, alpha = self._optimizer(name, bucket,
                                                         resolved)
            reduce_update.reduce_update(rows, store, state, kind, params,
                                        alpha, pulled)
            self._advance_step(name, kind)
        elif callable(resolved):
            store.copy_(resolved(store, reduce_update.rank_order_sum(rows)))
            if pulled is not None:
                pulled.copy_(store)
        else:
            reduce_update.reduce_apply(rows, store, resolved, pulled)

    @staticmethod
    def _handle_params(handle: str, defaults):
        parts = handle.split(":", 1)
        vals = list(defaults)
        if len(parts) == 2 and parts[1]:
            toks = parts[1].split(",")
            log.check(
                len(toks) <= len(vals),
                f"handle {handle!r} has {len(toks)} parameters but at "
                f"most {len(vals)} are supported",
            )
            for i, tok in enumerate(toks):
                vals[i] = float(tok)
        return vals

    def _optimizer(self, name: str, bucket: DenseBucket, handle: str):
        """``(kind, state vectors, params, alpha)`` of the bucket's
        optimizer step, as ``reduce_update.reduce_update`` takes them (the
        state allocated at first use; bucket lock held).  Adam's step size
        comes from the 1-based step of shard 0's counter, on the device;
        :meth:`_advance_step` moves the counter on after the step."""
        self._ensure_opt_state(name, handle, bucket)
        state = self._opt_states[name]
        if handle.startswith("sgd_momentum"):
            return ("sgd_momentum", state,
                    self._handle_params(handle, (0.01, 0.9)), None)
        if handle.startswith("adagrad"):
            return ("adagrad", state,
                    self._handle_params(handle, (0.01, 1e-8)), None)
        lr, b1, b2, eps = self._handle_params(handle,
                                              (1e-3, 0.9, 0.999, 1e-8))
        alpha = fused_update.adam_alpha(state[2][:1] + 1.0, lr, b1, b2,
                                        device=self._stores[name].device)
        return "adam", state[:2], (b1, b2, eps), alpha

    def _advance_step(self, name: str, kind: str) -> None:
        if kind == "adam":
            self._opt_states[name][2].add_(1.0)

    @staticmethod
    def _is_stateful(handle) -> bool:
        return isinstance(handle, str) and (
            handle.startswith("sgd_momentum")
            or handle.startswith("adam")
            or handle.startswith("adagrad")
        )

    def _resolve_handle(self, handle: Optional[ServerHandle]):
        return self._server_handle if handle is None else handle

    @property
    def handle_is_stateful(self) -> bool:
        """Whether the engine's default handle carries optimizer state
        (such handles cannot run in a group)."""
        return self._is_stateful(self._server_handle)

    def _effective_impl(self, dtype, resolved_handle) -> str:
        """The configured impl resolved against what the ring kernel
        serves (the JAX engine's eligibility rules): a ring needs >= 2
        ranks (the kv ranks, or on 2-D the dp ranks of each sub-ring), a
        2- or 4-byte dtype and a built-in elementwise handle; everything
        else runs the torch path.  A composite kv axis without a worker
        axis has no single ring dimension, so it runs the torch path."""
        if self.impl != "ring":
            return "torch"
        if self.worker_axis is None and isinstance(self.axis, tuple):
            return "torch"
        if self.num_workers < 2:
            return "torch"
        if torch_dtype(dtype).itemsize not in (2, 4):
            return "torch"
        if callable(resolved_handle):
            return "torch"
        return "ring"

    def _ring_compress(self, dtype) -> bool:
        """Whether the ring runs int8 wire compression (f32 only)."""
        return (self.wire_compress == "int8"
                and torch_dtype(dtype) == torch.float32)

    def _kv_shards(self) -> Optional[int]:
        """The ring kernel's ``kv_shards``: the shard count on 2-D groups,
        None on the 1-D ring."""
        return self.num_shards if self.worker_axis is not None else None

    def _zc_pull_eligible(self, dtype, resolved) -> bool:
        """Whether the store itself can be the pulled value: one kv shard
        (the all-gather is the identity, and ``padded_len ==
        total_len``), and a stateful handle or the torch path (the ring
        writes its own output)."""
        if self.num_shards != 1:
            return False
        if self._is_stateful(resolved):
            return True
        return self._effective_impl(dtype, resolved) == "torch"

    def flat_ring_eligible(self, dtype,
                           handle: Optional[ServerHandle] = None) -> bool:
        """Whether ``push_pull``/``push`` of this configuration run the
        1-D ring kernel, whose grads are ``[W, padded]`` rows; a flat
        ``[W*padded]`` tensor of them is taken without a copy."""
        resolved = self._resolve_handle(handle)
        return (not self._is_stateful(resolved)
                and self.worker_axis is None and not self._mp
                and self._effective_impl(dtype, resolved) == "ring")

    def flat_zc_eligible(self, handle: Optional[ServerHandle] = None) -> bool:
        """Whether a zero-copy ``push_pull`` of ``handle`` runs the
        one-worker path, whose grads are one ``[padded]`` row."""
        resolved = self._resolve_handle(handle)
        return (self.num_shards == 1
                and not self._is_stateful(resolved)
                and self.worker_axis is None)

    # -- optimizer state -----------------------------------------------------

    def _ensure_opt_state(self, name: str, handle: str, bucket) -> None:
        """Allocate (or validate) the bucket's optimizer state.  Call with
        the bucket lock held."""
        kind = handle.split(":", 1)[0]
        have = self._opt_kinds.get(name)
        if have == kind:
            return
        log.check(have is None,
                  f"bucket {name!r} already has {have!r} state; cannot "
                  f"switch to {kind!r}")

        length, shards = self._state_len(bucket)

        def zeros():
            return torch.zeros(length, dtype=bucket.dtype,
                               device=self.device)

        if kind in ("sgd_momentum", "adagrad"):
            state = (zeros(),)
        else:  # adam
            state = (zeros(), zeros(),
                     torch.zeros(shards, dtype=torch.float32,
                                 device=self.device))
        self._opt_states[name] = state
        self._opt_kinds[name] = kind

    def _state_len(self, bucket: DenseBucket) -> tuple:
        """(values, shards) this process holds of a bucket's state."""
        if not self._mp:
            return bucket.padded_len, self.num_shards
        return (self._layouts[bucket.name].local_len(
            self.group.process_index), len(self.group.local_ranks))

    def opt_state(self, name: str):
        """(kind, copies of the state tensors), or None when the bucket
        has no optimizer state.  Across processes a collective: the whole
        bucket's state through ``peers.gather_global``."""
        with self._bucket_mu[name]:
            if name not in self._opt_states:
                return None
            if self._mp:
                return self._opt_kinds[name], self._gather_state(name)
            return self._opt_kinds[name], tuple(
                s.clone() for s in self._opt_states[name]
            )

    def _gather_state(self, name: str) -> tuple:
        """The whole optimizer state of a bucket across processes (a
        collective): each vector assembled from every process's pieces,
        adam's step counter (the same on every rank) as ``num_shards``
        entries."""
        layout, state = self._layouts[name], self._opt_states[name]
        out = tuple(self._assemble(layout, t) for t in
                    (state[:2] if self._opt_kinds[name] == "adam"
                     else state[:1]))
        if self._opt_kinds[name] == "adam":
            out += (state[2][:1].expand(self.num_shards).clone(),)
        return out

    def set_opt_state(self, name: str, kind: str, values) -> None:
        """Restore optimizer state.  Vector states may arrive de-padded
        (``total_len``, the v2 checkpoint layout); the adam step counter
        may arrive with any length and is re-broadcast to ``num_shards``
        entries."""
        log.check(name in self._buckets, f"bucket {name!r} not registered")
        bucket = self._buckets[name]
        _, shards = self._state_len(bucket)
        placed = []
        for i, v in enumerate(values):
            if kind == "adam" and i == 2:
                flat = to_tensor(v, torch.float32, self.device).reshape(-1)
                step = flat[:1] if flat.numel() else torch.zeros(
                    1, device=self.device)
                placed.append(step.expand(shards).clone())
                continue
            if isinstance(v, torch.Tensor):
                log.check_eq(v.dtype, bucket.dtype,
                             f"bad opt restore dtype for bucket {name!r}")
            t = to_tensor(v, bucket.dtype, self.device).reshape(-1)
            log.check(
                t.numel() in (bucket.total_len, bucket.padded_len),
                f"bad optimizer state length {t.numel()} for bucket "
                f"{name!r} (want {bucket.total_len} or "
                f"{bucket.padded_len})",
            )
            if t.numel() != bucket.padded_len:
                t = torch.nn.functional.pad(
                    t, (0, bucket.padded_len - bucket.total_len))
            if self._mp:
                t = self._layouts[name].local_of(t, self.group.process_index)
            placed.append(t.clone())
        with self._bucket_mu[name]:
            self._opt_states[name] = tuple(placed)
            self._opt_kinds[name] = kind

    # -- data plane ops ------------------------------------------------------

    def _prep_grads(self, bucket: DenseBucket, grads) -> torch.Tensor:
        """Coerce grads to a contiguous ``[W, padded]`` tensor of the
        bucket dtype on the group's device (no copy when it already is
        one, or a flat ``[W*padded]`` view of one).  Across processes W is
        this process's ranks: its own rows; on 2-D it stays the dp size
        (the global rows, the same on every process)."""
        W, padded, total = self.num_workers, bucket.padded_len, bucket.total_len
        msg = "bad worker dim"
        if self._mp and self.worker_axis is None:
            W = len(self.group.local_ranks)
            msg = ("bad local worker dim (rows = this process's devices on "
                   "a multi-process mesh)")
        g = to_tensor(grads, bucket.dtype, self.device)
        log.check(g.dim() in (1, 2), "bad grads rank")
        if g.dim() == 1:
            if g.shape[0] == W * padded and W * padded != total:
                g = g.view(W, padded)
            else:
                g = g.unsqueeze(0).expand(W, g.shape[0])
        log.check_eq(int(g.shape[0]), W, msg)
        if g.shape[1] != padded:
            log.check_eq(int(g.shape[1]), total, "bad grad len")
            g = torch.nn.functional.pad(g, (0, padded - total))
        # A handle of this bucket's store may be the grads: the op makes
        # it stale before it reads them.
        return plain(g.contiguous())

    def _observe(self, name: str, op: str, bucket: DenseBucket,
                 t0: float) -> None:
        """Account one data-plane op: the byte counters, and the
        ``(bucket, op, bytes, us)`` event when profiling is on.  The us
        field is dispatch latency (op entry to the launches' enqueue),
        not device time: kernels run asynchronously, and
        ``utils.profiling.device_trace`` times them on the card."""
        payload = bucket.total_len * bucket.dtype.itemsize
        with self._counter_mu:
            if op in ("push", "push_pull"):
                self.push_bytes += payload
            if op in ("pull", "push_pull"):
                self.pull_bytes += payload
        if self.profiler is not None and getattr(self.profiler, "enabled",
                                                 False):
            dur_us = int((time.perf_counter() - t0) * 1e6)
            nbytes = payload * (2 if op == "push_pull" else 1)
            self.profiler.record_engine(name, op, nbytes, dur_us)

    def _update(self, name: str, bucket: DenseBucket, grads,
                handle: Optional[ServerHandle], with_pull: bool,
                zero_copy: bool = False):
        """Reduce ``grads``, apply the handle to the store in place, and
        return the fresh pulled ``[padded]`` tensor (``with_pull``; a
        handle of the store with ``zero_copy`` where eligible) or None."""
        resolved = self._resolve_handle(handle)
        zc = zero_copy and self._zc_pull_eligible(bucket.dtype, resolved)
        g = self._prep_grads(bucket, grads)
        with self._bucket_mu[name]:
            self._generations[name].advance()
            if self._mp:
                return self._mp_update(name, bucket, g, resolved, with_pull)
            store = self._stores[name]
            if (not self._is_stateful(resolved)
                    and self._effective_impl(bucket.dtype, resolved)
                    == "ring"):
                kw = dict(compress=self._ring_compress(bucket.dtype),
                          kv_shards=self._kv_shards())
                if with_pull:
                    return ring_collective.ring_push_pull(g, store, resolved,
                                                          **kw)
                ring_collective.ring_push(g, store, resolved, **kw)
                return None
            # D1/D2: the pulled copy written in the same pass (none where
            # the store itself is handed out).
            pulled = (torch.empty_like(store) if with_pull and not zc
                      else None)
            self._apply(name, bucket, resolved, g, pulled)
            if not with_pull:
                return None
            if zc:
                return ZeroCopyHandle.wrap(store, self._generations[name])
            return pulled

    def push_pull(self, name: str, grads,
                  handle: Optional[ServerHandle] = None,
                  zero_copy: bool = False) -> torch.Tensor:
        """Fused push + aggregate + update + pull; returns the pulled
        ``[total_len]`` tensor (a fresh tensor, filled in stream order).

        ``zero_copy=True`` asks for the store itself where the
        configuration allows it (:meth:`_zc_pull_eligible`: one kv shard,
        a stateful handle or the torch path), and a fresh copy elsewhere:
        the registered-buffer contract of the reference.  The result is
        then a :class:`ZeroCopyHandle` on the store's memory, and, as in
        the JAX engine, where the next op donates the store, the bucket's
        next mutating op makes it stale: a use raises, ``is_deleted()`` is
        True."""
        t0 = time.perf_counter()
        bucket = self._buckets[name]
        pulled = self._update(name, bucket, grads, handle, with_pull=True,
                              zero_copy=zero_copy)
        self._observe(name, "push_pull", bucket, t0)
        if isinstance(pulled, ZeroCopyHandle):
            return pulled  # padded == total on a zero-copy configuration
        return pulled[: bucket.total_len]

    def push(self, name: str, grads,
             handle: Optional[ServerHandle] = None) -> torch.Tensor:
        """Push + aggregate + update; returns a tiny completion token (a
        fresh 1-element tensor written after the update)."""
        t0 = time.perf_counter()
        bucket = self._buckets[name]
        self._update(name, bucket, grads, handle, with_pull=False)
        with self._bucket_mu[name]:
            token = self._stores[name][:1].clone()
        self._observe(name, "push", bucket, t0)
        return token

    def coalescer(self, handle: Optional[ServerHandle] = None, **kw):
        """A :class:`~pslite_tpu_torch.parallel.coalesce.
        CoalescingDispatcher` over this engine: push_pulls issued one at a
        time, from any thread, run as groups (:meth:`push_pull_group`)."""
        from .coalesce import CoalescingDispatcher

        return CoalescingDispatcher(self, handle=handle, **kw)

    def push_pull_group(self, names, grads_list,
                        handle: Optional[ServerHandle] = None
                        ) -> List[torch.Tensor]:
        """``push_pull`` of several buckets in one call: the pulled
        ``[total_len]`` tensors in ``names`` order (fresh).

        Stateless handles only.  Where every bucket runs the ring, the
        buckets run in one grouped ring launch per dtype (the int8
        buckets in one cluster launch over all their regions),
        bit-identical to their single push_pulls; otherwise each bucket
        takes the torch path.  The buckets' locks are taken in sorted
        order for the whole call."""
        t0 = time.perf_counter()
        log.check(len(names) == len(grads_list), "names/grads mismatch")
        log.check(len(set(names)) == len(names),
                  "duplicate bucket in group (each store is updated in "
                  "place once per call)")
        resolved = self._resolve_handle(handle)
        log.check(not self._is_stateful(resolved),
                  "push_pull_group supports stateless handles only")
        if self._mp:
            # Across processes each bucket is one collective op, in the
            # order given (the same on every process).
            return [self.push_pull(n, g, handle=handle)
                    for n, g in zip(names, grads_list)]
        buckets = [self._buckets[n] for n in names]
        gs = [self._prep_grads(b, g) for b, g in zip(buckets, grads_list)]
        use_ring = all(self._effective_impl(b.dtype, resolved) == "ring"
                       for b in buckets)
        ordered = sorted(names)
        for n in ordered:
            self._bucket_mu[n].acquire()
        try:
            for n in names:
                self._generations[n].advance()
            stores = [self._stores[n] for n in names]
            if use_ring:
                pulled = ring_collective.ring_push_pull_group(
                    gs, stores, resolved,
                    compress=[self._ring_compress(b.dtype) for b in buckets],
                    kv_shards=self._kv_shards())
            elif callable(resolved):
                pulled = []
                for store, g in zip(stores, gs):
                    store.copy_(resolved(store,
                                         reduce_update.rank_order_sum(g)))
                    pulled.append(store.clone())
            else:
                # Every bucket in one D1 launch (JAX's _group_program).
                pulled = reduce_update.reduce_group(gs, stores, resolved)
        finally:
            for n in reversed(ordered):
                self._bucket_mu[n].release()
        for i, (n, b) in enumerate(zip(names, buckets)):
            # One dispatch: its latency goes to the first bucket's event
            # (zero for the rest), so summed durations are not inflated.
            self._observe(n, "push_pull", b,
                          t0 if i == 0 else time.perf_counter())
        return [p[: b.total_len] for p, b in zip(pulled, buckets)]

    # -- multi-step replay ----------------------------------------------------

    def _replay_use_ring(self, dtype, resolved) -> bool:
        """Whether a replay runs the ring kernel: a stateless ring
        configuration without wire compression.  An int8 configuration
        replays on the torch path (exact sums) while its single and
        grouped ops keep the int8 ring, as the JAX engine rules."""
        return (not self._is_stateful(resolved)
                and self._effective_impl(dtype, resolved) == "ring"
                and not self._ring_compress(dtype))

    def _prep_grads_seq(self, bucket: DenseBucket, grads_seq) -> torch.Tensor:
        """``[T, total]`` (each step broadcast to every worker) or ``[T,
        W, total]`` (lengths ``padded_len`` too) as a contiguous ``[T, W,
        padded]`` tensor of the bucket dtype on the group's device.

        The JAX engine lays long sequences out as ``[W, T*padded]`` slabs
        (``_flat_replay``/``_replay_unroll``) so that XLA does not slice
        step t out of a tiled ``[T, padded]`` block on the TPU; a
        contiguous ``[T, W, padded]`` tensor already makes every step's
        ``[W, padded]`` slice contiguous, so the port keeps that one."""
        W, padded, total = self.num_workers, bucket.padded_len, bucket.total_len
        g = to_tensor(grads_seq, bucket.dtype, self.device)
        log.check(g.dim() in (2, 3), "grads_seq must be [T, total] or "
                                     "[T, W, total]")
        if g.dim() == 2:
            g = g.unsqueeze(1).expand(g.shape[0], W, g.shape[1])
        log.check_eq(int(g.shape[1]), W, "bad worker dim")
        if g.shape[2] != padded:
            log.check_eq(int(g.shape[2]), total, "bad grad len")
            g = torch.nn.functional.pad(g, (0, padded - total))
        return g.contiguous()

    def replay(self, name: str, grads_seq,
               handle: Optional[ServerHandle] = None, keep: str = "all",
               zero_copy: bool = False) -> torch.Tensor:
        """T consecutive ``push_pull`` steps of one bucket in one call.

        ``grads_seq`` is ``[T, total]`` (broadcast to every worker) or
        ``[T, W, total]``.  ``keep="all"`` returns every step's pulled
        values ``[T, total]``; ``keep="last"`` runs T pushes and one pull
        at the end, returning ``[total]``, or with ``zero_copy`` on an
        eligible configuration a handle of the store, stale after the
        bucket's next mutating op (see :meth:`push_pull`).

        The ring configurations run one C call of T ring launches
        (``ring_collective.ring_replay``: push_pull steps for ``all``,
        push steps for ``last``); the rest T launches of D1 (D2 for a
        stateful handle), each ``keep="all"`` step writing its pulled
        values into its row of the result.  The results equal T
        sequential ``push_pull`` calls bit for bit."""
        log.check(keep in ("all", "last"), f"bad keep {keep!r}")
        if self._mp:
            # Across processes: T collective ops, one per step.
            steps = len(grads_seq)
            outs = [self.push_pull(name, grads_seq[t], handle=handle)
                    if keep == "all" or t == steps - 1 else
                    self.push(name, grads_seq[t], handle=handle)
                    for t in range(steps)]
            return torch.stack(outs) if keep == "all" else outs[-1]
        t0 = time.perf_counter()
        bucket = self._buckets[name]
        resolved = self._resolve_handle(handle)
        zc = (zero_copy and keep == "last"
              and self._zc_pull_eligible(bucket.dtype, resolved))
        g = self._prep_grads_seq(bucket, grads_seq)
        steps = int(g.shape[0])
        with self._bucket_mu[name]:
            self._generations[name].advance()
            store = self._stores[name]
            if self._replay_use_ring(bucket.dtype, resolved):
                outs = ring_collective.ring_replay(
                    g, store, resolved, kv_shards=self._kv_shards(),
                    keep=keep)
            else:
                # One D1/D2 launch per step, writing step t's pulled
                # values straight into outs[t].
                outs = (torch.empty((steps, bucket.padded_len),
                                    dtype=bucket.dtype, device=self.device)
                        if keep == "all" else None)
                for t in range(steps):
                    self._apply(name, bucket, resolved, g[t],
                                outs[t] if outs is not None else None)
            if keep == "last":
                outs = (ZeroCopyHandle.wrap(store, self._generations[name])
                        if zc else store.clone())
        payload = bucket.total_len * bucket.dtype.itemsize
        with self._counter_mu:
            self.push_bytes += payload * steps
            self.pull_bytes += payload * (steps if keep == "all" else 1)
        if self.profiler is not None and getattr(self.profiler, "enabled",
                                                 False):
            dur_us = int((time.perf_counter() - t0) * 1e6)
            nbytes = payload * (steps + (steps if keep == "all" else 1))
            self.profiler.record_engine(name, "replay", nbytes, dur_us)
        if zc:
            return outs
        if keep == "all":
            return outs[:, : bucket.total_len]
        return outs[: bucket.total_len]

    # -- host-origin streams --------------------------------------------------

    def push_pull_stream(self, name: str, grads_iter: Iterable,
                         handle: Optional[ServerHandle] = None,
                         depth: int = 2):
        """Generator over ``push_pull`` results of one bucket with the
        host-to-device staging pipelined against the reductions (see
        :meth:`push_pull_multi_stream`)."""
        return self.push_pull_multi_stream(
            ((name, g) for g in grads_iter), handle=handle, depth=depth)

    def push_pull_multi_stream(self, pairs_iter: Iterable,
                               handle: Optional[ServerHandle] = None,
                               depth: int = 2):
        """Generator over ``push_pull`` results for ``(bucket_name,
        grads)`` pairs, with the staging of later pairs running ahead.

        A stager thread consumes the iterator and stages up to ``depth``
        items ahead of the caller, who launches each bucket's op on the
        staged grads.  On a CUDA group, host grads (numpy arrays, CPU
        tensors) go through pinned buffers: the stager copies the array
        into a pinned buffer, starts a ``non_blocking`` copy to the card
        on its own copy stream and records an event; the caller's stream
        waits on that event before the op, so bucket i+1's transfer runs
        under bucket i's reduction.  (A ``non_blocking`` copy from
        pageable memory would be synchronous.)  See :class:`_HostStager`
        for who owns each buffer.

        Results come out in order; an exception in the stager re-raises
        on the caller's thread; closing the generator early releases the
        stager."""
        log.check(depth >= 1, "depth must be >= 1")
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        done = object()
        stop = threading.Event()
        stager = (_HostStager(self.device, depth)
                  if self.device.type == "cuda" else None)

        def put(item) -> bool:
            # A bounded put that notices an abandoned consumer instead of
            # blocking forever on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stage():
            try:
                for name, g in pairs_iter:
                    bucket = self._buckets[name]
                    if stager is not None:
                        staged = stager.stage(g, bucket.dtype)
                    else:
                        staged = (self._prep_grads(bucket, g), None)
                    if not put(("ok", name, staged)):
                        return
            except BaseException as exc:  # surfaced on the caller's thread
                put(("err", exc, None))
                return
            put((done, None, None))

        t = threading.Thread(target=stage, name="engine-stager", daemon=True)
        t.start()
        try:
            while True:
                kind, a, b = q.get()
                if kind is done:
                    break
                if kind == "err":
                    raise a
                grads, event = b
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    # Allocated on the copy stream, read on this one.
                    grads.record_stream(current)
                yield self.push_pull(a, grads, handle=handle)
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30)

    # -- pulls ------------------------------------------------------------------

    def pull(self, name: str) -> torch.Tensor:
        """The bucket's values ``[total_len]`` (a fresh tensor), or, when
        a pull buffer is registered (:meth:`register_pull_buffer`), a
        fresh handle of that ``[padded]`` buffer, overwritten in place:
        the previous pull's handle is stale from then on."""
        t0 = time.perf_counter()
        bucket = self._buckets[name]
        with self._bucket_mu[name]:
            pinned = self._pinned_pulls.get(name)
            # Across processes a collective: the owners' shards gathered.
            full = (self._gather_full(name) if self._mp
                    else self._stores[name])
            if pinned is not None:
                buf, gen, _ = pinned
                gen.advance()
                buf.copy_(full)
                pulled = ZeroCopyHandle.wrap(buf, gen)
                self._pinned_pulls[name] = (buf, gen, pulled)
            elif self._mp:
                pulled = full[: bucket.total_len]
            else:
                pulled = self._stores[name][: bucket.total_len].clone()
        self._observe(name, "pull", bucket, t0)
        return pulled

    def register_pull_buffer(self, name: str) -> torch.Tensor:
        """Register a persistent ``[padded]`` pull buffer for ``name``
        (the reference's registered-buffer contract, ucx_van.h:603-623):
        every later ``pull(name)`` writes the store into this same
        memory and returns a new handle of it, as the JAX engine donates
        the previous pull's array to the next.  At most one pull of the
        bucket may be outstanding; a handle is stale after the next pull
        (a use raises).  Returns the first handle (zeros)."""
        bucket = self._buckets[name]
        buf = torch.zeros(bucket.padded_len, dtype=bucket.dtype,
                          device=self.device)
        gen = Generation(name)
        handle = ZeroCopyHandle.wrap(buf, gen)
        with self._bucket_mu[name]:
            self._pinned_pulls[name] = (buf, gen, handle)
        return handle

    def unregister_pull_buffer(self, name: str) -> None:
        with self._bucket_mu[name]:
            self._pinned_pulls.pop(name, None)

    def pinned_pull_buffer(self, name: str) -> Optional[torch.Tensor]:
        """The live handle of the registered pull buffer of ``name`` (the
        last pull's), or None."""
        with self._bucket_mu[name]:
            pinned = self._pinned_pulls.get(name)
            return pinned[2] if pinned is not None else None

    def store_array(self, name: str) -> torch.Tensor:
        """A copy of the ``[padded]`` store (checkpointing); across
        processes a collective through ``peers.gather_global``."""
        with self._bucket_mu[name]:
            if self._mp:
                return self._assemble(self._layouts[name],
                                      self._stores[name])
            return self._stores[name].clone()

    def set_store_array(self, name: str, value) -> None:
        """Restore a store from ``total_len`` or ``padded_len`` values."""
        bucket = self._buckets[name]
        if isinstance(value, torch.Tensor):
            log.check_eq(value.dtype, bucket.dtype, "bad restore dtype")
        flat = to_tensor(value, bucket.dtype, self.device).reshape(-1)
        log.check(flat.numel() in (bucket.total_len, bucket.padded_len),
                  "bad restore length")
        store = torch.zeros(bucket.padded_len, dtype=bucket.dtype,
                            device=self.device)
        store[: flat.numel()] = flat
        with self._bucket_mu[name]:
            self._generations[name].advance()
            if self._mp:
                # This process's pieces, in place (on the card, the store
                # lives in the bucket's exchange memory).
                self._stores[name].copy_(self._layouts[name].local_of(
                    store, self.group.process_index))
                return
            self._stores[name] = store

    # -- elastic tier ------------------------------------------------------------

    def reshard(self, group: DeviceGroup, axis_name=None) -> None:
        """Re-lay every registered bucket (store and optimizer state) onto
        a new device group: the engine side of the elastic tier (JAX
        ``CollectiveEngine.reshard``).  The key ranges are recut for the
        new shard count (padding included) and, on a 2-D or composite
        engine, for the new worker fan-in; callers' grads take the new
        W from then on.  ``axis_name`` (a name or a tuple) defaults to the
        current kv axis; a 2-D engine reshards only onto a group that
        carries its ``worker_axis``.  See :meth:`reshard_staged` for the
        stage/commit split."""
        with self.reshard_staged(group, axis_name) as commit:
            commit()

    @contextlib.contextmanager
    def reshard_staged(self, group: DeviceGroup, axis_name=None):
        """Stage a recut and yield its commit closure.

        On entry, with every bucket lock held (taken in sorted name
        order, released when the context exits), everything that can
        fail runs: the logical values of each store and optimizer state
        (``[:total_len]``, never the padded tensor: padding depends on the
        shard count) are placed, through :func:`placement.place`, as the
        new group's tensors; the adam step becomes one scalar broadcast to
        the new shard count; registered pull buffers get a fresh buffer
        of the new length.  Nothing of the engine changes until
        ``commit()``, which does plain assignments only: a coordinated
        recut of several engines stages them all first, so that a failure
        in any of them leaves every engine on the old group.  After the
        commit the buckets' zero-copy handles (and the last handle of
        each registered pull buffer) are stale.

        When both groups are on one card the recut is a copy on the card;
        a group on another device takes the state there.

        Across processes (either group spanning them) the recut is a
        collective of every process: each bucket's whole value is gathered
        in sorted name order (the owners' shards on the card,
        ``peers.gather_global`` for the optimizer state), and each process
        places the shards of the ranks it owns in the new group, which
        may differ from those it owned before, in a new exchange slab; the
        old slabs are retired at the commit."""
        if isinstance(axis_name, list):
            axis_name = tuple(axis_name)
        axis = axis_name or self.axis
        new_shards, new_workers = self._layout(group, axis)
        dev = group.device
        old_mp, new_mp = self._mp, group.is_multiprocess
        with self._mu:
            ordered = sorted(self._buckets)
        for n in ordered:
            self._bucket_mu[n].acquire()
        new_slabs: Dict[str, PeerSlab] = {}
        try:
            staged = {}
            for n in ordered:
                b = self._buckets[n]
                padded = -(-b.total_len // new_shards) * new_shards
                if old_mp or new_mp:
                    staged[n] = self._stage_mp(n, b, group, axis, padded,
                                               new_shards, new_slabs)
                    continue

                def repad(t, b=b, padded=padded):
                    return placement.place(t[: b.total_len], dev, padded)

                entry = {"padded": padded, "store": repad(self._stores[n])}
                if n in self._pinned_pulls:
                    buf = placement.place(self._stores[n][:0], dev, padded)
                    gen = Generation(n)
                    entry["pinned"] = (buf, gen, ZeroCopyHandle.wrap(buf, gen))
                if n in self._opt_states:
                    state = self._opt_states[n]
                    if self._opt_kinds[n] == "adam":
                        m, v, step = state
                        entry["opt"] = (repad(m), repad(v), placement.place(
                            step[:1].expand(new_shards), dev))
                    else:
                        entry["opt"] = (repad(state[0]),)
                staged[n] = entry

            def commit() -> None:
                self.group = group
                self.axis = axis
                self.device = dev
                self.num_shards = new_shards
                self.num_workers = new_workers
                self._mp = new_mp
                for n in ordered:
                    entry = staged[n]
                    self._buckets[n].padded_len = entry["padded"]
                    self._stores[n] = entry["store"]
                    self._generations[n].advance()
                    if "pinned" in entry:
                        self._pinned_pulls[n][1].advance()
                        self._pinned_pulls[n] = entry["pinned"]
                    if "opt" in entry:
                        self._opt_states[n] = entry["opt"]
                    if "layout" in entry:
                        self._layouts[n] = entry["layout"]
                    else:
                        self._layouts.pop(n, None)
                if old_mp or new_mp:
                    for slab in self._slabs.values():
                        self._retired.retire(slab)
                    self._slabs = dict(new_slabs)
                    new_slabs.clear()

            yield commit
        finally:
            for slab in new_slabs.values():  # staged, never committed
                self._retired.retire(slab)
            for n in reversed(ordered):
                self._bucket_mu[n].release()

    def _stage_mp(self, n: str, b: DenseBucket, group: DeviceGroup, axis,
                  padded: int, new_shards: int, new_slabs: dict) -> dict:
        """One bucket's staged state on ``group`` when the old or the new
        group spans processes (bucket locks held)."""
        dev = group.device
        if self._mp:
            full = self._gather_full(n)[: b.total_len]
        else:
            full = self._stores[n][: b.total_len]
        entry = {"padded": padded}
        layout = None
        if group.is_multiprocess:
            # Each process keeps the pieces of its ranks in the new
            # layout; on the card they are copied into a new slab.
            layout = entry["layout"] = self._new_layout(b.dtype, group, axis,
                                                        padded)
            me = group.process_index

            def place(t):
                whole = torch.zeros(padded, dtype=t.dtype, device=t.device)
                whole[:t.numel()] = t
                return placement.place(layout.local_of(whole, me), dev)
        else:
            def place(t):
                return placement.place_host_array(group, t, padded)
        store = place(full)
        if layout is not None and dev.type == "cuda":
            slab = PeerSlab(group, self._slab_layout(b, layout, me)[3])
            new_slabs[n] = slab
            staged, store = store, self._slab_store(slab, b, layout, me)
            store.copy_(staged)
        entry["store"] = store
        if n in self._pinned_pulls:
            buf = placement.place(full[:0], dev, padded)
            gen = Generation(n)
            entry["pinned"] = (buf, gen, ZeroCopyHandle.wrap(buf, gen))
        if n in self._opt_states:
            state = (self._gather_state(n) if self._mp
                     else self._opt_states[n])
            vecs = tuple(place(t[: b.total_len]) for t in
                         (state[:2] if self._opt_kinds[n] == "adam"
                          else state[:1]))
            if self._opt_kinds[n] == "adam":
                shards = (len(group.local_ranks) if group.is_multiprocess
                          else new_shards)
                vecs += (placement.place(state[2][:1].expand(shards).to(
                    torch.float32), dev),)
            entry["opt"] = vecs
        return entry

    def block(self, name: Optional[str] = None) -> None:
        """Wait for outstanding device work (ZPush/Wait semantics)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
