"""Checkpoint / resume of server state: the npz half of
``pslite_tpu/checkpoint.py``.

Snapshots of the engines (dense buckets with their optimizer state,
sparse tables with their accumulators), of message-path server stores
and handles, of exported key ranges and of a training loop's flat store,
as ``.npz`` files that the JAX package's functions of the same names
read and write: the same member names in the same order, the same dtypes
and shapes, and the same ``__meta__`` bytes (``json.dumps`` of a dict
built in the same key order).  ``np.savez`` stamps zip members with the
time of writing, so two files agree member by member, not byte by byte.

- :func:`save_engine` writes format v2, FLEET-SIZE PORTABLE: dense stores
  and vector optimizer states de-padded to ``total_len``, the adam step
  as one scalar, tables and accumulators in global row order.
  :func:`restore_engine` reads v2 into engines of any shard count and
  v1 (padded, shard-interleaved) onto the saver's shard count only.
- :class:`AsyncEngineCheckpointer` writes the v1 layout, as the JAX one
  does (no ``version`` in its meta: padded stores, the adam step per
  shard, interleaved tables).
- bfloat16 arrays are written as their raw 2-byte bits, the ``V2``
  dtype that ``np.savez`` gives an ``ml_dtypes.bfloat16`` array (and,
  read back, a ``V2`` array is taken as bfloat16).  The JAX
  ``restore_engine`` cannot cast ``V2`` into a bfloat16 store, so a bf16
  bucket moves from the JAX package to the port only.

Orbax is a JAX library, and this package imports no JAX: ``have_orbax``
is False, ``save_engine_orbax``/``restore_engine_orbax`` raise
``NotImplementedError``, ``save_range_segment(fmt="orbax")`` warns and
writes npz (what the JAX package does where orbax is not importable) and
``load_range_segment(fmt="orbax")`` raises.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .parallel.engine import to_tensor, torch_dtype
from .parallel.mesh import resolve_device
from .utils import logging as log

_NO_ORBAX = ("orbax checkpoints need JAX, which pslite_tpu_torch does not "
             "import; use the npz functions of this module")


def have_orbax() -> bool:
    """Always False: orbax is a JAX library."""
    return False


def save_engine_orbax(engine, path: str, sparse_engine=None) -> None:
    raise NotImplementedError(_NO_ORBAX)


def restore_engine_orbax(engine, path: str, sparse_engine=None) -> None:
    raise NotImplementedError(_NO_ORBAX)


def _host(value) -> np.ndarray:
    """A numpy array of ``value``; bfloat16 tensors as their raw 2-byte
    bits (``V2``)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(value)


def _bucket_meta(bucket) -> dict:
    return {"keys": bucket.keys.tolist(), "val_len": bucket.val_len,
            "total_len": bucket.total_len}


def _table_meta(sparse_engine, name: str, table) -> dict:
    return {"num_rows": table.num_rows, "dim": table.dim,
            "has_acc": name in sparse_engine._acc}


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def save_engine(engine, path: str, sparse_engine=None) -> None:
    """Snapshot every dense bucket (and sparse table) to ``path`` in
    format v2: dense stores and vector optimizer states sliced to
    ``total_len``, the adam step counter as a scalar, tables and
    accumulators de-interleaved to global row order, so that a file
    written by an 8-shard engine restores into a 4-shard one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    meta = {"version": 2, "dense": {}, "sparse": {}, "opt": {}}
    for name, bucket in engine._buckets.items():
        arrays[f"dense/{name}"] = _host(
            engine.store_array(name)[: bucket.total_len])
        meta["dense"][name] = _bucket_meta(bucket)
        opt = engine.opt_state(name)
        if opt is not None:
            kind, states = opt
            meta["opt"][name] = {"kind": kind, "n": len(states)}
            for i, s in enumerate(states):
                # The per-shard adam step -> one scalar (the same on every
                # shard by construction).
                s = s.reshape(-1)[:1] if kind == "adam" and i == 2 else \
                    s[: bucket.total_len]
                arrays[f"opt/{name}/{i}"] = _host(s)
    if sparse_engine is not None:
        for name, table in sparse_engine._tables.items():
            arrays[f"sparse/{name}"] = _host(
                sparse_engine.store_global_device(name))
            meta["sparse"][name] = _table_meta(sparse_engine, name, table)
            if name in sparse_engine._acc:
                arrays[f"sparse_acc/{name}"] = _host(
                    sparse_engine.acc_global_device(name))
    arrays["__meta__"] = _meta_array(meta)
    np.savez(path, **arrays)


def _check_v1_shards(meta: dict, data, engine, sparse_engine) -> None:
    """A v1 file is laid out for its saver's shard count S, which it does
    not record: restored onto another S its tables' interleaved rows
    would land permuted whenever the row counts happen to agree.  Refuse
    it when what the file does show of S disagrees with this engine's:
    an adam step vector holds S entries, and a store longer than its
    ``total_len`` is padded to a multiple of S."""
    shards = {engine.num_shards}
    if sparse_engine is not None:
        shards.add(sparse_engine.num_shards)
    seen = set()
    for name, info in meta.get("opt", {}).items():
        if info["kind"] == "adam":
            seen.add(int(data[f"opt/{name}/2"].size))
    for name, info in meta["dense"].items():
        n = int(data[f"dense/{name}"].size)
        if name in engine._buckets and n != info["total_len"]:
            log.check(n == engine._buckets[name].padded_len,
                      f"v1 checkpoint: bucket {name!r} is padded to {n} "
                      f"values, not to this engine's "
                      f"{engine._buckets[name].padded_len}: the file was "
                      f"written on another shard count; restore a v2 file "
                      f"(save_engine) instead")
    bad = seen - shards
    log.check(not bad,
              f"v1 checkpoint written by an engine of {sorted(bad)} shards "
              f"cannot restore onto {sorted(shards)} (its tables' rows "
              f"would be permuted); restore a v2 file (save_engine) "
              f"instead")


def restore_engine(engine, path: str, sparse_engine=None) -> None:
    """Restore buckets and tables saved by :func:`save_engine` (or, v1,
    by :class:`AsyncEngineCheckpointer`).  Buckets and tables must
    already be registered; a v2 file restores onto any shard count, a v1
    file onto the saver's only (refused before anything is restored
    where the file shows another shard count).  Without
    ``sparse_engine`` the tables are not read."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        v2 = meta.get("version", 1) >= 2
        if not v2:
            _check_v1_shards(meta, data, engine, sparse_engine)
        for name in meta["dense"]:
            log.check(name in engine._buckets,
                      f"bucket {name!r} not registered before restore")
            engine.set_store_array(name, data[f"dense/{name}"])
        for name, info in meta.get("opt", {}).items():
            engine.set_opt_state(
                name, info["kind"],
                [data[f"opt/{name}/{i}"] for i in range(info["n"])],
            )
        if sparse_engine is None:
            return
        for name, info in meta["sparse"].items():
            sparse_engine.set_store_array(name, data[f"sparse/{name}"],
                                          global_rows=v2)
            if info.get("has_acc"):
                sparse_engine.set_acc_array(name, data[f"sparse_acc/{name}"],
                                            global_rows=v2)


class AsyncEngineCheckpointer:
    """Engine checkpoints that do not block the training loop: the
    snapshot is taken on the device when :meth:`save` is called (a clone
    of each store and state under its lock), and a writer thread copies
    it to the host and writes the file (the v1 layout, as the JAX
    checkpointer writes).

    The snapshot is the state as of the ``save()`` call: pushes issued
    after it returns are not in the file.  The clones run on the calling
    thread's current stream, the one the engines' kernels run on, so a
    later in-place push cannot overwrite a store before its clone has
    read it; an event recorded after the clones is what the writer waits
    on before it copies them to the host.

    Device memory: each pending snapshot holds a full copy of the
    engines' state on the device (BASELINE config 5's table alone is 268
    MB), until the writer has copied it.  At most ``max_pending``
    snapshots wait in the queue, one is being written, and a ``save()``
    that finds the queue full blocks holding its own: ``max_pending + 2``
    copies at most.

    ``wait()`` joins every pending write; a failed write raises on the
    next ``save()`` or ``wait()``, and the checkpointer stays usable."""

    def __init__(self, max_pending: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._errors = []
        self._mu = threading.Lock()
        self._worker = threading.Thread(target=self._run, name="async-ckpt",
                                        daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            arrays, meta, path, event = item
            try:
                if event is not None:
                    event.synchronize()
                host = {k: _host(v) for k, v in arrays.items()}
                del arrays
                host["__meta__"] = _meta_array(meta)
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                tmp = path + ".tmp"
                np.savez(tmp, **host)
                # np.savez appends .npz to the name it writes.
                os.replace(
                    tmp if tmp.endswith(".npz") else tmp + ".npz",
                    path if path.endswith(".npz") else path + ".npz",
                )
            except Exception as exc:  # noqa: BLE001 - surfaced to caller
                with self._mu:
                    self._errors.append(exc)
            finally:
                self._q.task_done()

    def _raise_pending_error(self):
        with self._mu:
            if self._errors:
                raise self._errors.pop(0)

    def save(self, engine, path: str, sparse_engine=None) -> None:
        """Queue a snapshot of the engines (see the class docstring);
        blocks only while ``max_pending`` writes are waiting."""
        self._raise_pending_error()
        arrays = {}
        meta = {"dense": {}, "sparse": {}, "opt": {}}
        for name, bucket in engine._buckets.items():
            arrays[f"dense/{name}"] = engine.store_array(name)
            meta["dense"][name] = _bucket_meta(bucket)
            opt = engine.opt_state(name)
            if opt is not None:
                kind, states = opt
                meta["opt"][name] = {"kind": kind, "n": len(states)}
                for i, s in enumerate(states):
                    arrays[f"opt/{name}/{i}"] = s
        if sparse_engine is not None:
            for name, table in sparse_engine._tables.items():
                arrays[f"sparse/{name}"] = sparse_engine.store_array(name)
                meta["sparse"][name] = _table_meta(sparse_engine, name,
                                                   table)
                if name in sparse_engine._acc:
                    arrays[f"sparse_acc/{name}"] = sparse_engine.acc_array(
                        name)
        event = None
        cuda = [v.device for v in arrays.values() if v.device.type == "cuda"]
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0]))
        self._q.put((arrays, meta, path, event))

    def wait(self) -> None:
        """Block until every queued checkpoint is on disk; re-raise the
        first background failure if one occurred."""
        self._q.join()
        self._raise_pending_error()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._worker.join()


def save_range_segment(path: str, keys: np.ndarray, vals: np.ndarray,
                       lens: Optional[np.ndarray],
                       fmt: str = "npz") -> str:
    """Write one exported key range (sorted keys, flat vals, per-key
    lens) as a snapshot segment file ``path + ".npz"``, atomically (a
    temporary file renamed into place) and durably (the file and its
    directory fsynced before this returns).  Returns the format written:
    always ``"npz"`` (``fmt="orbax"`` warns, as the JAX package does
    where orbax is not importable)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if fmt == "orbax":
        log.warning("PS_SNAPSHOT_FORMAT=orbax but orbax is not "
                    "importable; writing the npz fallback")
    arrays = {"keys": np.asarray(keys), "vals": np.asarray(vals)}
    if lens is not None:
        arrays["lens"] = np.asarray(lens, dtype=np.int64)
    # A kill mid-write leaves the old segment or none, never a torn one;
    # the bytes are on disk before the caller reports success.
    tmp = f"{path}.tmp.{os.getpid()}"
    np.savez(tmp, **arrays)
    with open(tmp + ".npz", "rb") as fh:
        os.fsync(fh.fileno())
    os.replace(tmp + ".npz", path + ".npz")
    fsync_dir(os.path.dirname(path) or ".")
    return "npz"


def fsync_dir(directory: str) -> None:
    """Best-effort durability of a directory entry after a rename (some
    filesystems cannot fsync a directory)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def load_range_segment(path: str, fmt: str = "npz"):
    """Inverse of :func:`save_range_segment`: ``(keys, vals,
    lens|None)``."""
    if fmt == "orbax":
        raise NotImplementedError(_NO_ORBAX)
    with np.load(path + ".npz", allow_pickle=False) as data:
        return (data["keys"], data["vals"],
                data["lens"] if "lens" in data.files else None)


def save_kv_store(store: Dict[int, np.ndarray], path: str) -> None:
    """Snapshot a message-path server store (e.g. KVServerDefaultHandle's)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{str(k): v for k, v in store.items()})


def load_kv_store(path: str) -> Dict[int, np.ndarray]:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        return {int(k): data[k] for k in data.files}


def save_server_handle(handle, path: str) -> None:
    """Snapshot a message-path server handle, parameters and optimizer
    state: ``KVServerDefaultHandle`` (store) or
    ``KVServerOptimizerHandle`` (store, momentum/adam slots, step
    counts).  Handles apply in place, so quiesce the server first for a
    consistent snapshot."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"s_{k}": v for k, v in list(handle.store.items())}
    for slot in ("_m", "_v"):
        for k, v in list(getattr(handle, slot, {}).items()):
            arrays[f"{slot}_{k}"] = v
    t = getattr(handle, "_t", None)
    if t:
        items = sorted(list(t.items()))
        arrays["t_keys"] = np.asarray([k for k, _ in items], np.int64)
        arrays["t_vals"] = np.asarray([v for _, v in items], np.int64)
    np.savez(path, **arrays)


def load_server_handle(handle, path: str) -> None:
    """Restore state saved by :func:`save_server_handle` into a freshly
    constructed handle (hyperparameters come from the constructor)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        t_map = {}
        if "t_keys" in data.files:
            t_map = dict(zip(data["t_keys"].tolist(),
                             data["t_vals"].tolist()))
        for name in data.files:
            if name.startswith("s_"):
                handle.store[int(name[2:])] = data[name]
            elif name.startswith("_m_"):
                handle._m[int(name[3:])] = data[name]
            elif name.startswith("_v_"):
                handle._v[int(name[3:])] = data[name]
    if t_map and hasattr(handle, "_t"):
        handle._t.update(t_map)


def save_train_state(flat_store, step: int, path: str) -> str:
    """Snapshot a training loop's flat parameter store (a tensor or an
    array) and its step.  Returns the path written (``.npz`` appended)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, store=_host(flat_store), step=np.int64(step))
    return path if path.endswith(".npz") else path + ".npz"


def load_train_state(path: str, device=None):
    """``(store, step)`` saved by :func:`save_train_state`: the store as
    a numpy array, or with ``device`` a tensor on that device."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        store, step = data["store"], int(data["step"])
    if device is not None:
        raw_bf16 = store.dtype.kind == "V" and store.dtype.itemsize == 2
        dt = torch.bfloat16 if raw_bf16 else torch_dtype(store.dtype)
        store = to_tensor(store, dt, resolve_device(device))
    return store, step
