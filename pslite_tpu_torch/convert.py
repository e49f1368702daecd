"""Load engine checkpoints and server stores written by the JAX package.

``pslite_tpu.checkpoint.save_engine`` (checkpoint.py:271-330) writes a
version-2 npz: ``dense/<name>`` stores and ``opt/<name>/<i>`` optimizer
states in their logical (de-padded) layout, the adam step as a scalar,
``sparse/<name>`` tables and ``sparse_acc/<name>`` row-wise Adagrad
accumulators in global row order (``has_acc`` in the table's meta), and
a ``__meta__`` JSON record.  :func:`load_engine_npz` reads it with numpy
alone into a port engine, so server state carries across.
:func:`load_server_store` fills a message-path server handle from a JAX
handle's dicts (the npz ``save_server_handle`` is ROADMAP Queue 1
item 5).
"""

from __future__ import annotations

import json

import numpy as np

from .utils import logging as log


def load_engine_npz(engine, path: str, sparse_engine=None) -> None:
    """Restore every dense bucket (and its optimizer state) saved in
    ``path`` into ``engine``, and with ``sparse_engine`` every sparse
    table (and its accumulator).  Buckets and tables must already be
    registered, as for the JAX ``restore_engine``; the saver's shard
    count may differ from the engines'.  Without ``sparse_engine`` the
    sparse entries are not read, as in the JAX package."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        log.check_eq(meta.get("version"), 2, "unsupported checkpoint version")
        for name in meta["dense"]:
            engine.set_store_array(name, data[f"dense/{name}"])
        for name, info in meta.get("opt", {}).items():
            engine.set_opt_state(
                name, info["kind"],
                [data[f"opt/{name}/{i}"] for i in range(info["n"])],
            )
        if sparse_engine is None:
            return
        for name, info in meta.get("sparse", {}).items():
            sparse_engine.set_store_array(name, data[f"sparse/{name}"],
                                          global_rows=True)
            if info.get("has_acc"):
                sparse_engine.set_acc_array(name, data[f"sparse_acc/{name}"],
                                            global_rows=True)


def load_server_store(handle, store, slots=None) -> None:
    """Fill a port ``KVServerDefaultHandle`` or
    ``KVServerOptimizerHandle`` from a JAX handle's ``store`` dict (key
    -> numpy array), copying every array.  For the optimizer handle,
    ``slots`` is the JAX ``KVServerOptimizerHandle`` whose optimizer
    state (``_m``, ``_v``: key -> array; ``_t``: key -> step) comes
    along."""
    handle.store.clear()
    handle.store.update({int(k): np.array(v, copy=True)
                         for k, v in store.items()})
    if slots is None:
        return
    log.check(hasattr(handle, "_t"),
              "optimizer slots given for a handle without optimizer state")
    for name in ("_m", "_v"):
        dst = getattr(handle, name)
        dst.clear()
        dst.update({int(k): np.array(v, copy=True)
                    for k, v in getattr(slots, name).items()})
    handle._t.clear()
    handle._t.update({int(k): int(t) for k, t in slots._t.items()})
