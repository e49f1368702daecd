"""Load engine checkpoints and server stores written by the JAX package.

``pslite_tpu.checkpoint.save_engine`` (checkpoint.py:271-330) writes a
version-2 npz: ``dense/<name>`` stores and ``opt/<name>/<i>`` optimizer
states in their logical (de-padded) layout, the adam step as a scalar,
``sparse/<name>`` tables and ``sparse_acc/<name>`` row-wise Adagrad
accumulators in global row order (``has_acc`` in the table's meta), and
a ``__meta__`` JSON record.  :func:`load_engine_npz` reads such a file
into port engines through ``checkpoint.restore_engine``, the one restore
path, refusing any other version.  :func:`load_server_store` fills a
message-path server handle from a JAX handle's dicts in memory (files
go through ``checkpoint.save_server_handle``/``load_server_handle``).
"""

from __future__ import annotations

import json

import numpy as np

from .utils import logging as log


def load_engine_npz(engine, path: str, sparse_engine=None) -> None:
    """Restore every dense bucket (and its optimizer state) saved in the
    v2 file ``path`` into ``engine``, and with ``sparse_engine`` every
    sparse table (and its accumulator).  Buckets and tables must already
    be registered, as for the JAX ``restore_engine``; the saver's shard
    count may differ from the engines'.  Without ``sparse_engine`` the
    sparse entries are not read, as in the JAX package."""
    from .checkpoint import restore_engine

    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
    log.check_eq(meta.get("version"), 2, "unsupported checkpoint version")
    restore_engine(engine, path, sparse_engine=sparse_engine)


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
