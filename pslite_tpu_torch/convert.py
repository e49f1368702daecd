"""Load engine checkpoints written by the JAX package.

``pslite_tpu.checkpoint.save_engine`` (checkpoint.py:271-330) writes a
version-2 npz: ``dense/<name>`` stores and ``opt/<name>/<i>`` optimizer
states in their logical (de-padded) layout, the adam step as a scalar,
``sparse/<name>`` tables and ``sparse_acc/<name>`` row-wise Adagrad
accumulators in global row order (``has_acc`` in the table's meta), and
a ``__meta__`` JSON record.  :func:`load_engine_npz` reads it with numpy
alone into a port engine, so server state carries across.
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
