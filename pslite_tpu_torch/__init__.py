"""pslite_tpu_torch — pslite_tpu on PyTorch and CUDA.

A port of the JAX package ``pslite_tpu`` that imports neither JAX nor
``pslite_tpu``.  It covers:

- **The message control plane in one process** (``postoffice.py``,
  ``vans/``, ``customer.py``): scheduler, servers and workers (instance
  groups and the joint role too) started through ``start_ps`` or
  ``Postoffice(role, env).start()`` over the ``loopback`` van, with
  bootstrap and ranks, barriers, heartbeats and send lanes;
  ``KVWorker.push``/``pull``/``push_pull`` of any sorted keys, sliced
  across the servers' key ranges, with ``lens`` and ``cmd``;
  ``KVServer`` with ``KVServerDefaultHandle`` or
  ``KVServerOptimizerHandle``, applying on the apply-shard pool
  (``kv/apply_shards.py``; chunked pushes streamed into it); wire codecs
  with error feedback (``ops/codecs.py``: int8, fp8_e4m3, bf16, by
  ``register_bucket`` or ``codec=``); small-op batching
  (``PS_BATCH_BYTES``, ``kv/batching.py``), the serving fan-in
  ``KVWorker.multi_get``, the hot-key pull cache
  (``PS_HOT_CACHE``, ``kv/hot_cache.py``) and tenants with weighted-fair
  queues and admission control (``PS_TENANTS``, ``tenants.py``; a shed
  raises ``OverloadError``); ``SimpleApp``.  Host numpy, as in JAX.
- **The ICI data plane** (``vans/ici_van.py``, ``parallel/``): a
  worker's registered dense buckets through ``CollectiveEngine``, on a
  1-D group or a 2-D ``(dp, kv)`` group, with or without int8 wire
  compression (``PS_ICI_COMPRESS=int8``), the many-op surfaces
  (``push_pull_group``, the coalescer, ``replay``, host-origin streams,
  zero-copy and registered pulls), the ResNet-50 gradient trace
  (``models/resnet_trace.py``), and sparse tables (``SparseEngine``,
  ``push_sparse``/``pull_sparse``, ``models/embedding.py``).  On the
  ``ici`` van one ``KVWorker`` sends registered buckets to the engine
  and every other key over messages to the servers.
- **Engine state that moves**: npz checkpoints of engines and server
  handles, sync and async (``checkpoint.py``, the JAX package's npz
  layout, v2 restoring across shard counts), composite kv axes
  (``axis_name=("kv1", "kv2")``), and the live recut of dense buckets and
  sparse tables onto another device group (``CollectiveEngine.reshard``,
  ``SparseEngine.reshard``, ``KVWorker.reshard`` across a cluster).

The fused ring (single and grouped), int8 ring, fused optimizer (f32 and
bf16), quantize and sparse row kernels are written in CUDA for Hopper
(``csrc/``).  Device entry points run on CUDA unless the caller passes a
CPU device group, and raise without a card.
"""

from .base import ALL_GROUP, SCHEDULER_GROUP, SERVER_GROUP, WORKER_GROUP
from .kv.kv_app import (
    KVMeta,
    KVPairs,
    KVServer,
    KVServerDefaultHandle,
    KVServerOptimizerHandle,
    KVWorker,
    OverloadError,
)
from .kv.simple_app import SimpleApp, SimpleData
from .message import Role
from .parallel.engine import CollectiveEngine
from .parallel.mesh import DeviceGroup, default_group, make_group
from .parallel.sparse import SparseEngine
from .postoffice import Postoffice
from .ps import finalize, postoffice, start_ps

__all__ = [
    "ALL_GROUP",
    "CollectiveEngine",
    "DeviceGroup",
    "KVMeta",
    "KVPairs",
    "KVServer",
    "KVServerDefaultHandle",
    "KVServerOptimizerHandle",
    "KVWorker",
    "OverloadError",
    "Postoffice",
    "Role",
    "SCHEDULER_GROUP",
    "SERVER_GROUP",
    "SimpleApp",
    "SimpleData",
    "SparseEngine",
    "WORKER_GROUP",
    "default_group",
    "finalize",
    "make_group",
    "postoffice",
    "start_ps",
]
