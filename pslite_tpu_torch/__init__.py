"""pslite_tpu_torch — the ICI data plane of pslite_tpu on PyTorch and
CUDA: dense push_pull and sparse embedding tables.

A port of the JAX package ``pslite_tpu`` that imports neither JAX nor
``pslite_tpu``.  It covers a worker's registered dense buckets:
``KVWorker.push``/``pull``/``push_pull`` over the ICI van's
``CollectiveEngine``, on a 1-D group or a 2-D ``(dp, kv)`` group
(``make_group`` + ``worker_axis``), with or without int8 wire
compression (``PS_ICI_COMPRESS=int8``), and the int8 quantize ops; the
many-op surfaces (``push_pull_group``, the coalescer, ``replay``,
host-origin streams, zero-copy and registered pulls) and the ResNet-50
gradient trace (``models/resnet_trace.py``).  Sparse tables:
``SparseEngine`` (the van's ``sparse_engine``) and
``KVWorker.push_sparse``/``pull_sparse``, sum or row-wise Adagrad, single
and grouped, and the 1M-row Zipf embedding workload
(``models/embedding.py``, BASELINE config 5).  The fused ring (single and
grouped), int8 ring, fused optimizer, quantize and sparse row kernels are
written in CUDA for Hopper (``csrc/``).  Entry points run on CUDA unless the caller
passes a CPU device group, and raise without a card.
"""

from .kv.kv_app import KVWorker
from .parallel.engine import CollectiveEngine
from .parallel.mesh import DeviceGroup, default_group, make_group
from .parallel.sparse import SparseEngine
from .postoffice import Postoffice
from .ps import finalize, postoffice, start_ps

__all__ = [
    "CollectiveEngine",
    "DeviceGroup",
    "KVWorker",
    "Postoffice",
    "SparseEngine",
    "default_group",
    "finalize",
    "make_group",
    "postoffice",
    "start_ps",
]
