"""The data plane on device groups: groups, the collective KV engine,
sparse tables, and sequence-parallel primitives (the exports of
``pslite_tpu/parallel/__init__.py``, with device groups for meshes)."""

from .mesh import default_group, make_group
from .engine import CollectiveEngine, DenseBucket
from .coalesce import CoalescingDispatcher
from .pipeline import pipeline_apply, pipeline_loss, stack_layers

__all__ = [
    "CoalescingDispatcher",
    "CollectiveEngine",
    "DenseBucket",
    "default_group",
    "make_group",
    "pipeline_apply",
    "pipeline_loss",
    "stack_layers",
]
