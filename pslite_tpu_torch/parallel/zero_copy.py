"""Zero-copy pull results that go stale, as donated JAX arrays do.

In the JAX engine (``pslite_tpu/parallel/engine.py``) the array that
``push_pull(zero_copy=True)`` or ``replay(keep="last", zero_copy=True)``
returns is the store, and a registered pull buffer's array is the
previous pull's output; the bucket's next mutating op (the next pull, for
a registered buffer) donates that buffer, so a stale holder raises on use
and ``is_deleted()`` turns True.

Here the engine keeps its own tensor and hands out a
:class:`ZeroCopyHandle`: a tensor on the same memory (same
``data_ptr()``, no copy) that remembers the :class:`Generation` of its
bucket when it was made.  The engine advances the generation at every
mutating op; from then on any torch op on the old handle (``.numpy()``,
``.tolist()``, ``.cpu()``, ``.item()`` and ``data_ptr()`` included)
raises ``RuntimeError`` naming the bucket.  A live handle works wherever
a tensor does; what an op on it returns is a plain tensor (in-place ops
return the handle itself).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten


class Generation:
    """The count of ops that replaced what a bucket's handles show."""

    __slots__ = ("bucket", "value")

    def __init__(self, bucket: str):
        self.bucket = bucket
        self.value = 0

    def advance(self) -> None:
        self.value += 1


class ZeroCopyHandle(torch.Tensor):
    """A tensor aliasing an engine buffer, valid until its bucket's
    generation moves on."""

    _generation: Generation
    _made_at: int

    @staticmethod
    def wrap(t: torch.Tensor, generation: Generation) -> "ZeroCopyHandle":
        h = t.as_subclass(ZeroCopyHandle)
        h._generation = generation
        h._made_at = generation.value
        return h

    def is_deleted(self) -> bool:
        """True once the bucket's next mutating op has run (as
        ``jax.Array.is_deleted``)."""
        return self._made_at != self._generation.value

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, ZeroCopyHandle) and a.is_deleted():
                raise RuntimeError(
                    f"zero-copy result of bucket {a._generation.bucket!r} "
                    f"is stale: the bucket's next op replaced it "
                    f"(a deleted array in the JAX engine)")
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **kwargs)


def plain(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain tensor on the same memory (a view of a handle)."""
    return t.view(t.shape) if isinstance(t, ZeroCopyHandle) else t
