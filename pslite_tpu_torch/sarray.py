"""SArray — a typed numpy view with device placement tags.

Counterpart of ``pslite_tpu/sarray.py`` (the reference's
``include/ps/sarray.h``): zero-copy assignment, reinterpreting casts
(``astype_view``), zero-copy ``segment`` slices, and src/dst device tags
carried through both.  Host numpy only: the message path moves host
bytes, and device tensors ride the collective engine instead, so the
JAX class's handle to an on-device array is not carried.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np


class DeviceType(enum.IntEnum):
    """Where a buffer lives (reference: sarray.h device tags UNK/CPU/GPU)."""

    UNK = 0
    CPU = 1
    TPU = 2  # the reference's GPU slot (the JAX package's TPU HBM)


class SArray:
    """A typed view over shared bytes, with src/dst device placement tags.

    Copying an SArray never copies data — only the view.  ``segment`` and
    ``astype_view`` return new SArrays aliasing the same buffer, preserving
    device tags (reference: sarray.h:294-305, 319-323).
    """

    __slots__ = (
        "data",
        "src_device",
        "src_device_id",
        "dst_device",
        "dst_device_id",
    )

    def __init__(
        self,
        data: Any = None,
        dtype: Any = None,
        src_device: DeviceType = DeviceType.UNK,
        src_device_id: int = -1,
        dst_device: DeviceType = DeviceType.UNK,
        dst_device_id: int = -1,
    ):
        if data is None:
            self.data = np.empty(0, dtype=dtype or np.uint8)
        elif isinstance(data, SArray):
            self.data = data.data
            src_device = data.src_device
            src_device_id = data.src_device_id
            dst_device = data.dst_device
            dst_device_id = data.dst_device_id
        elif isinstance(data, np.ndarray):
            self.data = data if dtype is None else data.view(dtype)
        elif isinstance(data, (bytes, bytearray, memoryview)):
            self.data = np.frombuffer(data, dtype=dtype or np.uint8)
        else:
            self.data = np.asarray(data, dtype=dtype)
        self.src_device = src_device
        self.src_device_id = src_device_id
        self.dst_device = dst_device
        self.dst_device_id = dst_device_id

    # -- zero-copy transforms ------------------------------------------------

    def astype_view(self, dtype) -> "SArray":
        """Reinterpreting cast (no copy) — reference sarray.h:81-91."""
        out = SArray(self.data.view(dtype))
        out._copy_tags(self)
        return out

    def segment(self, begin: int, end: int) -> "SArray":
        """Zero-copy slice [begin, end) — reference sarray.h:294-305."""
        out = SArray(self.data[begin:end])
        out._copy_tags(self)
        return out

    def _copy_tags(self, other: "SArray") -> None:
        self.src_device = other.src_device
        self.src_device_id = other.src_device_id
        self.dst_device = other.dst_device
        self.dst_device_id = other.dst_device_id

    # -- properties ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.data)

    @property
    def size(self) -> int:
        return int(self.data.size)

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes)

    @property
    def dtype(self):
        return self.data.dtype

    def tobytes(self) -> bytes:
        return self.data.tobytes()

    def numpy(self) -> np.ndarray:
        return self.data

    def shares_memory(self, other: "SArray") -> bool:
        return np.shares_memory(self.data, other.data)

    def __getitem__(self, idx):
        return self.data[idx]

    def __repr__(self) -> str:
        return (
            f"SArray(dtype={self.data.dtype}, size={self.data.size}, "
            f"src={self.src_device.name}:{self.src_device_id}, "
            f"dst={self.dst_device.name}:{self.dst_device_id})"
        )


def as_sarray(x: Any, dtype=None) -> SArray:
    return x if isinstance(x, SArray) else SArray(x, dtype=dtype)
