"""Placement of staged state onto a device group's device.

Counterpart of ``pslite_tpu/parallel/placement.py``'s
``place_host_array``: the one function through which a reshard's staging
(``CollectiveEngine.reshard_staged``, ``SparseEngine.reshard_staged``)
builds every tensor of the new layout.  It is looked up on this module at
call time, so a test can replace it with one that fails on its N-th call
to play a peer that dies in the middle of a recut.
"""

from __future__ import annotations

from typing import Optional

import torch


def place(value: torch.Tensor, device,
          length: Optional[int] = None) -> torch.Tensor:
    """A fresh contiguous tensor on ``device`` holding ``value``'s rows
    first and zeros after them, ``length`` rows in all (``value``'s own
    row count by default).  A copy on the card when ``value`` is there
    too; the state moves with it otherwise."""
    rows = int(value.shape[0])
    length = rows if length is None else int(length)
    out = torch.zeros((length,) + tuple(value.shape[1:]), dtype=value.dtype,
                      device=device)
    out[:rows] = value
    return out
