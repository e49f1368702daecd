"""Operator tools over a live cluster: ``psmon`` (metrics, rates,
Prometheus text) and ``pstrace`` (tail traces, critical paths), the
port's copies of the repo's ``tools/psmon.py`` and ``tools/pstrace.py``.
Run them as ``python -m pslite_tpu_torch.tools.psmon`` and ``python -m
pslite_tpu_torch.tools.pstrace``."""
