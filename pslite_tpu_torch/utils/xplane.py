"""Device-timeline reader for ``torch.profiler`` traces: on-device busy
time and per-op time.

Counterpart of ``pslite_tpu/utils/xplane.py`` (:1-233), which reads the
XSpace protobuf ``jax.profiler.trace`` writes.  Here the trace is the
Chrome trace JSON that :class:`~pslite_tpu_torch.utils.profiling.
device_trace` writes (``trace_<pid>_<n>.json``, ``export_chrome_trace``);
the module keeps its name and its API so a reader finds the counterpart:
:func:`find_xplane_files`, :func:`plane_busy_ps`, :func:`plane_op_ps`,
:func:`device_busy_seconds` and :func:`device_op_seconds`.  It reads
with ``json`` alone.

A trace's complete events (``"ph": "X"``) map onto JAX's planes and
lines:

- a device event (``cat`` ``kernel``, ``gpu_memcpy`` or ``gpu_memset``:
  what runs on the card, as XLA's "XLA Ops" line carries kernels and
  copies) lies on plane ``/device:GPU:<device>``, line ``stream
  <stream>``;
- a GPU annotation (``gpu_user_annotation``) lies on that plane's
  ``annotations`` line: it spans device events and, like XLA's "Steps"
  and "XLA Modules" lines, would count them twice;
- every other event (operators, runtime calls, Python functions) lies on
  plane ``/host:CPU``, line ``thread <tid>``, which the device readers
  exclude as JAX's excludes ``/host:CPU`` planes.

Busy time is computed as the union of ``[ts, ts + dur]`` intervals per
line, and lines are summed, not unioned (JAX's :19-24): parallel streams
count as device-seconds of work.  Per-op time sums durations per kernel
name.  Timestamps are read as decimals (microseconds with three decimal
places in the trace), so picoseconds come out exact.

A trace without device events (a host without CUDA) reads as ``{}``;
callers turn that into "no measurement", never into a number.
"""

from __future__ import annotations

import json
import os
from decimal import Decimal
from typing import Dict, Iterator, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_CATEGORY = "gpu_user_annotation"
STREAM_LINE = "stream "


def _ps(us) -> int:
    """Picoseconds of a trace time in microseconds."""
    return int(Decimal(us) * 1_000_000)


def _events(path: str) -> Iterator[dict]:
    """The complete (``"ph": "X"``) events of one Chrome trace."""
    with open(path, "rb") as fh:
        doc = json.load(fh, parse_float=Decimal)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    for ev in events:
        if isinstance(ev, dict) and ev.get("ph") == "X":
            yield ev


def _where(ev: dict) -> Tuple[str, str]:
    """``(plane, line)`` of one event."""
    cat = ev.get("cat", "")
    args = ev.get("args") or {}
    if cat in DEVICE_CATEGORIES or cat == ANNOTATION_CATEGORY:
        plane = f"/device:GPU:{args.get('device', ev.get('pid'))}"
        if cat == ANNOTATION_CATEGORY:
            return plane, "annotations"
        return plane, f"{STREAM_LINE}{args.get('stream', ev.get('tid'))}"
    return "/host:CPU", f"thread {ev.get('tid')}"


def _lines(path: str) -> Dict[str, Dict[str, List[tuple]]]:
    """``{plane: {line: [(start_ps, end_ps, name)]}}`` of one trace."""
    out: Dict[str, Dict[str, List[tuple]]] = {}
    for ev in _events(path):
        dur = _ps(ev.get("dur", 0))
        if dur <= 0:
            continue
        start = _ps(ev.get("ts", 0))
        plane, line = _where(ev)
        out.setdefault(plane, {}).setdefault(line, []).append(
            (start, start + dur, str(ev.get("name", ""))))
    return out


def _union_ps(intervals: List[tuple]) -> int:
    """Length of the union of ``(start, end, ...)`` intervals."""
    spans = sorted((s, e) for s, e, *_ in intervals)
    busy = 0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def plane_busy_ps(path: str) -> Dict[str, Dict[str, int]]:
    """{plane_name: {line_name: busy_ps}} for one trace file."""
    return {plane: {line: _union_ps(iv) for line, iv in lines.items()}
            for plane, lines in _lines(path).items()}


def plane_op_ps(path: str) -> Dict[str, Dict[str, int]]:
    """{plane_name: {op_name: total duration_ps}} over the device planes'
    stream lines.

    Durations are SUMMED per op (not interval-unioned): the per-op split
    is a where-does-the-time-go diagnostic, so overlap within one op
    name is attributed to it in full."""
    out: Dict[str, Dict[str, int]] = {}
    for plane, lines in _lines(path).items():
        ops: Dict[str, int] = {}
        for line, iv in lines.items():
            if not line.startswith(STREAM_LINE):
                continue
            for s, e, name in iv:
                ops[name] = ops.get(name, 0) + e - s
        if ops:
            out[plane] = ops
    return out


def _is_device(plane: str) -> bool:
    return plane.startswith("/device:GPU:")


def device_op_seconds(logdir: str) -> Dict[str, float]:
    """{op_name: device-seconds} summed over all GPU planes in a trace
    dir — the op-level complement of :func:`device_busy_seconds`."""
    totals: Dict[str, float] = {}
    for path in find_xplane_files(logdir):
        for pname, ops in plane_op_ps(path).items():
            if not _is_device(pname):
                continue
            for nm, ps in ops.items():
                totals[nm] = totals.get(nm, 0.0) + ps / 1e12
    return totals


def find_xplane_files(logdir: str) -> List[str]:
    """The Chrome traces ``device_trace`` wrote under ``logdir``
    (``trace_*.json``)."""
    hits = []
    for root, _dirs, files in os.walk(logdir):
        for f in files:
            if f.startswith("trace_") and f.endswith(".json"):
                hits.append(os.path.join(root, f))
    return sorted(hits)


def device_busy_seconds(logdir: str) -> Dict[str, float]:
    """Per-device-plane busy seconds summed over that plane's stream
    lines.

    Planes ``/device:GPU:<n>`` are the card's timelines; ``/host:CPU``
    carries operators and runtime calls and is excluded.  Within a GPU
    plane only the stream lines (kernels, copies, sets) count: the
    annotation line spans those same intervals and would double-count
    them, so the filter is an allowlist, as JAX's is."""
    totals: Dict[str, float] = {}
    for path in find_xplane_files(logdir):
        for pname, lines in plane_busy_ps(path).items():
            if not _is_device(pname):
                continue
            busy = sum(ps for lname, ps in lines.items()
                       if lname.startswith(STREAM_LINE))
            if busy:
                totals[pname] = totals.get(pname, 0.0) + busy / 1e12
    return totals
