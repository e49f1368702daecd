"""The port's device-timeline reader (``pslite_tpu_torch/utils/
xplane.py``, over ``torch.profiler``'s Chrome trace) against JAX's
(``pslite_tpu/utils/xplane.py``, over an XSpace protobuf): the same
intervals, written once in each format, give equal busy and per-op
seconds.  The protobuf carries only the fields JAX's reader names
(XSpace.planes, XPlane id/name/lines and its event_metadata map for op
names, XLine id/name/timestamp_ns/events, XEvent metadata_id/offset_ps/
duration_ps)."""

import json
from decimal import Decimal

import numpy as np
import pytest

from pslite_tpu.utils import xplane as jx
from pslite_tpu_torch.utils import xplane as tx

# (stream, op name, start µs, duration µs): stream 7 has two overlapping
# kernels and a copy; stream 13 a kernel and a set that overlap stream 7
# in time (summed, not unioned, across streams).
DEVICE_EVENTS = [
    (7, "ring_kernel<float,4,false>", 1000.125, 20.5),
    (7, "ring_kernel<float,4,false>", 1010.0, 15.25),  # overlaps
    (7, "Memcpy DtoD (Device -> Device)", 1040.0, 3.001),
    (13, "sort_kernel", 1005.0, 7.125),
    (13, "Memset (Device)", 1030.0, 0.375),
]
# Stream 7: [1000.125, 1025.25] + [1040, 1043.001]; stream 13: 7.5.
STREAM7_PS = 25_125_000 + 3_001_000
STREAM13_PS = 7_125_000 + 375_000


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, value) -> bytes:
    if isinstance(value, int):
        return _varint(num << 3) + _varint(value)
    if isinstance(value, str):
        value = value.encode()
    return _varint((num << 3) | 2) + _varint(len(value)) + value


def _ps(us: float) -> int:
    """Picoseconds of a time as the trace writes it (its shortest
    decimal text)."""
    return int(Decimal(repr(us)) * 1_000_000)


def _xspace() -> bytes:
    names = sorted({name for _, name, _, _ in DEVICE_EVENTS})
    md = {name: i + 1 for i, name in enumerate(names)}
    plane = _field(1, 1) + _field(2, "/device:TPU:0")
    for stream in (7, 13):
        events = b"".join(
            _field(4, _field(1, md[name])
                   + _field(2, _ps(ts)) + _field(3, _ps(dur)))
            for s, name, ts, dur in DEVICE_EVENTS if s == stream)
        plane += _field(3, _field(1, stream) + _field(2, "XLA Ops")
                        + _field(3, 0) + events)
    # An annotating line over the same span: not an op line.
    plane += _field(3, _field(1, 99) + _field(2, "Steps") + _field(3, 0)
                    + _field(4, _field(1, 1) + _field(2, 1_000_000_000)
                             + _field(3, 50_000_000)))
    for name, mid in md.items():
        plane += _field(4, _field(1, mid)
                        + _field(2, _field(1, mid) + _field(2, name)))
    host = _field(1, 2) + _field(2, "/host:CPU") + _field(
        3, _field(1, 1) + _field(2, "python")
        + _field(4, _field(1, 1) + _field(2, 0) + _field(3, 9_000_000)))
    return _field(1, plane) + _field(1, host)


def _chrome() -> dict:
    cats = {"Memcpy": "gpu_memcpy", "Memset": "gpu_memset"}
    events = [
        {"ph": "X", "cat": cats.get(name.split()[0], "kernel"),
         "name": name, "pid": 0, "tid": stream, "ts": ts, "dur": dur,
         "args": {"device": 0, "stream": stream}}
        for stream, name, ts, dur in DEVICE_EVENTS]
    events += [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0,
         "tid": 7, "ts": 1000.0, "dur": 50.0,
         "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 4242,
         "tid": 4242, "ts": 0.0, "dur": 9.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 4242, "tid": 4242, "ts": 999.0, "dur": 1.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "pid": 0, "tid": 7,
         "ts": 1001.0, "s": "t"},
    ]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _write(tmp_path):
    jdir, tdir = tmp_path / "jax" / "plugins", tmp_path / "port"
    jdir.mkdir(parents=True)
    tdir.mkdir()
    (jdir / "host.xplane.pb").write_bytes(_xspace())
    (tdir / "trace_1_1.json").write_text(json.dumps(_chrome()))
    return str(tmp_path / "jax"), str(tdir)


def test_same_intervals_same_busy_and_op_seconds(tmp_path):
    jdir, tdir = _write(tmp_path)
    assert len(jx.find_xplane_files(jdir)) == 1
    assert tx.find_xplane_files(tdir) == [f"{tdir}/trace_1_1.json"]
    jbusy, tbusy = jx.device_busy_seconds(jdir), tx.device_busy_seconds(tdir)
    assert list(jbusy) == ["/device:TPU:0"]
    assert list(tbusy) == ["/device:GPU:0"]
    assert tbusy["/device:GPU:0"] == jbusy["/device:TPU:0"]
    assert tbusy["/device:GPU:0"] == pytest.approx(
        (STREAM7_PS + STREAM13_PS) / 1e12, rel=1e-15)
    jops, tops = jx.device_op_seconds(jdir), tx.device_op_seconds(tdir)
    assert tops == jops
    assert tops["ring_kernel<float,4,false>"] == pytest.approx(
        35.75e-6, rel=1e-15)
    # The picosecond views agree line for line and op for op.
    jp = jx.plane_op_ps(f"{jdir}/plugins/host.xplane.pb")["/device:TPU:0"]
    tp = tx.plane_op_ps(f"{tdir}/trace_1_1.json")["/device:GPU:0"]
    assert tp == jp


def test_streams_sum_and_one_stream_unions(tmp_path):
    _, tdir = _write(tmp_path)
    lines = tx.plane_busy_ps(f"{tdir}/trace_1_1.json")
    assert lines["/device:GPU:0"] == {"stream 7": STREAM7_PS,
                                      "stream 13": STREAM13_PS,
                                      "annotations": 50_000_000}
    # Host events land on the host plane, which the device readers skip.
    assert lines["/host:CPU"] == {"thread 4242": 10_000_000}
    assert set(tx.device_op_seconds(tdir)) == {
        name for _, name, _, _ in DEVICE_EVENTS}


def test_a_second_trace_adds_and_other_files_are_skipped(tmp_path):
    """A second trace of the same device in the directory adds to it
    (as a second XSpace file does in JAX's); other files are not
    traces."""
    _, tdir = _write(tmp_path)
    (tmp_path / "port" / "sub").mkdir()
    (tmp_path / "port" / "sub" / "trace_2_1.json").write_text(
        json.dumps(_chrome()))
    (tmp_path / "port" / "notes.json").write_text("{}")
    assert len(tx.find_xplane_files(tdir)) == 2
    busy = tx.device_busy_seconds(tdir)["/device:GPU:0"]
    assert busy == 2 * ((STREAM7_PS + STREAM13_PS) / 1e12)


def test_cpu_only_trace_reads_empty_and_goodput_zero(tmp_path):
    """On a host without CUDA the profiler records no device event: the
    readers give ``{}``, and a stress pattern measured by them reports
    0.0 (never an invented number)."""
    import torch

    from pslite_tpu_torch import stress
    from pslite_tpu_torch.parallel.engine import CollectiveEngine
    from pslite_tpu_torch.parallel.mesh import DeviceGroup
    from pslite_tpu_torch.parallel.sparse import SparseEngine
    from pslite_tpu_torch.utils.profiling import device_trace

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    seen = []

    def measure(loop):
        d = str(tmp_path / f"t{len(seen)}")
        with device_trace(d):
            loop()
        busy = tx.device_busy_seconds(d)
        seen.append((busy, tx.device_op_seconds(d),
                     tx.find_xplane_files(d)))
        return sum(busy.values()) / len(busy) if busy else None

    eng = CollectiveEngine(DeviceGroup(8, device="cpu"))
    sp = SparseEngine(eng.group)
    for pattern in stress.PATTERNS:
        assert stress.run_pattern(eng, sp, pattern, 4096, 1, measure) == 0.0
    assert len(seen) == len(stress.PATTERNS)
    for busy, ops, files in seen:
        assert busy == {} and ops == {} and len(files) == 1
    assert np.asarray(eng.pull("stress_dense_4096")).max() == 16.0
