"""pslite_tpu_torch's wire format and SArray against the JAX package's.

Mirrors ``test_wire.py`` and ``test_sarray.py``.  The same Meta and
Message, built in both packages from the same numpy inputs, must pack to
the same bytes (meta and whole frame), and each package must read the
other's bytes back to the same fields.  Tolerance: none, byte for byte.
"""

import itertools
import struct

import numpy as np
import pytest

from pslite_tpu import message as jmsg
from pslite_tpu import sarray as jsarray
from pslite_tpu import wire as jwire
from pslite_tpu_torch import message as tmsg
from pslite_tpu_torch import sarray as tsarray
from pslite_tpu_torch import wire as twire
from pslite_tpu_torch.range import Range, find_range
from pslite_tpu_torch.sarray import DeviceType, SArray


def _sample_meta(m):
    """The sample Meta of test_wire.py, built from message module ``m``."""
    node_a = m.Node(role=m.Role.WORKER, id=9, customer_id=2,
                    hostname="10.0.0.1", ports=[5001, 5002], dev_types=[2, 2],
                    dev_ids=[0, 1], is_recovery=True,
                    endpoint_name=b"\x01\x02ep", aux_id=3)
    node_b = m.Node(role=m.Role.SERVER, id=8, hostname="10.0.0.2",
                    ports=[6000])
    return m.Meta(
        head=7, app_id=11, customer_id=1, timestamp=42, sender=9, recver=8,
        request=True, push=True, pull=False, simple_app=False,
        body=b"hello-body", data_type=[8, 10, 5],
        control=m.Control(cmd=m.Command.ADD_NODE, node=[node_a, node_b],
                          barrier_group=7, msg_sig=0xDEADBEEF),
        key=123456789, addr=0xABCDEF, val_len=4096, option=-5, sid=77,
        data_size=8192, priority=9, src_dev_type=2, src_dev_id=0,
        dst_dev_type=1, dst_dev_id=-1,
    )


def _all_extensions(m):
    meta = _sample_meta(m)
    meta.control = m.Control()
    meta.trace = 0x1234
    meta.tenant = 3
    meta.stamp = 12
    meta.batch = m.BatchInfo(ops=(
        m.BatchOp(push=True, timestamp=5, key=100, val_len=4096, nseg=2),
        m.BatchOp(pull=True, timestamp=6, key=200, val_len=64, nseg=3,
                  option=7, stamp=99, trace=0x55,
                  codec=m.CodecInfo(codec=2, raw_len=0, block=128)),
    ))
    meta.codec = m.CodecInfo(codec=2, raw_len=1 << 26, block=128, flags=1)
    meta.chunk = m.ChunkInfo(xfer=5, index=1, total=3, offset=4096,
                             seg_lens=(128, 65536, 2048),
                             seg_types=(8, 2, 10))
    return meta


def _control(m):
    return m.Meta(recver=1, request=True, timestamp=3,
                  control=m.Control(cmd=m.Command.BARRIER, barrier_group=6))


def _kv_request(m):
    return m.Meta(app_id=0, customer_id=0, timestamp=17, sender=9, recver=8,
                  request=True, push=True, pull=True, head=3,
                  key=2 ** 63 + 5, val_len=96, priority=-2)


_METAS = {"sample": _sample_meta, "empty": lambda m: m.Meta(),
          "all_extensions": _all_extensions, "control": _control,
          "kv_request": _kv_request}


@pytest.mark.parametrize("kind", sorted(_METAS))
def test_pack_meta_bytes_equal_jax(kind):
    jm, tm = _METAS[kind](jmsg), _METAS[kind](tmsg)
    jb, tb = jwire.pack_meta(jm), twire.pack_meta(tm)
    assert tb == jb
    # Each package reads the other's bytes back to the same fields.
    assert twire.unpack_meta(jb) == tm
    assert jwire.unpack_meta(tb) == jm


def _message(m, sa, seed):
    rng = np.random.default_rng(seed)
    msg = m.Message(meta=_kv_request(m))
    msg.add_data(sa.SArray(np.array([3, 9, 2 ** 40], dtype=np.uint64)))
    msg.add_data(sa.SArray(rng.normal(size=12).astype(np.float32)))
    msg.add_data(sa.SArray(np.array([4, 4, 4], dtype=np.int32)))
    msg.add_data(sa.SArray(rng.normal(size=3)))  # float64
    return msg


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_frame_bytes_equal_jax(seed):
    jb = b"".join(bytes(c) for c in jwire.pack_frame(
        _message(jmsg, jsarray, seed)))
    tmsg_ = _message(tmsg, tsarray, seed)
    tb = b"".join(bytes(c) for c in twire.pack_frame(tmsg_))
    assert tb == jb
    meta_len, n_data = twire.unpack_frame_header(jb[:twire.FRAME_HEADER_SIZE])
    off = twire.FRAME_HEADER_SIZE
    lens = struct.unpack_from(f"<{n_data}Q", jb, off)
    off += 8 * n_data
    meta = twire.unpack_meta(jb[off:off + meta_len])
    off += meta_len
    bufs = []
    for ln in lens:
        bufs.append(jb[off:off + ln])
        off += ln
    out = twire.rebuild_message(meta, bufs)
    for got, want in zip(out.data, tmsg_.data):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert out.meta.data_size == sum(d.nbytes for d in tmsg_.data)


def test_meta_roundtrip():
    meta = _sample_meta(tmsg)
    assert twire.unpack_meta(twire.pack_meta(meta)) == meta
    assert twire.unpack_meta(twire.pack_meta(tmsg.Meta())) == tmsg.Meta()


def test_ext_registry_order_and_chunk_last():
    """Every EXT_* tag is unique, and the tail packs in the order trace,
    qos, batch, codec, chunk, with the chunk extension strictly last,
    for every subset that keeps it."""
    tags = {n: getattr(twire, n) for n in dir(twire) if n.startswith("EXT_")}
    assert len(tags) == 5 and len(set(tags.values())) == 5

    def ext_sequence(buf):
        fields = twire._META_FIXED.unpack_from(buf, 0)
        off = twire._META_FIXED.size + fields[-2] + fields[-1]
        view = memoryview(buf)
        for _ in range(fields[-3]):
            _node, off = twire._unpack_node(view, off)
        seq = []
        while off + 2 <= len(buf):
            tag, ln = struct.unpack_from("<BB", buf, off)
            seq.append((tag, off, ln))
            off += 2 + ln
        assert off == len(buf)
        return seq

    meta = _all_extensions(tmsg)
    buf = twire.pack_meta(meta)
    assert [t for t, _o, _l in ext_sequence(buf)] == [
        twire.EXT_TRACE, twire.EXT_QOS, twire.EXT_BATCH, twire.EXT_CODEC,
        twire.EXT_CHUNK]
    for drop in ("trace", "qos", "batch", "codec"):
        m2 = twire.unpack_meta(buf)
        if drop == "trace":
            m2.trace = 0
        elif drop == "qos":
            m2.tenant = m2.stamp = 0
        elif drop == "batch":
            m2.batch = None
        else:
            m2.codec = None
        b2 = twire.pack_meta(m2)
        tag, off, ln = ext_sequence(b2)[-1]
        assert tag == twire.EXT_CHUNK and off + 2 + ln == len(b2)
        assert ln == twire.chunk_ext_payload_size(3)


def test_pack_frame_contiguous_zero_copy():
    msg = tmsg.Message(meta=tmsg.Meta(app_id=1))
    contiguous = np.arange(16, dtype=np.float32)
    strided = np.arange(32, dtype=np.float32)[::2]
    msg.add_data(SArray(contiguous))
    msg.add_data(SArray(strided))
    chunks = twire.pack_frame(msg)
    assert np.shares_memory(np.frombuffer(chunks[3], np.float32), contiguous)
    np.testing.assert_array_equal(np.frombuffer(chunks[4], np.float32),
                                  strided)


def test_rebuild_message_accepts_ndarray_segments():
    vals = np.arange(12, dtype=np.float32)
    block = np.empty(64, np.uint8)
    block[: vals.nbytes] = vals.view(np.uint8)
    meta = tmsg.Meta(data_type=[10], data_size=vals.nbytes)
    out = twire.rebuild_message(meta, [block[: vals.nbytes]])
    np.testing.assert_array_equal(out.data[0].numpy(), vals)
    assert out.data[0].numpy().base is block


def test_meta_fixed_offsets():
    assert (twire.META_SID_OFF, twire.META_PRIORITY_OFF,
            twire.META_CONTROL_CMD_OFF, twire.META_FIXED_SIZE) == (
        jwire.META_SID_OFF, jwire.META_PRIORITY_OFF,
        jwire.META_CONTROL_CMD_OFF, jwire.META_FIXED_SIZE) == (58, 70, 84, 105)


def test_dtype_codes_match_jax():
    for dt in (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
               np.int64, np.uint64, np.float16, np.float32, np.float64):
        assert tmsg.dtype_code(dt) == jmsg.dtype_code(dt)
    for code in range(1, 13):
        assert tmsg.code_dtype(code) == jmsg.code_dtype(code)


# -- mirrors of tests/test_sarray.py -------------------------------------------

def test_zero_copy_assignment():
    a = SArray(np.arange(10, dtype=np.float32))
    b = SArray(a)
    assert a.shares_memory(b)
    b.data[0] = 99.0
    assert a.data[0] == 99.0


def test_segment_is_view():
    a = SArray(np.arange(10, dtype=np.float32), src_device=DeviceType.TPU,
               src_device_id=3)
    seg = a.segment(2, 5)
    assert seg.size == 3 and seg.shares_memory(a)
    assert seg.src_device == DeviceType.TPU and seg.src_device_id == 3
    seg.data[0] = -1.0
    assert a.data[2] == -1.0


def test_reinterpret_cast():
    a = SArray(np.arange(4, dtype=np.uint64))
    b = a.astype_view(np.uint8)
    assert b.nbytes == a.nbytes and b.size == 32 and b.shares_memory(a)


def test_from_bytes():
    a = SArray(b"\x01\x00\x00\x00", dtype=np.int32)
    assert a.size == 1 and int(a[0]) == 1


@pytest.mark.parametrize("begin,end", itertools.product([0, 3, 4, 40],
                                                        [4, 17, 33, 2 ** 64 - 1]))
def test_find_range_matches_jax(begin, end):
    from pslite_tpu.range import find_range as jfind

    keys = np.array([2, 4, 8, 16, 32], dtype=np.uint64)
    r, j = find_range(keys, begin, end), jfind(keys, begin, end)
    assert (r.begin, r.end) == (j.begin, j.end)
    assert Range(3, 7).size() == 4 and Range(3, 7).contains(6)
