"""Wire-compression codecs of the message path, with error feedback.

Counterpart of ``pslite_tpu/ops/codecs.py``, host numpy as there:

- ``int8`` — blockwise symmetric int8 (4x).
- ``fp8_e4m3`` — blockwise-scaled float8 e4m3fn (4x).
- ``bf16`` — round-to-nearest-even bfloat16 (2x), scale-free.

Wire layout (both directions): ``data = [keys, codes(u8), scales(f32)
(, lens(i32))]``, the codec identity in the ``EXT_CODEC`` meta extension
(``message.CodecInfo``).  Flat fixed-``k`` payloads take one f32 scale per
``BLOCK`` (128) values, the last block ragged; ``lens`` payloads scale per
key, each key's segment cut into its own blocks.

Error feedback (:class:`ErrorFeedback`): the encoder folds the last
round's quantization error toward one destination into the next round's
payload (``PS_CODEC_EF=0`` disables).  Residuals live with the encoder:
the worker for pushes, the server's handle for pull responses.

Encode and decode split the payload into block-aligned spans over a
process-wide thread pool (``PS_CODEC_THREADS``, default ``min(12,
cores)``); no span straddles a scale block, so the bytes are the same for
every thread count.  Large outputs come from a refcount-recycled buffer
pool (``PS_CODEC_POOL_MB``, default 256): a block is handed out again only
once every view of it (message segments, queued frames, store slices) is
gone, so a frame still waiting in a send lane keeps its codes.

NaN/Inf: NaN propagates (bf16/fp8 natively; int8 through the reserved
``-128`` code, flagged in ``CodecInfo.flags``); +/-Inf saturates to the
block's largest magnitude (bf16 keeps Inf).  Scales come from the finite
magnitudes only.

What is this package's own: JAX casts with ``ml_dtypes``, which these
codecs do not use (a host may lack it).  The fp8 tables are built with
``torch.float8_e4m3fn`` and patched where torch's cast differs from
``ml_dtypes`` (:func:`_fp8_tables`), and bf16 is encoded with bit
arithmetic that writes NaN as ``0x7FC0 | sign``, as ``ml_dtypes`` does
(:func:`_bf16_bits`), so every code byte equals the JAX package's.  fp8
is always registered (torch has the type).

The native core (``vans/native.py``) runs int8 and fp8 encode, decode and
range decode in one pass each, its span pool behind a single GIL release
(``psl_codec_*``, :func:`_native_codec`), fed this module's fp8 tables;
its bytes equal the numpy path's, which stays for ``PS_CODEC_NATIVE=0``
or ``PS_NATIVE=0`` and for ``lens`` payloads.  bf16 is numpy in both
packages.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import logging as log

BLOCK = 128  # values per scale block

# CodecInfo.flags bits.
FLAG_HAS_NAN = 1  # int8 payload holds -128 NaN sentinels

_PAR_MIN_BYTES = 1 << 21  # split encode/decode into spans above 2 MiB


# -- span thread pool -----------------------------------------------------------

_pool = None
_pool_mu = threading.Lock()
_tls = threading.local()


def codec_threads() -> int:
    """Worker count of the span pool (``PS_CODEC_THREADS``; 0 = serial)."""
    raw = os.environ.get("PS_CODEC_THREADS", "")
    if raw.strip():
        return max(0, int(raw))
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n = os.cpu_count() or 1
    return min(12, n)


def _get_pool():
    global _pool
    with _pool_mu:
        if _pool is None:
            import concurrent.futures

            _pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, codec_threads()),
                thread_name_prefix="codec-span")
        return _pool


def _scratch(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-thread scratch (two float32, one float16) of >= n values:
    fresh multi-MB temporaries per call convoy the span threads on the
    kernel's mmap lock."""
    s = getattr(_tls, "bufs", None)
    if s is None or s[0].size < n:
        s = (np.empty(n, np.float32), np.empty(n, np.float32),
             np.empty(n, np.float16))
        _tls.bufs = s
    return s


def _spans(n_elems: int, min_elems: int) -> List[Tuple[int, int]]:
    """Block-aligned spans of ``n_elems`` over the pool (one span when
    small or serial)."""
    nt = codec_threads()
    if nt <= 1 or n_elems * 4 < _PAR_MIN_BYTES:
        return [(0, n_elems)]
    blocks = (n_elems + min_elems - 1) // min_elems
    per = (blocks + nt - 1) // nt * min_elems
    return [(a, min(a + per, n_elems)) for a in range(0, n_elems, per)]


def _run_spans(fn, spans) -> None:
    if len(spans) == 1:
        fn(*spans[0])
        return
    list(_get_pool().map(lambda ab: fn(*ab), spans))


# -- output buffer pool -----------------------------------------------------------

def _free_block_refcount() -> int:
    """CPython refcount of a block referenced only by the pool's list and
    the probe's argument: an interpreter that counts otherwise degrades
    to never reusing a block, not to reusing a live one."""
    probe = [np.empty(0, np.uint8)]
    return sys.getrefcount(probe[0])


_FREE_REFS = _free_block_refcount()


class _BufPool:
    """Recycles the codecs' large outputs (codes, decoded values): a
    fresh multi-MB ``np.empty`` per call pays a page fault per page on
    first touch.  A block is handed out again only when its refcount says
    no view of it is alive."""

    _MAX_ENTRIES = 32

    def __init__(self, budget_mb: int):
        self._mu = threading.Lock()
        self._entries: List[np.ndarray] = []
        self._total = 0
        self._budget = budget_mb << 20  # <= 0 disables pooling

    def take(self, nbytes: int) -> np.ndarray:
        """A uint8 block of >= nbytes (callers slice and view it; the
        view's base reference marks the block busy)."""
        cls = 1 << max(16, (max(nbytes, 1) - 1).bit_length())
        if cls > self._budget:
            return np.empty(nbytes, np.uint8)
        with self._mu:
            best = -1
            for i in range(len(self._entries)):
                if (self._entries[i].nbytes >= nbytes
                        and sys.getrefcount(self._entries[i]) == _FREE_REFS
                        and (best < 0 or self._entries[i].nbytes
                             < self._entries[best].nbytes)):
                    best = i
            if best >= 0:
                return self._entries[best]
            block = np.empty(cls, np.uint8)
            if (self._total + cls > self._budget
                    or len(self._entries) >= self._MAX_ENTRIES):
                # Evict free smaller blocks, smallest first (indexing the
                # list directly: a local binding would raise the count).
                for i in sorted(range(len(self._entries)),
                                key=lambda j: self._entries[j].nbytes):
                    if (self._total + cls <= self._budget
                            and len(self._entries) < self._MAX_ENTRIES):
                        break
                    if (self._entries[i] is not None
                            and self._entries[i].nbytes < cls
                            and sys.getrefcount(self._entries[i])
                            == _FREE_REFS):
                        self._total -= self._entries[i].nbytes
                        self._entries[i] = None
                self._entries = [e for e in self._entries if e is not None]
            if (len(self._entries) < self._MAX_ENTRIES
                    and self._total + cls <= self._budget):
                self._entries.append(block)
                self._total += cls
            return block


_buf_pool: Optional[_BufPool] = None


def _take_buf(nbytes: int) -> np.ndarray:
    """Process-wide pooled block (``PS_CODEC_POOL_MB``, default 256; 0
    disables pooling)."""
    global _buf_pool
    if _buf_pool is None:
        with _pool_mu:
            if _buf_pool is None:
                _buf_pool = _BufPool(int(
                    os.environ.get("PS_CODEC_POOL_MB", "256") or "256"))
    return _buf_pool.take(nbytes)


_native_lib = None
_native_probed = False


def _native_codec():
    """The native core's codec kernels, or None (numpy) under
    ``PS_CODEC_NATIVE=0`` or a process-wide ``PS_NATIVE=0``.  The first
    call hands the core this module's fp8 tables.  A core that cannot be
    built raises."""
    global _native_lib, _native_probed
    if _native_probed:
        return _native_lib
    with _pool_mu:
        if not _native_probed:
            lib = None
            if os.environ.get("PS_CODEC_NATIVE", "1") not in ("0", "false"):
                from ..vans import native

                lib = native.load()
            if lib is not None:
                enc, dec = Fp8E4M3Codec._luts()
                lib.psl_codec_set_fp8_tables(enc.ctypes.data,
                                             dec.ctypes.data)
            _native_lib = lib
            _native_probed = True
    return _native_lib


def _native_rc(rc: int, what: str) -> int:
    """A codec kernel's flags; a negative return (a block size or kind it
    refuses) raises rather than quietly taking numpy."""
    if rc < 0:
        raise RuntimeError(f"native codec {what} refused the call ({rc})")
    return rc


# -- blockwise scale helpers ------------------------------------------------------

def n_blocks(n_elems: int, lens=None) -> int:
    """Scale count of a payload: flat blocks, or per-key blocks when
    ``lens`` (per-key value counts) is given."""
    if lens is None:
        return (n_elems + BLOCK - 1) // BLOCK
    lens = np.asarray(lens, dtype=np.int64)
    return int(((lens + BLOCK - 1) // BLOCK).sum())


def _key_block_starts(lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(block starts, block sizes) of a per-key blockwise layout: each
    key's segment is cut into its own ceil(len / BLOCK) blocks."""
    lens = np.asarray(lens, dtype=np.int64)
    nb = np.maximum((lens + BLOCK - 1) // BLOCK, 0)
    total = int(nb.sum())
    key_starts = np.concatenate(([0], np.cumsum(lens)))[:-1]
    kidx = np.repeat(np.arange(len(lens)), nb)
    first = np.concatenate(([0], np.cumsum(nb)))[:-1]
    within = np.arange(total) - np.repeat(first, nb)
    starts = key_starts[kidx] + within * BLOCK
    ends = np.minimum(starts + BLOCK, np.repeat(key_starts + lens, nb))
    return starts.astype(np.int64), (ends - starts).astype(np.int64)


class Codec:
    """One scheme: float32 payload <-> (codes u8, scales f32, flags).
    ``encode(..., resid=)`` fuses error feedback: it encodes ``vals +
    resid`` and leaves the new quantization error in ``resid``."""

    name: str = ""
    wire_id: int = 0
    block: int = BLOCK
    code_bytes_per_elem: int = 1
    range_decode: bool = False  # decode_key_ranges can decode it
    native_kind: int = -1  # psl_codec_* kind, -1: numpy only

    def encode(self, vals: np.ndarray, lens=None,
               resid: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, int]:
        raise NotImplementedError

    def decode(self, codes: np.ndarray, scales: np.ndarray, n: int,
               lens=None, flags: int = 0) -> np.ndarray:
        raise NotImplementedError

    def _check_input(self, vals: np.ndarray, lens) -> np.ndarray:
        if vals is None or vals.size == 0:
            raise ValueError(f"codec {self.name!r}: cannot encode empty vals")
        log.check(vals.dtype == np.float32,
                  f"codec {self.name!r} requires float32 values, got "
                  f"{vals.dtype}")
        v = vals.reshape(-1)
        if lens is not None:
            lens = np.asarray(lens, dtype=np.int64)
            log.check(int(lens.sum()) == v.size,
                      f"codec {self.name!r}: lens sum {int(lens.sum())} != "
                      f"vals size {v.size}")
        return np.ascontiguousarray(v)


class _BlockCodec(Codec):
    """The blockwise-scaled codecs (int8, fp8): span-parallel flat path
    into thread-local scratch, per-key ``reduceat`` path for ``lens``."""

    qmax: float = 0.0

    def _quantize_into(self, y: np.ndarray, out_u8: np.ndarray,
                       maybe_nonfinite: bool) -> bool:
        """y: scaled values (scratch, |y| <= qmax but non-finite ones);
        write codes into out_u8; True when NaN sentinels were written."""
        raise NotImplementedError

    def _reconstruct_into(self, codes_u8: np.ndarray,
                          out_f32: np.ndarray) -> None:
        """codes -> unscaled float32 values (sentinel NaNs not restored)."""
        raise NotImplementedError

    def _reconstruct(self, codes_u8: np.ndarray) -> np.ndarray:
        out = np.empty(codes_u8.size, np.float32)
        self._reconstruct_into(codes_u8, out)
        return out

    def encode(self, vals, lens=None, resid=None):
        v = self._check_input(vals, lens)
        if resid is not None:
            log.check(resid.size == v.size,
                      "error-feedback residual shape drifted")
        if lens is not None:
            return self._encode_ragged(v, lens, resid)
        n = v.size
        codes = _take_buf(n)[:n]
        scales = np.empty(n_blocks(n), np.float32)
        lib = _native_codec()
        if lib is not None:
            # One call: the core's span pool behind one GIL release.
            return codes, scales, _native_rc(lib.psl_codec_encode_mt(
                self.native_kind, v.ctypes.data,
                resid.ctypes.data if resid is not None else 0, n, BLOCK,
                codes.ctypes.data, scales.ctypes.data, codec_threads()),
                "encode")
        spans = _spans(n, BLOCK)
        flags = [False] * len(spans)

        def one(si, a, b):
            flags[si] = self._encode_span(v, a, b, codes, scales, resid)

        if len(spans) == 1:
            one(0, *spans[0])
        else:
            list(_get_pool().map(lambda t: one(t[0], *t[1]),
                                 enumerate(spans)))
        return codes, scales, (FLAG_HAS_NAN if any(flags) else 0)

    def _span_scales(self, y_abs: np.ndarray, full: int, m: int
                     ) -> Tuple[np.ndarray, bool]:
        """Per-block scales of one span from its |x|, and whether a
        non-finite value was seen (those blocks' maxes are taken again
        over their finite values only)."""
        parts = []
        bad_any = False
        if full:
            sl = y_abs[:full].reshape(-1, BLOCK).max(axis=1)
            bad = ~np.isfinite(sl)
            if bad.any():
                bad_any = True
                rows = np.nonzero(bad)[0]
                ya = y_abs[:full].reshape(-1, BLOCK)[rows]
                sl[rows] = np.where(np.isfinite(ya), ya, 0.0).max(axis=1)
            parts.append(sl)
        if m > full:
            t = float(y_abs[full:m].max())
            if not np.isfinite(t):
                bad_any = True
                ya = y_abs[full:m]
                fin = ya[np.isfinite(ya)]
                t = float(fin.max()) if fin.size else 0.0
            parts.append(np.array([t], np.float32))
        sl_all = parts[0] if len(parts) == 1 else np.concatenate(parts)
        np.maximum(sl_all, 1e-12, out=sl_all)
        sl_all /= self.qmax
        return sl_all.astype(np.float32, copy=False), bad_any

    def _encode_span(self, v, a, b, codes, scales, resid) -> bool:
        """Encode [a, b) (block-aligned start): scale, quantize and, with
        ``resid``, fold in and update the residual, into scratch."""
        m = b - a
        full = m - (m % BLOCK)
        eff_b, y_b, _ = _scratch(m)
        if resid is not None:
            eff = eff_b[:m]
            np.add(v[a:b], resid[a:b], out=eff)
        else:
            eff = v[a:b]
        y = y_b[:m]
        np.abs(eff, out=y)
        sl, maybe_bad = self._span_scales(y, full, m)
        sb = a // BLOCK
        scales[sb: sb + sl.size] = sl
        # Multiply by the reciprocal, as JAX does (the bytes depend on it).
        if full:
            np.multiply(eff[:full].reshape(-1, BLOCK),
                        (np.float32(1.0) / sl[: full // BLOCK])[:, None],
                        out=y[:full].reshape(-1, BLOCK))
        if m > full:
            np.multiply(eff[full:], np.float32(1.0) / sl[-1], out=y[full:])
        has_nan = self._quantize_into(y, codes[a:b], maybe_bad)
        if resid is not None:
            dec = y  # the quantized floats are spent
            self._reconstruct_into(codes[a:b], dec)
            if full:
                d2 = dec[:full].reshape(-1, BLOCK)
                d2 *= sl[: full // BLOCK, None]
            if m > full:
                dec[full:] *= sl[-1]
            np.subtract(eff, dec, out=resid[a:b])
            if maybe_bad or has_nan:
                # A NaN/Inf input's error is zero: it must not poison
                # later rounds through the residual.
                r = resid[a:b]
                r[~np.isfinite(r)] = 0.0
        return has_nan

    def _encode_ragged(self, v, lens, resid):
        """Per-key blockwise path: ``reduceat`` over key-local block
        starts, no padding, no scale spans two keys."""
        eff = v + resid if resid is not None else v
        starts, sizes = _key_block_starts(np.asarray(lens))
        absx = np.abs(eff)
        bad = not bool(np.isfinite(absx).all())
        if bad:
            absx = np.where(np.isfinite(absx), absx, 0.0)
        sl = np.maximum.reduceat(absx, starts).astype(np.float32)
        np.maximum(sl, 1e-12, out=sl)
        sl /= self.qmax
        per_elem = np.repeat(sl, sizes)
        y = eff / per_elem
        codes = _take_buf(v.size)[: v.size]
        has_nan = self._quantize_into(y, codes, bad)
        if resid is not None:
            dec = self._reconstruct(codes)
            dec *= per_elem
            err = eff - dec
            if bad or has_nan:
                err[~np.isfinite(err)] = 0.0
            resid[:] = err
        return codes, sl, (FLAG_HAS_NAN if has_nan else 0)

    def decode(self, codes, scales, n, lens=None, flags=0):
        codes = np.ascontiguousarray(codes).reshape(-1)[:n]
        scales = np.ascontiguousarray(scales, np.float32).reshape(-1)
        log.check(codes.size == n,
                  f"codec {self.name!r}: short payload ({codes.size} codes "
                  f"for {n} values)")
        expect = n_blocks(n, lens)
        log.check(scales.size >= expect,
                  f"codec {self.name!r}: scale table too short "
                  f"({scales.size} < {expect})")
        out = _take_buf(4 * n)[: 4 * n].view(np.float32)
        if lens is not None:
            _starts, sizes = _key_block_starts(np.asarray(lens))
            self._reconstruct_into(codes, out)
            out *= np.repeat(scales[:expect], sizes)
            if flags & FLAG_HAS_NAN:
                self._apply_nan(codes, out)
            return out
        lib = _native_codec()
        if lib is not None:
            _native_rc(lib.psl_codec_decode_mt(
                self.native_kind, codes.ctypes.data, scales.ctypes.data, n,
                BLOCK, flags, out.ctypes.data, codec_threads()), "decode")
            return out

        def one(a, b):
            m = b - a
            full = m - (m % BLOCK)
            seg = out[a:b]
            self._reconstruct_into(codes[a:b], seg)
            if full:
                d2 = seg[:full].reshape(-1, BLOCK)
                d2 *= scales[a // BLOCK: a // BLOCK + full // BLOCK, None]
            if m > full:
                seg[full:] *= scales[(a + full) // BLOCK]

        _run_spans(one, _spans(n, BLOCK))
        if flags & FLAG_HAS_NAN:
            self._apply_nan(codes, out)
        return out

    def _apply_nan(self, codes, out) -> None:
        """Restore NaN for sentinel codes (int8 only; fp8 decodes NaN
        natively)."""


class Int8Codec(_BlockCodec):
    """code = clip(rint(x / scale), -127, 127), scale = finite max|block|
    / 127.  NaN rides the reserved -128 code; +/-Inf saturates to
    +/-127."""

    name = "int8"
    wire_id = 1
    qmax = 127.0
    range_decode = True
    native_kind = 0

    def _quantize_into(self, y, out_u8, maybe_nonfinite):
        np.rint(y, out=y)
        np.clip(y, -127, 127, out=y)  # Inf saturates; NaN passes
        has_nan = False
        if maybe_nonfinite and not np.isfinite(y).all():
            nan = np.isnan(y)
            has_nan = bool(nan.any())
            y[nan] = -128.0
        out_u8.view(np.int8)[:] = y
        return has_nan

    def _reconstruct_into(self, codes_u8, out_f32):
        out_f32[:] = codes_u8.view(np.int8)

    def _apply_nan(self, codes, out) -> None:
        out[codes.view(np.int8) == -128] = np.nan


def _fp8_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(encode table over the 65,536 float16 patterns, decode table over
    the 256 codes) of float8 e4m3fn, byte for byte the JAX package's
    ``ml_dtypes`` tables.  torch's cast differs in two places, patched
    here: it saturates magnitudes above 464 (the midpoint past 448) and
    Inf to +/-448 where ``ml_dtypes`` gives NaN (``0x7f | sign``), and it
    decodes the NaN codes to ``0x7ff00000 | sign`` where ``ml_dtypes``
    gives the quiet NaN ``0x7fc00000 | sign``.  No clipped payload
    reaches the encode patch (codes are taken after a clip to +/-448)."""
    h = np.arange(65536, dtype=np.uint16).view(np.float16).astype(np.float32)
    enc = torch.from_numpy(h).to(torch.float8_e4m3fn).view(
        torch.uint8).numpy().copy()
    with np.errstate(invalid="ignore"):
        over = np.abs(h) > 464.0
    enc[over] = 0x7F | (np.signbit(h[over]).astype(np.uint8) << 7)
    dec = torch.from_numpy(np.arange(256, dtype=np.uint8)).view(
        torch.float8_e4m3fn).to(torch.float32).numpy().copy()
    bits = dec.view(np.uint32)
    bits[0x7F] = 0x7FC00000
    bits[0xFF] = 0xFFC00000
    return np.ascontiguousarray(enc), np.ascontiguousarray(dec)


class Fp8E4M3Codec(_BlockCodec):
    """x / scale clipped into [-448, 448], then cast to float8 e4m3fn
    through a float16 intermediate and a 64K-entry table (RNE twice, as
    in JAX).  NaN propagates natively (0x7f); +/-Inf saturates to +/-448
    * scale."""

    name = "fp8_e4m3"
    wire_id = 2
    qmax = 448.0
    range_decode = True
    native_kind = 1
    _tables: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @classmethod
    def _luts(cls):
        # One assignment of both tables: shard threads decode at once,
        # and none may see the encode table set and the decode one not.
        if cls._tables is None:
            cls._tables = _fp8_tables()
        return cls._tables

    def _quantize_into(self, y, out_u8, maybe_nonfinite):
        enc, _ = self._luts()
        np.clip(y, -self.qmax, self.qmax, out=y)  # Inf saturates
        _, _, h_b = _scratch(y.size)
        y16 = h_b[: y.size]
        with np.errstate(invalid="ignore"):  # NaN passes through
            y16[:] = y  # f32 -> f16, round to nearest even
        np.take(enc, y16.view(np.uint16), out=out_u8)
        return False  # NaN has a native e4m3fn code

    def _reconstruct_into(self, codes_u8, out_f32):
        _, dec = self._luts()
        np.take(dec, codes_u8, out=out_f32)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns, round to nearest even, NaN as
    the quiet ``0x7FC0 | sign`` (``ml_dtypes``' cast, which torch's does
    not match: it writes every NaN as 0xffff).  The add wraps only for
    NaN patterns, and those are rewritten from the input's sign."""
    u = x.view(np.uint32)
    out = ((u + (((u >> 16) & 1) + 0x7FFF)) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        out[nan] = 0x7FC0 | ((u[nan] >> 16) & 0x8000).astype(np.uint16)
    return out


class Bf16Codec(Codec):
    """Round-to-nearest-even bfloat16 (2 bytes per value, no scales).
    NaN and +/-Inf propagate exactly."""

    name = "bf16"
    wire_id = 3
    block = 0
    code_bytes_per_elem = 2

    def encode(self, vals, lens=None, resid=None):
        v = self._check_input(vals, lens)
        n = v.size
        codes = _take_buf(2 * n)[: 2 * n]
        c16 = codes.view(np.uint16)

        def one(a, b):
            if resid is not None:
                eff_b, _, _ = _scratch(b - a)
                eff = eff_b[: b - a]
                np.add(v[a:b], resid[a:b], out=eff)
            else:
                eff = v[a:b]
            c16[a:b] = _bf16_bits(eff)
            if resid is not None:
                dec = (c16[a:b].astype(np.uint32) << 16).view(np.float32)
                with np.errstate(invalid="ignore"):  # Inf - Inf
                    np.subtract(eff, dec, out=dec)
                dec[~np.isfinite(dec)] = 0.0
                resid[a:b] = dec

        _run_spans(one, _spans(n, 1024))
        return codes, np.empty(0, np.float32), 0

    def decode(self, codes, scales, n, lens=None, flags=0):
        codes = np.ascontiguousarray(codes).reshape(-1)[: 2 * n]
        log.check(codes.size == 2 * n,
                  f"codec bf16: short payload ({codes.size} bytes for {n} "
                  f"values)")
        out = _take_buf(4 * n)[: 4 * n].view(np.float32)
        c16u = codes.view(np.uint16)

        def one(a, b):
            # bf16 is the top half of f32: widen the bits in place.
            u = out[a:b].view(np.uint32)
            u[:] = c16u[a:b]
            u <<= 16

        _run_spans(one, _spans(n, 1024))
        return out


_REGISTRY: Dict[str, Codec] = {}
_BY_WIRE_ID: Dict[int, Codec] = {}

for _c in (Int8Codec(), Bf16Codec(), Fp8E4M3Codec()):
    _REGISTRY[_c.name] = _c
    _BY_WIRE_ID[_c.wire_id] = _c


def names() -> List[str]:
    return sorted(_REGISTRY)


def get_codec(name: str) -> Codec:
    c = _REGISTRY.get(name)
    log.check(c is not None,
              f"unknown codec {name!r} (available: {', '.join(names())})")
    return c


def by_wire_id(wire_id: int) -> Codec:
    c = _BY_WIRE_ID.get(wire_id)
    log.check(c is not None, f"unknown codec wire id {wire_id}")
    return c


def check_block(info) -> None:
    """Refuse a wire CodecInfo whose scale-block length this build cannot
    decode (scales are indexed by the local ``BLOCK``)."""
    log.check(info.block in (0, BLOCK),
              f"wire codec block {info.block} != local {BLOCK}; peers must "
              f"agree on the scale-block length")


# -- range decode (the apply pool's shard threads) ---------------------------------

def decode_key_ranges(codes, scales, info, n_keys: int,
                      positions=None) -> List[np.ndarray]:
    """Decode only the given keys' segments of a fixed-``k`` codec
    payload (``info``: the wire CodecInfo): one float32 segment per key,
    bit-identical to the same slices of the full decode.  Each shard of
    the apply pool decodes its own keys."""
    codec = by_wire_id(info.codec)
    check_block(info)
    n = info.raw_len // 4
    k = n // max(n_keys, 1)
    log.check(n_keys > 0 and n % n_keys == 0,
              "decode_key_ranges needs a fixed-k payload")
    log.check(codec.range_decode, f"codec {codec.name!r} has no range decode")
    if positions is None:
        pos = np.arange(n_keys, dtype=np.int64)
    else:
        pos = np.asarray(positions, dtype=np.int64)
    m = int(pos.size) * k
    out = _take_buf(4 * m)[: 4 * m].view(np.float32)
    codes = np.ascontiguousarray(codes).reshape(-1)
    scales = np.ascontiguousarray(scales, np.float32).reshape(-1)
    lib = _native_codec()
    if lib is not None and m:
        starts = (pos * k).astype(np.uint64)
        ends = starts + np.uint64(k)
        _native_rc(lib.psl_codec_decode_ranges(
            codec.native_kind, codes.ctypes.data, scales.ctypes.data,
            starts.ctypes.data, ends.ctypes.data, int(pos.size), BLOCK,
            info.flags, out.ctypes.data), "range decode")
        return [out[i * k: (i + 1) * k] for i in range(int(pos.size))]
    off = 0
    for p in pos:
        s = int(p) * k
        seg = out[off: off + k]
        codec._reconstruct_into(codes[s: s + k], seg)
        seg *= scales[np.arange(s, s + k) // BLOCK]
        if info.flags & FLAG_HAS_NAN:
            codec._apply_nan(codes[s: s + k], seg)
        off += k
    return [out[i * k: (i + 1) * k] for i in range(int(pos.size))]


# -- error feedback -----------------------------------------------------------------

class ErrorFeedback:
    """Bounded per-destination residual accumulators.

    One slot per (destination, key slice) holds the float32 quantization
    error of the last encode toward it; the next encode of the slice
    folds it back in (``Codec.encode(..., resid=slot)``).  At most
    ``max_slots`` (``PS_CODEC_EF_SLOTS``, default 64); the least recently
    used slot is evicted with a warning (one round's error is lost)."""

    def __init__(self, max_slots: int = 64, metrics=None):
        self._mu = threading.Lock()
        self._slots: Dict[tuple, np.ndarray] = {}
        self._locks: Dict[tuple, threading.Lock] = {}
        self._lru: List[tuple] = []
        self.max_slots = max(1, max_slots)
        self.evictions = 0
        if metrics is not None:
            metrics.gauge("ef.residual_norm", fn=self.residual_norm)

    def __len__(self) -> int:
        with self._mu:
            return len(self._slots)

    def slot(self, key: tuple, n: int) -> Tuple[np.ndarray, threading.Lock]:
        """The residual (zero when new) and its lock; a size change under
        the same key resets the slot."""
        with self._mu:
            r = self._slots.get(key)
            if r is None or r.size != n:
                if r is None and len(self._slots) >= self.max_slots:
                    victim = self._lru.pop(0)
                    self._slots.pop(victim, None)
                    self._locks.pop(victim, None)
                    self.evictions += 1
                    log.warning(f"error-feedback slot table full "
                                f"({self.max_slots}): evicted residual for "
                                f"{victim}; one round's quantization error "
                                f"is lost (raise PS_CODEC_EF_SLOTS)")
                r = np.zeros(n, np.float32)
                self._slots[key] = r
                self._locks.setdefault(key, threading.Lock())
            if key in self._lru:
                self._lru.remove(key)
            self._lru.append(key)
            return r, self._locks[key]

    def residual_norm(self) -> float:
        """L2 norm over every live residual."""
        with self._mu:
            slots = list(self._slots.values())
        if not slots:
            return 0.0
        return float(np.sqrt(sum(float(np.dot(r, r)) for r in slots)))


def ef_enabled(env=None) -> bool:
    """``PS_CODEC_EF`` (default on), from a node Environment when given,
    else the process environment."""
    if env is not None:
        return env.find_int("PS_CODEC_EF", 1) != 0
    return int(os.environ.get("PS_CODEC_EF", "1") or "1") != 0


def ef_slots(env=None) -> int:
    if env is not None:
        return env.find_int("PS_CODEC_EF_SLOTS", 64)
    return int(os.environ.get("PS_CODEC_EF_SLOTS", "64") or "64")
