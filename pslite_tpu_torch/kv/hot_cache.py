"""Worker-side hot-key pull cache (``PS_HOT_CACHE=1``).

Copy of ``pslite_tpu/kv/hot_cache.py``.  ``KVWorker.pull`` answers a
repeat pull of hot keys locally, with staleness bounded by a push-driven
version stamp piggybacked on every server response:

- The server keeps a per-node push version, bumped after each push has
  fully applied (as its response leaves), and stamps every response
  with it; a pull response's stamp is read at request intake, so every
  value in the response has observed it.
- The worker records the newest stamp seen per server (``observe``).
  An entry is served only while its fill stamp is still the newest
  known for its server: any push the worker hears about (its own above
  all) invalidates older fills, so a worker never reads its own writes
  stale, and a fill whose response predates a known push is skipped.
- Other workers' writes not yet heard about are bounded by
  ``PS_HOT_CACHE_TTL_S``.

A byte-bounded LRU (``PS_HOT_CACHE_MB``); ``seed`` restricts admission
to a hot set (``KVWorker.seed_hot_cache`` fills it from the servers'
``kv.hot_keys`` top-k).  Batched frames carry the stamp per sub-op in
both directions, so the contract holds through aggregation.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Set

import numpy as np


class HotKeyCache:
    """Bounded LRU of per-key pull values with stamp + TTL validity."""

    def __init__(self, max_bytes: int, ttl_s: float = 1.0,
                 max_val_bytes: int = 1 << 20, metrics=None):
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self.max_val_bytes = int(max_val_bytes)
        self._mu = threading.Lock()
        # key -> (vals copy, server id, fill stamp, fill monotonic time)
        self._entries: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        # Newest push-version stamp seen per server node id.
        self._latest: Dict[int, int] = {}
        # Admission hot set (None = admit everything).
        self._hot: Optional[Set[int]] = None
        if metrics is not None:
            self._c_hits = metrics.counter("kv.hot_cache.hits")
            self._c_misses = metrics.counter("kv.hot_cache.misses")
            self._c_invalidations = metrics.counter(
                "kv.hot_cache.invalidations")
            metrics.gauge("kv.hot_cache.bytes", fn=lambda: self._bytes)
            metrics.gauge("kv.hot_cache.entries",
                          fn=lambda: len(self._entries))
        else:  # stub harnesses
            class _N:  # noqa: D401 - trivial no-op counter
                def inc(self, n=1):
                    pass
            self._c_hits = self._c_misses = self._c_invalidations = _N()

    # -- stamps ---------------------------------------------------------------

    def observe(self, server: int, stamp: int) -> None:
        """Record a response stamp.  A newer stamp than previously seen
        from this server invalidates (lazily) every older fill — the
        push-driven invalidation path."""
        if stamp <= 0:
            return
        with self._mu:
            cur = self._latest.get(server, 0)
            if stamp > cur:
                self._latest[server] = stamp
                if cur:
                    self._c_invalidations.inc()

    def invalidate_range(self, begin: int, end: int) -> int:
        """Drop every cached entry whose key lies in ``[begin, end)``
        (docs/elasticity.md): when a key range migrates to a new owner,
        a cached fill's stamp was minted by the OLD owner — the new
        owner's independent version counter can never invalidate it, so
        a migrated key must not be served from the old stamp at all.
        Returns the number of entries dropped."""
        with self._mu:
            doomed = [k for k in self._entries if begin <= k < end]
            for k in doomed:
                seg = self._entries.pop(k)[0]
                self._bytes -= seg.nbytes
            if doomed:
                self._c_invalidations.inc(len(doomed))
            return len(doomed)

    # -- seeding --------------------------------------------------------------

    def seed(self, keys) -> None:
        """Restrict admission to (the union of) seeded hot keys —
        ``KVWorker.seed_hot_cache`` feeds it the servers' ``kv.hot_keys``
        top-k.  Never seeded, everything is admissible."""
        with self._mu:
            if self._hot is None:
                self._hot = set()
            self._hot.update(int(k) for k in np.asarray(keys).reshape(-1))

    # -- fill / serve ---------------------------------------------------------

    def fill(self, server: int, stamp: int, keys: np.ndarray,
             vals: np.ndarray) -> None:
        """Admit one pull-response slice (fixed-k payloads only; the
        caller checked divisibility).  Values are COPIED — response
        buffers live in pooled receive arenas that recycle."""
        n = len(keys)
        if n == 0 or stamp <= 0:
            return
        k = len(vals) // n
        if k * n != len(vals):
            return
        seg_bytes = k * vals.itemsize
        if seg_bytes > self.max_val_bytes:
            return
        now = time.monotonic()
        with self._mu:
            if stamp < self._latest.get(server, 0):
                # The response predates a push we already know about
                # (the invalidation race): filling it would resurrect a
                # stale value behind a fresh-looking lookup path — the
                # entry would be born invalid anyway, so skip the copy.
                return
            hot = self._hot
            for i, key in enumerate(keys):
                key = int(key)
                if hot is not None and key not in hot:
                    continue
                old = self._entries.pop(key, None)
                if old is not None:
                    self._bytes -= old[0].nbytes
                seg = np.array(vals[i * k:(i + 1) * k])  # owned copy
                self._entries[key] = (seg, server, stamp, now)
                self._bytes += seg.nbytes
            while self._bytes > self.max_bytes and self._entries:
                _, (seg, *_rest) = self._entries.popitem(last=False)
                self._bytes -= seg.nbytes

    def serve(self, keys: np.ndarray, out: np.ndarray) -> bool:
        """All-or-nothing local serve: when EVERY requested key has a
        live (stamp-fresh, TTL-fresh) entry, copy the values into
        ``out`` in key order and return True.  Partial hits return
        False untouched — the request then takes the normal round trip
        (whose response re-fills the cache)."""
        n = len(keys)
        if n == 0:
            return False
        now = time.monotonic()
        with self._mu:
            segs = []
            total = 0
            for key in keys:
                e = self._entries.get(int(key))
                if e is None:
                    self._c_misses.inc()
                    return False
                seg, server, stamp, t_fill = e
                if (stamp < self._latest.get(server, 0)
                        or (self.ttl_s > 0 and now - t_fill > self.ttl_s)):
                    # Invalid (superseded by a push, or aged out): drop
                    # it now so the table doesn't hold dead weight.
                    self._entries.pop(int(key), None)
                    self._bytes -= seg.nbytes
                    self._c_misses.inc()
                    return False
                segs.append(seg)
                total += seg.size
            flat = out.reshape(-1)
            if total != flat.size:
                self._c_misses.inc()
                return False  # caller's buffer shape disagrees: miss
            off = 0
            for key, seg in zip(keys, segs):
                flat[off:off + seg.size] = seg
                off += seg.size
                self._entries.move_to_end(int(key))  # LRU touch
            self._c_hits.inc()
            return True

    def serve_mask(self, keys: np.ndarray,
                   out: np.ndarray) -> Optional[np.ndarray]:
        """Partial serve (``KVWorker.multi_get`` fast path): copy every
        LIVE (stamp-fresh, TTL-fresh) entry's values into its key's row
        of ``out`` and return the boolean hit mask — the caller fetches
        only the misses.  Returns ``None`` (nothing touched) when the
        buffer shape cannot be row-partitioned (``out.size`` not
        divisible by ``len(keys)``); a live entry whose size disagrees
        with the row size counts a miss.  Validity rules are exactly
        :meth:`serve`'s
        — a superseded or aged entry counts a miss and is dropped — so
        read-your-writes semantics are identical whether a key is
        served through the all-or-nothing or the partial path.  Hits
        and misses are counted PER KEY (``serve`` counts per call)."""
        n = len(keys)
        if n == 0:
            return None
        flat = out.reshape(-1)
        if flat.size % n:
            return None
        k = flat.size // n
        mask = np.zeros(n, dtype=bool)
        now = time.monotonic()
        with self._mu:
            for i, key in enumerate(keys):
                key = int(key)
                e = self._entries.get(key)
                if e is None:
                    self._c_misses.inc()
                    continue
                seg, server, stamp, t_fill = e
                if (stamp < self._latest.get(server, 0)
                        or (self.ttl_s > 0
                            and now - t_fill > self.ttl_s)):
                    self._entries.pop(key, None)
                    self._bytes -= seg.nbytes
                    self._c_misses.inc()
                    continue
                if seg.size != k:
                    # Cached under a different per-key length (another
                    # pull shape): not servable into this row — a miss,
                    # but still a valid entry for its own shape.
                    self._c_misses.inc()
                    continue
                flat[i * k:(i + 1) * k] = seg
                self._entries.move_to_end(key)  # LRU touch
                mask[i] = True
                self._c_hits.inc()
        return mask

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._bytes = 0
