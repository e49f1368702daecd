"""Beyond-RAM tiered KV store.

Copy of ``pslite_tpu/kv/tiered.py``.  ``TieredStore`` replaces the plain
dict behind a handle's ``store`` (``KVServer.set_request_handle``
installs it when ``PS_STORE_RAM_MB`` is set): hot keys stay as ordinary
RAM ndarrays the apply path mutates in place, cold keys live as raw
value bytes in mmap'd append-only segment files (``PS_STORE_DIR``, each
``PS_STORE_SEGMENT_MB`` at most) with an in-RAM
``key -> (segment, offset, nbytes, dtype)`` index.

- **Promotion** happens on access: a ``get`` of a cold key reads its
  bytes into a fresh RAM ndarray and re-homes the key hot (the handle's
  ``cur += seg`` mutates the returned array in place).
- **Demotion** runs when the RAM tier exceeds its byte budget: the
  least-recently-accessed non-hot keys of the accessed key's eviction
  class append their bytes to the active segment and leave RAM.  The hot
  set (the server's ``kv.hot_keys`` top-k via ``hot_fn``) is evicted
  only when nothing colder remains.

Eviction classes use the apply pool's shard modulus (``key % shards``),
and a ``get`` only evicts keys of its own class, so a demotion always
runs on the one thread that could be applying to those keys: race-free
without a per-key lock, and deterministic for a given access sequence,
so a tiered store ends bit-exact with an all-RAM one.  Writers outside
the shard discipline (restores, imports) only insert: ``__setitem__``
never evicts unless ``set_evict_on_insert(True)`` (the boot-restore
window).

The tier is not durable: the index lives in RAM and segments go on
``close()``; snapshots (``kv/snapshot.py``) are the durability story.

Counters go to the node registry under the JAX package's names
(``kv.tier_gets``, ``kv.cold_hits``, ``kv.cold_misses``,
``kv.promotions``, ``kv.evictions``) and read through ``stats``
without the ``kv.`` prefix; a cold-read burst records a
``tier_pressure`` flight event.
"""

from __future__ import annotations

import itertools
import mmap
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..telemetry.flight import NULL_FLIGHT
from ..telemetry.metrics import node_registry
from ..telemetry.views import CounterView

# Cold reads within one pressure window that trip a tier_pressure
# flight event (coalesced: at most one event per window).
_PRESSURE_BURST = 64
_PRESSURE_WINDOW_S = 1.0
# Accesses between hot-set refreshes from hot_fn (the kv.hot_keys
# Space-Saving top-k) — refreshing per get would tax the apply path.
_HOT_REFRESH_EVERY = 512
# Per-process store sequence: two stores in ONE process sharing a
# PS_STORE_DIR (in-process test clusters) must not name the same
# segment file — interleaved O_APPEND writes with independent size
# bookkeeping would corrupt both cold indexes.
_STORE_SEQ = itertools.count()


class TieredStore:
    """Dict-shaped two-tier store: RAM ndarrays + mmap'd segments."""

    def __init__(self, ram_bytes: int, directory: Optional[str] = None,
                 shards: int = 1, hot_fn=None, metrics=None,
                 flight=None, segment_mb: float = 64.0):
        self.ram_budget = max(1, int(ram_bytes))
        self.shards = max(1, int(shards))
        self._hot_fn = hot_fn
        self._owns_dir = directory is None
        self.directory = directory or tempfile.mkdtemp(
            prefix=f"pslite_tiered_{os.getpid()}_")
        os.makedirs(self.directory, exist_ok=True)
        self._seg_cap = max(1 << 20, int(segment_mb * (1 << 20)))
        self._store_uid = next(_STORE_SEQ)
        # One lock guards the index/tier maps and segment appends; the
        # VALUE arrays are deliberately mutated outside it (the
        # apply-shard affinity contract in the module docstring).
        self._mu = threading.Lock()
        self._ram: Dict[int, np.ndarray] = {}
        self._ram_bytes = 0
        # key -> (seg_id, offset, nbytes, dtype str)
        self._cold: Dict[int, Tuple[int, int, int, str]] = {}
        self._cold_bytes = 0  # LIVE cold bytes (excludes dead appends)
        self._segs: List[dict] = []  # {"path", "fh", "size", "mm"}
        self._clock = 0
        self._last_access: Dict[int, int] = {}
        self._hot: set = set()
        self._gets_since_refresh = 0
        self._closed = False
        # Boot-restore mode (set_evict_on_insert): __setitem__ also
        # enforces the budget — safe ONLY while nothing else touches
        # the store (requests parked, apply pool idle), which is
        # exactly the snapshot/replica restore window.  Without it a
        # beyond-RAM restore would materialize the whole table in RAM
        # before the first get() ever runs.
        self._evict_on_insert = False
        reg = node_registry(metrics)
        self._c_gets = reg.counter("kv.tier_gets")
        self._c_cold_hits = reg.counter("kv.cold_hits")
        self._c_cold_misses = reg.counter("kv.cold_misses")
        self._c_promotions = reg.counter("kv.promotions")
        self._c_evictions = reg.counter("kv.evictions")
        reg.gauge("kv.tier_ram_bytes", fn=lambda: self._ram_bytes)
        reg.gauge("kv.tier_cold_bytes", fn=lambda: self._cold_bytes)
        # The counters without their ``kv.`` prefix (``stats["evictions"]``).
        self.stats = CounterView(reg, prefix="kv.")
        self._flight = flight or NULL_FLIGHT
        # [window start monotonic, cold reads this window, reported?]
        self._pressure = [time.monotonic(), 0, False]

    # -- segments ------------------------------------------------------------

    def _active_seg(self) -> dict:
        """The append target (held under ``_mu``); rolls to a fresh
        file past the per-segment cap so one mmap never grows without
        bound."""
        if self._segs and self._segs[-1]["size"] < self._seg_cap:
            return self._segs[-1]
        path = os.path.join(self.directory,
                            f"seg_{os.getpid()}_{self._store_uid}_"
                            f"{len(self._segs):06d}.bin")
        fh = open(path, "a+b")
        # A reused PS_STORE_DIR can hold a dead process's bytes in a
        # same-named file: appends land after them, so offsets must
        # account for the existing length.
        seg = {"path": path, "fh": fh,
               "size": os.path.getsize(path), "mm": None, "mm_size": 0}
        self._segs.append(seg)
        return seg

    def _append(self, arr: np.ndarray) -> Tuple[int, int, int, str]:
        """Append one value's bytes to the active segment (under
        ``_mu``); returns the cold-index entry."""
        raw = np.ascontiguousarray(arr.reshape(-1))
        seg = self._active_seg()
        off = seg["size"]
        seg["fh"].write(raw.view(np.uint8).tobytes())
        seg["size"] = off + raw.nbytes
        return (len(self._segs) - 1, off, raw.nbytes, str(raw.dtype))

    def _read(self, ent: Tuple[int, int, int, str]) -> np.ndarray:
        """Read one cold value back as a fresh owned ndarray (under
        ``_mu``): re-mmap when the file grew past the current map."""
        seg_id, off, nbytes, dtype = ent
        seg = self._segs[seg_id]
        if seg["mm"] is None or seg["mm_size"] < off + nbytes:
            seg["fh"].flush()
            if seg["mm"] is not None:
                seg["mm"].close()
            seg["mm"] = mmap.mmap(seg["fh"].fileno(), seg["size"],
                                  access=mmap.ACCESS_READ)
            seg["mm_size"] = seg["size"]
        buf = seg["mm"][off:off + nbytes]
        return np.frombuffer(buf, dtype=np.dtype(dtype)).copy()

    # -- placement -----------------------------------------------------------

    def _refresh_hot(self) -> None:
        if self._hot_fn is None:
            return
        try:
            self._hot = {int(k) for k in self._hot_fn()}
        except Exception:  # noqa: BLE001 - heat is advisory only
            self._hot = set()

    def _note_cold_read(self) -> None:
        """Coalesced tier-pressure accounting (under ``_mu``)."""
        now = time.monotonic()
        win = self._pressure
        if now - win[0] >= _PRESSURE_WINDOW_S:
            win[0], win[1], win[2] = now, 0, False
        win[1] += 1
        if win[1] >= _PRESSURE_BURST and not win[2]:
            win[2] = True
            self._flight.record(
                "tier_pressure", severity="warn",
                cold_reads=win[1], window_s=_PRESSURE_WINDOW_S,
                ram_bytes=self._ram_bytes, cold_bytes=self._cold_bytes,
            )

    def _maybe_evict(self, accessed_key: int) -> None:
        """Demote same-class LRU keys until the RAM tier fits the
        budget (under ``_mu``).  Only the accessed key's class is
        eligible — see the module docstring for why that is the
        race-freedom invariant — and the accessed key itself never
        demotes (its caller is about to mutate the returned array).
        Hysteresis: once over budget, evict down to ~90% so the O(ram
        keys) candidate scan amortizes over many accesses instead of
        re-running per get at the boundary."""
        if self._ram_bytes <= self.ram_budget:
            return
        target = int(self.ram_budget * 0.9)
        cls = accessed_key % self.shards
        candidates = [
            k for k in self._ram
            if k % self.shards == cls and k != accessed_key
        ]
        if not candidates:
            return
        candidates.sort(key=lambda k: self._last_access.get(k, 0))
        # Cold-first pass, then (only if still over) the hot set too:
        # the byte budget outranks heat.
        for pass_hot in (False, True):
            for k in candidates:
                if self._ram_bytes <= target:
                    return
                if k not in self._ram:
                    continue  # evicted by the first pass
                if not pass_hot and k in self._hot:
                    continue
                arr = self._ram.pop(k)
                self._last_access.pop(k, None)
                self._ram_bytes -= arr.nbytes
                self._cold[k] = self._append(arr)
                self._cold_bytes += arr.nbytes
                self._c_evictions.inc()

    # -- mapping protocol ----------------------------------------------------

    def get(self, key: int, default=None):
        key = int(key)
        self._c_gets.inc()
        with self._mu:
            self._clock += 1
            self._gets_since_refresh += 1
            if self._gets_since_refresh >= _HOT_REFRESH_EVERY:
                self._gets_since_refresh = 0
                self._refresh_hot()
            arr = self._ram.get(key)
            if arr is not None:
                self._last_access[key] = self._clock
                # Budget enforcement rides EVERY get (cheap compare
                # when under budget): insert-only storms grow RAM via
                # __setitem__, which deliberately never evicts.
                self._maybe_evict(key)
                return arr
            ent = self._cold.get(key)
            if ent is None:
                self._c_cold_misses.inc()
                self._maybe_evict(key)  # first-push insert follows
                return default
            # Promotion: the caller may mutate the array in place, so
            # the RAM copy becomes the one truth and the segment bytes
            # become dead garbage.  Read BEFORE dropping the index
            # entry — a transient mmap/IO failure must leave the key
            # cold and retryable, not permanently lost.
            arr = self._read(ent)
            del self._cold[key]
            self._c_cold_hits.inc()
            self._c_promotions.inc()
            self._note_cold_read()
            self._cold_bytes -= ent[2]
            self._ram[key] = arr
            self._ram_bytes += arr.nbytes
            self._last_access[key] = self._clock
            self._maybe_evict(key)
            return arr

    def __getitem__(self, key: int) -> np.ndarray:
        arr = self.get(key)
        if arr is None:
            raise KeyError(key)
        return arr

    def __setitem__(self, key: int, value: np.ndarray) -> None:
        key = int(key)
        value = np.asarray(value)
        with self._mu:
            self._clock += 1
            old = self._ram.pop(key, None)
            if old is not None:
                self._ram_bytes -= old.nbytes
            ent = self._cold.pop(key, None)
            if ent is not None:
                self._cold_bytes -= ent[2]
            self._ram[key] = value
            self._ram_bytes += value.nbytes
            self._last_access[key] = self._clock
            # NO eviction here by default: __setitem__ runs on
            # restore/migration threads outside the shard discipline
            # (module docstring); the next get() on each class
            # enforces the budget.  The boot-restore window opts in
            # via set_evict_on_insert (nothing else runs then).
            if self._evict_on_insert:
                self._maybe_evict(key)

    def set_evict_on_insert(self, flag: bool) -> None:
        """Opt into budget enforcement on ``__setitem__`` for the
        boot-restore window (requests parked, apply pool idle — the
        shard-discipline argument for never evicting on insert does
        not apply because NOTHING is applying)."""
        with self._mu:
            self._evict_on_insert = bool(flag)

    def discard(self, key: int) -> bool:
        """Drop a key WITHOUT reading its value — O(1) for cold keys,
        unlike ``pop`` which deserializes the segment bytes.  What the
        migration drop path uses (dropping a mostly-cold range must
        not pay a full-range disk read).  Returns whether the key
        existed."""
        key = int(key)
        with self._mu:
            arr = self._ram.pop(key, None)
            if arr is not None:
                self._ram_bytes -= arr.nbytes
                self._last_access.pop(key, None)
                return True
            ent = self._cold.pop(key, None)
            if ent is None:
                return False
            self._cold_bytes -= ent[2]
            return True

    def pop(self, key: int, default=None):
        key = int(key)
        with self._mu:
            arr = self._ram.pop(key, None)
            if arr is not None:
                self._ram_bytes -= arr.nbytes
                self._last_access.pop(key, None)
                return arr
            ent = self._cold.get(key)
            if ent is None:
                return default
            # Read before dropping the index entry — same transient-
            # IO-failure invariant as get(): a failed read must leave
            # the key cold and retryable, never lost.
            arr = self._read(ent)
            del self._cold[key]
            self._cold_bytes -= ent[2]
            return arr

    def __delitem__(self, key: int) -> None:
        sentinel = object()
        if self.pop(key, sentinel) is sentinel:
            raise KeyError(key)

    def __contains__(self, key) -> bool:
        key = int(key)
        with self._mu:
            return key in self._ram or key in self._cold

    def __len__(self) -> int:
        with self._mu:
            return len(self._ram) + len(self._cold)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __iter__(self) -> Iterator[int]:
        with self._mu:
            return iter(list(self._ram) + list(self._cold))

    def keys(self):
        return list(iter(self))

    def items(self) -> List[Tuple[int, np.ndarray]]:
        """Materialized (key, value) snapshot across BOTH tiers — what
        the generic ``export_range`` / ``save_server_handle`` paths
        iterate.  Cold values are read WITHOUT promoting (an export
        must not thrash the RAM tier) and without touching the serving
        counters; RAM values are the live arrays, matching plain-dict
        semantics (export concatenation copies them)."""
        with self._mu:
            out = list(self._ram.items())
            cold = list(self._cold.items())
            for key, ent in cold:
                out.append((key, self._read(ent)))
        return out

    def values(self):
        return [v for _, v in self.items()]

    def items_in_range(self, begin: int, end: int
                       ) -> List[Tuple[int, np.ndarray]]:
        """Materialized (key, value) snapshot of only the keys in
        ``[begin, end)`` — the ``export_range`` fast path: a per-range
        export of a beyond-RAM store reads only THAT range's cold
        bytes, instead of :meth:`items` materializing the whole table
        once per owned range.  Same no-promote / no-counter semantics
        as :meth:`items`."""
        with self._mu:
            out = [(k, v) for k, v in self._ram.items()
                   if begin <= k < end]
            cold = [(k, e) for k, e in self._cold.items()
                    if begin <= k < end]
            for k, ent in cold:
                out.append((k, self._read(ent)))
        return out

    # -- introspection / lifecycle -------------------------------------------

    @property
    def ram_bytes(self) -> int:
        return self._ram_bytes

    @property
    def cold_bytes(self) -> int:
        return self._cold_bytes

    def tier_of(self, key: int) -> Optional[str]:
        """'ram' | 'cold' | None — test/debug introspection."""
        key = int(key)
        with self._mu:
            if key in self._ram:
                return "ram"
            if key in self._cold:
                return "cold"
            return None

    def close(self) -> None:
        """Release mmaps/handles and (when the store created its own
        directory) remove the segment files."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            segs, self._segs = self._segs, []
            self._cold.clear()
            self._cold_bytes = 0
        for seg in segs:
            try:
                if seg["mm"] is not None:
                    seg["mm"].close()
                seg["fh"].close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
            if not self._owns_dir:
                try:
                    os.unlink(seg["path"])
                except OSError:
                    pass
        if self._owns_dir:
            shutil.rmtree(self.directory, ignore_errors=True)

    def __repr__(self) -> str:
        return (f"TieredStore(ram={len(self._ram)} keys/"
                f"{self._ram_bytes >> 20} MiB of "
                f"{self.ram_budget >> 20} MiB, cold={len(self._cold)} "
                f"keys/{self._cold_bytes >> 20} MiB, "
                f"shards={self.shards})")
