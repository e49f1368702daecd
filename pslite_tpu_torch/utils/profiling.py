"""Per-message event tracing (the port's copy of
``pslite_tpu/utils/profiling.py``; ``device_trace`` wraps
``torch.profiler`` in place of ``jax.profiler``).

Equivalent of the reference's ``USE_PROFILING`` van tracing
(``src/van.cc:29-77, 440-457``): when ``ENABLE_PROFILING`` is set, every
push/pull send/recv appends ``key,event,timestamp_us`` to a role-tagged file
(``PROFILE_PATH`` or ``pslite_profile_van_<role>_<ts>``).  For device-side
timelines use :class:`device_trace` (``torch.profiler``); this file-based
log covers the control plane the same way the reference covers its NICs,
and the engines' ``record_engine`` events cover the kernel path.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class MonotonicAnchor:
    """One wall-clock anchor plus monotonic offsets: timestamps that
    can never go backwards within a stream (NTP steps used to corrupt
    durations) yet merge across nodes on a shared wall timeline.  THE
    single timebase of the event log (Profiler) and the distributed
    tracer (telemetry/tracing.py) — two private copies of this formula
    would skew cross-file merge alignment if they ever drifted."""

    __slots__ = ("wall_ns", "mono_ns")

    def __init__(self):
        self.wall_ns = time.time_ns()
        self.mono_ns = time.monotonic_ns()

    def now_ns(self) -> int:
        return self.wall_ns + (time.monotonic_ns() - self.mono_ns)


class Profiler:
    # Events between explicit flushes: small enough that a crash loses
    # at most a syscall's worth of tail, large enough to stay off the
    # per-event hot path.
    _FLUSH_EVERY = 256

    def __init__(self, env, role: str):
        self._enabled = bool(env.find_int("ENABLE_PROFILING", 0))
        self._fh = None
        self._mu = threading.Lock()
        self._since_flush = 0
        self._anchor = MonotonicAnchor()
        if self._enabled:
            path = env.find("PROFILE_PATH")
            if not path:
                path = f"pslite_profile_van_{role}_{int(time.time())}"
            self._fh = open(path, "a")

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def closed(self) -> bool:
        """True when an enabled profiler's log was closed (Van.stop);
        a restarted van re-creates the profiler instead of silently
        dropping every event of its second life."""
        return self._enabled and self._fh is None

    def _ts_us(self) -> int:
        return self._anchor.now_ns() // 1000

    def _write(self, line: str) -> None:
        with self._mu:
            if self._fh is None:
                return
            self._fh.write(line)
            self._since_flush += 1
            if self._since_flush >= self._FLUSH_EVERY:
                self._fh.flush()
                self._since_flush = 0

    def record(self, key: int, event: str, push: bool) -> None:
        if not self._enabled or self._fh is None:
            return
        kind = "push" if push else "pull"
        self._write(f"{key},{event}_{kind},{self._ts_us()}\n")

    def record_engine(self, bucket: str, op: str, nbytes: int,
                      dur_us: int) -> None:
        """Collective data-plane event: ``bucket,<op>_engine,ts,bytes,µs``
        — the engine-path extension of the reference's (key, event, µs)
        log, so ENABLE_PROFILING covers the flagship transport too."""
        if not self._enabled or self._fh is None:
            return
        self._write(
            f"{bucket},{op}_engine,{self._ts_us()},{nbytes},{dur_us}\n"
        )

    def close(self) -> None:
        if self._fh is not None:
            with self._mu:
                if self._fh is not None:
                    self._fh.flush()
                    self._fh.close()
                    self._fh = None


def clocked(loop, measure=None):
    """Seconds taken by ``loop()`` — host wall clock by default, or
    whatever clock ``measure(loop) -> seconds | None`` implements (e.g.
    XPlane device-busy seconds).  The ONE definition of the clock-swap
    scaffold shared by the model replays and the stress patterns; None
    means the requested basis is unavailable and must propagate (never
    substitute a fake number)."""
    if measure is not None:
        return measure(loop)
    t0 = time.perf_counter()
    loop()
    return time.perf_counter() - t0


class device_trace:
    """Device-side timeline capture (``torch.profiler`` with CUDA
    activity): wrap the hot region and open the Chrome trace it writes
    into ``log_dir`` (``trace_<pid>_<n>.json``) in Perfetto or
    chrome://tracing::

        with device_trace("/tmp/ps_trace") as t:
            engine.push_pull("grads", g)
            engine.block()
        t.path  # the written trace

    On a host without CUDA only CPU activity is recorded.  ``events``
    holds the profiler's ``key_averages()`` after exit."""

    _seq = 0
    _seq_mu = threading.Lock()

    def __init__(self, log_dir: str):
        self._log_dir = log_dir
        self._prof = None
        self.path: Optional[str] = None
        self.events = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import os

        out = self._prof.__exit__(*exc)
        os.makedirs(self._log_dir, exist_ok=True)
        with device_trace._seq_mu:
            device_trace._seq += 1
            n = device_trace._seq
        self.path = os.path.join(self._log_dir,
                                 f"trace_{os.getpid()}_{n}.json")
        self._prof.export_chrome_trace(self.path)
        self.events = self._prof.key_averages()
        return out
