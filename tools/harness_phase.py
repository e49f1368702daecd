"""``chip_smoke.py``'s ``harness`` phase: the port's harnesses on one card.

- **Stress** (``pslite_tpu_torch/stress.py``) at full width: the four
  patterns at ``--len 30720000 --repeat 5`` on ``DeviceGroup(8,
  device="cuda:0")``, once under ``PS_ICI_IMPL=pallas`` (dense launches
  K4 ``ring_push_pull``, scatter K4 ``ring_push``) and once under the
  default impl (dense D1 with its pull, scatter D1 without); datascatter
  launches S1 under both.
  Each pattern runs twice: by the host clock, then with a ``measure``
  that wraps the loop in ``utils/profiling.device_trace`` and reads the
  trace with ``utils/xplane.py`` (device-busy seconds, top ops), held
  against the profiler's own ``key_averages()`` device time within
  ``BUSY_BAR``.  The pattern's first K4/S1/D1 launch is held against its
  plain version on clones of its inputs (bit-exact, ``sum``); after
  each pattern the store or table equals the float64 numpy result of
  the same calls.  Then ``--threads 2`` for dense, gather and scatter on
  the pallas engine, the stores exact again.
- **The CLI** (``pslite_tpu_torch/benchmark.py``) under the port's
  launcher: 2 workers + 2 servers over tcp, ``--mode push_pull`` at
  1,024,000 B x 40 keys per server (BASELINE config 2's topology at
  test_benchmark's size); both workers print ``CHECK_OK``.  Then
  ``ENABLE_RECV_BUFFER=1`` over shm, 1 + 1, ``push_then_pull``, with both
  hit counters above 0.
- **The tools**: ``psmon --json`` and the ``pstrace`` demo exit 0.
- **The examples** (``examples/torch/``), each once at its defaults (8
  ranks on cuda:0), through ``--example`` below so their kernel launches
  fold into the kernels line; the training examples' loss must fall.

The stress legs run in a process of their own (``--stress``): on the
card's machine a short ``torch.profiler`` window late in a process's life
loses its device events, so the phase leaves the calling process's
profiler as unused as it found it.

Run alone from the root of a checkout on the card:
``python3 tools/harness_phase.py``.  ``python3 tools/harness_phase.py
--example FILE [ARGS]`` runs one example as ``__main__`` and prints its
kernel launches last (``HARNESS_LAUNCHES {json}``).
"""

import json
import os
import re
import runpy
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

DEV = "cuda:0"
RANKS = 8
STRESS_LEN = 30_720_000   # stress.py's default: 7,680,000 f32 per tensor
STRESS_REPEAT = 5
STRESS_THREADS = 2
BUSY_BAR = 0.02           # the reader against key_averages()
WINDOWS = 5               # profiler windows a measurement may take
CLI_LEN = 1_024_000       # test_benchmark's 1 MB value per key
CLI_KEYS = 40             # NUM_KEY_PER_SERVER
CLI_REPEAT = 6
DEADLINE = 180.0          # seconds for every process group
HELD = ("ring_push_pull", "ring_push", "scatter_add", "reduce_apply")
# The wrapper each pattern's first launch goes through, and the count it
# adds to, per engine impl ("ring" is PS_ICI_IMPL=pallas, "torch" the
# default).
PATTERN_KERNEL = {("dense", "ring"): "ring_push_pull",
                  ("scatter", "ring"): "ring_push",
                  ("datascatter", "ring"): "scatter_add",
                  ("datascatter", "torch"): "scatter_add",
                  ("dense", "torch"): "reduce_apply",
                  ("scatter", "torch"): "reduce_apply"}
PATTERN_COUNTER = {("dense", "ring"): "ring_push_pull[float32]",
                   ("scatter", "ring"): "ring_push[float32]",
                   ("datascatter", "ring"): "sparse_scatter_add",
                   ("datascatter", "torch"): "sparse_scatter_add",
                   ("dense", "torch"): "reduce_push_pull[float32]",
                   ("scatter", "torch"): "reduce_push[float32]"}
EXAMPLE_DIR = os.path.join("examples", "torch")


def _counters():
    from pslite_tpu_torch.ops import fused_update as fu
    from pslite_tpu_torch.ops import quantize as qz
    from pslite_tpu_torch.ops import reduce_update as ru
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.ops import sparse_rows as sr

    return (ring.launches, fu.launches, qz.launches, sr.launches,
            ru.launches)


def _launches() -> dict:
    return {k: v for c in _counters() for k, v in c.items() if v}


def example_main(argv) -> int:
    """Run one example file as ``__main__`` with ``argv[1:]``; print the
    kernel launches it made last, whatever its exit."""
    path = argv[0]
    sys.argv = [path] + list(argv[1:])
    code = 0
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as exc:
        code = exc.code if isinstance(exc.code, int) else (
            0 if exc.code is None else 1)
    finally:
        print("HARNESS_LAUNCHES " + json.dumps(_launches()), flush=True)
    return code


# -- stress -------------------------------------------------------------------

def traced_measure(torch, root: str, record: list, iters: int):
    """``measure(loop)`` for ``run_pattern``: the loop under
    ``device_trace`` in a directory of its own, read by
    ``utils/xplane.py`` (the mean busy seconds of the device planes, None
    when the trace holds no device event); appends the reading, the
    reader's summed op seconds, ``key_averages()``' device total (its
    kernel, copy and set events: an aten op's self device time repeats
    theirs), the windows taken and how many came back incomplete to
    ``record``.  The profiler now and then loses a window's device events,
    all of them or the first (seen on an H100): a window whose device
    events do not come in multiples of the loop's ``iters`` ops is traced
    again, up to ``WINDOWS`` times."""
    from torch.autograd import DeviceType

    from pslite_tpu_torch.utils import xplane
    from pslite_tpu_torch.utils.profiling import device_trace

    on_card = torch.device(DEV).type == "cuda"

    def measure(loop):
        lost = 0
        for runs in range(1, WINDOWS + 1):
            d = tempfile.mkdtemp(prefix="trace_", dir=root)
            with device_trace(d) as t:
                loop()
            busy = xplane.device_busy_seconds(d)
            device = [e for e in t.events
                      if e.device_type == DeviceType.CUDA]
            whole = bool(device) and all(e.count % iters == 0
                                         for e in device)
            if (busy and whole) or not on_card:
                break
            lost += 1
        else:
            raise AssertionError(f"{WINDOWS} profiler windows lost device "
                                 f"events")
        ka = sum(e.self_device_time_total for e in device) / 1e6
        ops = sorted(xplane.device_op_seconds(d).items(),
                     key=lambda kv: -kv[1])
        mean = sum(busy.values()) / len(busy) if busy else None
        record.append({"busy_s": mean, "ops_s": sum(v for _, v in ops),
                       "ka_s": ka, "ops": ops, "runs": runs, "lost": lost})
        return mean

    return measure


def _model(pattern: str, calls: int, idx=None, rows: int = 0):
    """float64 numpy result of ``calls`` ops of a pattern on fresh state:
    every rank pushes ones."""
    if pattern == "datascatter":
        table = np.zeros((rows, 128), np.float64)
        np.add.at(table, idx.reshape(-1), float(calls))
        return table
    n = STRESS_LEN // 4
    return np.zeros(n) if pattern == "gather" else np.full(
        n, float(RANKS * calls))


def _check_state(torch, eng, sp, pattern: str, calls: int,
                 label: str) -> float:
    """The pattern's store (or table) against float64 numpy: exact.
    Returns the max abs error (0.0)."""
    name = f"stress_{pattern}_{STRESS_LEN}"
    if pattern == "datascatter":
        t = sp.table(f"{name}_tbl")
        idx = np.random.default_rng(0).integers(
            0, t.num_rows, size=(RANKS, t.num_rows // RANKS))
        got = sp.store_global_device(f"{name}_tbl")
        want = _model(pattern, calls, idx, t.num_rows)
    else:
        got = eng.store_array(name)[: STRESS_LEN // 4]
        want = _model(pattern, calls)
    got = got.double().cpu().numpy()
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} of {got.size} values differ "
                             f"from float64 numpy after {calls} calls")
    return float(np.abs(got - want).max())


def stress_leg(torch, ps, ring, sr, cs, impl, smi: str, root: str):
    """The four patterns on one engine under ``impl``; returns
    ``(result rows, engine, sparse engine, calls per pattern)``."""
    from pslite_tpu_torch import stress

    label_impl = impl or "torch (default)"
    eng = ps.CollectiveEngine(ps.DeviceGroup(RANKS, device=DEV), impl=impl)
    sp = ps.SparseEngine(eng.group, eng.axis)
    results, calls = [], {}
    for pattern in stress.PATTERNS:
        label = f"harness stress {label_impl} {pattern}"
        before = _launches()
        with cs.hold_first_launches(torch, ring, sr, names=HELD) as held:
            host_gbps = stress.run_pattern(eng, sp, pattern, STRESS_LEN,
                                           STRESS_REPEAT)
        errs = cs.check_held(torch, ring, sr, held, label)
        kernel = PATTERN_KERNEL.get((pattern, eng.impl))
        if sorted(held) != ([kernel] if kernel else []):
            raise AssertionError(f"{label}: first launches held "
                                 f"{sorted(held)}, expected {kernel}")
        record = []
        busy_gbps = stress.run_pattern(
            eng, sp, pattern, STRESS_LEN, STRESS_REPEAT,
            measure=traced_measure(torch, root, record, STRESS_REPEAT))
        rec = record[0]
        n = 2 * (1 + STRESS_REPEAT) + STRESS_REPEAT * (rec["runs"] - 1)
        calls[pattern] = n
        made = {k: v - before.get(k, 0) for k, v in _launches().items()
                if v != before.get(k, 0)}
        want = {PATTERN_COUNTER[(pattern, eng.impl)]: n} if kernel else {}
        if made != want:
            raise AssertionError(f"{label}: launches {made}, expected "
                                 f"{want}")
        err = _check_state(torch, eng, sp, pattern, n, label)
        busy, ka = rec["busy_s"] or 0.0, rec["ka_s"]
        # The reader's op seconds sum durations as key_averages() does;
        # its busy seconds union them per stream (JAX's definition), so
        # they fall below the sum by the time two events of one stream
        # overlap: S1's short-run kernel starts beside its long runs
        # (programmatic dependent launch).
        overlap = rec["ops_s"] - busy
        on_card = torch.device(DEV).type == "cuda"
        if on_card and not (
                busy > 0 and abs(rec["ops_s"] - ka) <= BUSY_BAR * ka
                and (overlap > BUSY_BAR * ka
                     or abs(busy - ka) <= BUSY_BAR * ka)):
            raise AssertionError(
                f"{label}: reader busy {busy} s, op sum {rec['ops_s']} s "
                f"against key_averages {ka} s (bar {BUSY_BAR:.0%})")
        top = ", ".join(f"{k[:48]} {v * 1e3:.4f} ms" for k, v in
                        rec["ops"][:3])
        print(f"{label}: {host_gbps:.3f} Gbit/s host clock, "
              f"{busy_gbps:.3f} Gbit/s device-busy; over {STRESS_REPEAT} "
              f"ops reader busy {busy * 1e3:.4f} ms, op sum "
              f"{rec['ops_s'] * 1e3:.4f} ms, key_averages {ka * 1e3:.4f} ms "
              f"(busy {(busy - ka) / max(ka, 1e-12):+.3%}, op sum "
              f"{(rec['ops_s'] - ka) / max(ka, 1e-12):+.3%}; same-stream "
              f"overlap {overlap * 1e3:.4f} ms); {rec['runs']} profiler "
              f"windows ({rec['lost']} lost events); top ops "
              f"{top or 'none'}; first launch {errs or 'none'} held (0 "
              f"differing); store exact after {n} calls; launches "
              f"{made or 'none'} [{smi}]", flush=True)
        results.append({"config": label, "ops": n,
                        "max_abs_err_vs_f64": err,
                        "gbps_host_clock": host_gbps,
                        "gbps_device_busy": busy_gbps,
                        "busy_ms": busy * 1e3,
                        "op_sum_ms": rec["ops_s"] * 1e3,
                        "key_averages_ms": ka * 1e3,
                        "profiler_windows": rec["runs"]})
    return results, eng, sp, calls


def threads_leg(torch, eng, sp, calls: dict, smi: str):
    """``--threads 2`` for dense, gather and scatter on one engine, as
    ``stress.main`` drives them; the stores exact after."""
    from pslite_tpu_torch import stress

    results = []
    for pattern in ("dense", "gather", "scatter"):
        before = _launches()
        got = {}

        def drive(i, pattern=pattern):
            got[i] = stress.run_pattern(eng, sp, pattern, STRESS_LEN,
                                        STRESS_REPEAT)

        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(STRESS_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        calls[pattern] += STRESS_THREADS * (1 + STRESS_REPEAT)
        label = f"harness stress pallas {pattern} --threads {STRESS_THREADS}"
        err = _check_state(torch, eng, sp, pattern, calls[pattern], label)
        made = {k: v - before.get(k, 0) for k, v in _launches().items()
                if v != before.get(k, 0)}
        kernel = PATTERN_KERNEL.get((pattern, eng.impl))
        want = ({PATTERN_COUNTER[(pattern, eng.impl)]:
                 STRESS_THREADS * (1 + STRESS_REPEAT)} if kernel else {})
        if made != want:
            raise AssertionError(f"{label}: launches {made}, expected "
                                 f"{want}")
        print(f"{label}: " + ", ".join(f"{g:.3f}" for g in got.values())
              + f" Gbit/s per thread (host clock), {wall:.3f} s wall; store "
              f"exact after {calls[pattern]} calls; launches "
              f"{made or 'none'} [{smi}]", flush=True)
        results.append({"config": label, "ops": calls[pattern],
                        "max_abs_err_vs_f64": err,
                        "gbps_host_clock": min(got.values())})
    return results


# -- process groups: the CLI, the tools, the examples -------------------------

def _env(extra=None) -> dict:
    env = dict(os.environ)
    # A flushed print then leaves in one write, so the lines of processes
    # that share a pipe never run together.
    env.pop("PYTHONUNBUFFERED", None)
    env.update(extra or {})
    return env


def _launcher(workers: int, servers: int, van: str, child) -> list:
    return [sys.executable, "-m", "pslite_tpu_torch.tracker.local", "-n",
            str(workers), "-s", str(servers), "--van", van, "--",
            sys.executable] + list(child)


def _example(name: str, *args) -> list:
    return [os.path.join("tools", "harness_phase.py"), "--example",
            os.path.join(EXAMPLE_DIR, f"{name}.py"), *args]


def run_group(jobs: dict) -> dict:
    """Start every ``{label: (argv, env)}`` at once from the checkout's
    root; ``{label: (rc, stdout, stderr, seconds)}``.  A job past
    ``DEADLINE`` is killed and fails."""
    procs, t0 = {}, time.perf_counter()
    for label, (argv, env) in jobs.items():
        procs[label] = subprocess.Popen(
            argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
    out = {}
    for label, p in procs.items():
        left = max(1.0, DEADLINE - (time.perf_counter() - t0))
        try:
            so, se = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            so, se = p.communicate()
            raise AssertionError(f"{label}: past {DEADLINE} s; stdout "
                                 f"{so[-800:]!r} stderr {se[-800:]!r}")
        out[label] = (p.returncode, so, se, time.perf_counter() - t0)
    for label, (rc, so, se, _) in out.items():
        if rc != 0:
            raise AssertionError(f"{label}: exit {rc}; stdout {so[-1500:]!r} "
                                 f"stderr {se[-1500:]!r}")
    return out


def cli_legs(smi: str) -> list:
    """The benchmark CLI over the port's launcher, each leg alone."""
    tcp = run_group({"cli tcp 2+2 push_pull": (_launcher(
        2, 2, "tcp", ["-m", "pslite_tpu_torch.benchmark", "--len",
                      str(CLI_LEN), "--repeat", str(CLI_REPEAT), "--mode",
                      "push_pull"]),
        _env({"NUM_KEY_PER_SERVER": str(CLI_KEYS)}))})
    _, so, _, secs = tcp["cli tcp 2+2 push_pull"]
    rates = [float(x) for x in re.findall(r"push_pull: ([0-9.]+) Gbps", so)]
    lats = [float(x) for x in re.findall(r"avg latency ([0-9.]+) us/key", so)]
    if so.count("CHECK_OK") != 2 or len(rates) < 2:
        raise AssertionError(f"cli tcp: {so.count('CHECK_OK')} CHECK_OK, "
                             f"rates {rates}: {so[-1500:]!r}")
    print(f"harness cli tcp 2 workers + 2 servers, push_pull {CLI_KEYS} x "
          f"{CLI_LEN} B per server: CHECK_OK from both workers; Gbit/s per "
          f"worker {rates}, us/key {lats} ({secs:.1f} s with the launch) "
          f"[{smi}]", flush=True)
    shm = run_group({"cli shm 1+1 recv buffers": (_launcher(
        1, 1, "shm", ["-m", "pslite_tpu_torch.benchmark", "--len",
                      str(CLI_LEN), "--repeat", str(CLI_REPEAT), "--mode",
                      "push_then_pull"]),
        _env({"NUM_KEY_PER_SERVER": str(CLI_KEYS),
              "ENABLE_RECV_BUFFER": "1"}))})
    _, so2, _, secs2 = shm["cli shm 1+1 recv buffers"]
    hits = {m.group(1): int(m.group(2))
            for m in re.finditer(r"(\w*RECV_BUFFER_HITS) (\d+)", so2)}
    if ("CHECK_OK" not in so2 or hits.get("RECV_BUFFER_HITS", 0) <= 0
            or hits.get("SERVER_RECV_BUFFER_HITS", 0) <= 0):
        raise AssertionError(f"cli shm recv buffers: hits {hits}: "
                             f"{so2[-1500:]!r}")
    push = [float(x) for x in re.findall(r"push: ([0-9.]+) Gbps", so2)]
    pull = [float(x) for x in re.findall(r"pull: ([0-9.]+) Gbps", so2)]
    print(f"harness cli shm 1 + 1, ENABLE_RECV_BUFFER=1, push_then_pull "
          f"{CLI_KEYS} x {CLI_LEN} B: CHECK_OK; hits {hits}; push {push}, "
          f"pull {pull} Gbit/s ({secs2:.1f} s with the launch) [{smi}]",
          flush=True)
    return [{"config": "harness cli tcp 2+2 push_pull",
             "ops": CLI_REPEAT + 2, "gbps_per_worker_min": min(rates)},
            {"config": "harness cli shm 1+1 recv buffers",
             "ops": 2 * CLI_REPEAT + 3,
             "recv_buffer_hits": hits["RECV_BUFFER_HITS"],
             "server_recv_buffer_hits": hits["SERVER_RECV_BUFFER_HITS"]}]


def tools_and_examples(ckpt: str, smi: str):
    """psmon, pstrace and the six examples, all at once; returns
    ``(result rows, the examples' kernel launches)``."""
    env = _env()
    jobs = {
        "psmon --json": ([sys.executable, "-m",
                          "pslite_tpu_torch.tools.psmon", "--json"], env),
        "pstrace": ([sys.executable, "-m",
                     "pslite_tpu_torch.tools.pstrace"], env),
        "kv_basics": (_launcher(2, 2, "tcp", [os.path.join(
            EXAMPLE_DIR, "kv_basics.py")]), env),
        "async_sgd": (_launcher(2, 1, "tcp", [os.path.join(
            EXAMPLE_DIR, "async_sgd.py")]), env),
        "elastic_replay": ([sys.executable] + _example("elastic_replay"),
                           env),
        "elastic_restart": (_launcher(0, 0, "tcp",
                                      _example("elastic_restart")),
                            _env({"PS_CKPT": ckpt})),
        "train_flagship": ([sys.executable] + _example("train_flagship"),
                           env),
        "train_pipeline": ([sys.executable] + _example("train_pipeline"),
                           env),
    }
    out = run_group(jobs)
    launches: dict = {}
    for label, (_, so, _, _) in out.items():
        for m in re.finditer(r"HARNESS_LAUNCHES (\{.*\})", so):
            for k, v in json.loads(m.group(1)).items():
                launches[k] = launches.get(k, 0) + v
    so = {label: r[1] for label, r in out.items()}
    secs = {label: r[3] for label, r in out.items()}
    nodes = json.loads(so["psmon --json"])
    if len(nodes) != 5:
        raise AssertionError(f"psmon --json: {len(nodes)} nodes")
    tail = re.search(r"tail lives in: (\w+)", so["pstrace"])
    if tail is None:
        raise AssertionError(f"pstrace: {so['pstrace'][-800:]!r}")
    checks = {
        "kv_basics": len(re.findall(r"pulled 2\.0 \(expected 2\.0\)",
                                    so["kv_basics"])) == 2,
        "async_sgd": len(re.findall(r"final loss", so["async_sgd"])) == 2,
        "elastic_replay": "reshard: 8 -> 4 shards" in so["elastic_replay"],
        "elastic_restart": ("ELASTIC_RESTART_OK restored onto 4 shards"
                            in so["elastic_restart"]),
    }
    losses = {}
    for name in ("train_flagship", "train_pipeline"):
        losses[name] = [(int(i), float(x)) for i, x in re.findall(
            r"step +(\d+) +loss ([0-9.]+)", so[name])]
        checks[name] = (len(losses[name]) >= 2
                        and losses[name][-1][1] < losses[name][0][1])
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"examples failed their checks: "
                             + "; ".join(f"{k}: {so[k][-800:]!r}"
                                         for k in bad))
    print(f"harness tools: psmon --json {len(nodes)} nodes "
          f"({secs['psmon --json']:.1f} s), pstrace demo: tail lives in "
          f"{tail.group(1)} ({secs['pstrace']:.1f} s)", flush=True)
    for name in ("kv_basics", "async_sgd", "elastic_replay",
                 "elastic_restart", "train_flagship", "train_pipeline"):
        keep = [ln for ln in so[name].splitlines()
                if re.search(r"pulled|final loss|shards|loss|tokens/s|"
                             r"ms/step|ELASTIC|DONE|HARNESS", ln)]
        print(f"harness example {name} ({secs[name]:.1f} s): "
              + " | ".join(keep[-8:]) + f" [{smi}]", flush=True)
    results = [{"config": f"harness example {name}",
                "ops": losses[name][-1][0] + 1,
                "first_loss": losses[name][0][1],
                "last_loss": losses[name][-1][1]}
               for name in ("train_flagship", "train_pipeline")]
    return results, launches


def stress_all(smi: str):
    """The stress legs in this process: ``(result rows, launches)``."""
    import torch

    import chip_smoke as cs
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.ops import sparse_rows as sr

    before = _launches()
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="pslite_stress_")
    try:
        results, eng, sp, calls = stress_leg(torch, ps, ring, sr, cs,
                                             "pallas", smi, root)
        results += threads_leg(torch, eng, sp, calls, smi)
        results += stress_leg(torch, ps, ring, sr, cs, None, smi, root)[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"harness stress: {time.perf_counter() - t0:.1f} s", flush=True)
    return results, {k: v - before.get(k, 0) for k, v in _launches().items()
                     if v != before.get(k, 0)}


def stress_child(smi: str):
    """``stress_all`` in a fresh process (``--stress``), its lines
    printed here: its profiler windows come early in that process's life,
    and this process's profiler stays as unused as before the phase (on
    the card's machine a short window late in a process's life loses its
    device events: PERF.md §6, the harnesses)."""
    out = run_group({"stress": ([sys.executable, os.path.join(
        "tools", "harness_phase.py"), "--stress", smi], _env())})
    tag = "HARNESS_STRESS "
    lines = out["stress"][1].splitlines()
    for ln in lines:
        if not ln.startswith(tag):
            print(ln, flush=True)
    doc = json.loads([ln for ln in lines if ln.startswith(tag)][-1][len(tag):])
    return doc["results"], doc["launches"]


def drive_harness(smi: str):
    """The phase; returns ``(result rows, the launches made in other
    processes)``."""
    t_phase = time.perf_counter()
    results, child = stress_child(smi)
    results += cli_legs(smi)
    root = tempfile.mkdtemp(prefix="pslite_harness_")
    try:
        more, made = tools_and_examples(os.path.join(root, "elastic_ck"),
                                        smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    results += more
    for k, v in made.items():
        child[k] = child.get(k, 0) + v
    print(f"harness phase: {time.perf_counter() - t_phase:.1f} s; "
          f"launches in other processes {child}", flush=True)
    return results, child


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("harness_phase: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pslite_tpu_torch.ops import _native
    from pslite_tpu_torch.vans import native as host_native

    t = time.time()
    _native.build(force=True)
    _native.lib()
    host_native.build(force=True)
    host_native.load()
    print(f"built in {time.time() - t:.1f} s", flush=True)
    smi = cs.nvidia_smi()
    print(smi)
    results, child = drive_harness(smi)
    for r in results:
        print(f"row {r}")
    print(f"launches (other processes) {child}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--example"]:
        sys.exit(example_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--stress"]:
        rows, made = stress_all(sys.argv[2])
        print("HARNESS_STRESS " + json.dumps({"results": rows,
                                              "launches": made}))
        sys.exit(0)
    sys.exit(main())
