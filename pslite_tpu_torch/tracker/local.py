"""Local multi-process launcher.

Counterpart of ``pslite_tpu/tracker/local.py`` (the reference's
``tracker/dmlc_local.py``): spawns 1 scheduler + S servers + W workers
(or, with ``--joint``, W processes that each host a worker and a server)
as OS processes wired by the ``DMLC_*`` variables, and supervises them:
a process exiting with 254 is started again (keepalive,
``dmlc_local.py:16-25``), which with the scheduler's node recovery
(``van.cc:266-332``) gives restart-based fault tolerance; the first
other failure terminates the rest.  ``--no-keepalive`` makes 254 a
failure like any other.  ``PS_CPU_PIN=N`` gives each spawned node its
own block of N CPUs (``sched_setaffinity`` in the child, Linux only).

Usage::

    python -m pslite_tpu_torch.tracker.local -n 2 -s 2 [--van tcp] -- \\
        python my_app.py args...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..utils.network import get_available_port

RESTART_EXIT_CODE = 254


def build_env(role: str, num_workers: int, num_servers: int, root_uri: str,
              root_port: int, van: str = "tcp", group_size: int = 1,
              extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    env.update(
        DMLC_ROLE=role,
        DMLC_NUM_WORKER=str(num_workers),
        DMLC_NUM_SERVER=str(num_servers),
        DMLC_PS_ROOT_URI=root_uri,
        DMLC_PS_ROOT_PORT=str(root_port),
        DMLC_GROUP_SIZE=str(group_size),
        PS_VAN_TYPE=van,
    )
    if extra:
        env.update(extra)
    return env


class LocalLauncher:
    def __init__(self, num_workers: int, num_servers: int, cmd: List[str],
                 van: str = "tcp", root_port: int = 0, group_size: int = 1,
                 keepalive: bool = True, joint: bool = False):
        if joint and num_workers != num_servers:
            raise ValueError(
                "joint mode hosts one worker+server pair per process; "
                f"num_workers ({num_workers}) must equal num_servers "
                f"({num_servers})")
        self.joint = joint
        self.num_workers = num_workers
        self.num_servers = num_servers
        self.cmd = cmd
        self.van = van
        self.group_size = group_size
        self.keepalive = keepalive
        self.root_port = root_port or get_available_port()
        self.root_uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        self._procs: List[tuple] = []  # (role, Popen)
        # PS_CPU_PIN=N: disjoint blocks of N CPUs per node, so a node's
        # threads never share cores with another's from run to run.
        try:
            self._pin_cpus = int(os.environ.get("PS_CPU_PIN", "0") or 0)
        except ValueError:
            self._pin_cpus = 0
        self._pin_next = 0

    def roles(self) -> List[str]:
        if self.joint:
            return ["scheduler"] + ["joint"] * self.num_workers
        return (["scheduler"] + ["server"] * self.num_servers
                + ["worker"] * self.num_workers)

    def _spawn(self, role: str) -> None:
        env = build_env(role, self.num_workers, self.num_servers,
                        self.root_uri, self.root_port, self.van,
                        self.group_size)
        env.setdefault("DMLC_NODE_HOST", self.root_uri)
        proc = subprocess.Popen(self.cmd, env=env,
                                preexec_fn=self._next_pin())
        self._procs.append((role, proc))

    def _next_pin(self):
        """The child's affinity setter for the next CPU block, or None
        (``PS_CPU_PIN`` unset or no ``sched_setaffinity``).  A block
        past the last CPU wraps, and then overlaps an earlier node's:
        that is warned, never silent."""
        if self._pin_cpus <= 0 or not hasattr(os, "sched_setaffinity"):
            return None
        avail = sorted(os.sched_getaffinity(0))
        if self._pin_next + self._pin_cpus > len(avail):
            print(f"[tracker] W PS_CPU_PIN={self._pin_cpus}: node "
                  f"#{self._pin_next // self._pin_cpus} wraps past "
                  f"{len(avail)} available CPUs — pinned blocks now "
                  f"OVERLAP earlier nodes", file=sys.stderr, flush=True)
        cpus = frozenset(avail[(self._pin_next + j) % len(avail)]
                         for j in range(min(self._pin_cpus, len(avail))))
        self._pin_next += self._pin_cpus

        def preexec(cpus=cpus):
            os.sched_setaffinity(0, cpus)
        return preexec

    def run(self) -> int:
        """Spawn every role and supervise: a process exiting 254 is
        restarted (with keepalive on); 0 when all exit 0, else the first
        failing exit code (the others are terminated)."""
        for role in self.roles():
            self._spawn(role)
        rc = 0
        while self._procs:
            time.sleep(0.1)
            for i, (role, proc) in enumerate(self._procs):
                code = proc.poll()
                if code is None:
                    continue
                self._procs.pop(i)
                if code == RESTART_EXIT_CODE and self.keepalive:
                    print(f"[tracker] restarting {role} (exit 254)",
                          file=sys.stderr, flush=True)
                    self._spawn(role)
                elif code != 0:
                    rc = code
                    self.terminate()
                break
        return rc

    def terminate(self) -> None:
        for _, proc in self._procs:
            if proc.poll() is None:
                proc.terminate()
        for _, proc in self._procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._procs.clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, required=True)
    ap.add_argument("--van", default="tcp")
    ap.add_argument("--group-size", type=int, default=1)
    ap.add_argument("--root-port", type=int, default=0)
    ap.add_argument("--joint", action="store_true",
                    help="one process per rank hosting worker+server")
    ap.add_argument("--no-keepalive", action="store_true",
                    help="exit 254 fails the run instead of a restart")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="program to launch (prefix with --)")
    args = ap.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        ap.error("no command given")
    try:
        launcher = LocalLauncher(
            args.num_workers, args.num_servers, cmd, van=args.van,
            root_port=args.root_port, group_size=args.group_size,
            keepalive=not args.no_keepalive, joint=args.joint)
    except ValueError as exc:
        ap.error(str(exc))
    try:
        return launcher.run()
    except KeyboardInterrupt:
        launcher.terminate()
        return 130


if __name__ == "__main__":
    sys.exit(main())
