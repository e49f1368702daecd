"""SSH multi-host launcher.

Counterpart of ``pslite_tpu/tracker/ssh.py``, over this package's
``tracker/local.build_env``.

Equivalent of the reference's ``tracker/dmlc_ssh.py``: starts the scheduler
locally and remote workers/servers over ssh, passing the DMLC_* environment
on the remote command line.  Hosts come from a file (one per line, workers
first) or --hosts.

Usage::

    python -m pslite_tpu_torch.tracker.ssh -n 2 -s 2 -H hosts.txt -- \
        python my_app.py
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
from typing import Dict, List

from .local import build_env


def _remote_cmd(env: Dict[str, str], cmd: List[str]) -> str:
    keys = [k for k in env if k.startswith(("DMLC_", "PS_", "BYTEPS_"))]
    exports = " ".join(f"{k}={shlex.quote(env[k])}" for k in sorted(keys))
    return f"env {exports} {' '.join(shlex.quote(c) for c in cmd)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, required=True)
    ap.add_argument("-H", "--hostfile", required=True)
    ap.add_argument("--root-port", type=int, default=9091)
    ap.add_argument("--van", default="tcp")
    ap.add_argument("--ssh-opts", default="-o StrictHostKeyChecking=no")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        ap.error("no command given")

    with open(args.hostfile) as fh:
        hosts = [h.strip() for h in fh if h.strip()]
    needed = args.num_workers + args.num_servers
    if len(hosts) < needed:
        # Round-robin hosts when fewer machines than roles.
        hosts = [hosts[i % len(hosts)] for i in range(needed)]

    import socket

    root_uri = socket.gethostbyname(socket.gethostname())
    procs = []

    def launch(host: str, role: str) -> None:
        env = build_env(role, args.num_workers, args.num_servers, root_uri,
                        args.root_port, args.van)
        remote = _remote_cmd(env, cmd)
        if role == "scheduler":
            procs.append(subprocess.Popen(remote, shell=True))
        else:
            procs.append(
                subprocess.Popen(
                    ["ssh"] + args.ssh_opts.split() + [host, remote]
                )
            )

    launch("localhost", "scheduler")
    for i in range(args.num_servers):
        launch(hosts[args.num_workers + i], "server")
    for i in range(args.num_workers):
        launch(hosts[i], "worker")

    rc = 0
    for p in procs:
        rc = rc or p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
