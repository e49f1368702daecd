"""MPI launcher.

Counterpart of ``pslite_tpu/tracker/mpi.py``, over this package's
``tracker/local.build_env``.

Equivalent of the reference's ``tracker/dmlc_mpi.py``: delegates process
placement to ``mpirun`` and derives the PS role from the MPI rank — rank 0
is the scheduler, the next S ranks are servers, the rest workers.  Two
modes:

- launcher: ``python -m pslite_tpu_torch.tracker.mpi -n 2 -s 2 -- python app.py``
  execs ``mpirun -np 1+n+s python -m pslite_tpu_torch.tracker.mpi --worker ...``
- per-rank shim (``--worker``): reads ``OMPI_COMM_WORLD_RANK`` /
  ``PMI_RANK``, exports the DMLC_* env, and execs the app.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from .local import build_env


def _mpi_rank() -> int:
    for var in ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "PMIX_RANK",
                "SLURM_PROCID"):
        val = os.environ.get(var)
        if val is not None:
            return int(val)
    raise RuntimeError("not running under a recognized MPI launcher")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, required=True)
    ap.add_argument("--root-uri", default="127.0.0.1")
    ap.add_argument("--root-port", type=int, default=9091)
    ap.add_argument("--van", default="tcp")
    ap.add_argument("--mpirun", default="mpirun")
    ap.add_argument("--worker", action="store_true",
                    help="internal: per-rank shim under mpirun")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        ap.error("no command given")

    if args.worker:
        rank = _mpi_rank()
        if rank == 0:
            role = "scheduler"
        elif rank <= args.num_servers:
            role = "server"
        else:
            role = "worker"
        env = build_env(role, args.num_workers, args.num_servers,
                        args.root_uri, args.root_port, args.van)
        os.execvpe(cmd[0], cmd, env)

    if shutil.which(args.mpirun) is None:
        print(f"error: {args.mpirun} not found", file=sys.stderr)
        return 127
    np_total = 1 + args.num_workers + args.num_servers
    inner = [
        args.mpirun, "-np", str(np_total),
        sys.executable, "-m", "pslite_tpu_torch.tracker.mpi",
        "-n", str(args.num_workers), "-s", str(args.num_servers),
        "--root-uri", args.root_uri, "--root-port", str(args.root_port),
        "--van", args.van, "--worker", "--",
    ] + cmd
    return subprocess.call(inner)


if __name__ == "__main__":
    sys.exit(main())
