"""The port's ssh and mpi launchers against the JAX package's, on the
same arguments: the remote command lines, the per-rank shim's
environment and the ``mpirun`` line.  Nothing runs ssh or mpirun:
``subprocess``, ``os.execvpe`` and the host lookup are replaced."""

import pytest

from pslite_tpu.tracker import mpi as jmpi
from pslite_tpu.tracker import ssh as jssh
from pslite_tpu_torch.tracker import mpi, ssh

CMD = ["python", "my app.py", "--flag=a b"]


@pytest.mark.parametrize("role", ["scheduler", "server", "worker"])
def test_ssh_remote_command_matches_jax(role):
    from pslite_tpu.tracker.local import build_env as jenv
    from pslite_tpu_torch.tracker.local import build_env as penv

    args = (role, 2, 3, "10.1.2.3", 9100, "ici_tcp")
    want = jssh._remote_cmd(jenv(*args), CMD)
    got = ssh._remote_cmd(penv(*args), CMD)
    assert got == want
    assert "DMLC_ROLE=" + role in got and "'my app.py'" in got


def _ssh_launches(module, monkeypatch, tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text("h1\nh2\n\n")
    launched = []

    class FakePopen:
        def __init__(self, cmd, shell=False):
            launched.append((cmd, shell))

        def wait(self):
            return 0

    monkeypatch.setattr(module.subprocess, "Popen", FakePopen)
    monkeypatch.setattr("socket.gethostbyname", lambda _h: "10.9.8.7")
    rc = module.main(["-n", "2", "-s", "1", "-H", str(hosts),
                      "--root-port", "9200", "--van", "tcp", "--"] + CMD)
    assert rc == 0
    return launched


def test_ssh_main_launches_like_jax(monkeypatch, tmp_path):
    """The scheduler locally, then servers and workers over ssh on the
    hosts round robin, each with the same remote command as JAX's."""
    want = _ssh_launches(jssh, monkeypatch, tmp_path)
    got = _ssh_launches(ssh, monkeypatch, tmp_path)
    assert got == want
    assert [c[0] if isinstance(c, list) else "local" for c, _ in got] == [
        "local", "ssh", "ssh", "ssh"]


@pytest.mark.parametrize("var", ["OMPI_COMM_WORLD_RANK", "PMI_RANK",
                                 "PMIX_RANK", "SLURM_PROCID"])
def test_mpi_rank_matches_jax(monkeypatch, var):
    for v in ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "PMIX_RANK",
              "SLURM_PROCID"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, "3")
    assert mpi._mpi_rank() == jmpi._mpi_rank() == 3
    monkeypatch.delenv(var)
    with pytest.raises(RuntimeError, match="MPI launcher"):
        mpi._mpi_rank()


def _shim(module, monkeypatch, rank: int):
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", str(rank))
    seen = {}

    def fake_exec(file, argv, env):
        seen.update(file=file, argv=argv, env=env)
        raise SystemExit(0)

    monkeypatch.setattr(module.os, "execvpe", fake_exec)
    with pytest.raises(SystemExit):
        module.main(["-n", "2", "-s", "2", "--root-uri", "10.0.0.1",
                     "--root-port", "9300", "--van", "shm", "--worker",
                     "--"] + CMD)
    return seen


@pytest.mark.parametrize("rank,role", [(0, "scheduler"), (1, "server"),
                                       (2, "server"), (3, "worker"),
                                       (4, "worker")])
def test_mpi_shim_environment_matches_jax(monkeypatch, rank, role):
    want = _shim(jmpi, monkeypatch, rank)
    got = _shim(mpi, monkeypatch, rank)
    assert got["file"] == want["file"] == CMD[0]
    assert got["argv"] == want["argv"] == CMD
    keys = sorted(k for k in set(got["env"]) | set(want["env"])
                  if k.startswith(("DMLC_", "PS_")))
    assert {k: got["env"].get(k) for k in keys} == \
        {k: want["env"].get(k) for k in keys}
    assert got["env"]["DMLC_ROLE"] == role


def test_mpi_launch_line_matches_jax(monkeypatch):
    def run(module):
        seen = []
        monkeypatch.setattr(module.shutil, "which", lambda _p: "/x/mpirun")
        monkeypatch.setattr(module.subprocess, "call",
                            lambda cmd: seen.append(cmd) or 0)
        assert module.main(["-n", "3", "-s", "1", "--"] + CMD) == 0
        return seen[0]

    want, got = run(jmpi), run(mpi)
    assert got == [w.replace("pslite_tpu.tracker.mpi",
                             "pslite_tpu_torch.tracker.mpi") for w in want]
    assert got[:3] == ["mpirun", "-np", "5"]
    monkeypatch.setattr(mpi.shutil, "which", lambda _p: None)
    assert mpi.main(["-n", "1", "-s", "1", "--"] + CMD) == 127
