"""The port's user examples (``examples/torch/``) on the CPU at tiny
sizes, each in a subprocess, launched as its docstring says (the
port's launcher where the original uses JAX's), all at once.  They
print what the JAX originals print; ``elastic_replay`` prints the same
numbers as its original, run beside it."""

import os
import re
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EX = os.path.join(_REPO, "examples", "torch")
_LAUNCH = [sys.executable, "-m", "pslite_tpu_torch.tracker.local"]

CASES = {
    "kv_basics": _LAUNCH + ["-n", "2", "-s", "2", "--", sys.executable,
                            os.path.join(_EX, "kv_basics.py")],
    "async_sgd": _LAUNCH + ["-n", "2", "-s", "1", "--", sys.executable,
                            os.path.join(_EX, "async_sgd.py")],
    "elastic_replay": [sys.executable, os.path.join(_EX, "elastic_replay.py"),
                       "--device", "cpu"],
    "elastic_restart": _LAUNCH + ["-n", "0", "-s", "0", "--", sys.executable,
                                  os.path.join(_EX, "elastic_restart.py"),
                                  "--device", "cpu"],
    "train_flagship": [sys.executable, os.path.join(_EX, "train_flagship.py"),
                       "--device", "cpu", "--steps", "6", "--batch", "4",
                       "--seq", "16", "--dim", "32"],
    "train_pipeline": [sys.executable, os.path.join(_EX, "train_pipeline.py"),
                       "--device", "cpu", "--steps", "6", "--seq", "16",
                       "--dim", "32"],
    "jax_elastic_replay": [sys.executable,
                           os.path.join(_REPO, "examples",
                                        "elastic_replay.py")],
}
# The device examples at their defaults: the card, or a raise without it.
CARD_CASES = ("elastic_replay", "train_flagship", "train_pipeline")
CASES.update({f"{name}@default": [sys.executable,
                                  os.path.join(_EX, f"{name}.py")]
              for name in CARD_CASES})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case started at once; ``{case: (rc, stdout, stderr)}``."""
    ck = str(tmp_path_factory.mktemp("ck") / "elastic_ck")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PS_CKPT=ck, PS_CKPT_BACKEND="npz")
    procs = {
        name: subprocess.Popen(cmd, cwd=_REPO, env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        for name, cmd in CASES.items()}
    out = {}
    for name, p in procs.items():
        try:
            so, se = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out[name] = (p.returncode, so, se)
    return out


def _ok(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, (name, so[-1500:], se[-1500:])
    return so


def _losses(out: str) -> list:
    return [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]


def test_kv_basics(runs):
    out = _ok(runs, "kv_basics")
    assert sorted(re.findall(r"worker \d: pulled 2.0 \(expected 2.0\)",
                             out)) == ["worker 0: pulled 2.0 (expected "
                                       "2.0)", "worker 1: pulled 2.0 "
                                       "(expected 2.0)"]


def test_async_sgd(runs):
    out = _ok(runs, "async_sgd")
    finals = [float(x) for x in re.findall(r"final loss ([0-9.]+)", out)]
    assert len(finals) == 2 and max(finals) < 0.05
    assert "step   0  loss" in out
    for role in ("scheduler", "server", "worker"):
        assert f"{role} DONE" in out


def test_elastic_replay_prints_the_originals_numbers(runs):
    out = _ok(runs, "elastic_replay")
    want = _ok(runs, "jax_elastic_replay")
    assert out.splitlines() == [ln for ln in want.splitlines()
                                if not ln.startswith("NOTE")]
    assert "reshard: 8 -> 4 shards" in out and out.endswith("DONE\n")


def test_elastic_restart_under_keepalive(runs):
    out = _ok(runs, "elastic_restart")
    assert "saved 2-step checkpoint from 8 shards" in out
    assert "ELASTIC_RESTART_OK restored onto 4 shards" in out


@pytest.mark.parametrize("name, mesh", [
    ("train_flagship", "mesh=(dp=4, sp=2) backend=cpu"),
    ("train_pipeline", "mesh=(dp=2, pp=4) backend=cpu")])
def test_training_examples_lose_loss(runs, name, mesh):
    out = _ok(runs, name)
    assert f"devices=8 {mesh}" in out
    losses = _losses(out)
    assert len(losses) >= 2 and losses[-1] < losses[0], out
    assert ("tokens/s" in out) if name == "train_flagship" else (
        "ms/step (bubble 3/5 of ticks)" in out)


@pytest.mark.parametrize("name", CARD_CASES)
def test_device_examples_need_a_card_unless_asked(runs, name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc, _, se = runs[f"{name}@default"]
    assert rc != 0 and "CUDA is not available" in se
