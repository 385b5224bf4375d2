"""Run one of the JAX repository's ``examples/*.py`` scripts in a
subprocess on the CPU, as a user would, and hand back what it printed
and the losses its train steps returned at full precision.

The script runs unmodified (``runpy`` under ``__main__``, after an
optional prelude, e.g. seeding Keras); the wrapper only wraps
``horovod_tpu.make_train_step`` so that each step it builds records
``float(loss)`` of every concrete call (one list a built step, in build
order) -- the scripts print losses at four decimals only.  Also the
``world1`` fixture for an example's ``main`` run in the test's
process."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")

_WRAPPER = r"""
import functools, json, os, runpy, sys
import horovod_tpu as hvd
steps = []
_make = hvd.make_train_step

def make_train_step(*a, **kw):
    step = _make(*a, **kw)
    losses = []
    steps.append(losses)

    def wrapped(*args, **kwargs):
        out = step(*args, **kwargs)
        try:
            losses.append(float(out[-1]))
        except Exception:       # traced (an audit): no value to record
            pass
        return out
    functools.update_wrapper(wrapped, step)
    return wrapped

hvd.make_train_step = make_train_step
exec(os.environ.get("JAX_EXAMPLE_PRELUDE", ""))
out, script = sys.argv[1], sys.argv[2]
sys.argv = sys.argv[2:]
rc = 0
try:
    runpy.run_path(script, run_name="__main__")
except SystemExit as e:
    rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
finally:
    rank = os.environ.get("HOROVOD_RANK", "0")
    with open(out if rank == "0" else f"{out}.{rank}", "w") as f:
        json.dump({"steps": steps}, f)
sys.exit(rc)
"""


def env(**extra) -> dict:
    e = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    e.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    e.update(extra)
    return e


def run_jax_example(name: str, args, tmp_path, timeout: int = 300,
                    launcher_np: int = 0, prelude: str = "", **extra_env):
    """``(stdout, [losses of each built train step])`` of
    ``examples/<name>.py args`` (rank 0's losses under ``python -m
    horovod_tpu.run -np N --cpu`` when ``launcher_np``); ``prelude`` is
    Python run in each process before the script.  Fails on a non-zero
    exit."""
    out = os.path.join(str(tmp_path), f"jax_{name}.json")
    cmd = [sys.executable, "-c", _WRAPPER, out,
           os.path.join(REPO, "examples", f"{name}.py"), *args]
    if launcher_np:
        cmd = [sys.executable, "-m", "horovod_tpu.run", "-np",
               str(launcher_np), "--cpu", *cmd]
    proc = subprocess.run(
        cmd, env=env(JAX_EXAMPLE_PRELUDE=prelude, **extra_env),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        return proc.stdout, json.load(f)["steps"]


def run_port(module: str, args, tmp_path, timeout: int = 300,
             launcher_np: int = 0, **extra_env):
    """``(returncode, stdout + stderr)`` of ``python -m
    horovod_tpu_torch.examples.<module> args``; under ``python -m
    horovod_tpu_torch.run -np N --cpu`` when ``launcher_np``."""
    cmd = [sys.executable, "-m", f"horovod_tpu_torch.examples.{module}",
           *args]
    if launcher_np:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
               str(launcher_np), "--cpu", *cmd]
    proc = subprocess.run(cmd, env=env(**extra_env), cwd=str(tmp_path),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout


@pytest.fixture
def world1(monkeypatch):
    """A fresh world of one for an example's ``main`` run in the test's
    process: no launcher identity in the environment, the framework shut
    down before and after, and the metrics registry reset (its counters
    outlive ``shutdown()``; a script run alone starts at zero)."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.timeline.metrics import reset_metrics
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    thvd.shutdown()
    reset_metrics()
    yield
    thvd.shutdown()
