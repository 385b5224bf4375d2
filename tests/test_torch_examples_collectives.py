"""PyTorch/CUDA port: the collective examples against the JAX
repository's scripts.

* ``allreduce_check`` under ``python -m horovod_tpu_torch.run -np N
  --cpu`` (gloo): every rank's checks pass (each asserts an exact
  result) and print the JAX script's ``... OK`` lines -- at np 2 the
  same set of lines as the JAX script under ``python -m horovod_tpu.run
  -np 2 --cpu``.
* ``allreduce_benchmark`` on the JAX test's arguments: the ``bus>=``
  line, the results exact; at world 1 the bus factor is 0 and no bus
  number is printed.
"""

import json
import re

import pytest

from _jax_examples import run_jax_example, run_port, world1  # noqa: F401
from horovod_tpu_torch.examples import allreduce_benchmark

CHECKS = ("allreduce OK", "allgatherv OK", "broadcast_object OK",
          "allgather_object OK", "broadcast_parameters OK", "alltoall OK",
          "alltoallv OK", "reducescatter OK", "grouped gather/scatter OK",
          "grouped_allreduce OK", "process_set allreduce OK", "barrier OK")


def _ok_lines(out: str) -> set:
    """``rank r: ... OK`` lines without the launcher's tags."""
    lines = set()
    for ln in out.splitlines():
        ln = re.sub(r"^\[\d+\]<std(out|err)>", "", ln).strip()
        if re.match(r"rank \d+: ", ln) and (" OK" in ln):
            lines.add(ln)
    return lines


@pytest.mark.parametrize("np_", [2, 3])
def test_allreduce_check_under_the_launcher(tmp_path, np_):
    rc, out = run_port("allreduce_check", [], tmp_path, launcher_np=np_)
    assert rc == 0, out
    lines = _ok_lines(out)
    for r in range(np_):
        for check in CHECKS:
            assert any(ln.startswith(f"rank {r}: {check}") for ln in lines), \
                (r, check, out)
    total = float(sum(range(np_)))
    assert f"rank 0: allreduce OK -> {total}" in lines


def test_allreduce_check_prints_the_jax_scripts_lines(tmp_path):
    jax_out, _ = run_jax_example("allreduce_check", [], tmp_path,
                                 launcher_np=2)
    rc, out = run_port("allreduce_check", [], tmp_path, launcher_np=2)
    assert rc == 0, out
    assert _ok_lines(out) == _ok_lines(jax_out)
    assert len(_ok_lines(out)) == 2 * len(CHECKS)


def test_allreduce_benchmark_at_world_one(world1, capsys, tmp_path):
    recs = allreduce_benchmark.main(
        ["--device", "cpu", "--sizes-mb", "1,2", "--iters", "2",
         "--json", str(tmp_path / "sweep.json")])
    out = capsys.readouterr().out
    assert [r["mib"] for r in recs] == [1.0, 2.0]
    assert all(r["exact"] and r["bus_gib_s"] is None for r in recs)
    assert out.count("bus>= n/a (world 1: bus factor 2(n-1)/n = 0") == 2
    with open(tmp_path / "sweep.json") as f:
        doc = json.load(f)
    assert doc["world"] == 1 and doc["backend"] == "gloo"
    assert allreduce_benchmark.bus_factor(1) == 0.0
    assert allreduce_benchmark.bus_factor(4) == 1.5


def test_allreduce_benchmark_at_world_two(tmp_path):
    """The JAX test's sizes at world 2: the bus number is the algorithm
    bandwidth times 2(n-1)/n = 1."""
    rc, out = run_port("allreduce_benchmark",
                       ["--sizes-mb", "1", "--iters", "2", "--json",
                        str(tmp_path / "sweep.json")], tmp_path,
                       launcher_np=2)
    assert rc == 0, out
    assert "bus>=" in out and "n/a" not in out
    with open(tmp_path / "sweep.json") as f:
        doc = json.load(f)
    (rec,) = doc["sweep"]
    assert doc["world"] == 2 and rec["exact"]
    assert rec["bus_gib_s"] == pytest.approx(rec["algo_gib_s"])
