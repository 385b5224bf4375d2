"""PyTorch/CUDA port: the observability and tuning examples against the
JAX repository's scripts.

* ``metrics_probe`` (fp16 and ``powersgd:4``): the JAX script in a
  subprocess on one CPU device (``_jax_examples`` records its losses at
  full precision), the port's ``main`` here at world 1 on the same
  arguments -- the same numpy draws.  Held: the per-step losses within
  1e-6 (relative), the scraped ``horovod_step_total``,
  ``horovod_wire_bytes_per_step``, ``horovod_uncompressed_bytes_per_step``
  and ``horovod_compression_ratio`` lines equal, the printed
  ``explain_plan`` rows equal column for column but ``fence`` (the JAX
  plan names its barrier, the port's stream order needs none), and the
  port's step audit ``ok()``.
* ``straggler_probe`` on the JAX test's steps and rank (10 steps, rank
  3), stalled 1 s after step 9 instead of 0.3 s after step 4.  The
  monitor's lateness is an EWMA (alpha 0.3) of step walls, so a stall
  six steps before the end keeps 5 % of its weight, and under the
  suite's six workers a CPU step of this MLP swings by 100 ms (2 ms
  alone): there the JAX test's stall names whichever rank the load hit
  last.  After step 9 the stall keeps 30 % (0.3 s).  The probe names
  rank 3 live and in its merge, the stalled step
  ``dispatch_gap``-dominated; the JAX package's own merge
  (``horovod_tpu.timeline.__main__.merge``) reads the port's per-rank
  traces and names rank 3 too.  The JAX script itself is not run: its
  live verdict reads the dominant span of the newest step, a timing race
  (its own test is the suite's unsteady one).  Not asserted: the JAX
  test's ``host-bound`` verdict for the slow rank, which holds only
  while the stall outweighs that rank's ten steps together -- under the
  suite's load they took over 1 s.
* ``autotune_value_demo``: both scenarios' selections equal the JAX
  ``run_scenario``'s (on the conftest's 8 CPU devices as a (2, 4)
  mesh), and every modeled cost within 1e-9 of the JAX script's
  ``modeled_step_seconds``.
* ``fp8_cost_probe``: the round trip within one e4m3 step, the codes
  bitwise the JAX package's ``fp8_quantize`` on the same input.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from _jax_examples import REPO, run_jax_example, world1  # noqa: F401
from horovod_tpu_torch.examples import (autotune_value_demo,
                                        fp8_cost_probe, metrics_probe,
                                        straggler_probe)

METRIC_STEPS = 3
STALL_S = 1.0
STALL_AFTER = 9
LOSS_RTOL = 1e-6
COST_RTOL = 1e-9


def _plan_rows(out: str) -> list:
    """The rows of the first ``render_plan`` table in ``out``: columns
    from the header, cut at the dashed line's segments."""
    lines = out.splitlines()
    i = next(j for j, ln in enumerate(lines) if ln.startswith("bucket  "))
    dashes = lines[i + 1]
    spans, pos = [], 0
    for seg in dashes.split("  "):
        spans.append((pos, pos + len(seg)))
        pos += len(seg) + 2
    names = [lines[i][a:b].strip() for a, b in spans]
    rows = []
    for ln in lines[i + 2:]:
        if ln.startswith("total:") or not ln.strip():
            break
        cells = [ln[a:b].strip() for a, b in spans[:-1]]
        cells.append(ln[spans[-1][0]:].strip())
        rows.append(dict(zip(names, cells)))
    return rows


def _metric_lines(out: str) -> list:
    return sorted(ln.strip() for ln in out.splitlines()
                  if ln.strip().startswith(metrics_probe.REPORTED))


@pytest.mark.parametrize("codec", ["fp16", "powersgd:4"])
def test_metrics_probe_matches_the_jax_script(world1, tmp_path, capsys,
                                              monkeypatch, codec):
    args = ["--steps", str(METRIC_STEPS), "--compression", codec]
    out, steps = run_jax_example("metrics_probe",
                                 ["--cpu-devices", "1", *args], tmp_path)
    assert "metrics probe OK" in out
    monkeypatch.setenv("HOROVOD_METRICS_PORT", "0")
    port = metrics_probe.main(["--device", "cpu", *args])
    printed = capsys.readouterr().out
    assert "metrics probe OK" in printed
    assert f"horovod_step_total {METRIC_STEPS}" in printed
    np.testing.assert_allclose(port["losses"], steps[0], rtol=LOSS_RTOL)
    assert _metric_lines(printed) == _metric_lines(out)
    assert len(_metric_lines(out)) == 4
    jax_rows = _plan_rows(out)
    port_rows = _plan_rows(printed)
    assert len(port_rows) == len(jax_rows) == len(port["plan"]) >= 1
    for j, p in zip(jax_rows, port_rows):
        j.pop("fence")
        p.pop("fence")
        assert p == j
    assert port["audit"].ok()
    assert len(port["families"]) >= 8


def test_straggler_probe_names_the_injected_rank(world1, tmp_path):
    trace = tmp_path / "traces"
    rep = straggler_probe.main(
        ["--device", "cpu", "--steps", "10", "--slow-rank", "3",
         "--slow-step", str(STALL_AFTER), "--slow-secs", str(STALL_S),
         "--trace-dir", str(trace), "--json", str(tmp_path / "v.json")])
    assert rep["live"]["straggler_rank"] == 3
    with open(tmp_path / "v.json") as f:
        verdicts = json.load(f)
    assert verdicts["detected_rank"] == verdicts["merged_rank"] == 3
    assert verdicts["injected_secs"] == STALL_S
    assert rep["merged"]["straggler"]["straggler_rank"] == 3
    assert rep["merged"]["ranks"] == 8
    assert rep["stalled"]["spans"]["dispatch_gap"] >= STALL_S
    # The JAX package's merge reads the port's traces alike.
    from horovod_tpu.timeline.__main__ import merge
    jrep = merge(str(trace), str(tmp_path / "jax_merged.json"))
    assert jrep["ranks"] == 8
    assert jrep["straggler"]["straggler_rank"] == 3
    with open(tmp_path / "jax_merged.json") as f:
        assert len({e.get("pid") for e in json.load(f)}) == 8


def test_straggler_probe_refuses_a_rank_outside_the_world(world1):
    with pytest.raises(SystemExit):
        straggler_probe.main(["--device", "cpu", "--ranks", "2",
                              "--slow-rank", "2"])


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_autotune_value_demo",
        os.path.join(REPO, "examples", "autotune_value_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


@pytest.fixture(scope="module")
def jax_selections():
    import jax
    import horovod_tpu as jhvd
    from horovod_tpu.parallel.mesh import build_mesh
    demo = _jax_demo()
    jhvd.shutdown()
    jhvd.init(mesh=build_mesh(jax.devices()[:8], hierarchical=True,
                              dcn_size=2))
    try:
        return demo, {name: demo.run_scenario(name)
                      for name in demo.SCENARIOS}
    finally:
        jhvd.shutdown()


def test_autotune_value_demo_selects_as_the_jax_script(world1, tmp_path,
                                                       jax_selections):
    demo, want = jax_selections
    out = tmp_path / "demo.json"
    doc = autotune_value_demo.main(["--device", "cpu", "--out", str(out)])
    assert doc["out"] == str(out)
    with open(out) as f:
        written = json.load(f)
    got = {r["scenario"]: r for r in written["results"]}
    assert set(got) == set(want) == set(autotune_value_demo.SCENARIOS)
    for name, w in want.items():
        g = got[name]
        assert g["selected"] == w["selected"] == w["expected"]
        assert g["matches_model_optimum"]
        assert g["sampled_configs"] == w["sampled_configs"]
        assert g["modeled_ms"] == w["modeled_ms"]


@pytest.mark.parametrize("scenario", sorted(autotune_value_demo.SCENARIOS))
def test_autotune_value_demo_costs_equal_the_jax_function(jax_selections,
                                                          scenario):
    demo, _ = jax_selections
    sc = autotune_value_demo.SCENARIOS[scenario]
    assert {k: v for k, v in sc.items()} == demo.SCENARIOS[scenario]
    for h in (False, True):
        for codec in ("none", "bf16", "fp16", "fp8"):
            got = autotune_value_demo.modeled_step_seconds(h, codec, sc)
            want = demo.modeled_step_seconds(h, codec, sc)
            assert got == pytest.approx(want, rel=COST_RTOL, abs=0)


def test_autotune_value_demo_leaves_the_repo_file_alone(world1, tmp_path,
                                                        monkeypatch):
    """Without ``--out`` the record goes to ``AUTOTUNE_DEMO_OUT`` (else a
    new temporary directory), never the JAX side's
    ``AUTOTUNE_DEMO.json``."""
    repo_file = os.path.join(REPO, "AUTOTUNE_DEMO.json")
    with open(repo_file, "rb") as f:
        before = f.read()
    target = tmp_path / "env.json"
    monkeypatch.setenv("AUTOTUNE_DEMO_OUT", str(target))
    doc = autotune_value_demo.main(["--device", "cpu"])
    assert doc["out"] == str(target) and target.exists()
    monkeypatch.delenv("AUTOTUNE_DEMO_OUT")
    doc = autotune_value_demo.main(["--device", "cpu"])
    assert os.path.dirname(doc["out"]) != REPO
    with open(repo_file, "rb") as f:
        assert f.read() == before


def test_fp8_cost_probe_round_trip_and_codes(tmp_path):
    import jax.numpy as jnp
    import torch
    from horovod_tpu.collectives.compression import \
        fp8_quantize as j_quantize
    from horovod_tpu_torch.collectives.compression import fp8_quantize
    rec = fp8_cost_probe.main(["--device", "cpu", "--elements", "65536",
                               "--iters", "2", "--json",
                               str(tmp_path / "fp8.json")])
    assert rec["within_one_step"] and rec["ms"] > 0
    assert rec["floor_ms"] == pytest.approx(10 * 65536 / 3350e9 * 1e3)
    with open(tmp_path / "fp8.json") as f:
        assert json.load(f)["elements"] == 65536
    x = np.random.RandomState(0).randn(4096).astype(np.float32) * 3
    q, s = fp8_quantize(torch.from_numpy(x))
    jq, js = j_quantize(jnp.asarray(x))
    assert np.array_equal(q.view(torch.uint8).numpy(),
                          np.asarray(jq).view(np.uint8))
    assert float(s) == float(js)
