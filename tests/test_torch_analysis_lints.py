"""The port's repo lints, baseline and CLI (``horovod_tpu_torch/analysis``)
against the JAX package's (``horovod_tpu/analysis``).

* The idiom-free rules (locks, legplan, envreg) run by the JAX rule and
  the port rule on the same fixture trees under ``tmp_path`` (written
  once as ``horovod_tpu/`` and once as ``horovod_tpu_torch/``, the
  package each rule exempts by path) give equal ``(rule, ident, line)``
  sets.  The one intended difference: the port's env registry also
  reads the table of README's port section.
* The idiom-bound rules use counterpart fixtures: raw
  ``torch.distributed`` collectives (through each alias) and an exempt
  ``collectives/`` file; wall-clock reads inside and outside a
  ``torch.cuda.graph`` block, a ``torch.compile``d function and what it
  calls; the kernel families' sources and parity tests.
* The same baseline text gives the same kept, suppressed and stale sets
  in both packages; an entry without a justification is refused.
* The port's tree is clean under its baseline, every entry of which is
  used and justified; the CLI exits 0 on the repo and 1 when a finding
  is left unsuppressed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from horovod_tpu.analysis import findings as jfind
from horovod_tpu.analysis.lints import base as jbase
from horovod_tpu.analysis.lints.envreg import EnvRegistryRule as JEnv
from horovod_tpu.analysis.lints.legplan import \
    LegDerivationOutsidePlannerRule as JLeg
from horovod_tpu.analysis.lints.locks import UnlockedSharedStateRule as JLocks
from horovod_tpu_torch.analysis import findings as tfind
from horovod_tpu_torch.analysis.lints import base as tbase
from horovod_tpu_torch.analysis.lints import rule_catalogue, run_lints
from horovod_tpu_torch.analysis.lints.envreg import EnvRegistryRule as TEnv
from horovod_tpu_torch.analysis.lints.kernel_tests import \
    KernelParityTestRule
from horovod_tpu_torch.analysis.lints.legplan import \
    LegDerivationOutsidePlannerRule as TLeg
from horovod_tpu_torch.analysis.lints.locks import \
    UnlockedSharedStateRule as TLocks
from horovod_tpu_torch.analysis.lints.nondeterminism import \
    NondeterminismInStepRule
from horovod_tpu_torch.analysis.lints.planner import \
    CollectiveOutsidePlannerRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOCKS = {
    "worker.py": """
        import threading

        class Worker:
            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                self._count += 1
                self.total = self.total + 1

            def locked(self):
                with self._lock:
                    self._count += 1
                with self._cv:
                    self._waits += 1

            def nested(self):
                def inner():
                    self._n += 1
                return inner
        """,
    "plain.py": """
        import threading

        class Plain:
            def bump(self):
                self._count += 1
        """,
    "nothread.py": """
        class Runner:
            def start(self):
                self._t = Thread(target=self.run)

            def run(self):
                self._i += 1
        """,
}

LEGPLAN = {
    "exchange.py": """
        from .controller.fusion import ExchangeLeg, plan_exchange

        def bad():
            row = ExchangeLeg(tag="x", axis="", collective="psum",
                              codec="none", wire_dtype="float32",
                              elements=1, nbytes=4)
            note_leg("flat_ar")
            launch(buf, leg="zero_rs")
            return row

        def good(rec, plan):
            note_leg(plan.legs[0])
            rec.span("exchange", leg="host-label")
            rec.add("gap", 0.1, leg="host-label")
            launch(buf, leg=plan.legs[0].tag)
        """,
    "controller/fusion.py": """
        def _build():
            return [ExchangeLeg(tag="flat_ar")]
        """,
    "timeline/spans.py": """
        def normalize(rec):
            note_leg("ledger")
        """,
}

ENVREG = {
    "config.py": """
        import os

        def load():
            a = _env("DOCUMENTED")
            b = _env_int("UNDOCUMENTED", 3)
            c = os.environ.get("HOROVOD_PORT_ONLY")
            d = os.environ["HVD_TPU_LITERAL"]
            return a, b, c, d
        """,
}

API_MD = "| `HOROVOD_DOCUMENTED` | a knob |\n| `HOROVOD_LITERAL` | x |\n"
README = ("# Title\n\n| `HOROVOD_PORT_ONLY` | outside the port section |\n"
          "\n## PyTorch/CUDA port (`horovod_tpu_torch/`)\n\ntext\n\n"
          "| Variable | Meaning |\n|---|---|\n"
          "| `HOROVOD_PORT_ONLY` | the port's own |\n\n## Next\n")


def _tree(root, pkg, files, docs=None):
    """Write ``files`` under ``root/pkg`` (and ``docs``: repo-relative
    name -> text) and return the package dir."""
    for rel, src in files.items():
        path = root / pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    for rel, text in (docs or {}).items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return str(root / pkg)


def _keys(findings):
    return {(f.rule, f.ident, f.line) for f in findings}


def _both(tmp_path, files, jrule, trule, docs=None):
    jpkg = _tree(tmp_path / "j", "horovod_tpu", files, docs)
    tpkg = _tree(tmp_path / "t", "horovod_tpu_torch", files, docs)
    j = list(jrule.run(jbase.LintContext(pkg_dir=jpkg,
                                         repo_root=str(tmp_path / "j"))))
    t = list(trule.run(tbase.LintContext(pkg_dir=tpkg,
                                         repo_root=str(tmp_path / "t"))))
    return _keys(j), _keys(t)


def test_lock_rule_matches_jax_on_fixture_tree(tmp_path):
    j, t = _both(tmp_path, LOCKS, JLocks(), TLocks())
    assert t == j
    assert {ident for _, ident, _ in t} == {"Worker._run:_count"}


def test_legplan_rule_matches_jax_on_fixture_tree(tmp_path):
    """Both flag the hand-built row, the string ``note_leg`` and the
    string ``leg=`` in ``exchange.py``, and exempt each its own
    planner and span normalizer."""
    j, t = _both(tmp_path, LEGPLAN, JLeg(), TLeg())
    assert t == j
    assert sorted(ident.split(":")[0] for _, ident, _ in t) == \
        ["ExchangeLeg", "leg=", "note_leg"]


def test_envreg_rule_matches_jax_on_fixture_tree(tmp_path):
    """Without a README both flag exactly the undocumented names; the
    port's README table row (and only one inside its port section)
    documents ``HOROVOD_PORT_ONLY`` for the port rule alone."""
    docs = {"docs/api.md": API_MD}
    j, t = _both(tmp_path, ENVREG, JEnv(), TEnv(), docs)
    assert t == j
    assert {ident for _, ident, _ in t} == {"UNDOCUMENTED", "PORT_ONLY"}
    j, t = _both(tmp_path, ENVREG, JEnv(), TEnv(),
                 dict(docs, **{"README.md": README}))
    assert j - t == {("lint-undocumented-env", "PORT_ONLY", None)}
    assert {ident for _, ident, _ in t} == {"UNDOCUMENTED"}


def test_envreg_rule_needs_its_registry(tmp_path):
    j, t = _both(tmp_path, ENVREG, JEnv(), TEnv())
    assert t == j == {("lint-undocumented-env", "missing", None)}


# -- the idiom-bound rules ---------------------------------------------------

PLANNER_BAD = """
    import torch
    import torch.distributed as dist
    import torch.distributed as tdist
    from torch import distributed as d2
    from torch.distributed import all_gather_into_tensor as agit, ReduceOp

    def f(x, out, g):
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        tdist.broadcast(x, src=0)
        d2.reduce_scatter_tensor(out, x)
        torch.distributed.all_to_all_single(out, x)
        agit(out, x)
        ops = [dist.P2POp(dist.isend, x, 1)]
        dist.barrier()
        return dist.get_rank(), ReduceOp.SUM, ops
    """


def _ctx(tmp_path, pkg, files):
    return tbase.LintContext(pkg_dir=_tree(tmp_path, pkg, files),
                             repo_root=str(tmp_path))


def test_planner_rule_flags_raw_collectives_through_any_alias(tmp_path):
    ctx = _ctx(tmp_path, "horovod_tpu_torch", {"feature.py": PLANNER_BAD})
    found = sorted(f.ident.split(":")[0] for f in
                   CollectiveOutsidePlannerRule().run(ctx))
    assert found == ["dist.all_gather_into_tensor", "dist.all_reduce",
                     "dist.all_to_all_single", "dist.broadcast",
                     "dist.isend", "dist.reduce_scatter_tensor"]


def test_planner_rule_exempts_the_exchange_layer(tmp_path):
    ctx = _ctx(tmp_path, "horovod_tpu_torch",
               {"collectives/ops.py": PLANNER_BAD,
                "adasum/vhdd.py": PLANNER_BAD})
    assert not list(CollectiveOutsidePlannerRule().run(ctx))


NONDET = """
    import random
    import time

    import numpy as np
    import torch

    def window(x):
        return x + helper()

    def helper():
        return time.perf_counter()

    def compiled(x):
        return x * np.random.rand()

    def host_only(x):
        return time.time() + random.random()

    def capture(graph, x, gen):
        t0 = time.time()
        with torch.cuda.graph(graph):
            y = window(x) + time.monotonic()
            z = torch.rand(3, generator=gen)
        return y, z, t0

    fast = torch.compile(compiled)
    """


def test_nondeterminism_rule_flags_captured_and_compiled_reads(tmp_path):
    """Inside the graph block and in what it calls by name, and in a
    ``torch.compile``d function: flagged; the host's own reads before
    the capture and in a function nothing captures: not; a generator
    draw: not."""
    ctx = _ctx(tmp_path, "horovod_tpu_torch", {"step.py": NONDET})
    found = {f.ident.split(":")[0]: f.message for f in
             NondeterminismInStepRule().run(ctx)}
    block = 1 + textwrap.dedent(NONDET).splitlines().index(
        "    with torch.cuda.graph(graph):")
    assert sorted(found) == ["compiled", f"graph@{block}", "helper"]
    assert "wall-clock" in found[f"graph@{block}"]
    assert "host RNG" in found["compiled"]


def test_nondeterminism_rule_on_the_port_tree_sees_the_train_loop():
    """The rule reaches the port's one capture (``TrainLoop._capture``'s
    graph block) and the functions it runs, and finds nothing there."""
    from horovod_tpu_torch.analysis.lints.nondeterminism import \
        captured_regions
    ctx = tbase.LintContext()
    sf = next(s for s in ctx.files
              if s.relpath == "horovod_tpu_torch/training.py")
    labels = [label for label, _ in captured_regions(sf.tree)]
    assert any(label.startswith("graph@") for label in labels)
    assert "_window" in labels
    assert not list(NondeterminismInStepRule().run(ctx))


REGISTRY = """
    KERNEL_CONTRACTS = {
        "mykern": {
            "source": "horovod_tpu_torch/ops/csrc/mykern.cu",
            "site": "ops.mykern.launch_it (the wrapper)",
        },
    }
    """


def test_kernel_rule_flags_a_family_without_its_test(tmp_path):
    pkg = _tree(tmp_path, "horovod_tpu_torch",
                {"ops/registry.py": REGISTRY, "ops/mykern.py": "x = 1\n",
                 "ops/csrc/mykern.cu": "// kernel\n"})
    ctx = tbase.LintContext(pkg_dir=pkg, repo_root=str(tmp_path))
    rule = KernelParityTestRule()
    found = list(rule.run(ctx))
    assert [f.ident for f in found] == ["mykern"]
    tests = tmp_path / "tests"
    tests.mkdir()
    # A name-matching file that never imports the wrapper does not count,
    # nor does one importing the JAX module of that name.
    (tests / "test_torch_mykern.py").write_text(
        "from horovod_tpu.ops import mykern\n")
    assert [f.ident for f in rule.run(ctx)] == ["mykern"]
    (tests / "test_torch_mykern.py").write_text(
        "from horovod_tpu_torch.ops import registry, mykern as k\n")
    assert not list(rule.run(ctx))
    # A source no family names, and a family whose source is missing.
    (tmp_path / "horovod_tpu_torch/ops/csrc/stray.cu").write_text("//\n")
    os.remove(tmp_path / "horovod_tpu_torch/ops/csrc/mykern.cu")
    assert sorted(f.ident for f in rule.run(ctx)) == \
        ["mykern:source", "stray.cu:unnamed"]


# -- baseline semantics ------------------------------------------------------

BASELINE = ("rule-a pkg/a.py ident-1  # accepted because reasons\n"
            "rule-a pkg/a.py *  # any other ident of rule-a in a.py\n"
            "rule-b pkg/b.py *  # never matches anything\n")


def _finding(mod, rule, path, ident):
    return mod.Finding(rule=rule, severity="error", path=path, ident=ident,
                       message="m")


@pytest.mark.parametrize("text", [BASELINE, "", "# only a comment\n"])
def test_baseline_splits_findings_as_jax(tmp_path, text):
    p = tmp_path / "baseline.txt"
    p.write_text(text)
    out = []
    for mod in (jfind, tfind):
        fs = [_finding(mod, "rule-a", "pkg/a.py", "ident-1"),
              _finding(mod, "rule-a", "pkg/a.py", "ident-2"),
              _finding(mod, "rule-c", "pkg/c.py", "x")]
        kept, suppressed = mod.apply_baseline(fs, mod.load_baseline(str(p)),
                                              baseline_path="b.txt")
        out.append(([(f.rule, f.path, f.ident, f.line) for f in kept],
                    [f.key() for f in suppressed]))
    assert out[1] == out[0]


@pytest.mark.parametrize("line", ["some-rule some/path some-ident\n",
                                  "some-rule some/path some-ident  #\n",
                                  "too few  # fields\n"])
def test_baseline_entry_without_justification_is_refused(tmp_path, line):
    p = tmp_path / "baseline.txt"
    p.write_text(line)
    for mod in (jfind, tfind):
        with pytest.raises(ValueError, match="justification"):
            mod.load_baseline(str(p))


# -- the port's tree and the CLI ---------------------------------------------

def test_port_tree_lints_clean_under_its_baseline():
    findings = run_lints()
    baseline = tfind.load_baseline()
    kept, suppressed = tfind.apply_baseline(findings, baseline)
    assert not kept, "\n".join(f.render() for f in kept)   # none stale
    assert len(suppressed) == len(baseline) == 4
    assert all(e.justification for e in baseline)
    assert tfind.default_baseline_path().endswith(
        os.path.join("horovod_tpu_torch", "analysis", "baseline.txt"))
    assert set(rule_catalogue()) == {
        "lint-unlocked-shared-state", "lint-nondeterminism-in-step",
        "lint-collective-outside-planner",
        "lint-leg-derivation-outside-planner", "lint-undocumented-env",
        "lint-kernel-needs-parity-test"}


def _cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_all_exits_zero_on_the_repo():
    proc = _cli("--all", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("analysis: 0 error(s),") and \
        last.endswith("4 baseline-suppressed"), last
    assert proc.stdout.count("-- OK") == 13


def test_cli_step_audit_defaults_to_cuda_and_raises_without_it(
        monkeypatch, capsys):
    """Without ``--device`` the step audit asks for ``cuda``, as
    ``init()`` does: with no GPU it raises before auditing anything,
    never quietly on the CPU."""
    from horovod_tpu_torch.analysis import __main__ as cli
    from horovod_tpu_torch.analysis import trace_audit
    monkeypatch.delenv("HVD_TPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audited = []
    monkeypatch.setattr(trace_audit, "audit_step",
                        lambda *a, **kw: audited.append(kw))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--step-audit"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
    assert not audited
    assert "audit step:" not in capsys.readouterr().out


def test_cli_exits_one_with_a_finding_left_unsuppressed(tmp_path):
    """The real tree against a baseline suppressing nothing: the raw
    lockstep collectives and the lock findings remain -- exit 1; a
    malformed baseline: exit 2."""
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    proc = _cli("--lint", "--baseline", str(empty))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "lint-collective-outside-planner" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == \
        "analysis: 4 error(s), 0 warning(s), 0 baseline-suppressed"
    bad = tmp_path / "bad.txt"
    bad.write_text("rule path ident\n")
    assert _cli("--lint", "--baseline", str(bad)).returncode == 2
