"""PyTorch/CUDA port: ``horovod_tpu_torch.examples.serving_probe`` against
the JAX repository's ``examples/serving_probe.py``.

* The JAX script's default drill (its 8-device tensor-parallel mesh, 12
  requests of ``LLAMA_SERVE``) and the port's at world 2 under ``python
  -m horovod_tpu_torch.run -np 2 --cpu`` (tp 2 over gloo), on the same
  seeded load: every request completes in both, the scraped
  request-lifecycle lines are equal (submitted, admitted, completed;
  prefill and decode tokens), the same prefill dispatches and in-step
  collective legs are attributed (the decode steps a load takes follow
  the host's timing; the probe holds the decode leg's count to its own
  report's steps, and every family to the engine's report).
* ``--long-prompts`` at world 2: chunked prefill of the 512/2048/4096
  mixture; both ``serving_prefill`` and ``serving_prefill_chunk`` legs
  fire (the probe checks), and the prefill tokens scraped equal the
  prompt lengths the JAX package's ``long_prompt_spec`` draws for the
  same load.
* ``SERVING_FAMILIES`` and :func:`check_serving_metrics` on a scrape
  that lacks a family or miscounts a request.
"""

import json
import re

from _jax_examples import run_jax_example, run_port
from horovod_tpu_torch.examples import serving_probe

REQUESTS = 12


def _clean(out: str) -> list:
    return [re.sub(r"^\[\d+\]<std(out|err)>", "", ln).rstrip()
            for ln in out.splitlines()]


def _serving_lines(lines) -> list:
    return sorted(ln.strip() for ln in lines if ln.strip().startswith((
        "horovod_serving_requests_total", "horovod_serving_tokens_total")))


def _legs_line(lines) -> str:
    """The span-legs line, its decode step count masked: the steps a
    load takes follow the host's timing (arrivals join between
    steps)."""
    (ln,) = [ln for ln in lines if ln.startswith("span legs attributed")]
    return re.sub(r"serving_decode \(\d+ steps\)", "serving_decode (N steps)",
                  ln)


def test_serving_probe_matches_the_jax_script(tmp_path):
    jax_out, _ = run_jax_example("serving_probe",
                                 ["--requests", str(REQUESTS)], tmp_path)
    rc, out = run_port("serving_probe", ["--requests", str(REQUESTS)],
                       tmp_path, launcher_np=2)
    assert rc == 0, out
    jl, pl = _clean(jax_out), _clean(out)
    assert "serving probe OK" in jax_out
    assert "serving probe OK" in out and "world 2)" in out
    assert f"served {REQUESTS}/{REQUESTS} requests" in out
    assert _serving_lines(pl) == _serving_lines(jl)
    assert len(_serving_lines(pl)) == 5
    # The same dispatches; the in-step legs are 2 a layer.
    assert _legs_line(pl) == _legs_line(jl)


def test_serving_probe_long_prompts_at_world_two(tmp_path):
    from horovod_tpu.serving.loadgen import generate, long_prompt_spec
    rc, out = run_port("serving_probe", ["--long-prompts", "--requests",
                                         "4", "--json",
                                         str(tmp_path / "report.json")],
                       tmp_path, launcher_np=2)
    assert rc == 0, out
    assert "serving probe OK" in out and "served 4/4 requests" in out
    reqs = generate(long_prompt_spec(num_requests=4, rate_rps=2.0,
                                     vocab_size=256, seed=11))
    want = sum(len(r.prompt) for r in reqs)
    assert f'horovod_serving_tokens_total{{phase="prefill"}} {want}' in out
    with open(tmp_path / "report.json") as f:
        report = json.load(f)
    assert (report["world"], report["completed"]) == (2, 4)
    assert report["prompt_tokens"] == want and report["prefill_chunks"] > 0
    assert any(len(r.prompt) > 512 for r in reqs)   # a chunked admission


def test_check_serving_metrics_flags_what_disagrees():
    class Rep:
        num_requests = completed = 2
        prompt_tokens, new_tokens = 10, 6

    fams = "".join(f"# TYPE {f} counter\n"
                   for f in serving_probe.SERVING_FAMILIES)
    after = fams + (
        'horovod_serving_requests_total{event="submitted"} 2\n'
        'horovod_serving_requests_total{event="admitted"} 2\n'
        'horovod_serving_requests_total{event="completed"} 2\n'
        'horovod_serving_tokens_total{phase="prefill"} 10\n'
        'horovod_serving_tokens_total{phase="decode"} 6\n'
        "horovod_serving_ttft_seconds_count 2\n"
        'horovod_serving_token_latency_seconds_bucket{le="1"} 4\n'
        "horovod_serving_token_latency_seconds_count 4\n")
    assert serving_probe.check_serving_metrics("", after, Rep) == []
    short = after.replace("# TYPE horovod_serving_queue_depth counter\n", "")
    assert serving_probe.check_serving_metrics("", short, Rep) == [
        "horovod_serving_queue_depth absent"]
    # A scrape before the serve is subtracted: a request left over from
    # an earlier load is not this one's.
    before = 'horovod_serving_requests_total{event="completed"} 1\n'
    fails = serving_probe.check_serving_metrics(before, after, Rep)
    assert fails == ['horovod_serving_requests_total{event="completed"}: '
                     '1.0 != 2']
