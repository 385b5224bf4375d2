"""PyTorch/CUDA port: the launcher's host code (``horovod_tpu_torch/run``)
against the JAX package's.

Each pure function gets the same inputs in both packages and must give
the same answer: the HMAC digests (``secret.py``), the retry schedules,
budgets and refusals (``retry.py``, with the sleeps recorded), the host
grammar (``hosts.py``: ``-H``, hostfiles, IPv6, lenient discovery lines,
errors), the tagged output and first-failure supervision
(``exec_util.py``), and the KV rendezvous (``http_kv.py``: round trips,
the per-job secret, the clock-skew window, a server blackout, a chaos
blackout on the client, chunked objects) -- with each package's client
talking to the other's server.  Then the launcher's CLI (``launch.py``):
the worker environment, the refusals of what is not ported, the build
report, ``--explain-plan`` beside the JAX one, and real runs of
``python -m horovod_tpu_torch.run -np 2 --cpu`` (gloo): an allreduce, a
failing worker's exit code, ``-H localhost:2``, and a peer killed in the
middle of a collective, whose survivor's torch exception the elastic
classifier must call a recoverable comm failure.
"""

import io
import os
import random
import subprocess
import sys
import time

import pytest

from horovod_tpu.run import exec_util as jexec
from horovod_tpu.run import hosts as jhosts
from horovod_tpu.run import http_kv as jkv
from horovod_tpu.run import retry as jretry
from horovod_tpu.run import secret as jsecret
from horovod_tpu_torch.elastic import chaos
from horovod_tpu_torch.run import exec_util as texec
from horovod_tpu_torch.run import hosts as thosts
from horovod_tpu_torch.run import http_kv as tkv
from horovod_tpu_torch.run import launch as tlaunch
from horovod_tpu_torch.run import retry as tretry
from horovod_tpu_torch.run import secret as tsecret

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HVD_TPU_RENDEZVOUS_FILE", "HOROVOD_CHAOS",
                 "HVD_TPU_CHAOS")


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    yield
    chaos.reset()


def _env():
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


# ---------------------------------------------------------------------------
# secret.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [b"", b"payload", bytes(range(256)),
                                     b"PUT\n/kv/s/k\n123.5\nvalue"])
def test_secret_digest_equals_jax(payload):
    key = tsecret.make_secret_key()
    assert len(key) == 64 and int(key, 16) >= 0
    d = tsecret.compute_digest(key, payload)
    assert d == jsecret.compute_digest(key, payload)
    assert tsecret.check_digest(key, payload, d)
    assert jsecret.check_digest(key, payload, d)
    assert not tsecret.check_digest(key, payload + b"x", d)
    assert not tsecret.check_digest(tsecret.make_secret_key(), payload, d)
    assert tsecret.SECRET_ENV == jsecret.SECRET_ENV


# ---------------------------------------------------------------------------
# retry.py
# ---------------------------------------------------------------------------

POLICIES = {
    "default": {},
    "flat": dict(retries=5, backoff_ms=100.0, multiplier=1.0, jitter=0.0),
    "capped": dict(retries=8, backoff_ms=100.0, multiplier=2.0,
                   max_backoff_ms=300.0, jitter=0.0),
    "jitter": dict(retries=6, backoff_ms=20.0, jitter=0.5),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_retry_delay_schedule_equals_jax(name):
    tp = tretry.RetryPolicy(**POLICIES[name])
    jp = jretry.RetryPolicy(**POLICIES[name])
    rt, rj = random.Random(5), random.Random(5)
    for attempt in range(10):
        assert tp.delay_s(attempt, rt) == jp.delay_s(attempt, rj)


def test_retry_policy_from_env_equals_jax(monkeypatch):
    assert tretry.RetryPolicy.from_env() == tretry.RetryPolicy()
    monkeypatch.setenv("HOROVOD_KV_RETRIES", "7")
    monkeypatch.setenv("HOROVOD_KV_BACKOFF_MS", "10")
    t, j = tretry.RetryPolicy.from_env(), jretry.RetryPolicy.from_env()
    assert (t.retries, t.backoff_ms) == (j.retries, j.backoff_ms) == (7, 10.0)
    monkeypatch.setenv("HVD_TPU_KV_RETRIES", "2")   # the override wins
    assert tretry.RetryPolicy.from_env().retries == 2


def _sleeps(mod, fail_times, policy_kw, **kw):
    """The sleeps and the outcome of ``call_with_retries`` over a call
    failing ``fail_times`` times."""
    sleeps, calls = [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise ConnectionError("transient")
        return "ok"

    try:
        out = mod.call_with_retries(flaky, policy=mod.RetryPolicy(
            **policy_kw), sleep=sleeps.append, rng=random.Random(1), **kw)
    except ConnectionError as e:
        out = f"raised {e}"
    return out, sleeps, calls["n"]


@pytest.mark.parametrize("fails", [0, 2, 3, 10])
@pytest.mark.parametrize("budget", [None, 0.35])
def test_call_with_retries_equals_jax(fails, budget):
    kw = dict(retries=10, backoff_ms=100.0, multiplier=1.0, jitter=0.0,
              budget_s=budget)
    assert _sleeps(tretry, fails, kw) == _sleeps(jretry, fails, kw)


def test_call_with_retries_no_retry_wins():
    class AuthLike(ConnectionError):
        pass

    for mod in (tretry, jretry):
        sleeps = []
        with pytest.raises(AuthLike):
            mod.call_with_retries(
                lambda: (_ for _ in ()).throw(AuthLike("403")),
                policy=mod.RetryPolicy(retries=3, backoff_ms=10.0),
                no_retry=(AuthLike,), sleep=sleeps.append)
        assert sleeps == []


def test_retries_are_counted():
    from horovod_tpu_torch.timeline import metrics as tm
    c = tm.registry().counter("horovod_kv_retries_total")
    before = c.value
    _sleeps(tretry, 2, dict(retries=3, backoff_ms=1.0, jitter=0.0))
    assert c.value == before + 2


# ---------------------------------------------------------------------------
# hosts.py
# ---------------------------------------------------------------------------

def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


SPECS = ["h1:4, h2:2,h3", "localhost", "h1:x", ":4", "::1", "[::1]:2",
         "[2001:db8::2]:4", "[]:2", "[::1]x", "h:0", "h:-2", ",,", "a,b:3"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_host_spec_equals_jax(spec):
    assert _outcome(thosts.parse_host_spec, spec) == \
        _outcome(jhosts.parse_host_spec, spec)


LINES = ["host:4", "host", "::1", "[::1]", "[::1]:8", "host:gpu", "host:0",
         "[]", "[::1]:x", ":3"]


@pytest.mark.parametrize("item", LINES)
@pytest.mark.parametrize("strict", [False, True])
def test_split_host_slots_equals_jax(item, strict):
    assert _outcome(thosts.split_host_slots, item, 2, strict) == \
        _outcome(jhosts.split_host_slots, item, 2, strict)


@pytest.mark.parametrize("text", [
    "# cluster\nnode1 slots=4\nnode2:2\nnode3\n", "node1:0\n",
    "node1 slots=-3\n", "node1:x\n", "# only a comment\n"])
def test_parse_hostfile_equals_jax(tmp_path, text):
    hf = tmp_path / "hosts"
    hf.write_text(text)
    assert _outcome(thosts.parse_hostfile, str(hf)) == \
        _outcome(jhosts.parse_hostfile, str(hf))


def test_total_slots_and_all_local_equal_jax():
    for hs in ([("localhost", 2), ("127.0.0.1", 1)], [("::1", 2)],
               [("localhost", 2), ("farawaynode", 1)]):
        assert thosts.all_local(hs) == jhosts.all_local(hs)
        assert thosts.total_slots(hs) == jhosts.total_slots(hs)


# ---------------------------------------------------------------------------
# exec_util.py
# ---------------------------------------------------------------------------

def _tagged_lines(mod, code: str, tag: bool = True):
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        p = mod.TaggedProcess(3, [sys.executable, "-c", code],
                              dict(os.environ), tag=tag)
        code_ = p.wait(timeout=60)
    finally:
        sys.stdout, sys.stderr = saved
    return code_, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("tag", [True, False])
def test_tagged_output_equals_jax(tag):
    code = ("import sys; print('one'); print('two'); "
            "print('err', file=sys.stderr); sys.exit(4)")
    got = _tagged_lines(texec, code, tag)
    assert got == _tagged_lines(jexec, code, tag)
    assert got[0] == 4
    if tag:
        assert got[1] == "[3]<stdout>one\n[3]<stdout>two\n"
        assert got[2] == "[3]<stderr>err\n"


def test_wait_all_returns_first_failure_and_stops_the_rest():
    for mod in (texec, jexec):
        procs = [mod.TaggedProcess(r, [sys.executable, "-c", c],
                                   dict(os.environ))
                 for r, c in enumerate(["import sys; sys.exit(3)",
                                        "import time; time.sleep(60)"])]
        t0 = time.monotonic()
        assert mod.wait_all(procs, term_grace_s=5.0) == 3
        assert time.monotonic() - t0 < 30
        assert all(p.poll() is not None for p in procs)


# ---------------------------------------------------------------------------
# http_kv.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server,client", [(tkv, tkv), (tkv, jkv),
                                           (jkv, tkv)])
def test_kv_roundtrip_auth_and_skew(server, client):
    secret = tsecret.make_secret_key()
    srv = server.RendezvousServer(secret, host="127.0.0.1")
    try:
        kv = client.KVClient("127.0.0.1", srv.port, secret)
        assert kv.get("s", "k") is None
        kv.put("s", "k", b"value-1")
        assert kv.get("s", "k") == b"value-1"
        kv.delete("s", "k")
        assert kv.get("s", "k") is None
        bad = client.KVClient("127.0.0.1", srv.port,
                              tsecret.make_secret_key())
        with pytest.raises(client.RendezvousAuthError, match="secret"):
            bad.put("s", "k", b"evil")
        assert not issubclass(client.RendezvousAuthError, ConnectionError)
        # A valid signature over a stale timestamp is a replay: 403.
        from urllib.error import HTTPError
        from urllib.request import Request, urlopen
        old = repr(time.time() - 3600)
        path = "/kv/s/k2"
        sig = tsecret.compute_digest(
            secret, tkv._signable("PUT", path, old, b"replayed"))
        req = Request(f"http://127.0.0.1:{srv.port}{path}",
                      data=b"replayed", method="PUT",
                      headers={tkv.SIG_HEADER: sig, tkv.TS_HEADER: old})
        with pytest.raises(HTTPError) as ei:
            urlopen(req, timeout=5)
        assert ei.value.code == 403
        assert abs(kv.server_time() - time.time()) < 60
    finally:
        srv.stop()


def test_kv_wire_format_equals_jax():
    assert (tkv.SIG_HEADER, tkv.TS_HEADER, tkv.MAX_SKEW_S) == \
        (jkv.SIG_HEADER, jkv.TS_HEADER, jkv.MAX_SKEW_S)
    for args in (("PUT", "/kv/a/b", "1.5", b"v"), ("GET", "/time", "2", b"")):
        assert tkv._signable(*args) == jkv._signable(*args)


def test_kv_client_rides_out_server_blackout():
    secret = tsecret.make_secret_key()
    srv = tkv.RendezvousServer(secret, host="127.0.0.1")
    try:
        policy = tretry.RetryPolicy(retries=20, backoff_ms=50.0,
                                    multiplier=1.5, max_backoff_ms=200.0,
                                    jitter=0.0)
        kv = tkv.KVClient("127.0.0.1", srv.port, secret,
                          retry_policy=policy)
        srv.blackout(0.4)
        kv.put("s", "k", b"survived")
        assert kv.get("s", "k") == b"survived"
        bad = tkv.KVClient("127.0.0.1", srv.port, tsecret.make_secret_key(),
                           retry_policy=tretry.RetryPolicy(
                               retries=20, backoff_ms=500.0))
        t0 = time.monotonic()
        with pytest.raises(tkv.RendezvousAuthError):
            bad.get("s", "k")
        assert time.monotonic() - t0 < 1.0   # never retried
    finally:
        srv.stop()


def test_kv_client_fails_client_side_during_chaos_blackout():
    secret = tsecret.make_secret_key()
    srv = tkv.RendezvousServer(secret, host="127.0.0.1")
    try:
        inj = chaos.install("kv_blackout@step=1,secs=0.3", rank=0, size=1)
        inj.on_step(1)
        no_retry = tkv.KVClient("127.0.0.1", srv.port, secret,
                                retry_policy=tretry.RetryPolicy(retries=0))
        with pytest.raises(ConnectionError, match="chaos KV blackout"):
            no_retry.put("s", "k", b"v")
        patient = tkv.KVClient(
            "127.0.0.1", srv.port, secret,
            retry_policy=tretry.RetryPolicy(retries=20, backoff_ms=50.0,
                                            multiplier=1.5,
                                            max_backoff_ms=200.0,
                                            jitter=0.0))
        patient.put("s", "k", b"v")
        assert patient.get("s", "k") == b"v"
    finally:
        srv.stop()


def test_kv_chunked_object_crosses_packages():
    secret = tsecret.make_secret_key()
    srv = tkv.RendezvousServer(secret, host="127.0.0.1")
    try:
        t = tkv.KVClient("127.0.0.1", srv.port, secret)
        j = jkv.KVClient("127.0.0.1", srv.port, secret)
        value = bytes(range(256)) * 1021
        parts = t.put_large("pages", "obj", value, chunk_bytes=50_000)
        assert parts == -(-len(value) // 50_000)
        assert j.get_large("pages", "obj") == value
        assert t.get("pages", "obj") == j.get("pages", "obj")
        t.put("pages", "obj.part1", b"X" * 50_000)
        with pytest.raises(ValueError, match="hash mismatch"):
            t.get_large("pages", "obj")
        t.delete_large("pages", "obj")
        assert t.get("pages", "obj") is None
        assert t.get_large("pages", "missing") is None
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# launch.py
# ---------------------------------------------------------------------------

def test_worker_env_contents():
    env = tlaunch.worker_env(rank=1, size=4, coordinator="127.0.0.1",
                             port=1234, cpu=True, store="/tmp/x/store")
    assert env["HOROVOD_RANK"] == "1" and env["HOROVOD_SIZE"] == "4"
    assert env["MASTER_ADDR"] == "127.0.0.1"
    assert env["MASTER_PORT"] == env["HVD_TPU_COORDINATOR_PORT"] == "1234"
    assert env["HVD_TPU_FORCE_CPU"] == "1"
    assert env["HVD_TPU_RENDEZVOUS_FILE"] == "/tmp/x/store"
    gpu = tlaunch.worker_env(rank=0, size=1, coordinator="h", port=1,
                             cpu=False)
    assert "HVD_TPU_FORCE_CPU" not in gpu
    assert "HVD_TPU_RENDEZVOUS_FILE" not in gpu


def test_force_cpu_only_when_asked(monkeypatch):
    import torch

    from horovod_tpu_torch.core.device import resolve_device
    monkeypatch.delenv("HVD_TPU_FORCE_CPU", raising=False)
    monkeypatch.delenv("HOROVOD_FORCE_CPU", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    monkeypatch.setenv("HVD_TPU_FORCE_CPU", "1")
    assert resolve_device(None) == torch.device("cpu")


def test_cli_usage_errors():
    for argv in (["-np", "2"],                          # no command
                 ["-H", "remote1:4", "python", "x.py"],  # remote host
                 ["-H", "localhost:x", "python", "x.py"],
                 ["-H", "localhost:2", "--host-discovery-script", "d.sh",
                  "python", "x.py"]):
        with pytest.raises(SystemExit):
            tlaunch.run_command(argv)


@pytest.mark.parametrize("flag", [["--timeline-filename", "t.json"],
                                  ["--autotune"], ["--probe"]])
def test_cli_refuses_what_is_not_ported(flag):
    with pytest.raises(NotImplementedError, match="1.11"):
        tlaunch.run_command(["-np", "1", *flag, "true"])


def test_cli_refuses_lsf_without_np(monkeypatch):
    monkeypatch.setenv("LSB_JOBID", "42")
    with pytest.raises(NotImplementedError, match="LSF"):
        tlaunch.run_command(["true"])


def test_check_build_lists_the_port():
    text = tlaunch.check_build()
    for want in ("horovod_tpu_torch", "torch ", "gloo", "NCCL", "elastic",
                 "bn_bwd.cu", "fused_update.cu", "flash_fwd.cu"):
        assert want in text


@pytest.mark.parametrize("comp", [None, "fp16", "topk:0.25"])
def test_explain_plan_cli_equals_jax(monkeypatch, comp):
    """The same buckets, bytes, codec and fuse keys as the JAX launcher's
    table; only the fence column differs (the port's exchange has no
    mesh fence: its cell is empty)."""
    from horovod_tpu.run.launch import explain_plan_cli
    if comp:
        monkeypatch.setenv("HOROVOD_COMPRESSION", comp)
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(4 << 20))
    got = tlaunch.explain_plan_cli().splitlines()
    want = explain_plan_cli().splitlines()
    assert len(got) == len(want) > 4
    assert got[0] == want[0] and got[-1] == want[-1]
    assert got[1].split() == want[1].split()
    fence = want[1].split().index("fence")
    for g, w in zip(got[3:-1], want[3:-1]):
        w = w.split()
        assert g.split() == w[:fence] + w[fence + 1:]


_ALLREDUCE = """
import torch
import horovod_tpu_torch as hvd
hvd.init()
x = torch.full((3,), float(hvd.rank() + 1))
y = hvd.allreduce(x, op=hvd.Sum)
assert y.tolist() == [float(sum(range(1, hvd.size() + 1)))] * 3, y
hvd.barrier()
print(f"rank {hvd.rank()}/{hvd.size()} on {hvd.core.state.global_state().device}: allreduce OK", flush=True)
hvd.shutdown()
"""


@pytest.mark.integration
@pytest.mark.parametrize("how", [["-np", "2"], ["-H", "localhost:2"]])
def test_static_run_two_workers(tmp_path, how):
    script = tmp_path / "ar.py"
    script.write_text(_ALLREDUCE)
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", *how, "--cpu",
         sys.executable, str(script)],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for r in range(2):
        assert f"[{r}]<stdout>rank {r}/2 on cpu: allreduce OK" in out.stdout


@pytest.mark.integration
def test_failing_worker_propagates_exit_code(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--cpu",
         sys.executable, str(bad)],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 3


_PEER_DEATH = """
import os, sys, time, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.elastic.run_loop import _looks_like_comm_failure
hvd.init()
x = torch.ones(1 << 16)
hvd.allreduce(x)
if hvd.rank() == 1:
    os._exit(0)     # a clean exit: the launcher leaves rank 0 running
time.sleep(1.0)
try:
    for _ in range(50):
        hvd.allreduce(x)
    print("NOERROR", flush=True)
except Exception as e:
    print(f"ERROR {type(e).__name__}: {str(e)[:300]!r}", flush=True)
    print(f"CLASS={_looks_like_comm_failure(e)}", flush=True)
    os._exit(0)
"""


@pytest.mark.integration
def test_peer_death_error_is_a_comm_failure(tmp_path):
    """A peer killed between collectives: the survivor's exception, as
    torch raises it on gloo, classifies as a recoverable comm failure."""
    script = tmp_path / "peer_death.py"
    script.write_text(_PEER_DEATH)
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--cpu",
         sys.executable, str(script)],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    text = out.stdout + out.stderr
    assert "CLASS=True" in text, text[-4000:]
    assert "NOERROR" not in text, text[-4000:]


def test_kv_heartbeat_writer_and_driver_age():
    from horovod_tpu_torch.core.stall import KVHeartbeatWriter
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    secret = tsecret.make_secret_key()
    srv = tkv.RendezvousServer(secret, host="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{srv.port}"
        w = KVHeartbeatWriter(url, "w0", secret, interval_s=0.05)
        time.sleep(0.15)
        drv = ElasticDriver.__new__(ElasticDriver)
        drv._kv = tkv.KVClient("127.0.0.1", srv.port, secret)
        age = drv._kv_heartbeat_age("w0")
        assert age is not None and age < 5.0
        assert drv._kv_heartbeat_age("w-unknown") is None
        w.stop()
        assert drv._kv_heartbeat_age("w0") is None
    finally:
        srv.stop()


def test_notifier_reads_a_jax_drivers_document_over_http(monkeypatch):
    import json

    from horovod_tpu.elastic.notify import ASSIGNMENT_KEY as JKEY
    from horovod_tpu_torch.elastic.notify import ASSIGNMENT_KEY, Notifier
    assert ASSIGNMENT_KEY == JKEY
    secret = tsecret.make_secret_key()
    srv = jkv.RendezvousServer(secret, host="127.0.0.1")
    try:
        monkeypatch.setenv(tsecret.SECRET_ENV, secret)
        monkeypatch.delenv("HVD_TPU_ELASTIC_EPOCH", raising=False)
        n = Notifier(path=f"http://127.0.0.1:{srv.port}", worker_id="w0")
        assert n.enabled and n.read() is None
        doc = {"epoch": 3, "size": 2, "port": 1234, "ranks": {"w0": 0}}
        jkv.KVClient("127.0.0.1", srv.port, secret).put(
            *JKEY, json.dumps(doc).encode())
        got = n.updated()
        assert got == doc
        n.accept(got)
        assert n.updated() is None
    finally:
        srv.stop()
