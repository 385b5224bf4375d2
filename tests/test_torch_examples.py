"""PyTorch/CUDA port: the Horovod PyTorch examples in the package
(``horovod_tpu_torch/examples``), against one process and the JAX
package's shim.

* ``pytorch_mnist``'s training loop (``train``, eight steps) in a gloo
  world of 2 (this file, run as a script, is each rank; a ``FileStore``
  under pytest's temporary directory) with ``--compression none``: the
  loss curve and the final weights equal one
  process training the same ``Net`` with plain ``SGD(0.05, momentum
  0.9)`` on the two ranks' batches concatenated (the Average of two
  equal halves' mean gradients is the whole batch's), losses within
  1e-5 relative, weights within 1e-5 absolute.
* ``pytorch_mnist`` at world 1 with fp16 compression (the example's
  default) against the JAX repository's shim (``horovod_tpu.torch_api``
  on a one-device mesh) running the JAX example's ``Net`` from the same
  seed through the same loop: the same five losses and final weights
  within 1e-6 (ROADMAP item 1.4's parity point).
* The script's ``main()`` at world 1 with its defaults (30 steps, fp16)
  passes its final-loss check; two steps fail it.
* ``torch_resnet50`` runs two steps on the CPU at 64 x 64, batch 4,
  through the sync-BN layer's plain path: 53 ``SyncBatchNorm`` sites,
  25,557,032 parameters in 161 tensors, finite losses.
* ``llama_lora`` on the CPU: two steps on ``LLAMA_TINY``, the same with
  ``--8b``'s layout (the int8 frozen base and remat) on the tiny config,
  and ``--serve-adapters 3``; each prints the JAX example's messages.
* ``bert_pretrain --tp 2`` and ``long_context --sp 2`` (ring; Ulysses
  packed) through ``python -m horovod_tpu_torch.run -np 2 --cpu`` at tiny
  sizes: a falling loss, the full-tree checkpoint, the first step's
  parity with one process.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as thvd
from horovod_tpu_torch.examples import (llama_lora, pytorch_mnist,
                                        torch_resnet50)
from horovod_tpu_torch.models import LLAMA_TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
WORLD2_STEPS = 8
SHIM_STEPS = 5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
SHIM_TOL = 1e-6


def _worker(rank: int, world: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    run = pytorch_mnist.train(pytorch_mnist.parse_args(
        ["--device", "cpu", "--compression", "none",
         "--steps", str(WORLD2_STEPS)]))
    torch.save({"losses": run.losses,
                "params": {k: v.detach().clone()
                           for k, v in run.model.state_dict().items()}},
               out)
    thvd.shutdown()


def _run_world(tmp, world):
    store = str(tmp / "store")
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), store,
         str(tmp / f"r{r}.pt")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {r: torch.load(tmp / f"r{r}.pt", weights_only=False)
            for r in range(world)}


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def _one_process_on_both_batches(steps, batch_size=64):
    torch.manual_seed(42)
    model = pytorch_mnist.Net()
    sgd = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    centers = pytorch_mnist.class_centers()
    losses = []
    for step in range(steps):
        parts = [pytorch_mnist.synthetic_batch(centers, step, r, batch_size)
                 for r in range(2)]
        x, y = (torch.from_numpy(np.concatenate(p)) for p in zip(*parts))
        sgd.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        sgd.step()
        losses.append(loss.item())
    return losses, model.state_dict()


def test_pytorch_mnist_world_of_two_equals_one_process(tmp_path):
    got = _run_world(tmp_path, 2)
    want_losses, want_params = _one_process_on_both_batches(WORLD2_STEPS)
    for r in range(2):
        np.testing.assert_allclose(got[r]["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        for k, v in want_params.items():
            np.testing.assert_allclose(got[r]["params"][k].numpy(),
                                       v.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)


def _jax_example_net():
    """The JAX repository's ``examples/pytorch_mnist.py`` ``Net``."""
    spec = importlib.util.spec_from_file_location(
        "jax_pytorch_mnist", os.path.join(REPO, "examples",
                                          "pytorch_mnist.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Net


def _shim_run(steps):
    """The example's loop through ``horovod_tpu.torch_api`` on one
    device: ``(losses, final state_dict)``."""
    import horovod_tpu as jhvd
    import horovod_tpu.torch_api as shvd
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    try:
        torch.manual_seed(42)
        model = _jax_example_net()()
        opt = shvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=shvd.Compression.fp16)
        shvd.broadcast_parameters(model.state_dict(), root_rank=0)
        shvd.broadcast_optimizer_state(opt, root_rank=0)
        centers = pytorch_mnist.class_centers()
        losses = []
        for step in range(steps):
            opt.zero_grad()
            x, y = (torch.from_numpy(a) for a in pytorch_mnist
                    .synthetic_batch(centers, step, 0, 64))
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            losses.append(float(shvd.allreduce(loss.detach(), name="loss")))
        return losses, {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
    finally:
        jhvd.shutdown()


def test_pytorch_mnist_world_of_one_matches_the_jax_shim(world1):
    want_losses, want_params = _shim_run(SHIM_STEPS)
    run = pytorch_mnist.train(pytorch_mnist.parse_args(
        ["--device", "cpu", "--steps", str(SHIM_STEPS)]))
    np.testing.assert_allclose(run.losses, want_losses, rtol=SHIM_TOL)
    got = run.model.state_dict()
    assert set(got) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=SHIM_TOL, err_msg=k)


def test_pytorch_mnist_checks_its_final_loss(world1):
    with pytest.raises(AssertionError, match="did not fall"):
        pytorch_mnist.main(["--device", "cpu", "--steps", "2"])


def test_pytorch_mnist_script_passes_its_check(world1):
    """The script as a user runs it: 30 steps, fp16, the final-loss
    check."""
    run = pytorch_mnist.main(["--device", "cpu"])
    assert len(run.losses) == 30 and run.losses[-1] < 0.7 * run.losses[0]


def test_torch_resnet50_runs_on_the_cpu(world1):
    run = torch_resnet50.main(["--device", "cpu", "--image-size", "64",
                               "--batch-size", "4", "--steps", "2"])
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()


def test_torch_resnet50_full_width_counts():
    model = torch_resnet50.ResNet50(
        1000, lambda c: thvd.SyncBatchNorm(c, device="meta"))
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == 25_557_032
    assert len(params) == 161
    assert sum(isinstance(m, thvd.SyncBatchNorm)
               for m in model.modules()) == torch_resnet50.RESNET50_BN_SITES


@pytest.mark.parametrize("layout", [[], ["--8b"]],
                         ids=["base", "int8_remat"])
def test_llama_lora_trains_on_the_cpu(world1, capsys, monkeypatch, layout):
    # --8b's layout (int8 base + remat) on the tiny config.
    monkeypatch.setattr(llama_lora, "LLAMA3_8B", LLAMA_TINY)
    run = llama_lora.main(["--device", "cpu", "--steps", "2", *layout])
    out = capsys.readouterr().out
    base = "int8" if layout else "float32"
    assert f"trainable(LoRA)=16.4K batch=2 seq=128 base={base}" in out
    assert "step    2 loss" in out and "sequences/s" in out
    assert "final loss" in out
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    assert len(run.named) == 2 * 7 * 2
    if layout:
        assert run.model.remat
        assert run.model.layer_0.attn.wq.kernel_q8.q.dtype == torch.int8


def test_llama_lora_serves_three_adapters_on_the_cpu(capsys):
    run = llama_lora.main(["--device", "cpu", "--serve-adapters", "3"])
    out = capsys.readouterr().out
    for j in range(3):
        assert f"adapter {j}: 10 tokens match" in out
    assert "multi-LoRA serve OK: 3 adapters shared one base" in out
    assert run.report.completed == 3


def _launch_two(module, args, tmp_path):
    """``python -m horovod_tpu_torch.run -np 2 --cpu python -m module
    args``: (return code, output)."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--cpu",
         sys.executable, "-m", module, *args], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300)
    return out.returncode, out.stdout


def test_bert_pretrain_tp_runs_at_world_two(tmp_path):
    """``bert_pretrain --tp 2`` on BERT_TINY through the launcher: the HBM
    report, a falling loss, and a checkpoint of the FULL tree (the
    shards gathered over the model set)."""
    ck = tmp_path / "bert.npz"
    rc, log = _launch_two("horovod_tpu_torch.examples.bert_pretrain",
                          ["--tp", "2", "--steps", "4",
                           "--save-checkpoint", str(ck)], tmp_path)
    assert rc == 0, log
    assert "mesh=dcn1 x (data1, model2)" in log and "HBM/device" in log
    first = float(log.split("step    0  loss ")[1].split()[0])
    last = float(log.split("final loss ")[1].split()[0])
    assert last < first, log
    with np.load(ck) as z:
        shapes = {k: z[k].shape for k in z.files}
    wq = [v for k, v in shapes.items() if "layer_0" in k and "wq" in k
          and "kernel" in k]
    assert wq == [(64, 64)], shapes


@pytest.mark.parametrize("mode,extra", [("ring", []),
                                        ("ulysses", ["--packed"])],
                         ids=["ring", "ulysses_packed"])
def test_long_context_runs_at_world_two(tmp_path, mode, extra):
    """``long_context`` at sp 2 through the launcher: the first step's
    loss equal to one process's full attention and a falling loss."""
    rc, log = _launch_two("horovod_tpu_torch.examples.long_context",
                          ["--sp", "2", "--seq-len", "64", "--steps", "5",
                           "--mode", mode, "--compare-single-device",
                           *extra], tmp_path)
    assert rc == 0, log
    assert "PARITY OK" in log and f"mode={mode}, seq=64, sp=2" in log


def test_autoscale_probe_runs_at_world_four(tmp_path):
    """``autoscale_probe`` through the launcher at ``-np 4 --cpu``: the
    control plane over four gloo ranks under ``kill@`` and ``slow@``,
    every ``horovod_ctl_*`` family on rank 0's ``/metrics`` endpoint
    against the drill report, every rank's report equal."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "4", "--cpu",
         sys.executable, "-m", "horovod_tpu_torch.examples.autoscale_probe",
         "--device", "cpu"], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout
    assert "autoscale probe OK (mesh 4 -> 2" in out.stdout, out.stdout
    assert "dead [3], evicted [1]" in out.stdout, out.stdout


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
