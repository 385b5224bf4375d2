"""PyTorch/CUDA port: ``horovod_tpu_torch.examples.mnist_lenet`` against
the JAX repository's ``examples/mnist_lenet.py``.

The JAX script runs unmodified in a subprocess on one CPU device (its
world step's losses recorded at full precision, ``_jax_examples``); the
port's ``main`` runs here at world 1 on the same arguments, fed the JAX
script's own parameter tree (``he_normal`` of ``PRNGKey(0)`` split in 8)
as numpy -- the data is numpy-seeded in both.  Held: every step's loss
within 1e-5 (relative) of the JAX run's; ``--compare-single-device``'s
``PARITY OK`` (the framework's step against a bare SGD step); the port's
own initializer converging; and the script at world 2 under the launcher
printing the world-1 run's losses (each rank's half of the batch, the
gradients averaged: the same step up to roundoff).
"""

import re

import numpy as np

from _jax_examples import run_jax_example, run_port, world1  # noqa: F401
from horovod_tpu_torch.examples import mnist_lenet

STEPS = 20
LOSS_RTOL = 1e-5


def _jax_params():
    import jax
    k = jax.random.split(jax.random.PRNGKey(0), 8)
    he = jax.nn.initializers.he_normal()
    shapes = {"c1": ((5, 5, 1, 6), 6), "c2": ((5, 5, 6, 16), 16),
              "f1": ((256, 120), 120), "f2": ((120, 84), 84),
              "f3": ((84, 10), 10)}
    return {name: {"w": np.asarray(he(k[i], w)),
                   "b": np.zeros((b,), np.float32)}
            for i, (name, (w, b)) in enumerate(shapes.items())}


def test_mnist_lenet_matches_the_jax_script(world1, tmp_path, capsys):
    out, steps = run_jax_example(
        "mnist_lenet", ["--cpu-devices", "1", "--steps", str(STEPS)],
        tmp_path)
    run = mnist_lenet.main(["--device", "cpu", "--steps", str(STEPS)],
                           params=_jax_params())
    (want,) = steps
    assert len(run["losses"]) == len(want) == STEPS
    np.testing.assert_allclose(run["losses"], want, rtol=LOSS_RTOL)
    printed = capsys.readouterr().out
    for s in range(0, STEPS, 10):
        line = f"step {s:4d}  loss"
        assert line in printed and line in out


def test_mnist_lenet_compare_single_device(world1, capsys):
    run = mnist_lenet.main(["--device", "cpu", "--steps", "12",
                            "--compare-single-device"],
                           params=_jax_params())
    assert "PARITY OK" in capsys.readouterr().out
    assert run["diff"] < 1e-5
    assert len(run["ref_losses"]) == 12


def test_mnist_lenet_default_init_converges(world1):
    run = mnist_lenet.main(["--device", "cpu", "--steps", "20"])
    assert run["losses"][-1] < 0.5 * run["losses"][0]


def test_mnist_lenet_script_params_load_into_lenet():
    p = _jax_params()
    sd = mnist_lenet.state_from_script_params(p, "cpu")
    assert tuple(sd["Conv_0.kernel"].shape) == (6, 1, 5, 5)   # OIHW
    np.testing.assert_array_equal(sd["Conv_1.kernel"].numpy(),
                                  p["c2"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["Dense_2.kernel"].numpy(),
                                  p["f3"]["w"])


def test_mnist_lenet_at_world_two_prints_the_world_one_losses(world1,
                                                              tmp_path):
    run = mnist_lenet.main(["--device", "cpu", "--steps", str(STEPS)])
    rc, out = run_port("mnist_lenet", ["--steps", str(STEPS)], tmp_path,
                       launcher_np=2)
    assert rc == 0, out
    got = [float(v) for v in re.findall(r"step +\d+  loss ([\d.]+)", out)]
    assert len(got) == 2
    # Printed at four decimals: within one unit of the last place.
    np.testing.assert_allclose(got, [run["losses"][0], run["losses"][10]],
                               atol=1.5e-4)
