"""PyTorch/CUDA port: ``horovod_tpu_torch.examples.tensorflow2_mnist``
against the JAX repository's ``examples/tensorflow2_mnist.py``.  It needs
``tensorflow`` and ``keras`` (skipped without them; the card's machine
has neither, so it runs on the CPU only), which only the scripts'
processes import.

* At world 2 under each package's launcher
  (``-np 2 --cpu``), Keras's initializers seeded alike in both
  (``keras.utils.set_random_seed(0)``: the port's ``--seed 0``, a
  prelude before the JAX script) -- the data is numpy-seeded in both:
  every printed loss (steps 0 and 10, the final loss, each rank's
  averaged final loss) within 1e-4 of the JAX run's, as printed at four
  decimals.
"""

import importlib.util
import re

import pytest

from _jax_examples import run_jax_example, run_port

pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("tensorflow") is None
    or importlib.util.find_spec("keras") is None,
    reason="needs tensorflow and keras")

MNIST_STEPS = 12
_LOSS = re.compile(r"(step +\d+  loss|final loss|rank \d: avg final loss) "
                   r"([\d.]+)")


def _losses(out: str) -> dict:
    found = {}
    for ln in out.splitlines():
        m = _LOSS.search(ln)
        if m:
            found[m.group(1)] = float(m.group(2))
    return found


def test_tensorflow2_mnist_matches_the_jax_script(tmp_path):
    jax_out, _ = run_jax_example(
        "tensorflow2_mnist", ["--steps", str(MNIST_STEPS)], tmp_path,
        launcher_np=2, prelude="import keras; keras.utils.set_random_seed(0)")
    rc, out = run_port("tensorflow2_mnist",
                       ["--steps", str(MNIST_STEPS), "--seed", "0"],
                       tmp_path, launcher_np=2)
    assert rc == 0, out
    got, want = _losses(out), _losses(jax_out)
    assert set(got) == set(want) == {
        "step    0  loss", "step   10  loss", "final loss",
        "rank 0: avg final loss", "rank 1: avg final loss"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert "rank 1: avg final loss" in out and " OK" in out
