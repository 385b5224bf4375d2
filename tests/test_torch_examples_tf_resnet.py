"""PyTorch/CUDA port: ``horovod_tpu_torch.examples.tf2_resnet50`` (the
port of ``examples/tf2_resnet50.py``, whose own test asserts ``tf2
resnet50 OK``): ``keras.applications.ResNet50`` through the port's
TensorFlow shim at 64 x 64, batch 2, two steps -- ``tf2 resnet50 OK``
with finite losses.  It needs ``tensorflow`` and ``keras`` (skipped
without them; the card's machine has neither)."""

import importlib.util
import re

import numpy as np
import pytest

from _jax_examples import run_port

pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("tensorflow") is None
    or importlib.util.find_spec("keras") is None,
    reason="needs tensorflow and keras")


def test_tf2_resnet50_runs_through_the_shim(tmp_path):
    rc, out = run_port("tf2_resnet50",
                       ["--device", "cpu", "--image-size", "64",
                        "--batch-size", "2", "--steps", "2"], tmp_path)
    assert rc == 0, out
    assert "tf2 resnet50 OK" in out
    first, last = re.search(r"loss ([\d.]+) -> ([\d.]+)", out).groups()
    assert np.isfinite([float(first), float(last)]).all()
    assert "2 steps, size 1, tf2 shim" in out
