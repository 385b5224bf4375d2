"""PyTorch/CUDA port: ``horovod_tpu_torch.examples.grad_compression``
against the JAX repository's ``examples/grad_compression.py``.

The JAX script runs unmodified in a subprocess on one CPU device
(``--cpu-devices 1``: the port runs one rank here, and top-k selects per
rank, so only a world of one is like for like); its train steps' losses
are recorded at full precision (``_jax_examples``).  The port's
``main`` runs in this process on the same arguments, fed the JAX
script's own initial parameters (``he_normal`` of ``jax.random.key(0)``
split in two) as numpy.  Held: each codec's wire bytes a step exactly,
the first loss within 1e-5 and the last within 1e-4 (relative) for no
codec, ``powersgd:4`` and ``topk:0.05``, and the composed paths
(``--zero``, ``--microbatches 2``) the same way.
"""

import re

import numpy as np
import pytest

import horovod_tpu_torch as thvd
from _jax_examples import LAUNCHER_ENV, run_jax_example, world1  # noqa: F401
from horovod_tpu_torch.examples import grad_compression

STEPS = 10
LOSS0_RTOL = 1e-5
LOSS_END_RTOL = 1e-4
CODECS = ("uncompressed", "powersgd:4", "topk:0.05")
_ROW = re.compile(r"^(\S+)\s+(\d+) B\s+([\d.]+)x\s+([\d.]+)\s+([\d.]+)$")


def _jax_params():
    import jax
    import jax.numpy as jnp
    k1, k2 = jax.random.split(jax.random.key(0))
    he = jax.nn.initializers.he_normal()
    return {"w1": np.asarray(he(k1, (64, 128), jnp.float32)),
            "b1": np.zeros((128,), np.float32),
            "w2": np.asarray(he(k2, (128, 10), jnp.float32)),
            "b2": np.zeros((10,), np.float32)}


def _table(out: str) -> dict:
    """``{codec: (wire bytes, ratio)}`` of a printed codec table."""
    rows = {}
    for ln in out.splitlines():
        m = _ROW.match(ln.strip())
        if m:
            rows[m.group(1)] = (int(m.group(2)), float(m.group(3)))
    return rows


@pytest.fixture(scope="module")
def three_way(tmp_path_factory):
    """The JAX script's three-way run and the port's on its arguments."""
    tmp = tmp_path_factory.mktemp("grad_compression")
    out, steps = run_jax_example(
        "grad_compression", ["--cpu-devices", "1", "--steps", str(STEPS)],
        tmp)
    mp = pytest.MonkeyPatch()
    for k in LAUNCHER_ENV:
        mp.delenv(k, raising=False)
    thvd.shutdown()
    try:
        port = grad_compression.main(
            ["--device", "cpu", "--steps", str(STEPS)],
            params=_jax_params())
    finally:
        thvd.shutdown()
        mp.undo()
    return {"out": out, "steps": dict(zip(CODECS, steps)), "port": port}


@pytest.mark.parametrize("codec", CODECS)
def test_codec_matches_the_jax_script(three_way, codec, capsys):
    jax_losses = three_way["steps"][codec]
    port = three_way["port"][codec]
    assert len(jax_losses) == len(port["losses"]) == STEPS
    wire, _ = _table(three_way["out"])[codec]
    assert port["wire"] == wire
    np.testing.assert_allclose(port["losses"][0], jax_losses[0],
                               rtol=LOSS0_RTOL)
    np.testing.assert_allclose(port["losses"][-1], jax_losses[-1],
                               rtol=LOSS_END_RTOL)
    assert np.isfinite(port["losses"]).all()


def test_printed_table_matches_the_jax_script(three_way):
    """The port prints the JAX script's table: the same codecs, wire
    bytes and ratios (the losses are held above at full precision)."""
    jax_rows = _table(three_way["out"])
    assert set(jax_rows) == set(CODECS)
    base = jax_rows["uncompressed"][0]
    for codec, r in three_way["port"].items():
        assert (r["wire"], round(base / r["wire"], 1)) == jax_rows[codec]


@pytest.mark.parametrize("extra", [
    ["--zero", "--compression", "powersgd:4"],
    ["--microbatches", "2", "--compression", "topk:0.05"],
], ids=["zero_powersgd", "microbatches_topk"])
def test_composed_path_matches_the_jax_script(world1, tmp_path, extra):
    args = ["--steps", str(STEPS), *extra]
    out, steps = run_jax_example("grad_compression",
                                 ["--cpu-devices", "1", *args], tmp_path)
    port = grad_compression.main(["--device", "cpu", *args],
                                 params=_jax_params())
    (name, r), = port.items()
    assert name == extra[-1]
    assert r["wire"] == _table(out)[name][0]
    np.testing.assert_allclose(r["losses"][0], steps[0][0], rtol=LOSS0_RTOL)
    np.testing.assert_allclose(r["losses"][-1], steps[0][-1],
                               rtol=LOSS_END_RTOL)


def test_default_init_draws_the_he_normal_shapes():
    p = grad_compression.init_params()
    assert {k: v.shape for k, v in p.items()} == {
        "w1": (64, 128), "b1": (128,), "w2": (128, 10), "b2": (10,)}
    # A truncated normal at two standard deviations of sqrt(2 / fan_in).
    bound = 2 * np.sqrt(2.0 / 64) / 0.87962566103423978
    assert np.abs(p["w1"]).max() <= bound
    assert 0.8 < p["w1"].std() / np.sqrt(2.0 / 64) < 1.2
