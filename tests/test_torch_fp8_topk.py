"""PyTorch/CUDA port: the fp8 and top-k exchanges and the codec grammar,
against the JAX package.

On the CPU, in one process:

* ``fp8_quantize`` -- codes and scales bitwise equal to the JAX
  quantizer's, per tensor and per row (an all-zero row takes scale 1 and
  comes back exact; an empty tensor), on f32 values spanning 1e-6 to 1e2
  and on bf16;
* the top-k selection -- on tied magnitudes (exact zeros, +-v, integer
  values) the indices of ``lax.top_k``, lowest index first among equals;
* ``parse_compression`` (every spec, the errors too),
  ``resolve_compressor_name``, ``topk_count`` and ``wire_payload_bytes``
  (every codec, sizes, itemsizes and ICI extents) equal to the JAX
  package's.

Gloo worlds of 2 and 4 (this file, run as a script, is each rank; they
meet through a ``FileStore`` under pytest's temporary directory), against
the JAX op under ``jax.shard_map`` on a mesh of as many CPU devices:

* ``fp8_allreduce``: Sum and Average, prescale and postscale, a size
  that pads.  Bitwise at world 2.  At world 4 the f32 sum of four rows
  may be ordered otherwise than XLA's, so each element is held within one
  e4m3 step (at its shard's scale) of the JAX value, and the number of
  codes that differ is reported (0 expected);
* ``topk_allreduce`` with a residual, tied magnitudes and duplicate
  indices across ranks, fractions 0.25 and 1.0: the new residual bitwise
  (it is zero exactly where the rank sent, so the selected set is the
  JAX one), the output within 1e-6 of max |value| (duplicate indices are
  scatter-added in another order); ``topk:1.0`` equals the exact
  allreduce (integer-valued inputs, so every order sums exactly);
* Adasum with ``wire_codec="fp8"``, flat at worlds 2 and 4 and
  hierarchical at world 4 (2 nodes of 2), within 1e-6 of max |value|,
  the tolerance of ``tests/test_torch_adasum.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as thvd
from horovod_tpu_torch.collectives import compression as tcomp
from horovod_tpu_torch.collectives import ops as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_LOCAL_SIZE", "HOROVOD_HIERARCHICAL",
                 "HOROVOD_COMPRESSION")
WORLDS = (2, 4)
F32_REL = 1e-6
FP8_CASES = {          # name: (shape, op, prescale, postscale)
    "sum": ((37,), "Sum", 1.0, 1.0),
    "average_scaled": ((8, 9), "Average", 0.5, 3.0),
}
TOPK_CASES = {         # name: (size, fraction, op)
    "q_avg": (50, 0.25, "Average"),
    "q_sum": (37, 0.25, "Sum"),
    "all": (24, 1.0, "Sum"),
}


def _fp8_input(name, rank):
    shape = FP8_CASES[name][0]
    rng = np.random.RandomState(100 + 10 * rank + len(name))
    return (rng.randn(*shape) * 10.0 ** rng.uniform(-3, 2, shape)).astype(
        np.float32)


def _tied(seed, size):
    """Integer values in [-3, 3]: ties in magnitude, exact zeros and
    +-v pairs everywhere."""
    return np.random.RandomState(seed).randint(-3, 4, size).astype(
        np.float32)


def _topk_inputs(name, rank):
    size = TOPK_CASES[name][0]
    return _tied(200 + rank, size), _tied(300 + rank, size)


def _adasum_input(rank):
    return np.random.RandomState(400 + rank).randn(45).astype(np.float32)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _worker(rank: int, world: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    from horovod_tpu_torch.adasum.vhdd import (adasum_allreduce,
                                               adasum_allreduce_hierarchical)
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    res = {}
    for name, (_, op, pre, post) in FP8_CASES.items():
        x = torch.from_numpy(_fp8_input(name, rank))
        res["fp8", name] = tops.fp8_allreduce(
            x, getattr(thvd, op), prescale_factor=pre, postscale_factor=post)
        assert torch.equal(x, torch.from_numpy(_fp8_input(name, rank)))
    for name, (_, fraction, op) in TOPK_CASES.items():
        x, r = (torch.from_numpy(a) for a in _topk_inputs(name, rank))
        res["topk", name] = tops.topk_allreduce(
            x, getattr(thvd, op), fraction=fraction, residual=r)
        res["exact", name] = thvd.allreduce(x + r, op=getattr(thvd, op))
    a = torch.from_numpy(_adasum_input(rank))
    res["adasum_fp8"] = adasum_allreduce(a, wire_codec="fp8")
    res["adasum"] = adasum_allreduce(a)
    res["allreduce_fp8_codec"] = thvd.allreduce(
        a, op=thvd.Sum, compression=thvd.Compression.fp8)
    if world == 4:
        res["adasum_fp8_hier"] = adasum_allreduce_hierarchical(
            a, local_size=2, wire_codec="fp8")
    thvd.barrier()
    torch.save(res, out)
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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: _run_world(tmp_path_factory.mktemp(f"fp8topk{w}"), w)
            for w in WORLDS}


def _jax_run(shape, axes, fn, inputs_by_rank):
    """``fn(*per-device inputs)`` under ``jax.shard_map`` on a mesh of
    ``shape`` (named ``axes``) over the first CPU devices, rank ``r`` the
    row-major device ``r``; returns each output stacked by rank.

    Op by op, not under ``jax.jit``: compiled, XLA rewrites the
    quantizer's ``absmax / 448`` into ``absmax * (1 / 448)``, which moves
    a scale by an ulp now and then; the JAX package's code divides, and
    so does the port."""
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    stacked = [jnp.asarray(np.stack([inputs_by_rank[r][i] for r in range(n)]))
               for i in range(len(inputs_by_rank[0]))]
    f = jax.shard_map(
        lambda *xs: jax.tree.map(lambda y: y[None],
                                 fn(*[x[0] for x in xs])),
        mesh=mesh, in_specs=P(axes), out_specs=P(axes), check_vma=False)
    return jax.tree.map(np.asarray, f(*stacked))


def _e4m3_step(values, scale):
    """The spacing of e4m3 codes at ``values`` quantized with ``scale``
    (3 mantissa bits; the subnormal spacing 2^-9 below 2^-6)."""
    mag = np.abs(values) / scale
    exp = np.floor(np.log2(np.maximum(mag, 2.0 ** -6)))
    return 2.0 ** (exp - 3) * scale


# ---------------------------------------------------------------------------
# In one process: the quantizer, the selection, the grammar
# ---------------------------------------------------------------------------


def _spread(seed, shape):
    rng = np.random.RandomState(seed)
    return (rng.choice([-1.0, 1.0], shape)
            * 10.0 ** rng.uniform(-6, 2, shape)).astype(np.float32)


@pytest.mark.parametrize("case", ["tensor", "rows", "rows_zero", "empty",
                                  "bf16", "subnormal"])
def test_fp8_quantize_bitwise_matches_jax(case):
    from horovod_tpu.collectives import compression as jcomp
    axis = None
    if case == "tensor":
        x = _spread(0, (1 << 14,))
    elif case in ("rows", "rows_zero"):
        x, axis = _spread(1, (4, 1000)), 0
        if case == "rows_zero":
            x[2] = 0.0
    elif case == "empty":
        x, axis = np.zeros((3, 0), np.float32), 0
    elif case == "subnormal":
        x = np.concatenate([_spread(2, (500,)) * 1e-3,
                            np.float32([448.0, -1e-7, 0.0])])
    else:
        x = _spread(3, (2048,))
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if case == "bf16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    q, s = tcomp.fp8_quantize(tx, axis=axis)
    jq, js = jcomp.fp8_quantize(jx, axis=axis)
    assert q.dtype == torch.float8_e4m3fn and s.dtype == torch.float32
    np.testing.assert_array_equal(
        q.view(torch.uint8).numpy(),
        np.asarray(jq).view(np.uint8).reshape(q.shape))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tcomp.fp8_dequantize(q, s if axis is None else s[:, None],
                                torch.float32)
    want = jcomp.fp8_dequantize(jq, js if axis is None else js[:, None],
                                jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    if case == "rows_zero":
        assert s[2].item() == 1.0 and not back[2].any()


@pytest.mark.parametrize("size,k", [(1000, 100), (1000, 250), (4099, 1025),
                                    (12, 12), (7, 1)])
def test_topk_selection_matches_lax_top_k_on_ties(size, k):
    x = _tied(size, size)
    got = tops._topk_select(torch.from_numpy(x), k)
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SPECS = ["none", "fp16", "bf16", "fp8", " FP8 ", "powersgd:2", "topk:0.25",
         "topk:1", "topk:1e-05", "ici:none,dcn:fp8", "ici:bf16,dcn:topk:0.25",
         "dcn:powersgd:4", "ici:fp16", " ici:none , dcn:bf16 ", None]
BAD_SPECS = ["topk:0", "topk:1.5", "topk:x", "gzip", "ici:fp8,dcn:none",
             "ici:none,ici:bf16", "ici:none,dcn:ici:none,dcn:fp8",
             "icy:none", "ici", "ici:topk:0.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_compression_every_spec_matches_jax(spec):
    from horovod_tpu.collectives import compression as jcomp
    got, want = tcomp.parse_compression(spec), jcomp.parse_compression(spec)
    assert got.__name__ == want.__name__
    for pred in ("is_fp8", "is_topk", "is_powersgd", "is_hier_legs",
                 "is_error_feedback"):
        assert getattr(tcomp, pred)(got) == getattr(jcomp, pred)(want)
    assert tcomp.resolve_compressor_name(got.__name__) is got
    if tcomp.is_hier_legs(got):
        assert got.ici.__name__ == want.ici.__name__
        assert got.dcn.__name__ == want.dcn.__name__
    if tcomp.is_topk(got):
        assert got.fraction == want.fraction
        assert tcomp.Compression.topk(got.fraction) is got


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_value_error_in_both(spec):
    from horovod_tpu.collectives import compression as jcomp
    with pytest.raises(ValueError) as want:
        jcomp.parse_compression(spec)
    with pytest.raises(ValueError) as got:
        tcomp.parse_compression(spec)
    assert str(got.value) == str(want.value)


def test_resolve_compressor_name_rebuilds_parameterized_codecs():
    from horovod_tpu.collectives import compression as jcomp
    for name in ("TopK0p125Compressor", "HierBF16CompressorDcnFP8Compressor",
                 "HierNoneCompressorDcnPowerSGD3Compressor", "FP8Compressor"):
        got = tcomp.resolve_compressor_name(name)
        assert got.__name__ == jcomp.resolve_compressor_name(name).__name__
    with pytest.raises(KeyError):
        tcomp.resolve_compressor_name("Gzip")


def test_wire_payload_bytes_and_topk_count_match_jax():
    from horovod_tpu.collectives import compression as jcomp
    checked = 0
    for spec in SPECS:
        for size in (0, 1, 7, 1000, 25_557_032):
            for itemsize in (2, 4):
                for world in (1, 2, 8):
                    got = tcomp.wire_payload_bytes(
                        tcomp.parse_compression(spec), size, itemsize, world)
                    want = jcomp.wire_payload_bytes(
                        jcomp.parse_compression(spec), size, itemsize, world)
                    assert got == want, (spec, size, itemsize, world)
                    checked += 1
    for size in (1, 9, 1000, 15053824):
        for f in (1e-5, 0.01, 0.25, 1.0):
            assert tcomp.topk_count(size, f) == jcomp.topk_count(size, f)
    assert checked == len(SPECS) * 30


# ---------------------------------------------------------------------------
# Gloo worlds against the JAX ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FP8_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_fp8_allreduce_matches_jax(worlds, world, name):
    from horovod_tpu.collectives import ops as jops
    from horovod_tpu.collectives.compression import fp8_quantize
    shape, op, pre, post = FP8_CASES[name]
    import horovod_tpu as jhvd
    want = _jax_run((world,), ("hvd",),
                    lambda x: jops.fp8_allreduce(
                        x, getattr(jhvd, op), axes=("hvd",),
                        prescale_factor=pre, postscale_factor=post),
                    {r: (_fp8_input(name, r),) for r in range(world)})
    got = {r: worlds[world][r]["fp8", name] for r in range(world)}
    for r in range(world):
        assert got[r].shape == shape and got[r].dtype == torch.float32
        assert torch.equal(got[r], got[0])     # every rank alike
    g, w = got[0].numpy(), want[0]
    if world == 2:
        np.testing.assert_array_equal(g, w)
        return
    # World 4: each element within one e4m3 step of its shard's scale.
    size = int(np.prod(shape))
    chunk = -(-size // world)
    flat_g, flat_w = g.reshape(-1), w.reshape(-1)
    differ = 0
    for j in range(world):
        sl = slice(j * chunk, min((j + 1) * chunk, size))
        _, scale = fp8_quantize(jnp.asarray(flat_w[sl]))
        step = _e4m3_step(flat_w[sl], float(scale))
        assert np.all(np.abs(flat_g[sl] - flat_w[sl]) <= step + 1e-30)
        differ += int(np.sum(flat_g[sl] != flat_w[sl]))
    print(f"fp8_allreduce world 4 {name}: {differ} codes differ")


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_topk_allreduce_matches_jax(worlds, world, name):
    from horovod_tpu.collectives import ops as jops
    import horovod_tpu as jhvd
    size, fraction, op = TOPK_CASES[name]
    want_out, want_res = _jax_run(
        (world,), ("hvd",),
        lambda x, r: jops.topk_allreduce(
            x, getattr(jhvd, op), fraction=fraction, axes=("hvd",),
            residual=r),
        {r: _topk_inputs(name, r) for r in range(world)})
    for r in range(world):
        out, res = worlds[world][r]["topk", name]
        assert out.shape == (size,) and res.dtype == torch.float32
        np.testing.assert_array_equal(res.numpy(), want_res[r])
        assert np.abs(out.numpy() - want_out[r]).max() <= F32_REL * max(
            np.abs(want_out[r]).max(), 1e-30)
        k = tcomp.topk_count(size, fraction)
        x, rr = _topk_inputs(name, r)
        assert int(np.sum(res.numpy() != x + rr)) <= k
        if fraction == 1.0:
            assert not res.any()
            np.testing.assert_array_equal(
                out.numpy(), worlds[world][r]["exact", name].numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_adasum_fp8_wire_matches_jax(worlds, world):
    from horovod_tpu.adasum.xla import adasum_allreduce as jadasum
    want = _jax_run((world,), ("hvd",),
                    lambda x: jadasum(x, axis="hvd", wire_codec="fp8"),
                    {r: (_adasum_input(r),) for r in range(world)})
    plain = worlds[world][0]["adasum"].numpy()
    for r in range(world):
        got = worlds[world][r]["adasum_fp8"].numpy()
        assert np.abs(got - want[r]).max() <= F32_REL * np.abs(want[r]).max()
    # fp8 touched the wire: the result moved off the f32 exchange's.
    assert not np.array_equal(worlds[world][0]["adasum_fp8"].numpy(), plain)


def test_adasum_fp8_hierarchical_matches_jax(worlds):
    from horovod_tpu.adasum.xla import adasum_allreduce_hierarchical as jh
    want = _jax_run((2, 2), ("dcn", "ici"),
                    lambda x: jh(x, dcn_axis="dcn", ici_axis="ici",
                                 wire_codec="fp8"),
                    {r: (_adasum_input(r),) for r in range(4)})
    for r in range(4):
        got = worlds[4][r]["adasum_fp8_hier"].numpy()
        assert np.abs(got - want[r]).max() <= F32_REL * np.abs(want[r]).max()


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_with_the_fp8_codec_is_fp8_allreduce(worlds, world):
    from horovod_tpu.collectives import ops as jops
    import horovod_tpu as jhvd
    want = _jax_run((world,), ("hvd",),
                    lambda x: jops.fp8_allreduce(x, jhvd.Sum, axes=("hvd",)),
                    {r: (_adasum_input(r),) for r in range(world)})
    got = worlds[world][0]["allreduce_fp8_codec"].numpy()
    if world == 2:
        np.testing.assert_array_equal(got, want[0])
    else:
        assert np.abs(got - want[0]).max() <= 0.07 * np.abs(want[0]).max()


def test_fp8_and_topk_refuse_what_jax_refuses():
    thvd.init(device="cpu")
    try:
        x = torch.ones(4)
        with pytest.raises(ValueError, match="Sum/Average"):
            tops.fp8_allreduce(x, thvd.Max)
        with pytest.raises(ValueError, match="floating"):
            tops.fp8_allreduce(torch.ones(4, dtype=torch.int32))
        with pytest.raises(ValueError, match="Sum/Average"):
            tops.topk_allreduce(x, thvd.Min, fraction=0.5)
        with pytest.raises(ValueError, match="floating"):
            tops.topk_allreduce(torch.ones(4, dtype=torch.int32),
                                fraction=0.5)
        with pytest.raises(ValueError, match="exchange codec"):
            thvd.allreduce(x, compression="topk:0.5")
    finally:
        thvd.shutdown()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
