"""PyTorch/CUDA port: the fusion planner vs the JAX package's.

``horovod_tpu_torch.controller.fusion.plan_buckets`` must give the same
bucket layout as ``horovod_tpu.controller.fusion.plan_buckets`` for the
same (shape, dtype) leaves: the same buckets in the same order, each with
the same dtype and the same (index, shape, size) leaves, and the same memo
key.  Pure Python on both sides: the JAX leaves are
``jax.ShapeDtypeStruct``s, the port's are tensors on the meta device.
Exact equality, no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.controller import fusion as jfusion
from horovod_tpu.models.transformer import LLAMA_TINY as J_TINY
from horovod_tpu.models.transformer import LlamaLM as JLlamaLM
from horovod_tpu.models.transformer import lora_mask
from horovod_tpu_torch.controller import fusion as tfusion
from horovod_tpu_torch.controller.cache import LRUCache
from horovod_tpu_torch.models import LLAMA_TINY, LlamaLM, lora_parameters

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16, "int32": jnp.int32}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "float16": torch.float16, "int32": torch.int32}

MIXED = [((4, 8), "float32"), ((300,), "bfloat16"), ((), "float32"),
         ((16, 16), "float16"), ((2, 3, 5), "int32"), ((128,), "float32"),
         ((64, 4), "bfloat16"), ((1000,), "float32"), ((7,), "float16")]


def _lora_leaves():
    """(shape, dtype) of every LoRA leaf of the flax ``LlamaLM(LLAMA_TINY,
    lora_rank=4)``, in the tree's flatten order."""
    model = JLlamaLM(J_TINY, dtype=jnp.float32, lora_rank=4)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    mask = lora_mask(shapes)
    return [(tuple(x.shape), str(x.dtype)) for x, m in zip(
        jax.tree.leaves(shapes), jax.tree.leaves(mask)) if m]


LEAF_SETS = {"mixed": MIXED, "lora_tiny": None}


def _layout(spec, name_of):
    return [(name_of(dt), tuple((s.index, tuple(s.shape), s.size)
                                for s in leaves))
            for dt, leaves in spec.buffers]


@pytest.mark.parametrize("leaf_set", sorted(LEAF_SETS))
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("threshold", [0, 1024, 64 * 1024 * 1024])
def test_plan_buckets_layout_matches_jax(leaf_set, reverse, threshold):
    leaves = LEAF_SETS[leaf_set] or _lora_leaves()
    jl = [jax.ShapeDtypeStruct(s, _JDT[d]) for s, d in leaves]
    tl = [torch.empty(s, dtype=_TDT[d], device="meta") for s, d in leaves]
    want = jfusion._plan_buckets_uncached(jl, threshold, reverse)
    got = tfusion.plan_buckets(tl, threshold, reverse=reverse)
    assert _layout(got, tfusion.dtype_name) == _layout(
        want, lambda dt: str(jnp.dtype(dt)))
    assert got.num_leaves == want.num_leaves == len(leaves)
    assert tfusion.plan_key(tl, threshold) == jfusion.plan_key(jl, threshold)
    if threshold == 0:      # every leaf alone in its bucket
        assert len(got.buffers) == len(leaves)


def test_lora_leaves_are_the_ports_adapters():
    """The port's LoRA model has the same adapter tensors (names, shapes)
    as the flax tree's masked leaves; its registration order is forward
    order (wq, wk, wv, wo, w_gate, w_up, w_down), which is what the
    optimizer's ``reverse=True`` plan turns into bucket-ready order."""
    model = LlamaLM(LLAMA_TINY, device="meta", lora_rank=4)
    named = lora_parameters(model)
    assert sorted((tuple(p.shape), "float32") for _, p in named) == \
        sorted(_lora_leaves())
    assert [n.split(".")[2] for n, _ in named[:14:2]] == [
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"]


def test_pack_unpack_round_trip_and_copy():
    rng = np.random.RandomState(0)
    leaves = [torch.from_numpy(np.asarray(rng.randn(*s), np.float32)).to(
        _TDT[d]) for s, d in MIXED if d != "int32"]
    spec = tfusion.plan_buckets(leaves, 1024, reverse=True)
    bufs = tfusion.pack(leaves, spec)
    assert [b.numel() * b.element_size() for b in bufs] == \
        spec.bucket_bytes()
    for b in bufs:
        b.add_(0)                      # buffers are copies, never views
        assert b.dim() == 1
    out = tfusion.unpack(bufs, spec)
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(out, leaves))
    bufs[0].fill_(7)                   # writing a buffer leaves inputs alone
    assert not any(bool((x == 7).all()) for x in leaves if x.numel() > 1)


def test_plan_cache_memoizes_by_key():
    tfusion.clear_plan_cache()
    leaves = [torch.empty(s, dtype=_TDT[d], device="meta")
              for s, d in MIXED]
    a = tfusion.plan_buckets(leaves, 4096)
    b = tfusion.plan_buckets(list(leaves), 4096)
    c = tfusion.plan_buckets(leaves, 4096, reverse=True)
    assert a is b and a is not c
    st = tfusion.plan_cache_stats()
    assert (st["hits"], st["misses"], st["size"]) == (1, 2, 2)
    assert tfusion._get_plan_cache().capacity == \
        tfusion.PLAN_CACHE_CAPACITY == 1024
    assert tfusion.plan_buckets(leaves).buffers == tfusion.plan_buckets(
        leaves, 64 * 1024 * 1024).buffers


def test_lru_cache_evicts_least_recent():
    c = LRUCache(capacity=2)
    for key in ("a", "b", "a", "c"):
        c.get_or_build(key, lambda key=key: key.upper())
    assert c.stats() == (1, 3, 1) and len(c) == 2
    assert c.get_or_build("a", lambda: "rebuilt") == "A"   # kept
    assert c.get_or_build("b", lambda: "rebuilt") == "rebuilt"
