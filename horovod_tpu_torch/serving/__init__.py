"""Serving data plane on one GPU: paged KV cache, prefill, paged decode,
LoRA banks, speculative decoding (drafters and the verify step),
continuous-batching scheduler, open-loop load generator, engine."""

from .decode import (ServingDecodeStep, build_decode_step,  # noqa: F401
                     build_verify_step, greedy_sample, prefill_forward,
                     stack_adapters)
from .engine import (RequestPrefetcher, ServingEngine,  # noqa: F401
                     ServingReport)
from .kvcache import CacheConfig, PagedKVCache  # noqa: F401
from .loadgen import LoadSpec, generate  # noqa: F401
from .scheduler import (ContinuousBatchScheduler, Request,  # noqa: F401
                        TenantClass, parse_tenant_classes)
from .spec import ModelDrafter, NgramDrafter  # noqa: F401
