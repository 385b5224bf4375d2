"""Serving data plane on one GPU: paged KV cache, prefill, paged decode,
continuous-batching scheduler, open-loop load generator, engine."""

from .decode import (ServingDecodeStep, build_decode_step,  # noqa: F401
                     greedy_sample, prefill_forward)
from .engine import (RequestPrefetcher, ServingEngine,  # noqa: F401
                     ServingReport)
from .kvcache import CacheConfig, PagedKVCache  # noqa: F401
from .loadgen import LoadSpec, generate  # noqa: F401
from .scheduler import (ContinuousBatchScheduler, Request,  # noqa: F401
                        TenantClass, parse_tenant_classes)
