"""Serving data plane: paged KV cache (refcounted pages, fp8 cold pages,
the radix prefix cache), chunked prefill, paged decode, LoRA banks,
speculative decoding, continuous-batching scheduler, open-loop load
generator, engine; tensor-parallel decode and verify steps over a rank
mesh (``decode_param_specs``, the kv-head-sharded pool of
``cache_sharding``, ``ServingEngine(mesh=)`` and ``rebuild_mesh``, run
in lock-step across the world's ranks), the SLO-driven control plane
that resizes that mesh (``ServingControlPlane``); the KV-page wire
codec, the fleet router, the scale policies, the fleet scaler and the
disaggregated fleet."""

from .controlplane import (ControlPlaneReport, FleetScaler,  # noqa: F401
                           ServingControlPlane)
from .decode import (ServingDecodeStep, build_decode_step,  # noqa: F401
                     build_verify_step, decode_param_specs, greedy_sample,
                     prefill_forward, stack_adapters)
from .engine import (RequestPrefetcher, ServingEngine,  # noqa: F401
                     ServingReport)
from .fleet import (DecodeWorker, FleetReport,  # noqa: F401
                    HandoffTicket, PrefillWorker, ServingFleet)
from .kvcache import (CacheConfig, CacheShard, PagedKVCache,  # noqa: F401
                      PrefixCache, cache_sharding)
from .kvwire import (WirePages, decode_kv, encode_kv,  # noqa: F401
                     import_pages, wire_tier)
from .loadgen import (LoadSpec, fleet_spec, generate,  # noqa: F401
                      long_prompt_spec, prefix_spec)
from .policy import (Decision, FleetPolicy,  # noqa: F401
                     FleetPolicyConfig, FleetSample, PolicyConfig,
                     ScalePolicy, SLOSample, valid_tp_sizes)
from .router import FleetRouter  # noqa: F401
from .scheduler import (ContinuousBatchScheduler, Request,  # noqa: F401
                        TenantClass, parse_tenant_classes)
from .spec import ModelDrafter, NgramDrafter  # noqa: F401
