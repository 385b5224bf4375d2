"""Llama-3 family model with LoRA, seeded init, and the flax weight
converter."""

from .convert import params_from_jax  # noqa: F401
from .transformer import (LLAMA3_8B, LLAMA_1B, LLAMA_SERVE,  # noqa: F401
                          LLAMA_TINY, LlamaConfig, LlamaLM, RMSNorm,
                          freeze_base, init_llama_params, lora_parameters,
                          rotary_embedding)
