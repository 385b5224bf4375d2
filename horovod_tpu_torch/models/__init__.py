"""The port's models: the Llama-3 family with LoRA, ResNet and LeNet;
seeded init, and the flax weight converters."""

from .convert import (flax_leaf_order, from_flax_layout,  # noqa: F401
                      params_from_jax, resnet_state_from_jax,
                      to_flax_layout)
from .layers import init_params  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     ResNet18, ResNet34, ResNet50, ResNet101, ResNet152,
                     init_resnet_params, s2d_conv_init_kernel,
                     space_to_depth)
from .transformer import (LLAMA3_8B, LLAMA_1B, LLAMA_SERVE,  # noqa: F401
                          LLAMA_TINY, LlamaConfig, LlamaLM, RMSNorm,
                          freeze_base, init_llama_params, lora_parameters,
                          rotary_embedding)
