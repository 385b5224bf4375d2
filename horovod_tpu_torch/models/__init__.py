"""The port's models: the Llama-3 family with LoRA, BERT, ResNet, VGG,
Inception-v3 and LeNet; seeded init, and the flax weight converters."""

from .convert import (flax_leaf_order, flax_state_from_jax,  # noqa: F401
                      from_flax_layout, params_from_jax,
                      resnet_state_from_jax, to_flax_layout)
from .inception import InceptionV3  # noqa: F401
from .layers import init_params  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     ResNet18, ResNet34, ResNet50, ResNet101, ResNet152,
                     init_resnet_params, s2d_conv_init_kernel,
                     space_to_depth)
from .transformer import (BERT_BASE, BERT_LARGE, BERT_TINY,  # noqa: F401
                          LLAMA3_8B, LLAMA_1B, LLAMA_SERVE, LLAMA_TINY, Bert,
                          BertConfig, BertTP, EncoderBlock, LayerNorm,
                          LlamaConfig, ParamTree, bert_tp_apply,
                          LlamaLM, RMSNorm, freeze_base, init_bert_params,
                          init_llama_params, lora_parameters, merge_lora,
                          quantize_frozen_base, quantize_int8,
                          rotary_embedding)
from .vgg import VGG, VGG16, VGG19  # noqa: F401
