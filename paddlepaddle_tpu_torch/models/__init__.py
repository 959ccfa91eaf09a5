"""The model zoo: the Llama and MoE decoders, ResNet, BERT and GPT."""

from .bert import (BertConfig, BertForSequenceClassification,  # noqa: F401
                   BertModel)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  gpt_sharding_rules)
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaModel, llama_sharding_rules)
from .moe import MoEConfig, MoEForCausalLM  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
