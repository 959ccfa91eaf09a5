"""nn subset of the port: the layers the Llama, MoE, ResNet, BERT and GPT
paths build on, the loss layers and the gradient clips."""

from . import functional  # noqa: F401
from .activation import (CELU, ELU, GELU, GLU, LeakyReLU,  # noqa: F401
                         LogSigmoid, LogSoftmax, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, Maxout, Mish, PReLU, ReLU,
                         ReLU6, RReLU, SELU, Sigmoid, Silu, Softmax,
                         Softplus, Softshrink, Softsign, Swish, Tanh,
                         Tanhshrink, ThresholdedReLU)
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, GradientClipByGlobalNorm,
                   GradientClipByNorm, GradientClipByValue, clip_grad_norm_)
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import LayerList, Sequential  # noqa: F401
from .conv import Conv1D, Conv2D  # noqa: F401
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,  # noqa: F401
                   CrossEntropyLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   LayerNorm, RMSNorm)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
