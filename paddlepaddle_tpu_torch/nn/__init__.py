"""nn subset of the port: the layers the Llama and MoE paths build on, the
loss layers and the gradient clips."""

from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .common import Embedding, Linear  # noqa: F401
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,  # noqa: F401
                   CrossEntropyLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .norm import RMSNorm  # noqa: F401
