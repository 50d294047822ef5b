from .config import ModelConfig  # noqa: F401
from .lm import LM  # noqa: F401
from . import sampled_softmax  # noqa: F401
from .sampled_softmax import (  # noqa: F401
    LMHeadIndex,
    SampledSoftmaxConfig,
    lsh_decode_step,
    make_sampled_loss,
    sampled_softmax_loss,
)
