from .ops import gqa_attention, gqa_decode  # noqa: F401
from .ref import attention_ref, decode_ref  # noqa: F401
from .kernel import flash_attention_cuda, flash_decode_cuda  # noqa: F401
