from .ops import gather_weight  # noqa: F401
from .ref import gather_weight_ref  # noqa: F401
from .kernel import (  # noqa: F401
    LAWS, draw_assemble_cuda, gather_weight_cuda, law_code)
