from .ops import gather_weight  # noqa: F401
from .ref import gather_weight_ref  # noqa: F401
from .kernel import gather_weight_cuda  # noqa: F401
