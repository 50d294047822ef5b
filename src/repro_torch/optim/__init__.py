from .optimizers import (  # noqa: F401
    SGD,
    AdaGrad,
    AdaGradState,
    Adam,
    AdamState,
    SGDState,
    apply_updates,
    make_optimizer,
)
from . import schedules  # noqa: F401
