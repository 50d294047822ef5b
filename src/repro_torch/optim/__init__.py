from .optimizers import (  # noqa: F401
    SGD,
    AdaGrad,
    AdaGradState,
    Adam,
    AdamState,
    SGDState,
    apply_updates,
    make_optimizer,
    update_in_place,
)
from . import schedules  # noqa: F401
