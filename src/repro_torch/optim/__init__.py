from .optimizers import (  # noqa: F401
    SGD,
    Adafactor,
    AdafactorState,
    AdaGrad,
    AdaGradState,
    Adam,
    Adam8bit,
    Adam8bitState,
    AdamState,
    QTensor,
    SGDState,
    apply_updates,
    make_optimizer,
    update_in_place,
)
from . import compression, schedules  # noqa: F401
