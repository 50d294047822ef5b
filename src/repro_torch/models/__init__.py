from .config import ModelConfig  # noqa: F401
from .lm import LM  # noqa: F401
