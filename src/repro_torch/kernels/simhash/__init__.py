from .ops import simhash_codes  # noqa: F401
from .ref import simhash_codes_ref  # noqa: F401
from .kernel import simhash_codes_cuda  # noqa: F401
