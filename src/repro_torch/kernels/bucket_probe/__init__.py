from .ops import (  # noqa: F401
    bucket_probe,
    bucket_probe_codes,
    bucket_probe_multi,
)
from .ref import (  # noqa: F401
    bucket_probe_codes_ref,
    bucket_probe_multi_ref,
    bucket_probe_ref,
)
from .kernel import (  # noqa: F401
    bucket_probe_codes_cuda,
    bucket_probe_cuda,
    bucket_probe_multi_cuda,
)
