from .faults import (  # noqa: F401
    FaultError,
    FaultInjector,
    NanLossWeights,
    RefreshHang,
    RefreshRaise,
    delete_leaf,
    flip_manifest_byte,
    truncate_arrays,
)
