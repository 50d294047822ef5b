from .faults import (  # noqa: F401
    DropBarrier,
    FaultError,
    FaultInjector,
    NanLossWeights,
    ProcHang,
    ProcKill,
    RefreshHang,
    RefreshRaise,
    delete_leaf,
    flip_manifest_byte,
    truncate_arrays,
)
