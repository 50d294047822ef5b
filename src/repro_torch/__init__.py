"""PyTorch/CUDA port of the LGD system (``repro`` is the JAX reference).

Imports ``torch`` and numpy only — never JAX, never ``repro``.  Entry
points run on the card unless the caller passes ``device="cpu"``; on the
CPU every kernel is replaced by its plain PyTorch version.  Hashing
needs full fp32 matmuls: ``repro_torch.kernels.require_full_fp32`` turns
TF32 off and checks it before every projection.
"""
