"""Gradient compression with error feedback (PyTorch port of
``repro.optim.compression``).

int8 block quantisation cuts a data-parallel gradient all-reduce's wire
traffic 4x against bf16 (one f32 scale per 256-value block: 2.06 bytes a
value), and ERROR FEEDBACK keeps convergence: each step's quantisation
residual is added to the next step's gradient instead of discarded, so
the long-run compression error stays O(1) rather than O(T).

    residual = init_error_feedback(params)
    q, residual = compress_with_feedback(grads, residual)  # before the reduce
    grads_hat = decompress(q, like=grads)                  # after it

``grads`` and ``params`` are a tensor or a dict of named tensors, as in
``repro_torch.optim``; a compressed tree is a ``QTensor`` or a dict of
them.  A 256-value block of the flattened leaf does not follow a shard
of the leaf, so a DTensor gradient (a model placed on a mesh) is
compressed whole, one leaf at a time: its full value on every rank
(``full_tensor()``, a reduction where it is partial), which gives every
rank the same quantised tree and residual, and ``wire_bytes`` the
meshless count.  The residual is kept placed as its parameter (this
rank's shard of the whole residual), so only the int8 tree and one
leaf's f32 temporaries are whole on a rank.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .optimizers import (
    _dequantize_blockwise,
    _placed_as,
    _quantize_blockwise,
    _whole,
    is_dtensor,
)

BLOCK = 256


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def compress(grads: Any, block: int = BLOCK) -> Any:
    """Quantise every gradient leaf to an int8 ``QTensor``."""
    return _map(lambda g: _quantize_blockwise(
        _whole(g).to(torch.float32), block), grads)


def decompress(qtree: Any, like: Any = None) -> Any:
    """Inverse of ``compress``; casts back to ``like``'s dtypes if given."""
    if like is None:
        return _map(_dequantize_blockwise, qtree)
    return _map(lambda q, l: _dequantize_blockwise(q).to(l.dtype), qtree,
                like)


def init_error_feedback(params: Any) -> Any:
    """The residual accumulator: f32 zeros shaped like the gradients,
    a DTensor parameter's placed as it is."""
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_with_feedback(grads: Any, residual: Any,
                           block: int = BLOCK) -> Tuple[Any, Any]:
    """Quantise (grads + residual) and carry the quantisation error
    forward.  Returns (qtree, new_residual); a DTensor residual stays
    placed as it was."""
    def one(g, r):
        corrected = _whole(g).to(torch.float32) + _whole(r)
        q = _quantize_blockwise(corrected, block)
        new = corrected - _dequantize_blockwise(q)
        return q, _placed_as(new, r) if is_dtensor(r) else new

    if isinstance(grads, dict):
        pairs = {k: one(g, residual[k]) for k, g in grads.items()}
        return ({k: q for k, (q, _) in pairs.items()},
                {k: r for k, (_, r) in pairs.items()})
    return one(grads, residual)


def wire_bytes(qtree: Any) -> int:
    """Bytes a compressed gradient tree puts on the wire."""
    leaves = qtree.values() if isinstance(qtree, dict) else [qtree]
    return sum(q.q.numel() * q.q.element_size()
               + q.scale.numel() * q.scale.element_size() for q in leaves)
