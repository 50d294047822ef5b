"""Carry state between the JAX package and the port, through numpy.

The port never imports JAX: every function here takes or returns numpy
arrays (anything ``np.asarray`` accepts, JAX arrays included).  With it
both packages compute on identical state — the parity tests build an
index or a training state in one and continue it in the other.

Packed codes are uint32 in the reference and int64 in [0, 2^32) in the
port; ``order`` is int32 there and int64 here.  Optimiser states map by
class name (``SGDState``, ``AdaGradState``, ``AdamState``) field by
field.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lgd import LGDState
from repro_torch.core.tables import LSHIndex
from repro_torch.optim import AdaGradState, AdamState, SGDState

_OPT_STATES = {cls.__name__: cls for cls in (SGDState, AdaGradState,
                                             AdamState)}


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def codes_from_numpy(codes, device="cpu") -> torch.Tensor:
    """uint32 codes -> int64 codes in [0, 2^32)."""
    a = np.asarray(codes)
    if a.dtype != np.uint32:
        raise TypeError(f"reference codes are uint32, got {a.dtype}")
    return torch.from_numpy(a.astype(np.int64)).to(device)


def codes_to_numpy(codes: torch.Tensor) -> np.ndarray:
    """int64 codes in [0, 2^32) -> uint32 codes."""
    a = codes.detach().cpu().numpy()
    if a.size and (a.min() < 0 or a.max() >= 2 ** 32):
        raise ValueError("codes out of the uint32 range")
    return a.astype(np.uint32)


def index_from_numpy(projections, sorted_codes, order,
                     device="cpu") -> LSHIndex:
    """The reference's (projections, sorted_codes, order) -> ``LSHIndex``."""
    return LSHIndex(
        tensor_from_numpy(np.asarray(projections, np.float32), device),
        codes_from_numpy(sorted_codes, device),
        torch.from_numpy(np.asarray(order).astype(np.int64)).to(device))


def index_to_numpy(index: LSHIndex):
    """``LSHIndex`` -> (float32 projections, uint32 codes, int32 order)."""
    return (index.projections.detach().cpu().numpy().astype(np.float32),
            codes_to_numpy(index.sorted_codes),
            index.order.detach().cpu().numpy().astype(np.int32))


def opt_state_from_numpy(state, device="cpu"):
    """A reference optimiser state (NamedTuple of arrays / None) -> port."""
    cls = _OPT_STATES.get(type(state).__name__)
    if cls is None:
        raise TypeError(f"no port of optimiser state {type(state).__name__}")
    return cls(*(None if f is None else tensor_from_numpy(f, device)
                 for f in state))


def opt_state_to_numpy(state) -> dict:
    """Port optimiser state -> {field: numpy array or None}."""
    return {name: None if f is None else f.detach().cpu().numpy()
            for name, f in zip(state._fields, state)}


def lgd_state_from_numpy(state, device="cpu") -> LGDState:
    """A reference ``LGDState`` (theta, opt_state, index, step) -> port."""
    return LGDState(
        tensor_from_numpy(state.theta, device),
        opt_state_from_numpy(state.opt_state, device),
        index_from_numpy(*state.index, device=device),
        tensor_from_numpy(state.step, device))


def lgd_state_to_numpy(state: LGDState) -> dict:
    return {"theta": state.theta.detach().cpu().numpy(),
            "opt_state": opt_state_to_numpy(state.opt_state),
            "index": index_to_numpy(state.index),
            "step": state.step.detach().cpu().numpy()}
