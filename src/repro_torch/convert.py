"""Carry state between the JAX package and the port, through numpy.

The port never imports JAX: every function here takes or returns numpy
arrays (anything ``np.asarray`` accepts, JAX arrays included).  With it
both packages compute on identical state — the parity tests build an
index or a training state in one and continue it in the other.

LM parameters: ``lm_params_from_numpy`` maps the reference's pytree
(``embed_group`` plus ``blocks[j]`` stacked over repeats) into the port's
``LM``, layer ``r * len(block_pattern) + j`` from slice ``r``;
``lm_params_to_numpy`` maps back.  bf16 arrays (``ml_dtypes.bfloat16``)
cross bit for bit; numpy has no bf16 of its own, so they come back as
f32, which holds every bf16 value exactly.

Packed codes are uint32 in the reference and int64 in [0, 2^32) in the
port; ``order`` is int32 there and int64 here.  A banded family's
``BandedScale`` maps field by field (``banded_scale_{from,to}_numpy``),
and ``lm_head_index_from_numpy`` puts the reference's ``LMHeadIndex``
state (scale, x_aug, index) into a port ``LMHeadIndex``.  Optimiser
states of a single tensor map by class name (``SGDState``,
``AdaGradState``, ``AdamState``) field by field.  An LM's Adam state — moments shaped
like the parameter pytree there, dicts keyed by the port's parameter
names here — maps with ``adam_state_{from,to}_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.families import BandedScale
from repro_torch.core.lgd import LGDState
from repro_torch.core.tables import LSHIndex
from repro_torch.models import LM, LMHeadIndex, ModelConfig
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


def banded_scale_from_numpy(scale, device="cpu") -> BandedScale:
    """The reference's ``BandedScale`` (boundaries, scales) -> port."""
    return BandedScale(*(tensor_from_numpy(np.asarray(f, np.float32), device)
                         for f in scale))


def banded_scale_to_numpy(scale: BandedScale):
    """``BandedScale`` -> (boundaries, scales) as float32 numpy."""
    return tuple(f.detach().cpu().numpy().astype(np.float32) for f in scale)


def lm_head_index_from_numpy(head: LMHeadIndex, scale, x_aug, index,
                             refreshes: int = 0) -> LMHeadIndex:
    """Load the reference's ``LMHeadIndex`` state into ``head`` (built on
    the same model and config): the pinned scale (a ``BandedScale``'s
    fields, or M), ``x_aug``, the (projections, sorted_codes, order)
    index and the refresh count the drift draw is keyed by.  Both sides
    then hold the same index."""
    dev = head.device
    head.scale = (banded_scale_from_numpy(scale, dev)
                  if isinstance(scale, tuple) else
                  tensor_from_numpy(np.asarray(scale, np.float32), dev))
    head.x_aug = tensor_from_numpy(np.asarray(x_aug, np.float32), dev)
    head.index = index_from_numpy(*index, device=dev)
    head.refreshes = refreshes
    return head


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


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _where(name: str, cfg: ModelConfig):
    """Where the reference keeps the port's parameter ``name``:
    ``(None, dotted)`` in ``embed_group``, or ``(j, r, dotted)`` in slice
    r of ``blocks[j]`` — port layer i is pattern position j, repeat r,
    with ``r, j = divmod(i, len(block_pattern))``."""
    head, rest = name.split(".", 1)
    if head == "embed_group":
        return None, rest
    i, dotted = rest.split(".", 1)
    r, j = divmod(int(i), len(cfg.block_pattern))
    return j, r, dotted


def _leaf(tree: dict, dotted: str):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


def lm_tree_from_numpy(tree, lm: LM) -> dict:
    """A pytree shaped like the reference's LM params (the params, or
    Adam's moments) -> {``lm``'s parameter name: tensor on its device}."""
    out = {}
    for name, _ in lm.named_parameters():
        where = _where(name, lm.cfg)
        a = (_leaf(tree["embed_group"], where[1]) if where[0] is None
             else _leaf(tree["blocks"][where[0]], where[2])[where[1]])
        out[name] = _to_tensor(a).to(lm.device)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _set(tree: dict, dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = value


def lm_tree_to_numpy(named: dict, cfg: ModelConfig) -> dict:
    """{port parameter name: tensor} -> the reference's pytree layout
    (stacked over repeats), as numpy; bf16 leaves come back as f32."""
    out = {"embed_group": {}, "blocks": [{} for _ in cfg.block_pattern]}
    stacks: dict = {}       # (j, dotted name) -> the repeats, in order
    for name, t in named.items():
        where = _where(name, cfg)
        if where[0] is None:
            _set(out["embed_group"], where[1], _to_numpy(t))
        else:
            stacks.setdefault((where[0], where[2]), []).append(_to_numpy(t))
    for (j, dotted), arrs in stacks.items():
        _set(out["blocks"][j], dotted, np.stack(arrs))
    return out


@torch.no_grad()
def lm_params_from_numpy(params, cfg: ModelConfig, device) -> LM:
    """The reference's ``init_params`` pytree -> the port's ``LM`` on
    ``device`` (no default: the caller names the device)."""
    lm = LM(cfg, device=device)
    own = dict(lm.named_parameters())
    for name, t in lm_tree_from_numpy(params, lm).items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: reference shape {tuple(t.shape)} != "
                             f"port shape {tuple(own[name].shape)}")
        own[name].copy_(t)
    return lm


def lm_params_to_numpy(lm: LM) -> dict:
    """The port's ``LM`` -> the reference's pytree layout (stacked over
    repeats), as numpy; bf16 leaves come back as f32."""
    return lm_tree_to_numpy(dict(lm.named_parameters()), lm.cfg)


def adam_state_from_numpy(state, lm: LM) -> AdamState:
    """The reference's ``AdamState`` over LM params -> the port's, with
    dicts of f32 moments keyed by ``lm``'s parameter names."""
    return AdamState(tensor_from_numpy(state.step, lm.device),
                     lm_tree_from_numpy(state.m, lm),
                     lm_tree_from_numpy(state.v, lm))


def adam_state_to_numpy(state: AdamState, cfg: ModelConfig) -> dict:
    """The port's dict ``AdamState`` -> {"step", "m", "v"} in the
    reference's layout, as numpy."""
    return {"step": state.step.detach().cpu().numpy(),
            "m": lm_tree_to_numpy(state.m, cfg),
            "v": lm_tree_to_numpy(state.v, cfg)}
