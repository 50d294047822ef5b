"""Carry state between the JAX package and the port, through numpy.

The port never imports JAX: every function here takes or returns numpy
arrays (anything ``np.asarray`` accepts, JAX arrays included).  With it
both packages compute on identical state — the parity tests build an
index or a training state in one and continue it in the other.

LM parameters: ``lm_params_from_numpy`` maps the reference's pytree
(``embed_group`` plus ``blocks[j]`` stacked over repeats) into the port's
``LM``, layer ``r * len(block_pattern) + j`` from slice ``r``, and the
one shared_attn block ``shared`` from ``params["shared"]`` (the
reference keeps None at its ``blocks[j]``); ``lm_params_to_numpy`` maps
back, None included, so a round trip gives the reference's tree.  bf16
arrays (``ml_dtypes.bfloat16``) cross bit for bit; numpy has no bf16 of
its own, so they come back as f32, which holds every bf16 value exactly.

Packed codes are uint32 in the reference and int64 in [0, 2^32) in the
port; ``order`` is int32 there and int64 here.  A banded family's
``BandedScale`` maps field by field (``banded_scale_{from,to}_numpy``),
and ``lm_head_index_from_numpy`` puts the reference's ``LMHeadIndex``
state (scale, x_aug, index) into a port ``LMHeadIndex``.  Optimiser
states of a single tensor map by class name (``SGDState``,
``AdaGradState``, ``AdamState``, ``Adam8bitState``, ``AdafactorState``)
field by field; a ``QTensor`` crosses as (q, scale, shape).  An LM's
states — slots shaped like the parameter pytree there, dicts keyed by
the port's parameter names here — map with ``adam_state_{from,to}_numpy``,
``adam8bit_state_{from,to}_numpy`` and ``adafactor_state_{from,to}_numpy``.

The reference quantises (Adam8bit) and factors (Adafactor) each
STACKED leaf — (repeats, ...) over a block pattern's layers — where the
port has one leaf a layer.  The two are the same state only where a
stacked leaf splits exactly: a QTensor when each layer's size is a whole
number of blocks (or there is one repeat); Adafactor's ≥ 2-D leaves
always, and a layer's 1-D leaf (a norm scale) only at one repeat, where
the reference's one-row factoring is the port's unfactored moment.
Elsewhere these functions raise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.families import BandedScale
from repro_torch.core.lgd import LGDState
from repro_torch.core.tables import LSHIndex
from repro_torch.models import LM, LMHeadIndex, ModelConfig
from repro_torch.optim import (
    AdafactorState,
    AdaGradState,
    Adam8bitState,
    AdamState,
    QTensor,
    SGDState,
)

_OPT_STATES = {cls.__name__: cls for cls in (
    SGDState, AdaGradState, AdamState, Adam8bitState, AdafactorState)}


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


def qtensor_from_numpy(q, scale, shape, device="cpu") -> QTensor:
    """A reference ``QTensor``'s (q, scale, shape) -> port."""
    return QTensor(tensor_from_numpy(np.asarray(q, np.int8), device),
                   tensor_from_numpy(np.asarray(scale, np.float32), device),
                   tuple(shape))


def qtensor_to_numpy(qt: QTensor) -> tuple:
    """Port ``QTensor`` -> (int8 q, f32 scale, shape)."""
    return (qt.q.detach().cpu().numpy(), qt.scale.detach().cpu().numpy(),
            tuple(qt.shape))


def _field_from_numpy(f, device):
    if f is None:
        return None
    if hasattr(f, "q") and hasattr(f, "scale"):      # a reference QTensor
        return qtensor_from_numpy(f.q, f.scale, f.shape, device)
    return tensor_from_numpy(f, device)


def opt_state_from_numpy(state, device="cpu"):
    """A reference optimiser state of one tensor (NamedTuple of arrays,
    QTensors or None) -> port."""
    cls = _OPT_STATES.get(type(state).__name__)
    if cls is None:
        raise TypeError(f"no port of optimiser state {type(state).__name__}")
    return cls(*(_field_from_numpy(f, device) for f in state))


def opt_state_to_numpy(state) -> dict:
    """Port optimiser state -> {field: numpy array, (q, scale, shape) of a
    QTensor, or None}."""
    return {name: None if f is None else
            qtensor_to_numpy(f) if isinstance(f, QTensor) else
            f.detach().cpu().numpy()
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
    ``(group, dotted)`` in the unstacked ``embed_group`` or ``shared``
    (the one shared_attn block), or ``(j, r, dotted)`` in slice r of
    ``blocks[j]`` — port layer i is pattern position j, repeat r, with
    ``r, j = divmod(i, len(block_pattern))``."""
    head, rest = name.split(".", 1)
    if head in ("embed_group", "shared"):
        return head, rest
    i, dotted = rest.split(".", 1)
    r, j = divmod(int(i), len(cfg.block_pattern))
    return j, r, dotted


def _leaf(tree: dict, dotted: str):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


def _empty_tree(cfg: ModelConfig) -> dict:
    """The reference's LM pytree without leaves: ``blocks[j]`` is None at
    a shared_attn position, and ``shared`` exists when one does."""
    out = {"embed_group": {}, "blocks": [
        None if kind == "shared_attn" else {} for kind in cfg.block_pattern]}
    if "shared_attn" in cfg.block_pattern:
        out["shared"] = {}
    return out


def lm_tree_from_numpy(tree, lm: LM) -> dict:
    """A pytree shaped like the reference's LM params (the params, or
    Adam's moments) -> {``lm``'s parameter name: tensor on its device}."""
    out = {}
    for name, _ in lm.named_parameters():
        where = _where(name, lm.cfg)
        a = (_leaf(tree[where[0]], where[1]) if len(where) == 2
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
    (stacked over repeats, None at a shared_attn position), as numpy;
    bf16 leaves come back as f32."""
    out = _empty_tree(cfg)
    stacks: dict = {}       # (j, dotted name) -> the repeats, in order
    for name, t in named.items():
        where = _where(name, cfg)
        if len(where) == 2:
            _set(out[where[0]], where[1], _to_numpy(t))
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


def _stacked(name: str, cfg: ModelConfig):
    """(repeat r, repeats R) of a block parameter, None for the embed
    group's and the shared block's."""
    where = _where(name, cfg)
    if len(where) == 2:
        return None
    return where[1], cfg.n_layers // len(cfg.block_pattern)


def _ref_leaf(tree, name: str, cfg: ModelConfig):
    """The reference's leaf (whole stack) holding the port's ``name``."""
    where = _where(name, cfg)
    if len(where) == 2:
        return _leaf(tree[where[0]], where[1])
    return _leaf(tree["blocks"][where[0]], where[2])


def _set_ref(out: dict, name: str, cfg: ModelConfig, value) -> None:
    where = _where(name, cfg)
    if len(where) == 2:
        _set(out[where[0]], where[1], value)
    else:
        _set(out["blocks"][where[0]], where[2], value)


def _blocks_of(shape, block: int, name: str, repeats: int) -> int:
    """Blocks one layer's slice of a stacked QTensor takes; raises where
    the layers share a block."""
    size = int(np.prod(shape, dtype=np.int64))
    if repeats > 1 and size % block:
        raise ValueError(
            f"{name}: {size} values a layer is not a whole number of "
            f"{block}-value blocks, so the reference's stacked QTensor "
            f"shares blocks between layers")
    return -(-size // block)


def adam8bit_state_from_numpy(state, lm: LM) -> Adam8bitState:
    """The reference's ``Adam8bitState`` over LM params -> the port's,
    with dicts of ``QTensor`` keyed by ``lm``'s parameter names."""
    cfg, dev = lm.cfg, lm.device

    def slot(tree):
        out = {}
        for name, p in lm.named_parameters():
            ref = _ref_leaf(tree, name, cfg)
            q, scale = np.asarray(ref.q), np.asarray(ref.scale)
            st = _stacked(name, cfg)
            if st is not None:
                n = _blocks_of(p.shape, q.shape[1], name, st[1])
                q, scale = (q[st[0] * n:(st[0] + 1) * n],
                            scale[st[0] * n:(st[0] + 1) * n])
            out[name] = qtensor_from_numpy(q, scale, p.shape, dev)
        return out

    return Adam8bitState(tensor_from_numpy(state.step, dev),
                         slot(state.m), slot(state.v))


def adam8bit_state_to_numpy(state: Adam8bitState, cfg: ModelConfig) -> dict:
    """The port's dict ``Adam8bitState`` -> {"step", "m", "v"} in the
    reference's layout: each leaf (q, scale, shape), layers' blocks
    concatenated into the stacked leaf's."""
    def slot(named):
        out = _empty_tree(cfg)
        stacks: dict = {}
        for name, qt in named.items():
            q, scale, shape = qtensor_to_numpy(qt)
            st = _stacked(name, cfg)
            if st is None:
                _set_ref(out, name, cfg, (q, scale, shape))
                continue
            _blocks_of(shape, q.shape[1], name, st[1])
            where = _where(name, cfg)
            stacks.setdefault((where[0], where[2]), []).append(
                (q, scale, shape))
        for (j, dotted), parts in stacks.items():
            _set(out["blocks"][j], dotted, (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                (len(parts),) + tuple(parts[0][2])))
        return out

    return {"step": state.step.detach().cpu().numpy(),
            "m": slot(state.m), "v": slot(state.v)}


def adafactor_state_from_numpy(state, lm: LM) -> AdafactorState:
    """The reference's ``AdafactorState`` over LM params -> the port's."""
    cfg, dev = lm.cfg, lm.device
    vr, vc = {}, {}
    for name, p in lm.named_parameters():
        r_, c_ = (np.asarray(_ref_leaf(t_, name, cfg))
                  for t_ in (state.vr, state.vc))
        st = _stacked(name, cfg)
        if st is not None and p.dim() >= 2:
            r_, c_ = r_[st[0]], c_[st[0]]
        elif st is not None:
            if st[1] != 1:
                raise ValueError(
                    f"{name}: the reference factors the stacked "
                    f"({st[1]}, ...) leaf of this 1-D parameter")
            r_, c_ = c_, np.zeros((0,), np.float32)
        vr[name] = tensor_from_numpy(r_, dev)
        vc[name] = tensor_from_numpy(c_, dev)
    return AdafactorState(tensor_from_numpy(state.step, dev), vr, vc)


def adafactor_state_to_numpy(state: AdafactorState,
                             cfg: ModelConfig) -> dict:
    """The port's dict ``AdafactorState`` -> {"step", "vr", "vc"} in the
    reference's layout.  A 1-D layer parameter at one repeat becomes the
    reference's one-row factoring: vc the port's moment, vr its mean
    (what the row statistic holds, since both are running means of the
    same squares)."""
    vr, vc = _empty_tree(cfg), _empty_tree(cfg)
    stacks: dict = {}
    for name in state.vr:
        r_, c_ = (_to_numpy(state.vr[name]), _to_numpy(state.vc[name]))
        st = _stacked(name, cfg)
        if st is None:
            _set_ref(vr, name, cfg, r_)
            _set_ref(vc, name, cfg, c_)
            continue
        if c_.size == 0 and r_.ndim == 1:          # a 1-D parameter
            if st[1] != 1:
                raise ValueError(
                    f"{name}: the reference factors the stacked "
                    f"({st[1]}, ...) leaf of this 1-D parameter")
            _set_ref(vr, name, cfg, np.mean(r_, keepdims=True))
            _set_ref(vc, name, cfg, r_)
            continue
        where = _where(name, cfg)
        stacks.setdefault((where[0], where[2]), []).append((r_, c_))
    for (j, dotted), parts in stacks.items():
        _set(vr["blocks"][j], dotted, np.stack([p[0] for p in parts]))
        _set(vc["blocks"][j], dotted, np.stack([p[1] for p in parts]))
    return {"step": state.step.detach().cpu().numpy(), "vr": vr, "vc": vc}
