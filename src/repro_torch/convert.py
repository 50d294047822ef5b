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
port; ``order`` is int32 there and int64 here.  Optimiser states map by
class name (``SGDState``, ``AdaGradState``, ``AdamState``) field by
field.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lgd import LGDState
from repro_torch.core.tables import LSHIndex
from repro_torch.models import LM, ModelConfig
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


# LM leaves by dotted name: the same path in the port's modules and in
# the reference's dicts
_ATTN = ("norm.scale", "wq", "wk", "wv", "wo")
_FFN = ("norm.scale", "w_up", "w_down", "w_gate")
_EMBED = ("embed", "lm_head", "final_norm.scale")


def _leaf(tree, dotted: str):
    """``tree``'s leaf at a dotted path: attributes of a module, keys of a
    reference dict."""
    for key in dotted.split("."):
        tree = (getattr(tree, key) if isinstance(tree, torch.nn.Module)
                else tree[key])
    return tree


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


@torch.no_grad()
def _assign(param: torch.Tensor, a, name: str) -> None:
    t = _to_tensor(a)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: reference shape {tuple(t.shape)} != "
                         f"port shape {tuple(param.shape)}")
    param.copy_(t)


def _groups(lm: LM):
    """(port module, leaf names, where) for the embedding group (where
    None) and each layer's attn and ffn (where (j, r, "attn" | "ffn"):
    pattern position j, repeat r)."""
    n_pat = len(lm.cfg.block_pattern)
    yield lm.embed_group, _EMBED, None
    for i, blk in enumerate(lm.blocks):
        r, j = divmod(i, n_pat)
        yield blk.attn, _ATTN, (j, r, "attn")
        if blk.ffn is not None:
            yield blk.ffn, _FFN, (j, r, "ffn")


def lm_params_from_numpy(params, cfg: ModelConfig, device) -> LM:
    """The reference's ``init_params`` pytree -> the port's ``LM`` on
    ``device`` (no default: the caller names the device)."""
    lm = LM(cfg, device=device)
    for module, names, where in _groups(lm):
        for name in names:
            param = _leaf(module, name)
            if param is None:
                continue
            if where is None:
                _assign(param, _leaf(params["embed_group"], name),
                        f"embed_group.{name}")
            else:
                j, r, kind = where
                _assign(param, _leaf(params["blocks"][j][kind], name)[r],
                        f"blocks[{j}].{kind}.{name}[{r}]")
    return lm


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _set(tree: dict, dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = value


def lm_params_to_numpy(lm: LM) -> dict:
    """The port's ``LM`` -> the reference's pytree layout (stacked over
    repeats), as numpy; bf16 leaves come back as f32."""
    out = {"embed_group": {},
           "blocks": [{} for _ in lm.cfg.block_pattern]}
    stacks: dict = {}       # (j, dotted name) -> the repeats, in order
    for module, names, where in _groups(lm):
        for name in names:
            param = _leaf(module, name)
            if param is None:
                continue
            if where is None:
                _set(out["embed_group"], name, _to_numpy(param))
            else:
                j, _, kind = where
                stacks.setdefault((j, f"{kind}.{name}"), []).append(
                    _to_numpy(param))
    for (j, dotted), arrs in stacks.items():
        _set(out["blocks"][j], dotted, np.stack(arrs))
    return out
