"""First-order optimisers (PyTorch port of ``repro.optim.optimizers``).

All share the reference's functional interface:

    opt.init(params)                      -> opt_state (NamedTuple)
    opt.update(grads, opt_state, params)  -> (updates, new_opt_state)
    params_new = apply_updates(params, updates)

``params``, ``grads`` and ``updates`` are a tensor (the linear models)
or a dict of named tensors (an LM's ``named_parameters()``), as the
reference's are pytrees.  A state is ``(step, *slots)``: the step count
as a 0-d int32 tensor, so an update never waits on the host, and each
slot (momentum, accumulator, moments) a tensor or a dict of f32
tensors shaped like ``params`` (None where the optimiser keeps none).
Updates come back in the gradients' dtype where the reference's do.
LGD plugs in as a gradient *estimator* underneath any of them.

``update_in_place`` is the LM trainer's form of one step: leaf by leaf,
the update is computed and added to the parameter and the slots are
overwritten in place, so the f32 temporaries of one leaf are the only
transient memory.  Each optimiser therefore splits its update into
``_scalars(step)`` (the per-step learning rate and bias corrections,
computed once) and ``_leaf`` (one tensor's update and new slots).

``Adam8bit``, ``Adafactor``, the optax adapter and ``compression`` come
with the training-stack slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import torch

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]

_NOT_PORTED = ("adam8bit", "adafactor")


def make_optimizer(name: str, lr: Optional[Schedule] = None, **kwargs):
    """Build an optimiser by CLI-friendly name.

    ``sgd`` (plain), ``momentum`` (heavy-ball 0.9), ``adagrad``, ``adam``
    or ``adamw``; ``lr`` defaults to 3e-2 for sgd/momentum/adagrad and
    3e-3 for the Adam family.  ``kwargs`` go to the dataclass.
    """
    key = name.lower()
    makers = {
        "sgd": lambda lr, **kw: SGD(lr=3e-2 if lr is None else lr, **kw),
        "momentum": lambda lr, **kw: SGD(
            lr=3e-2 if lr is None else lr, **{"momentum": 0.9, **kw}),
        "adagrad": lambda lr, **kw: AdaGrad(
            lr=3e-2 if lr is None else lr, **kw),
        "adam": lambda lr, **kw: Adam(lr=3e-3 if lr is None else lr, **kw),
        "adamw": lambda lr, **kw: Adam(
            lr=3e-3 if lr is None else lr, **{"weight_decay": 0.01, **kw}),
    }
    if key in _NOT_PORTED or key.startswith("optax:"):
        raise ValueError(
            f"optimizer {name!r} is not ported to PyTorch yet; it comes "
            "with the training-stack slice (ROADMAP.md queue 1)")
    if key not in makers:
        raise ValueError(
            f"unknown optimizer {name!r}; choose from {sorted(makers)}")
    return makers[key](lr, **kwargs)


def _lr_at(lr: Schedule, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def apply_updates(params, updates):
    if isinstance(params, dict):
        return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
    return params + updates.to(params.dtype)


class _Optimizer:
    """The functional interface over ``_slots`` / ``_scalars`` / ``_leaf``."""

    state_cls: type

    def _slots(self, p: torch.Tensor) -> tuple:
        """Initial per-leaf slots (None for a slot the optimiser skips)."""
        raise NotImplementedError

    def _scalars(self, step: torch.Tensor) -> tuple:
        """Per-step scalars shared by every leaf."""
        return (_lr_at(self.lr, step),)

    def _leaf(self, g, slots: tuple, p, scalars: tuple):
        """(update, new slots) of one tensor."""
        raise NotImplementedError

    def init(self, params):
        first = next(iter(params.values())) if isinstance(params, dict) \
            else params
        step = torch.zeros((), dtype=torch.int32, device=first.device)
        if not isinstance(params, dict):
            return self.state_cls(step, *self._slots(params))
        per_leaf = {k: self._slots(p) for k, p in params.items()}
        first_slots = next(iter(per_leaf.values()))
        return self.state_cls(step, *(
            None if s0 is None else {k: ps[i] for k, ps in per_leaf.items()}
            for i, s0 in enumerate(first_slots)))

    def update(self, grads, state, params=None):
        sc = self._scalars(state.step)
        if not isinstance(grads, dict):
            upd, slots = self._leaf(grads, tuple(state[1:]), params, sc)
            return upd, self.state_cls(state.step + 1, *slots)
        upd = {}
        slots = [None if s is None else {} for s in state[1:]]
        for k, g in grads.items():
            upd[k], new = self._leaf(
                g, tuple(None if s is None else s[k] for s in state[1:]),
                None if params is None else params[k], sc)
            for out, ns in zip(slots, new):
                if out is not None:
                    out[k] = ns
        return upd, self.state_cls(state.step + 1, *slots)


@torch.no_grad()
def update_in_place(optimizer: _Optimizer, params: dict, grads: dict, state):
    """One optimiser step over dicts of named tensors, IN PLACE.

    Leaf by leaf: the update is added to ``params[k]`` and the new slots
    are copied into ``state``'s slot tensors, so one leaf's temporaries
    are the only transient memory.  Returns the state with its new step.
    """
    sc = optimizer._scalars(state.step)
    for k, p in params.items():
        old = tuple(None if s is None else s[k] for s in state[1:])
        upd, new = optimizer._leaf(grads[k], old, p, sc)
        p.add_(upd.to(p.dtype))
        for o, ns in zip(old, new):
            if o is not None:
                o.copy_(ns)
    return state._replace(step=state.step + 1)


# ---------------------------------------------------------------------------
# SGD (+ momentum)
# ---------------------------------------------------------------------------

class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SGD(_Optimizer):
    lr: Schedule = 1e-2
    momentum: float = 0.0
    nesterov: bool = False

    state_cls = SGDState

    def _slots(self, p):
        return (torch.zeros_like(p) if self.momentum else None,)

    def _leaf(self, g, slots, p, sc):
        (lr,) = sc
        if self.momentum:
            mom = self.momentum * slots[0] + g
            if self.nesterov:
                return -lr * (self.momentum * mom + g), (mom,)
            return -lr * mom, (mom,)
        return -lr * g, (None,)


# ---------------------------------------------------------------------------
# AdaGrad (Duchi et al., 2011) — the paper's adaptive-LR companion to LGD
# ---------------------------------------------------------------------------

class AdaGradState(NamedTuple):
    step: torch.Tensor
    accum: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdaGrad(_Optimizer):
    lr: Schedule = 1e-2
    eps: float = 1e-10
    initial_accum: float = 0.0

    state_cls = AdaGradState

    def _slots(self, p):
        return (torch.full_like(p, self.initial_accum, dtype=torch.float32),)

    def _leaf(self, g, slots, p, sc):
        (lr,) = sc
        accum = slots[0] + torch.square(g.to(torch.float32))
        return -lr * g / (torch.sqrt(accum) + self.eps), (accum,)


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Adam(_Optimizer):
    lr: Schedule = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # AdamW-style decoupled decay

    state_cls = AdamState

    def _slots(self, p):
        zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return zeros, zeros.clone()

    def _scalars(self, step):
        t = (step + 1).to(torch.float32)
        return (_lr_at(self.lr, step), 1.0 / (1 - self.b1 ** t),
                1.0 / (1 - self.b2 ** t))

    def _leaf(self, g, slots, p, sc):
        lr, mhat_scale, vhat_scale = sc
        b1, b2 = self.b1, self.b2
        g32 = g.to(torch.float32)
        m = b1 * slots[0] + (1 - b1) * g32
        v = b2 * slots[1] + (1 - b2) * torch.square(g32)
        del g32
        # the reference's -lr * (m * mhat) / (sqrt(v * vhat) + eps), in
        # the same order, with in-place steps on this leaf's temporaries
        upd = (m * mhat_scale).mul_(-lr)
        upd.div_((v * vhat_scale).sqrt_().add_(self.eps))
        if self.weight_decay and p is not None:
            upd = upd - lr * self.weight_decay * p.to(torch.float32)
        # updates in the gradient's dtype, as the reference emits them
        return upd.to(g.dtype), (m, v)
