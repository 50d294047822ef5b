"""First-order optimisers (PyTorch port of ``repro.optim.optimizers``).

All share the reference's functional interface:

    opt.init(params)                      -> opt_state (NamedTuple)
    opt.update(grads, opt_state, params)  -> (updates, new_opt_state)
    params_new = apply_updates(params, updates)

``params``, ``grads`` and ``updates`` are tensors (the linear models of
this slice); states hold tensors on the parameters' device, with the
step count as a 0-d int32 tensor, so an update never waits on the host.
LGD plugs in as a gradient *estimator* underneath any of them.

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


def apply_updates(params: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    return params + updates.to(params.dtype)


def _step0(params: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params.device)


# ---------------------------------------------------------------------------
# SGD (+ momentum)
# ---------------------------------------------------------------------------

class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Schedule = 1e-2
    momentum: float = 0.0
    nesterov: bool = False

    def init(self, params):
        mom = torch.zeros_like(params) if self.momentum else None
        return SGDState(_step0(params), mom)

    def update(self, grads, state: SGDState, params=None):
        lr = _lr_at(self.lr, state.step)
        if self.momentum:
            mom = self.momentum * state.momentum + grads
            if self.nesterov:
                upd = -lr * (self.momentum * mom + grads)
            else:
                upd = -lr * mom
            return upd, SGDState(state.step + 1, mom)
        return -lr * grads, SGDState(state.step + 1, None)


# ---------------------------------------------------------------------------
# AdaGrad (Duchi et al., 2011) — the paper's adaptive-LR companion to LGD
# ---------------------------------------------------------------------------

class AdaGradState(NamedTuple):
    step: torch.Tensor
    accum: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdaGrad:
    lr: Schedule = 1e-2
    eps: float = 1e-10
    initial_accum: float = 0.0

    def init(self, params):
        return AdaGradState(
            _step0(params),
            torch.full_like(params, self.initial_accum, dtype=torch.float32))

    def update(self, grads, state: AdaGradState, params=None):
        lr = _lr_at(self.lr, state.step)
        accum = state.accum + torch.square(grads.to(torch.float32))
        upd = -lr * grads / (torch.sqrt(accum) + self.eps)
        return upd, AdaGradState(state.step + 1, accum)


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Schedule = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # AdamW-style decoupled decay

    def init(self, params):
        zeros = torch.zeros(params.shape, dtype=torch.float32,
                            device=params.device)
        return AdamState(_step0(params), zeros, zeros.clone())

    def update(self, grads, state: AdamState, params=None):
        step = state.step + 1
        lr = _lr_at(self.lr, state.step)
        b1, b2 = self.b1, self.b2
        g = grads.to(torch.float32)
        m = b1 * state.m + (1 - b1) * g
        v = b2 * state.v + (1 - b2) * torch.square(g)
        t = step.to(torch.float32)
        mhat_scale = 1.0 / (1 - b1 ** t)
        vhat_scale = 1.0 / (1 - b2 ** t)
        upd = -lr * (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + self.eps)
        if self.weight_decay and params is not None:
            upd = upd - lr * self.weight_decay * params.to(torch.float32)
        return upd.to(grads.dtype), AdamState(step, m, v)
