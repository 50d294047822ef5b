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

``Adam8bit`` keeps its moments as ``QTensor`` slots (int8 blocks and one
f32 scale a block), which ``update_in_place`` overwrites through their
``q`` and ``scale``; ``Adafactor`` keeps factored row and column second
moments.  Both are the reference's plain array code, op for op.  The
reference's optax adapter is not planned: the port has no optax.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.kernels import is_dtensor

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def make_optimizer(name: str, lr: Optional[Schedule] = None, **kwargs):
    """Build an optimiser by CLI-friendly name.

    ``sgd`` (plain), ``momentum`` (heavy-ball 0.9), ``adagrad``, ``adam``,
    ``adamw``, ``adam8bit`` or ``adafactor``; ``lr`` defaults to 3e-2 for
    sgd/momentum/adagrad and 3e-3 for the Adam family and Adafactor.
    ``kwargs`` go to the dataclass.  The reference's ``optax:<name>``
    adapter is not planned (the port has no optax).
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
        "adam8bit": lambda lr, **kw: Adam8bit(
            lr=3e-3 if lr is None else lr, **kw),
        "adafactor": lambda lr, **kw: Adafactor(
            lr=3e-3 if lr is None else lr, **kw),
    }
    if key.startswith("optax:"):
        raise ValueError(
            f"optimizer {name!r}: the optax adapter is not planned for the "
            "PyTorch port, which has no optax; choose a built-in name")
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


def _whole(t):
    """A DTensor's full value on every rank; anything else unchanged."""
    return t.full_tensor() if is_dtensor(t) else t


def _following(t: torch.Tensor, like: torch.Tensor,
               dims: tuple) -> torch.Tensor:
    """``t``, a tensor of the dims ``dims`` of the DTensor ``like`` (in
    order), placed so that each of ``like``'s shards follows its dim and
    a shard of a dim ``t`` lacks is replicated (a partial sum reduced);
    meshless ``t`` itself."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(dims.index(x.dim)) if x.is_shard() and x.dim in dims
          else Replicate() for x in like.placements]
    if tuple(t.placements) == tuple(pl):
        return t
    return t.redistribute(t.device_mesh, pl)


def _placed_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` with the placements of the DTensor ``like``: a DTensor is
    redistributed (a partial one reduced), a plain whole tensor cut to
    this rank's shard (no data moves)."""
    if not is_dtensor(t):
        from repro_torch.dist.sharding import shard_of
        return shard_of(t, like.device_mesh, like.placements)
    if tuple(t.placements) == tuple(like.placements):
        return t
    return t.redistribute(like.device_mesh, like.placements)


@torch.no_grad()
def update_in_place(optimizer: _Optimizer, params: dict, grads: dict, state):
    """One optimiser step over dicts of named tensors, IN PLACE.

    Leaf by leaf: the update is added to ``params[k]`` and the new slots
    are copied into ``state``'s slot tensors, so one leaf's temporaries
    are the only transient memory.  Returns the state with its new step.

    DTensor leaves (a model placed on a mesh): each gradient is first
    placed as its parameter, the update and the new slots are placed as
    the parameter and the old slots before the in-place writes, so a
    slot placed apart from its parameter (the reference places optimiser
    state by its own tree paths) is redistributed around the update.  An
    optimiser whose slots do not follow a shard (``Adam8bit``'s
    256-value blocks of the flattened leaf: ``_whole_leaves``) updates
    the whole leaf on every rank from the gathered gradient.
    """
    sc = optimizer._scalars(state.step)
    whole = getattr(optimizer, "_whole_leaves", False)
    for k, p in params.items():
        old = tuple(None if s is None else s[k] for s in state[1:])
        g = grads[k]
        if is_dtensor(p):
            g = _placed_as(g, p)
            if whole:
                upd, new = optimizer._leaf(
                    _whole(g), old, None, tuple(_whole(x) for x in sc))
            else:
                upd, new = optimizer._leaf(g, old, p, sc)
            upd = _placed_as(upd, p)
            new = tuple(ns if o is None or not is_dtensor(o)
                        else _placed_as(ns, o) for o, ns in zip(old, new))
        else:
            upd, new = optimizer._leaf(g, old, p, sc)
        p.add_(upd.to(p.dtype))
        del upd
        for o, ns in zip(old, new):
            if o is not None and o is not ns:
                o.copy_(ns)      # a QTensor copies its q and scale
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


# ---------------------------------------------------------------------------
# Adam with block-wise int8 moments (optimizer-state compression)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QTensor:
    """Block-quantised tensor: int8 payload + per-block f32 scales.

    ``q`` is (nblocks, block) int8 (the flattened tensor, zero-padded to
    a whole block), ``scale`` (nblocks,) f32, ``shape`` the original
    shape.  ``copy_`` overwrites ``q`` and ``scale`` in place.
    """

    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple

    def copy_(self, other: "QTensor") -> "QTensor":
        if tuple(other.shape) != tuple(self.shape):
            raise ValueError(f"QTensor shape {tuple(other.shape)} != "
                             f"{tuple(self.shape)}")
        self.q.copy_(other.q)
        self.scale.copy_(other.scale)
        return self


def _numel(shape) -> int:
    size = 1
    for s in shape:
        size *= s
    return size


def _quantize_blockwise(x: torch.Tensor, block: int) -> QTensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(
        torch.int8)
    return QTensor(q, scale, tuple(x.shape))


def _dequantize_blockwise(qt: QTensor) -> torch.Tensor:
    flat = (qt.q.to(torch.float32) * qt.scale[:, None]).reshape(-1)
    return flat[:_numel(qt.shape)].reshape(qt.shape)


def _quantized_zeros(shape, block: int, device) -> QTensor:
    """``_quantize_blockwise`` of f32 zeros, without the f32 temporary:
    zero payload, every scale the 1e-12 floor."""
    nblocks = -(-_numel(shape) // block)
    return QTensor(torch.zeros((nblocks, block), dtype=torch.int8,
                               device=device),
                   torch.full((nblocks,), 1e-12, dtype=torch.float32,
                              device=device), tuple(shape))


class Adam8bitState(NamedTuple):
    step: torch.Tensor
    m: QTensor      # a QTensor, or a dict of them
    v: QTensor


@dataclasses.dataclass(frozen=True)
class Adam8bit(_Optimizer):
    """Adam with int8 block-quantised first/second moments.

    Optimiser state drops from 8 bytes a parameter (f32 m and v) to
    ~2.03 (int8 m and v, one f32 scale per ``block`` values); the update
    is computed in f32 after dequantisation, and its f32 updates are the
    reference's.
    """

    lr: Schedule = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    block: int = 256

    state_cls = Adam8bitState
    # a block of the flattened leaf does not follow a shard of the leaf
    _whole_leaves = True

    def _slots(self, p):
        return (_quantized_zeros(p.shape, self.block, p.device),
                _quantized_zeros(p.shape, self.block, p.device))

    def _scalars(self, step):
        t = (step + 1).to(torch.float32)
        return (_lr_at(self.lr, step), 1 - self.b1 ** t, 1 - self.b2 ** t)

    def _leaf(self, g, slots, p, sc):
        lr, c1, c2 = sc
        b1, b2 = self.b1, self.b2
        g32 = g.to(torch.float32)
        m = b1 * _dequantize_blockwise(slots[0]) + (1 - b1) * g32
        v = b2 * _dequantize_blockwise(slots[1]) + (1 - b2) * torch.square(
            g32)
        del g32
        # the reference's -lr * (m / c1) / (sqrt(v / c2) + eps), in the
        # same order, with in-place steps on this leaf's temporaries
        u = (m / c1).mul_(-lr)
        u.div_((v / c2).sqrt_().add_(self.eps))
        return u, (_quantize_blockwise(m, self.block),
                   _quantize_blockwise(v, self.block))


# ---------------------------------------------------------------------------
# Adafactor (factored second moment) — memory-lean alternative for giants
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: torch.Tensor   # row second moment (the full v for < 2-D tensors)
    vc: torch.Tensor   # column second moment ((0,) for < 2-D tensors)


@dataclasses.dataclass(frozen=True)
class Adafactor(_Optimizer):
    lr: Schedule = 1e-2
    decay: float = 0.8     # t^-decay running-average exponent
    eps: float = 1e-30
    clip_threshold: float = 1.0

    state_cls = AdafactorState

    def _slots(self, p):
        z = functools.partial(torch.zeros, dtype=torch.float32,
                              device=p.device)
        if p.dim() >= 2:
            return z(p.shape[:-1]), z(p.shape[:-2] + p.shape[-1:])
        return z(p.shape), z((0,))

    def _scalars(self, step):
        t = (step + 1).to(torch.float32)
        return _lr_at(self.lr, step), 1.0 - t ** (-self.decay)

    def _leaf(self, g, slots, p, sc):
        lr, beta = sc
        vr, vc = slots
        g32 = g.to(torch.float32)
        g2 = torch.square(g32) + self.eps
        n = g.dim()
        if n >= 2:
            # on a mesh the row and column statistics follow the
            # gradient's shards, so v, the size of the leaf, is built on
            # this rank's shard (left to DTensor it can come out whole,
            # 21.5 GB of f32 for an expert stack of llama4's)
            rows, cols = tuple(range(n - 1)), tuple(range(n - 2)) + (n - 1,)
            vr_n = _following(beta * _following(vr, g, rows) + (1 - beta)
                              * torch.mean(g2, dim=-1), g, rows)
            vc_n = _following(beta * _following(vc, g, cols) + (1 - beta)
                              * torch.mean(g2, dim=-2), g, cols)
            r = _following(vr_n / torch.clamp(torch.mean(
                vr_n, dim=-1, keepdim=True), min=self.eps), g, rows)
            v = _following(r[..., None] * vc_n[..., None, :], g,
                           tuple(range(n)))
        else:
            vr_n = beta * vr + (1 - beta) * g2
            vc_n = vc
            v = vr_n
        del g2
        u = g32 / torch.sqrt(torch.clamp(v, min=self.eps))
        del v, g32
        rms = torch.sqrt(torch.mean(torch.square(u)) + self.eps)
        u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
        # updates in the gradient's dtype, as the reference emits them
        return (-lr * u).to(g.dtype), (vr_n, vc_n)
