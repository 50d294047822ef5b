"""Training loop: LGD-sampled or uniform batches, gradient clipping, the
non-finite guard, checkpoints with resume and rollback, gradient
compression and the step hook (PyTorch port of ``repro.train.trainer``).

One step: loss -> backward -> (``grad_compress``: int8 compression with
error feedback, then decompression) -> global gradient norm -> the
non-finite guard -> clip to ``grad_clip`` -> the optimiser, applied leaf
by leaf in place on the model's parameters (``optim.update_in_place``).
Parameters are the model's ``named_parameters()``, under the names
``repro_torch.convert`` maps to the reference's pytree.

THE GUARD.  With ``skip_nonfinite`` a step whose loss or gradient norm
is not finite applies NO update: the finiteness flag is read on the
host before the optimiser runs, and a False flag skips it, so params,
optimiser state and the error-feedback residual stay bitwise unchanged.
(The reference selects the old buffers inside its jitted step instead;
eagerly, a branch saves the extra passes over every parameter and
moment that a select costs.)  The batch is still consumed and ``step``
still advances, keeping the data stream aligned with the step counter.
Counted in ``skipped_steps``.

FAULT TOLERANCE (with ``ckpt_dir``), the reference's contract:
  * every ``ckpt_every`` steps an asynchronous atomic checkpoint of
    ``{"params", "opt_state"}`` (``train.checkpoint``), with the step and
    a streaming sampler's mutation log in its manifest; the tree is
    copied to host memory before the next step runs;
  * ``resume=True`` restores the newest checkpoint that passes
    ``verify()`` into the live tensors, in place, and drops newer ones
    (an abandoned timeline); a sampler is then rewound with
    ``restore_at(step)``, a plain iterator by skipping consumed batches;
  * ``rollback_after`` consecutive skipped steps roll back to the newest
    verified checkpoint (sampler mode; at most ``max_rollbacks`` times),
    logged as a ``rollback`` event in ``metrics_history``.
``step_hook(trainer)`` runs after every completed step, after its
checkpoint (e.g. ``LMHeadIndex.step_hook``).

ADAPTIVE OPTIMIZERS under LGD: the importance weights 1/(p_i N) enter
the LOSS (``models.layers.chunked_cross_entropy``), so the gradient any
optimiser receives is the unbiased estimate of the full-batch gradient,
and Adam's moments are running statistics of that estimate.

LGD sampler hook: pass ``sampler=`` (an ``LSHSampledPipeline``) instead
of ``batches``.  The trainer draws ``sampler.next_batch`` (device
tensors, no host-side assembly), pushes the live model through
``sampler.set_params`` after every step, calls
``sampler.before_param_update`` before each in-place update (an async
refresh in flight must read the launch-time weights first), feeds
``sampler.note_loss`` each step's finiteness (the degradation ladder),
and at log cadence reads ``sampler_stats``, ``check_health`` and
``health_summary`` into ``metrics_history``.  ``data_seconds``
accumulates the host time spent drawing batches and
``sampler_overhead`` is its share of the loop's wall time.

Host syncs per step are the reference's: the finiteness flag and the
loss are read once each (``bool``, ``float``).

UNDER A MESH (a model placed by ``dist.sharding.distribute_model``): the
optimiser state is placed by ``tree_param_shardings`` as the reference
places its optimiser state (``distribute_state``), the loss and the
gradients are DTensors, the global clip norm sums every shard's squares
(a DTensor reduction over the whole mesh, read whole on every rank), and
``optim.update_in_place`` places each update as its parameter.  With
``grad_compress`` each leaf's gradient is compressed whole, as the
reference's step compresses whatever gradients it has: made replicated
first, so the quantised tree and the error-feedback residual are the
same on every rank; the residual is kept placed as its parameter, and
each decompressed gradient is placed as its parameter as it is made
(``optim.optimizers._placed_as``, Adam8bit's whole-leaf
redistribution), before the clip and the update, so one leaf at a time
is whole in f32.  As meshless, the residual is not part of a
checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.dist.sharding import (
    distribute_state,
    is_dtensor,
    replicate_like,
    to_local_replicated,
)
from repro_torch.optim import compression, update_in_place
from repro_torch.optim.optimizers import _placed_as
from . import checkpoint as ckpt


@dataclasses.dataclass
class TrainerConfig:
    """The reference's config, field for field.  ``donate`` is a JAX
    buffer knob (the port updates in place): kept so configs compare
    equal, and inert."""

    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    grad_clip: Optional[float] = 1.0
    donate: bool = True
    # split each batch into N equal slices along dim 0 and accumulate
    # their gradients in f32
    grad_accum: int = 1
    # int8 gradient compression with error feedback (optim/compression.py)
    grad_compress: bool = False
    skip_nonfinite: bool = True
    # consecutive skipped steps before a rollback to the newest verified
    # checkpoint (sampler mode); 0 disables it
    rollback_after: int = 5
    max_rollbacks: int = 3        # lifetime cap on rollbacks
    # called with the Trainer after every completed step (post-update,
    # post-checkpoint); it may mutate the params (then push them with
    # ``trainer.sampler.set_params``) or raise at this clean boundary
    step_hook: Optional[Callable] = None


def _micro(x, accum: int, i: int):
    """Slice ``i`` of ``accum`` equal slices along dim 0."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    mb = x.shape[0] // accum
    return x[i * mb:(i + 1) * mb]


class Trainer:
    """Training loop with the LGD-sampler hook and metrics.

    Args:
      cfg: model config.
      params: the model (an ``LM``); its parameters are updated in place.
      optimizer: any ``repro_torch.optim`` optimiser.
      batches: iterator of batch dicts (uniform mode); exclusive with
        ``sampler``.
      tcfg: loop policy knobs.
      resume: restore the newest valid checkpoint in ``tcfg.ckpt_dir``.
      loss_fn: optional ``loss_fn(params, batch)``; default
        ``params.loss(batch)``.
      sampler: an ``LSHSampledPipeline`` (LGD mode).

    Determinism: with a sampler, restoring at step t replays the batch
    sequence of a run that reached step t; with ``batches``, restore
    skips the consumed batches, so the iterator must be re-creatable.
    """

    def __init__(
        self,
        cfg,
        params,
        optimizer,
        batches: Optional[Iterator[Dict[str, torch.Tensor]]] = None,
        tcfg: TrainerConfig = TrainerConfig(),
        resume: bool = True,
        loss_fn: Optional[Callable] = None,
        sampler=None,
    ):
        if (batches is None) == (sampler is None):
            raise ValueError("pass exactly one of batches= or sampler=")
        self._sampler = sampler
        if sampler is not None:
            sampler.set_params(params)
            batches = iter(sampler.next_batch, None)
        self.cfg = cfg
        self.optimizer = optimizer
        self.batches = batches
        self.tcfg = tcfg
        self.params = params
        self.named_params = dict(params.named_parameters())
        self.opt_state = optimizer.init(
            {k: p.detach() for k, p in self.named_params.items()})
        first = next(iter(self.named_params.values()))
        self.mesh = first.device_mesh if is_dtensor(first) else None
        if self.mesh is not None:
            self.opt_state = distribute_state(self.opt_state, self.mesh, cfg)
        self.loss_fn = loss_fn or (lambda p, b: p.loss(b))
        self.step = 0
        self.metrics_history = []
        self._ewma_dt = None
        self.straggler_steps = 0
        self.skipped_steps = 0      # non-finite steps (no update applied)
        self.rollbacks = 0          # checkpoint rollbacks taken
        self._bad_streak = 0        # consecutive skipped steps
        self.data_seconds = 0.0     # host-blocking batch-draw time (total)
        self.loop_seconds = 0.0     # total run() wall time
        self._last_draw_dt = 0.0    # host-blocking time of the last draw
        self._ckpt = ckpt.AsyncCheckpointer()
        self._ef_residual = (compression.init_error_feedback(
            {k: p.detach() for k, p in self.named_params.items()})
            if tcfg.grad_compress else None)
        if resume and tcfg.ckpt_dir:
            # the newest checkpoint that passes verify(): a corrupt
            # newest costs one interval, not the run
            last = ckpt.latest_valid_step(tcfg.ckpt_dir)
            if last is not None:
                self.restore(last)

    # -- one step -------------------------------------------------------------

    def _grads_of(self, batch):
        """(loss, {name: gradient}) of one batch, over ``grad_accum``
        micro-batches (gradients summed in f32, then averaged)."""
        accum = max(self.tcfg.grad_accum, 1)
        if accum == 1:
            loss = self.loss_fn(self.params, batch)
            loss.backward()
            return to_local_replicated(loss.detach()), {
                k: p.grad for k, p in self.named_params.items()}
        total, acc = None, None
        for i in range(accum):
            mb = {k: _micro(v, accum, i) for k, v in batch.items()}
            loss = self.loss_fn(self.params, mb)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
            if acc is None:
                acc = {k: p.grad.float() for k, p in self.named_params.items()}
            else:
                for k, p in self.named_params.items():
                    acc[k] += p.grad
            for p in self.named_params.values():
                p.grad = None
        scale = 1.0 / accum
        return to_local_replicated(total) * scale, {
            k: g * scale for k, g in acc.items()}

    def _placed(self, name, t):
        """``t`` placed as parameter ``name`` (unchanged meshless)."""
        p = self.named_params[name]
        return _placed_as(t, p) if is_dtensor(p) else t

    def train_step(self, batch):
        """One optimiser step on ``batch``; returns (loss, grad_norm) as
        device tensors and ``ok``, whether the update was applied (a
        bool; None without the guard)."""
        loss, grads = self._grads_of(batch)
        clip, guard = self.tcfg.grad_clip, self.tcfg.skip_nonfinite
        with torch.no_grad():
            if self._ef_residual is not None:
                # the quantised tree is what a data-parallel reduce sends;
                # a DTensor leaf is compressed whole, and each decompressed
                # gradient placed as its parameter as it is made
                qtree, residual = compression.compress_with_feedback(
                    grads, self._ef_residual)
                grads = {k: self._placed(k, compression.decompress(
                    q, like=grads[k])) for k, q in qtree.items()}
                del qtree
            if clip is not None or guard:
                # one NaN/Inf anywhere propagates into the norm, so its
                # finiteness checks the whole gradient
                # under a mesh each square-sum is a reduction over every
                # shard of its leaf
                gnorm = to_local_replicated(torch.sqrt(sum(
                    g.float().square().sum() for g in grads.values())))
            else:
                gnorm = torch.zeros((), device=loss.device)
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm)) \
                if guard else None
            if ok is not False:
                if self._ef_residual is not None:
                    # a skipped step keeps the residual, as the reference's
                    # select does
                    self._ef_residual = residual
                if clip is not None:
                    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9),
                                        max=1.0)
                    for g in grads.values():   # in place, in their dtype
                        g.copy_(g.float().mul_(replicate_like(scale, g)))
                if self._sampler is not None:
                    self._sampler.before_param_update()
                self.opt_state = update_in_place(
                    self.optimizer, self.named_params, grads, self.opt_state)
        for p in self.named_params.values():
            p.grad = None
        return loss, gnorm, ok

    # -- loop -----------------------------------------------------------------

    @property
    def sampler(self):
        """The LGD sampler this trainer drives (None in batches mode)."""
        return self._sampler

    @property
    def sampler_overhead(self) -> float:
        """Fraction of loop wall time spent blocked on batch draws."""
        return self.data_seconds / max(self.loop_seconds, 1e-12)

    def finalize(self):
        self._ckpt.wait()
        if self._sampler is not None:
            self._sampler.finalize()

    # -- checkpoint -----------------------------------------------------------

    def _state_tree(self):
        return {"params": self.named_params, "opt_state": self.opt_state}

    def save(self):
        """Checkpoint the step asynchronously (the tree is on the host
        when this returns) and keep the newest ``keep_ckpts``."""
        if not self.tcfg.ckpt_dir:
            return
        extra = {"step": self.step}
        if self._sampler is not None and self._sampler.streaming:
            # the explicit append/evict log: a restore replays membership
            extra["mutation_log"] = self._sampler.mutation_log()
        # under a mesh every rank gathers its shards (collective), rank 0
        # writes
        writer = self.mesh is None or self.mesh.get_rank() == 0
        self._ckpt.save(self.tcfg.ckpt_dir, self.step, self._state_tree(),
                        extra=extra, write=writer)
        if writer:
            ckpt.keep_last(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)

    def restore(self, step: int):
        """Load checkpoint ``step`` into the live parameters and optimiser
        state, in place, and realign the data stream."""
        _, extra = ckpt.restore(self.tcfg.ckpt_dir, step, self._state_tree(),
                                in_place=True)
        self.step = extra.get("step", step)
        # newer checkpoints are an abandoned timeline (a corrupt newest,
        # or the future a rollback rewound past)
        ckpt.discard_after(self.tcfg.ckpt_dir, self.step)
        if self._sampler is not None:
            # rebuild the index from the restored params and rewind the
            # key streams: O(refresh), bitwise the same on every restore
            self._sampler.set_params(self.params)
            if "mutation_log" in extra:
                self._sampler.load_mutation_log(extra["mutation_log"])
            self._sampler.restore_at(self.step)
            return
        for i in range(self.step):     # skip the consumed batches
            try:
                next(self.batches)
            except StopIteration:
                raise RuntimeError(
                    f"batch iterator exhausted after {i} batches while "
                    f"skipping to checkpoint step {self.step} — the "
                    f"iterator is shorter than the checkpoint (it must be "
                    f"re-creatable past the restore point)") from None

    def _rollback(self) -> bool:
        """Roll back to the newest VERIFIED checkpoint after a streak of
        non-finite steps (sampler mode).  True on success."""
        try:
            self._ckpt.wait()           # surface a boxed async failure
        except RuntimeError:
            pass                        # an older checkpoint may be valid
        step_v = ckpt.latest_valid_step(self.tcfg.ckpt_dir)
        if step_v is None:
            return False
        prev = self.step
        self.restore(step_v)
        self.rollbacks += 1
        self._bad_streak = 0
        self.metrics_history.append({
            "step": self.step, "event": "rollback",
            "from_step": prev, "to_step": step_v,
            "skipped_steps": self.skipped_steps,
        })
        return True

    def _draw(self):
        t0 = time.time()
        try:
            return next(self.batches)
        finally:
            self._last_draw_dt = time.time() - t0
            self.data_seconds += self._last_draw_dt

    def run(self, n_steps: int) -> Dict[str, list]:
        """Train ``n_steps`` steps; batch k trains step k (the next batch
        is drawn while step k runs, and only if step k+1 will run)."""
        losses = []
        if n_steps <= 0:
            return {"losses": losses}
        target = self.step + n_steps
        t_loop = time.time()
        try:
            next_batch = self._draw()
        except StopIteration:
            self.loop_seconds += time.time() - t_loop
            return {"losses": losses}
        while self.step < target:
            t0 = time.time()
            loss, gnorm, ok = self.train_step(next_batch)
            if ok is False:
                self.skipped_steps += 1
                self._bad_streak += 1
            else:
                self._bad_streak = 0
            if self._sampler is not None:
                # the ladder: a non-finite streak sends the pipeline to
                # uniform-fallback
                self._sampler.note_loss(ok is not False)
                if ok is False and self.tcfg.rollback_after > 0 and \
                        self._bad_streak >= self.tcfg.rollback_after and \
                        self.tcfg.ckpt_dir and \
                        self.rollbacks < self.tcfg.max_rollbacks and \
                        self._rollback():
                    # the prefetched batch belongs to the abandoned stream
                    # position: draw again at the rolled-back step
                    next_batch = self._draw()
                    continue
                # the next draw's query reads the post-step model; sync
                # on the loss first, so data_seconds measures the draw
                self._sampler.set_params(self.params)
                loss = float(loss)
            if self.step + 1 < target:
                try:
                    next_batch = self._draw()
                except StopIteration:
                    next_batch = None
            else:
                next_batch = None
            loss = float(loss)
            dt = time.time() - t0
            self._ewma_dt = dt if self._ewma_dt is None else \
                0.9 * self._ewma_dt + 0.1 * dt
            if dt > self.tcfg.straggler_factor * self._ewma_dt:
                self.straggler_steps += 1
            self.step += 1
            losses.append(loss)
            if self.step % self.tcfg.log_every == 0:
                entry = {
                    "step": self.step, "loss": loss,
                    "grad_norm": float(gnorm), "dt": dt,
                    "data_dt": self._last_draw_dt,
                    "stragglers": self.straggler_steps,
                    "skipped_steps": self.skipped_steps,
                    "rollbacks": self.rollbacks,
                }
                if self._sampler is not None:
                    st = self._sampler.sampler_stats()   # syncs
                    entry["fallback_rate"] = st["fallback_rate"]
                    entry["primary_miss_rate"] = st["primary_miss_rate"]
                    # feeds the batch fallback rate into the ladder
                    entry["health"] = self._sampler.check_health()
                    entry["health_transitions"] = \
                        self._sampler.health_summary()["transitions"]
                self.metrics_history.append(entry)
            if self.tcfg.ckpt_dir and \
                    self.step % self.tcfg.ckpt_every == 0:
                self.save()
            if self.tcfg.step_hook is not None:
                # may mutate params or raise at this clean step boundary
                self.tcfg.step_hook(self)
            if next_batch is None:
                break
        self.loop_seconds += time.time() - t_loop
        return {"losses": losses}
