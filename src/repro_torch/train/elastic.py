"""Elastic restart: restore a checkpoint onto a different mesh (PyTorch
port of ``repro.train.elastic``).

The checkpoint format is mesh-agnostic (host numpy per leaf, a DTensor
leaf written whole), so scaling a job up or down is: build the new mesh,
recompute the placements for it, and restore with reshard-on-load.  The
same path handles node failure (restart on the surviving smaller mesh)
and scale-up.  ``restore_on_mesh`` places each leaf of a meshless
template by ``dist.sharding.tree_param_shardings`` (the parameters, and
each optimiser slot under its field, as the reference places
``opt_shapes``); ``mesh=None`` restores onto the template's device.

LGD shard-by-example state is NOT checkpointed: each shard's index is a
pure function of (pipeline seed, corpus shard, restored params, restored
step), so a restart, one that changes the shard count included, rebuilds
it with ``rebuild_sharded_pipeline``, whose shard count defaults to the
mesh's data-parallel degree.  The rebuild is bit-deterministic
(per-shard seed streams and a canonical fresh sort, see
``LSHSampledPipeline.restore_at``): two rebuilds of one checkpoint draw
the same batches.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.dist.sharding import (
    data_axis_size,
    mesh_axes,
    param_placements,
)
from . import checkpoint as ckpt


def state_shardings(mesh, cfg) -> Callable:
    """``shardings(path, leaf)`` for ``checkpoint.restore`` of a trainer
    tree (``{"params": {name: ...}, "opt_state": (step, slots...)}``)
    onto ``mesh``: ``params/<name>`` by ``param_placements``,
    ``opt_state/<field>/<name>`` as that slot (the reference's
    ``.field/...`` paths), the step replicated, an ``Adam8bit``
    ``QTensor``'s ``q`` / ``scale`` plain (whole on every rank)."""
    from torch.distributed.tensor import Replicate

    def fn(path: str, leaf):
        parts = path.split("/")
        if parts[0] == "params" and len(parts) == 2:
            return param_placements(parts[1], leaf.shape, mesh, cfg)
        if parts[0] == "opt_state" and len(parts) == 3:
            return param_placements(parts[2], leaf.shape, mesh, cfg,
                                    slot=parts[1])
        if parts[0] == "opt_state" and len(parts) == 4:
            return None          # a QTensor's q or scale
        return [Replicate()] * len(mesh_axes(mesh))
    return fn


def restore_on_mesh(ckpt_dir: str, step: int, template: Any, mesh=None, *,
                    cfg=None, in_place: bool = False) -> tuple:
    """Restore ``template``-structured state of checkpoint ``step`` onto
    ``mesh`` (any shape; ``cfg`` names the model's leaves): ``(state,
    extra)``.  Without a mesh each leaf lands on its template leaf's
    device (with ``in_place``, into the template's own tensors, DTensor
    templates included)."""
    if mesh is None:
        return ckpt.restore(ckpt_dir, step, template, in_place=in_place)
    if cfg is None:
        raise ValueError("restore_on_mesh onto a mesh needs cfg=")
    return ckpt.restore(ckpt_dir, step, template, in_place=in_place,
                        shardings=state_shardings(mesh, cfg), mesh=mesh)


def restore_latest_valid_on_mesh(ckpt_dir: str, template: Any, mesh=None, *,
                                 cfg=None, in_place: bool = False) -> tuple:
    """The elastic restart's entry point: restore the newest checkpoint
    that passes ``verify()`` onto ``mesh`` (a node failure is exactly
    when the newest one is likely truncated).  Returns ``(step, state,
    extra)``; raises FileNotFoundError when no valid checkpoint exists."""
    step = ckpt.latest_valid_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(
            f"no valid checkpoint under {ckpt_dir!r}")
    state, extra = restore_on_mesh(ckpt_dir, step, template, mesh, cfg=cfg,
                                   in_place=in_place)
    return step, state, extra


def rebuild_sharded_pipeline(
    seed: int,
    tokens,
    feature_fn: Callable,
    query_fn: Callable,
    config,
    step: int,
    *,
    n_shards: Optional[int] = None,
    mesh=None,
    params: Any = None,
    feature_batch: int = 512,
    mutation_log: Any = None,
    owned_shards=None,
    device="cuda",
):
    """Reshard-on-restore for the LGD pipeline: build a
    ``ShardedLSHPipeline`` of ``n_shards`` from the construction corpus
    and the RESTORED ``params``, and rewind it to ``step``.  Twice with
    the same arguments it gives bitwise the same indexes and batches.
    ``n_shards`` defaults to the data-parallel degree of ``mesh`` (1
    without one), so a job that comes back on fewer or more devices
    re-partitions the corpus to match; ``mesh`` places the composed
    batches (``ShardedLSHPipeline``).

    ``mutation_log``: a streaming pipeline's checkpointed log (checkpoint
    ``extra["mutation_log"]``), replayed by ``restore_at``.  It records
    its shard routing, so it restores only onto the SAME ``n_shards``,
    checked before any shard is built.  ``owned_shards``: rebuild a
    subset of the shards (static corpora only)."""
    from repro_torch.data.lsh_pipeline import ShardedLSHPipeline

    if n_shards is None:
        n_shards = data_axis_size(mesh) if mesh is not None else 1
    if isinstance(mutation_log, dict) and "n_shards" in mutation_log:
        logged = int(mutation_log["n_shards"])
        if logged != n_shards:
            # logged append/evict entries are routed by the recorded shard
            # bounds (a global id encodes its shard, and window eviction
            # is shard-local), so there is no canonical re-routing
            raise ValueError(
                f"streaming mutation log was recorded under n_shards="
                f"{logged} but this rebuild targets n_shards="
                f"{n_shards}: logged append/evict entries only replay "
                f"on the recorded shard layout.  Restore with "
                f"n_shards={logged} (one surviving process owns every "
                f"recorded shard), or rebuild the window from the "
                f"upstream source instead of the log.")
    pipe = ShardedLSHPipeline(
        seed, tokens, feature_fn, query_fn, config, n_shards=n_shards,
        feature_batch=feature_batch, params=params, mesh=mesh,
        owned_shards=owned_shards, device=device)
    if mutation_log is not None:
        pipe.load_mutation_log(mutation_log)
    # the constructor just built every index from the restored params, as
    # restore_at would, so only the counters rewind; a shard whose
    # replayed log is non-empty rebuilds anyway
    pipe.restore_at(step, rebuild=False)
    return pipe


def rescale_plan(old_devices: int, new_devices: int,
                 global_batch: int) -> dict:
    """Policy for an elastic rescale: keep the GLOBAL batch fixed so the
    trajectory is unchanged; the per-device batch and the gradient
    accumulation adjust.

    Invariants (asserted): ``per_device_batch_new * new_devices *
    grad_accum_steps == global_batch``, and ``per_device_batch_new <=
    per_device_batch_old`` (a scale-down never asks a device for more
    memory than it had).  Raises ValueError when ``global_batch`` does
    not divide over ``new_devices``."""
    if old_devices <= 0 or new_devices <= 0:
        raise ValueError(
            f"device counts must be positive, got old={old_devices} "
            f"new={new_devices}")
    if global_batch % new_devices != 0:
        raise ValueError(
            f"global_batch={global_batch} does not divide over "
            f"new_devices={new_devices}; elastic rescale keeps the "
            f"global batch fixed, so restore on a device count that "
            f"divides it (or change the batch explicitly)")
    micro = global_batch // new_devices       # rows/device per optimiser step
    per_old = max(global_batch // old_devices, 1)
    # the smallest accumulation depth that caps the per-device batch at
    # the old one and divides the per-device rows exactly
    target = -(-micro // per_old)
    accum = next(a for a in range(target, micro + 1) if micro % a == 0)
    plan = {
        "old_devices": old_devices,
        "new_devices": new_devices,
        "global_batch": global_batch,
        "per_device_batch_old": per_old,
        "per_device_batch_new": micro // accum,
        "grad_accum_steps": accum,
    }
    assert (plan["per_device_batch_new"] * new_devices
            * plan["grad_accum_steps"] == global_batch), plan
    return plan
