"""Shard-by-example placement for LGD on one device (PyTorch port of the
shard-by-example part of ``repro.dist.sharding``).

* ``example_shard_bounds(n, s, S)``: the contiguous [lo, hi) of corpus
  shard s, sizes differing by at most 1 with the remainder to the lowest
  ids, bitwise the reference's.  Shard s's LSH index covers exactly
  those rows (``data.lsh_pipeline.ShardedLSHPipeline``).
* ``shard_store_device(device, s, S)``: where shard s's token store and
  index live.  On one device every shard lives on the pipeline's device,
  which is what the reference's meshless path (``mesh=None``: the default
  device) computes.
* ``compose_sharded_batch(parts, device)``: the global batch as the
  concatenation of the per-shard sub-batches on that device, shard s's
  rows at [s·m_s, (s+1)·m_s).

Not here: the mesh placement of the reference module (``use_mesh``,
``logical``, ``param_spec``, ``tree_param_shardings``,
``batch_sharding``, ``host_local_mesh``), which spreads parameters and
batches over several devices and comes with a ``DeviceMesh``
(ROADMAP.md queue 1 item 6c).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import resolve_device


def example_shard_bounds(n: int, shard_id: int, n_shards: int):
    """Contiguous [lo, hi) bounds of corpus shard ``shard_id``: a balanced
    split (sizes differ by at most 1, the remainder to the lowest ids)."""
    if not (0 <= shard_id < n_shards):
        raise ValueError(f"shard_id {shard_id} not in [0, {n_shards})")
    base, rem = divmod(n, n_shards)
    lo = shard_id * base + min(shard_id, rem)
    hi = lo + base + (1 if shard_id < rem else 0)
    return lo, hi


def shard_store_device(device, shard_id: int, n_shards: int) -> torch.device:
    """Placement of corpus shard ``shard_id``'s store: the pipeline's one
    device (``shard_id`` / ``n_shards`` keep the reference's signature
    for the placement over several devices)."""
    if not (0 <= shard_id < n_shards):
        raise ValueError(f"shard_id {shard_id} not in [0, {n_shards})")
    return resolve_device(device)


def compose_sharded_batch(parts: Sequence[torch.Tensor],
                          device) -> torch.Tensor:
    """The global batch from equal-length per-shard parts (dim 0), in
    shard order, on ``device``: no host round trip."""
    dev = resolve_device(device)
    return torch.cat([p.to(dev) for p in parts])
